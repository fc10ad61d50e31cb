"""Partition specs and rule-based sharding of parameter trees (counterpart
of ``distllm_tpu.parallel.sharding``).

Models expose ``param_specs(config) -> tree of P`` alongside
``init``/``apply``, as in JAX. There ``shard_pytree`` places the whole
tree on the mesh and XLA inserts the collectives; here every rank is a
process that keeps only its own slice of each leaf (:func:`shard_leaf`),
and the model code issues the collectives itself
(:mod:`~distllm_tpu_torch.parallel.comm`): the all-reduce after each
row-parallel product, the MoE combine's sum, the gather of vocab-sharded
logits.

Quantized leaves. The JAX package replicates every ``QTensor``; the port
shards int8 ones, which is exact:

- column-parallel (the output axis N split): the codes and the
  per-output-channel scales split along N together;
- row-parallel (the input axis K split): the codes split along K and the
  scales stay whole. A scale belongs to an output channel, so every rank
  multiplies by the same ``s``: ``sum_k (x_k @ q_k) * s = (x @ q) * s``,
  the unsharded product up to the order of the sum;
- a 4-D expert bank ``[L, E, in, out]`` splits its codes on E and on the
  width axis, and its scales ``[L, E, 1, out]`` on E and, column-parallel,
  on ``out``.

An nf4 leaf's blocks run over each flattened ``[in, out]`` slice, so a
column split cuts across them: it is replicated, as in JAX, and carries
the rank's slice (``QTensor.view``), which :meth:`QTensor.dequantize`
takes from the dequantized layer at the point of use.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from distllm_tpu_torch.ops.quantization import QTensor


class PartitionSpec(tuple):
    """One entry per array axis: ``None`` (replicated along it), a mesh
    axis name, or a tuple of names (split over their product, the first
    major). Missing trailing entries are ``None``, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f'P{tuple.__repr__(self)}'


P = PartitionSpec


class NamedSharding:
    """A spec on a mesh (the JAX ``NamedSharding``): :meth:`local` is this
    rank's slice of a leaf."""

    def __init__(self, mesh, spec: PartitionSpec) -> None:
        self.mesh, self.spec = mesh, spec

    def local(self, leaf):
        return shard_leaf(leaf, self.spec, self.mesh)

    def __repr__(self) -> str:
        return f'NamedSharding({self.spec!r})'


def named_sharding(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def replicate(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def axis_slices(shape: tuple, spec, mesh) -> list[tuple[int, int] | None]:
    """This rank's ``(start, stop)`` on each axis of ``shape`` under
    ``spec`` (``None`` where the axis is whole). Raises when a split axis
    does not divide evenly."""
    spec = tuple(spec or ())
    if len(spec) > len(shape):
        raise ValueError(f'spec {spec!r} has more entries than shape {shape}')
    out: list = []
    for dim, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        parts = math.prod(mesh.shape[n] for n in names)
        if parts == 1:
            out.append(None)
            continue
        if dim % parts:
            raise ValueError(
                f'axis of size {dim} does not split evenly over {names} ({parts} parts)'
            )
        index = 0
        for name in names:  # the first name major, as JAX lays devices out
            index = index * mesh.shape[name] + mesh.coords[name]
        size = dim // parts
        out.append((index * size, (index + 1) * size))
    return out


def _take(x: torch.Tensor, slices) -> torch.Tensor:
    """``x`` narrowed on every sliced axis, as a fresh contiguous tensor
    (a view would keep the whole leaf alive)."""
    if all(s is None for s in slices):
        return x
    for axis, s in enumerate(slices):
        if s is not None:
            x = x.narrow(axis, s[0], s[1] - s[0])
    return x.clone(memory_format=torch.contiguous_format)


def shard_leaf(leaf, spec, mesh):
    """This rank's slice of one leaf under ``spec``: a tensor narrowed on
    its split axes; an int8 :class:`QTensor` with its codes narrowed and
    its scales narrowed where they run along a split axis (kept whole on
    their size-1 input axis); an nf4 one replicated with the rank's slice
    recorded (``QTensor.view``)."""
    if leaf is None:
        return None
    shape = tuple(leaf.shape)
    slices = axis_slices(shape, spec, mesh)
    if all(s is None for s in slices):
        return leaf
    if not isinstance(leaf, QTensor):
        return _take(leaf, slices)
    local = tuple(d if s is None else s[1] - s[0] for d, s in zip(shape, slices))
    if leaf.kind == 'int8':
        scale_slices = [
            s if leaf.scale.shape[axis] == shape[axis] else None
            for axis, s in enumerate(slices)
        ]
        return QTensor(
            _take(leaf.q, slices), _take(leaf.scale, scale_slices), leaf.kind,
            local, leaf.out_dtype, leaf.block_size,
        )
    return leaf.with_view(slices)


def shard_pytree(params: Any, specs: Any, mesh) -> Any:
    """This rank's slice of every leaf of ``params``, each under its spec
    in ``specs`` (a tree prefix-compatible with ``params`` whose leaves
    are :class:`PartitionSpec` or ``None``). Axes named in a spec that
    have size 1 in the mesh are legal (no-op sharding), so the same specs
    work from 1 rank to many."""
    if isinstance(params, dict):
        if isinstance(specs, dict):
            missing = sorted(set(params) - set(specs))
            if missing:
                raise ValueError(f'params/specs mismatch: no spec for {missing}')
            return {k: shard_pytree(v, specs[k], mesh) for k, v in params.items()}
        return {k: shard_pytree(v, specs, mesh) for k, v in params.items()}
    return shard_leaf(params, specs, mesh)


def spec_parts(spec, mesh) -> int:
    """Into how many slices ``spec`` cuts a leaf on ``mesh``."""
    parts = 1
    for entry in tuple(spec or ()):
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        parts *= math.prod(mesh.shape[n] for n in names)
    return parts


def spec_at(specs: Any, path: tuple):
    """The spec that governs the leaf at ``path`` (a spec tree may stop
    above a leaf: its spec then covers the subtree)."""
    node = specs
    for key in path:
        if not isinstance(node, dict):
            break
        node = node[key]
    return node


def global_numel(params: Any, specs: Any, mesh, path: tuple = ()) -> tuple[int, int]:
    """``(elements, bytes)`` of the whole tree across the mesh, from this
    rank's slices: a split leaf counts its slice times its parts, a
    replicated one once (the JAX package's global leaf sizes)."""
    if isinstance(params, dict):
        n = b = 0
        for key, value in params.items():
            dn, db = global_numel(value, specs, mesh, path + (key,))
            n, b = n + dn, b + db
        return n, b
    if params is None:
        return 0, 0
    factors = [spec_parts(P(entry), mesh) for entry in tuple(spec_at(specs, path) or ())]
    if isinstance(params, QTensor):
        if params.kind == 'nf4':  # replicated whole
            factors = []
        q, scale = params.q, params.scale
        # A scale axis is split where it runs along the codes' axis.
        pairs = [(q, factors), (scale, [
            f if scale.shape[a] == q.shape[a] else 1 for a, f in enumerate(factors)
        ])]
    else:
        pairs = [(params, factors)]
    n = b = 0
    for t, fs in pairs:
        parts = math.prod(fs)
        n += t.numel() * parts
        b += t.numel() * t.element_size() * parts
    return n, b


def leaf_sharder(specs: Any, mesh, quantization: str | None = None,
                 out_dtype='bfloat16'):
    """A ``leaf_fn(path, leaf, stacked=True)`` for the families' ``init``
    and ``params_from_hf``: the rank's slice of each leaf as it is made,
    under its spec in ``specs``. ``stacked=False`` is one layer's slice of
    a stacked leaf (its spec without the layer axis). With
    ``quantization`` a leaf ``quantize_pytree`` would quantize is
    quantized whole first (a checkpoint's leaves: row-parallel int8 scales
    span the whole input axis), so the codes are the unsharded ones."""
    from distllm_tpu_torch.ops.quantization import (
        quantize_int8,
        quantize_nf4,
        should_quantize,
    )

    def fn(path, leaf, stacked=True):
        if quantization and should_quantize(path, leaf, 4096):
            quantize = quantize_int8 if quantization == 'int8' else quantize_nf4
            leaf = quantize(leaf, out_dtype=out_dtype)
        spec = spec_at(specs, path)
        if not stacked:
            spec = P(*tuple(spec or ())[1:])
        return shard_leaf(leaf, spec, mesh)

    return fn
