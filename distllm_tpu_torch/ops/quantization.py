"""Weight-only quantization (PyTorch counterpart of
``distllm_tpu.ops.quantization``).

Large linear kernels are stored as int8 (symmetric, per output channel)
or nf4 (blockwise 4-bit normal-float codebook, two codes per byte) and
used at the point of use: a 2-D int8 kernel goes straight to the int8
matmul (``ops.quantized_matmul``, kernel K2 on the card) and is never
dequantized; an nf4 kernel is dequantized per layer inside the layer
loop (``models.common.dense``).

The quantizers run on the tensor's own device with the numpy code's
arithmetic (fp32 absmax over the input axis only, ``/ 127``, a zero
scale replaced by 1, round half to even, clip to +-127), so the codes
and scales equal the JAX package's bitwise on the same fp32 weights. A
stacked ``[L, in, out]`` leaf, or a Mixtral expert bank ``[L, E, in,
out]``, is quantized one ``[in, out]`` slice at a time, so the fp32
temporaries never hold more than one slice (235 MB for one expert's
``[4096, 14336]`` where the whole Mixtral-8x7B bank would need 60 GB).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from distllm_tpu_torch.utils import torch_dtype

# The 16 normal-float levels of the QLoRA NF4 data type: quantiles of a
# standard normal, normalized to [-1, 1] (public constants).
NF4_CODEBOOK = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)
# Midpoints between adjacent levels, in fp32 as the numpy quantizer forms
# them: the nearest level is a searchsorted over these.
_NF4_MIDPOINTS = (NF4_CODEBOOK[1:] + NF4_CODEBOOK[:-1]) / 2.0

MODES = ('int8', 'nf4')
# Key substrings whose leaves stay full precision: embedding tables, norm
# scales, biases, the output head and MoE routers (bitsandbytes quantizes
# only nn.Linear weights and exempts lm_head).
_EXEMPT_TAGS = ('embed', 'norm', 'ln', 'bias', 'head', 'router')


class QTensor:
    """A quantized weight leaf: codes, scales and what restores them.

    - int8: ``q`` keeps the weight's shape (``[in, out]`` or stacked
      ``[L, in, out]``); ``scale`` is fp32 and keepdims-broadcastable
      (``[1, out]`` / ``[L, 1, out]``).
    - nf4: ``q`` is uint8 ``[..., nblocks, block_size // 2]`` (high
      nibble first); ``scale`` is fp32 ``[..., nblocks]``.

    ``shape`` is the logical float shape and ``out_dtype`` the dtype
    :meth:`dequantize` returns. ``qt[li]`` slices ``q`` and ``scale`` on
    the leading layer axis together (the port's layer loops index where
    the JAX code's ``lax.scan`` slices a stacked leaf).

    ``view`` (nf4 under tensor parallelism, ``parallel.sharding``): the
    codes are the whole weight's, replicated, and ``view = (full_shape,
    slices)`` names this rank's ``(start, stop)`` on each sliced axis;
    ``shape`` is then the slice's and :meth:`dequantize` narrows the
    dequantized weight to it.
    """

    __slots__ = ('q', 'scale', 'kind', 'shape', 'out_dtype', 'block_size', 'view')

    def __init__(
        self,
        q: torch.Tensor,
        scale: torch.Tensor,
        kind: str,
        shape: tuple[int, ...],
        out_dtype: 'str | torch.dtype',
        block_size: int = 0,
        view: tuple | None = None,
    ) -> None:
        if kind not in MODES:
            raise ValueError(f'unknown quantization kind {kind!r}')
        self.q = q
        self.scale = scale
        self.kind = kind
        self.shape = tuple(int(d) for d in shape)
        self.out_dtype = torch_dtype(out_dtype)
        self.block_size = int(block_size)
        self.view = view

    def with_view(self, slices) -> 'QTensor':
        """The same codes, seen through this rank's ``slices`` (one
        ``(start, stop)`` or ``None`` per logical axis)."""
        if self.view is not None:
            raise ValueError('this QTensor is already a slice')
        local = tuple(d if s is None else s[1] - s[0] for d, s in zip(self.shape, slices))
        return QTensor(self.q, self.scale, self.kind, local, self.out_dtype,
                       self.block_size, (self.shape, tuple(slices)))

    def __getitem__(self, index: int) -> 'QTensor':
        if len(self.shape) < 3:
            raise IndexError('only a stacked QTensor has a layer axis to index')
        view = None
        if self.view is not None:
            full, slices = self.view
            if slices[0] is not None:
                raise IndexError('the layer axis of this QTensor is sliced')
            view = (full[1:], slices[1:])
        return QTensor(
            self.q[index], self.scale[index], self.kind, self.shape[1:],
            self.out_dtype, self.block_size, view,
        )

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def dequantize(self) -> torch.Tensor:
        """The float weight in ``out_dtype``, with the JAX arithmetic
        (codes and scale cast to ``out_dtype``, multiplied there). An
        int8 product takes the codes as they are: promotion casts them to
        ``out_dtype`` exactly (|q| <= 127) inside the one multiply, so no
        float copy of the codes is made first. (On the H100 a cast and
        then an in-place multiply by the broadcast scale, both
        unvectorized, took 266 ms of a Mixtral-8x7B decode pass against
        the one multiply's 191: ``scripts/profile_torch_serve.py --model
        mixtral``.)"""
        dt = self.out_dtype
        if self.kind == 'int8':
            return torch.mul(self.q, self.scale.to(dt))
        high = (self.q >> 4) & 0x0F
        low = self.q & 0x0F
        codes = torch.stack([high, low], dim=-1).reshape(*self.q.shape[:-1], -1)
        codebook = _nf4_codebook(self.q.device, dt)
        values = codebook[codes.long()] * self.scale.to(dt)[..., None]
        lead = self.q.shape[:-2]
        full, slices = self.view if self.view is not None else (self.shape, ())
        tail = full[-2:]
        flat = values.reshape(*lead, -1)[..., : tail[0] * tail[1]]
        out = flat.reshape(*lead, *tail)
        for axis, s in enumerate(slices):
            if s is not None:
                out = out.narrow(axis, s[0], s[1] - s[0])
        return out

    def __repr__(self) -> str:
        return (f'QTensor({self.kind}, shape={self.shape}, '
                f'out_dtype={self.out_dtype}, device={self.device})')


# The NF4 codebook on each (device, dtype), made once: a host-to-device
# copy per dequantization would block, and a decode step captured as a
# CUDA graph may not block. The eager step before a capture makes it.
_NF4_CODEBOOKS: dict[tuple[str, torch.dtype], torch.Tensor] = {}


def _nf4_codebook(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    key = (str(device), dtype)
    book = _NF4_CODEBOOKS.get(key)
    if book is None:
        book = torch.as_tensor(NF4_CODEBOOK, device=device).to(dtype)
        _NF4_CODEBOOKS[key] = book
    return book


def _int8_slice(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Codes and scales of one ``[..., in, out]`` slice (fp32 math). The
    one slice-sized fp32 transient is the copy divided in place: the
    absmax comes from ``amax`` / ``amin`` (``|w|``'s max exactly, with no
    ``|w|`` tensor), and rounding and clipping act on the quotient."""
    w = w.to(torch.float32, copy=True)
    absmax = torch.maximum(w.amax(dim=-2, keepdim=True), w.amin(dim=-2, keepdim=True).neg_())
    # A tensor divisor, not the scalar 127: on CUDA PyTorch turns division
    # by a host scalar into multiplication by its reciprocal, which rounds
    # differently from numpy's division.
    scale = absmax / torch.full_like(absmax, 127.0)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = w.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def _nf4_slice(w: torch.Tensor, block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed codes and block scales of one 2-D weight (fp32 math)."""
    flat = w.float().reshape(-1)
    pad = (-flat.numel()) % block_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block_size)
    absmax = blocks.abs().amax(dim=-1)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax)
    normalized = blocks / scale[:, None]
    midpoints = torch.as_tensor(_NF4_MIDPOINTS, device=w.device)
    idx = torch.searchsorted(midpoints, normalized.contiguous()).to(torch.uint8)
    packed = (idx[:, 0::2] << 4) | idx[:, 1::2]
    return packed, scale


def _per_slice(w: torch.Tensor, fn, *args):
    """``fn`` over every ``[in, out]`` slice of a ``[..., in, out]``
    weight (a layer's slice, or one expert's of an ``[L, E, in, out]``
    bank), one at a time, written into outputs preallocated on the first
    and stacked on the leading axes: the fp32 transients never exceed one
    slice (a ``[32, 4096, 14336]`` leaf never has an fp32 copy), nor the
    codes a second copy. A 2-D weight in one call."""
    lead = w.shape[:-2]
    if not lead:
        return fn(w, *args)
    flat = w.reshape(-1, *w.shape[-2:])
    outs = None
    for i in range(flat.shape[0]):
        parts = fn(flat[i], *args)
        if outs is None:
            outs = tuple(p.new_empty((flat.shape[0], *p.shape)) for p in parts)
        for out, part in zip(outs, parts):
            out[i] = part
        del parts
    return tuple(out.reshape(*lead, *out.shape[1:]) for out in outs)


def quantize_int8(
    w: torch.Tensor, out_dtype: 'str | torch.dtype' = 'bfloat16'
) -> QTensor:
    """Symmetric per-output-channel int8 (channel = last axis); only the
    input axis (second to last) is reduced, so every layer of a stacked
    ``[L, in, out]`` leaf, and every expert of an ``[L, E, in, out]``
    bank, keeps its own per-channel range. One ``[in, out]`` slice is
    quantized at a time into preallocated codes and scales."""
    if w.dim() < 2:
        raise ValueError(f'int8 quantization needs a [..., in, out] weight, got {tuple(w.shape)}')
    q, scale = _per_slice(w, _int8_slice)
    return QTensor(q, scale, 'int8', tuple(w.shape), out_dtype)


def quantize_nf4(
    w: torch.Tensor,
    block_size: int = 64,
    out_dtype: 'str | torch.dtype' = 'bfloat16',
) -> QTensor:
    """Blockwise NF4: per-block absmax scale and 4-bit codebook codes, two
    per byte. Blocks run over the flattened weight of each layer; a
    partial tail block is zero-padded (zero maps to level 7 exactly)."""
    if w.dim() < 2:
        raise ValueError(f'nf4 quantization needs a [..., in, out] weight, got {tuple(w.shape)}')
    if block_size % 2:
        raise ValueError('nf4 block_size must be even (two codes per byte)')
    q, scale = _per_slice(w, _nf4_slice, block_size)
    return QTensor(q, scale, 'nf4', tuple(w.shape), out_dtype, block_size)


def should_quantize(path: tuple, leaf: Any, min_size: int) -> bool:
    """The JAX ``_should_quantize`` gate: a floating 2-, 3- or 4-D leaf of
    at least ``min_size`` elements whose ``/``-joined, lower-cased key
    path names none of the exempt tags."""
    if (
        not isinstance(leaf, torch.Tensor)
        or leaf.dim() not in (2, 3, 4)
        or leaf.numel() < min_size
        or not leaf.is_floating_point()
    ):
        return False
    keys = '/'.join(str(k) for k in path).lower()
    return not any(tag in keys for tag in _EXEMPT_TAGS)


def normalize_mode(value: 'bool | str | None') -> str | None:
    """A config's ``quantization`` field as a mode: ``True`` means
    ``'nf4'`` (the reference's quantization flag loads bitsandbytes NF4);
    ``False`` / ``None`` / ``''`` disable."""
    if value is True:
        return 'nf4'
    if value and value not in MODES:
        raise ValueError(f'unknown quantization mode {value!r}; one of {MODES}')
    return value or None


def quantize_pytree(
    params: dict,
    mode: str = 'nf4',
    min_size: int = 4096,
    block_size: int = 64,
    out_dtype: 'str | torch.dtype' = 'bfloat16',
    delete_source: bool = False,
) -> dict:
    """Replace large float kernels of a nested-dict tree with
    :class:`QTensor` leaves; exempt and small leaves pass through.

    ``delete_source=True`` streams the conversion: each replaced leaf is
    dropped from ``params`` (the caller's dict) as soon as its codes
    exist, so device memory peaks at the float weights plus one leaf's
    codes instead of the float weights plus all codes. Only set it when
    the caller owns ``params``.
    """
    if mode not in MODES:
        raise ValueError(f'unknown quantization mode {mode!r}; one of {MODES}')

    def walk(node: dict, path: tuple) -> dict:
        out = {}
        for key in list(node):
            leaf = node[key]
            here = path + (key,)
            if isinstance(leaf, dict):
                out[key] = walk(leaf, here)
            elif isinstance(leaf, QTensor) or not should_quantize(here, leaf, min_size):
                out[key] = leaf
            else:
                if mode == 'int8':
                    out[key] = quantize_int8(leaf, out_dtype)
                else:
                    out[key] = quantize_nf4(leaf, block_size, out_dtype)
                if delete_source:
                    node[key] = None
                del leaf
        return out

    return walk(params, ())


def dequantize_pytree(params: dict) -> dict:
    """The tree with every :class:`QTensor` leaf restored to its float
    weight."""
    if isinstance(params, dict):
        return {k: dequantize_pytree(v) for k, v in params.items()}
    return params.dequantize() if isinstance(params, QTensor) else params


def leaves(tree) -> list:
    """The leaves of a nested-dict tree, a :class:`QTensor` as one leaf."""
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in leaves(value)]
    return [tree]


def quantized_nbytes(params: dict) -> tuple[int, int]:
    """``(quantized bytes, float bytes)`` over the tree, for telemetry."""
    q_bytes = f_bytes = 0
    for leaf in leaves(params):
        if isinstance(leaf, QTensor):
            q_bytes += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            f_bytes += leaf.numel() * leaf.element_size()
    return q_bytes, f_bytes


def qtensor_from_jax(leaf, device: 'str | torch.device') -> QTensor:
    """A JAX ``QTensor`` whose ``q``/``scale`` the caller turned into numpy
    arrays, as the port's, on ``device``: codes keep their integer dtype,
    scales stay fp32. Recognised by its attributes (the port never
    imports the JAX class)."""
    q = torch.from_numpy(np.array(leaf.q, copy=True)).to(device)
    scale = torch.from_numpy(np.array(leaf.scale, np.float32, copy=True)).to(device)
    return QTensor(q, scale, str(leaf.kind), tuple(leaf.shape),
                   str(leaf.out_dtype), int(leaf.block_size))


def is_jax_qtensor(leaf) -> bool:
    return all(hasattr(leaf, a) for a in ('q', 'scale', 'kind', 'out_dtype'))
