"""The collectives of a tensor- and expert-parallel forward: what GSPMD
inserts for the JAX package, issued by the model code here.

A model config bound to a mesh (:func:`bind`) carries a
:class:`TensorParallel` in its ``tp`` attribute; ``models.mistral`` and
``models.mixtral`` read it:

- each rank computes its ``num_heads / model`` query heads and
  ``num_kv_heads / model`` KV heads (column-parallel ``q``/``k``/``v``,
  their biases with them) and its slice of the MLP width;
- :meth:`TensorParallel.reduce_model` sums the partial products of the
  row-parallel ``o`` and ``down`` over the ``model`` group;
- :meth:`TensorParallel.reduce_moe` sums Mixtral's combine over the
  ``expert`` x ``model`` group (each rank holds its experts' slice of the
  width);
- :meth:`TensorParallel.gather_model` assembles logits of a vocab-sharded
  ``lm_head``;
- :meth:`TensorParallel.gather_heads` assembles the ranks' KV heads of
  spilled pool blocks, bit for bit, for the engine's host tier.

Every collective is an ``all_reduce``: the gather writes the rank's
columns into zeros and sums, so one primitive serves NCCL (inside a
captured CUDA graph) and gloo (which stages CUDA tensors through the host
and supports fewer collectives on them). A sum with zeros is exact. With
a group of one rank the collectives still run (an identity), so a
captured graph holds them as it would across cards.
"""

from __future__ import annotations

import copy

import torch

from distllm_tpu_torch.parallel.mesh import EXPERT_AXIS, MODEL_AXIS, MOE_AXES


class TensorParallel:
    """One rank's place on the ``model`` and ``expert`` axes and the groups
    it sums over."""

    def __init__(self, mesh) -> None:
        if mesh.groups is None:
            raise ValueError('a mesh without process groups has no collectives to bind')
        self.model_size = mesh.shape[MODEL_AXIS]
        self.model_rank = mesh.coords[MODEL_AXIS]
        self.expert_size = mesh.shape[EXPERT_AXIS]
        self.expert_rank = mesh.coords[EXPERT_AXIS]
        self.model_group = mesh.group(MODEL_AXIS)
        self.moe_group = mesh.group(MOE_AXES)
        self.backend = mesh.backend

    def local_heads(self, num_heads: int) -> int:
        if num_heads % self.model_size:
            raise ValueError(
                f'{num_heads} heads do not split over model={self.model_size}'
            )
        return num_heads // self.model_size

    @staticmethod
    def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist

        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    def reduce_model(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the ``model`` group's partial products (in place)."""
        return self._all_reduce(x, self.model_group)

    def reduce_moe(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ``expert`` x ``model`` group (in place)."""
        return self._all_reduce(x, self.moe_group)

    def gather_model(self, x: torch.Tensor) -> torch.Tensor:
        """The ``model`` group's last-axis slices of ``x``, in rank order,
        as one tensor ``[..., model * n]``: each rank's columns written
        into zeros, then summed."""
        n = x.shape[-1]
        full = x.new_zeros((*x.shape[:-1], n * self.model_size))
        full[..., self.model_rank * n:(self.model_rank + 1) * n] = x
        return self._all_reduce(full, self.model_group)


    def gather_heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ``model`` group's slices of ``x`` along axis ``dim`` (each
        rank's KV heads), in rank order, as one tensor on every rank:
        each rank's slice written into zeros and summed as raw bytes (a
        ``uint8`` view), where every byte has one non-zero addend, so each
        value arrives bitwise (-0.0 included, which a float sum with +0.0
        would not keep)."""
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.model_size
        full = x.new_zeros(shape)
        full.narrow(dim, self.model_rank * n, n).copy_(x)
        self._all_reduce(full.view(torch.uint8), self.model_group)
        return full


def bind(cfg, mesh):
    """A copy of model config ``cfg`` whose forward runs this rank's shard
    on ``mesh`` (``cfg.tp``); ``cfg`` itself is untouched. A mesh without
    process groups (``single_device_mesh``) binds nothing."""
    out = copy.copy(cfg)
    out.tp = None if mesh is None or mesh.groups is None else TensorParallel(mesh)
    return out


def local_heads(cfg) -> tuple[int, int]:
    """``(query heads, KV heads)`` this rank computes under ``cfg``."""
    tp = getattr(cfg, 'tp', None)
    if tp is None:
        return cfg.num_heads, cfg.num_kv_heads
    return tp.local_heads(cfg.num_heads), tp.local_heads(cfg.num_kv_heads)
