"""Paged KV cache: the device block pool and the block allocator
(PyTorch counterpart of ``distllm_tpu.generate.engine.kv_cache``).

K/V live as ``[L, num_blocks, block_size, N_kv, Hd]`` device tensors and
sequences own lists of block ids. Block 0 is the reserved TRASH block —
padded and out-of-budget writes land there (``ops/paged_attention``).
An int8 pool (``EngineConfig.kv_cache_dtype='int8'``) holds each of K and
V as a ``QuantizedKV``: int8 data of the same shape and an fp32 scale
``[L, num_blocks, N_kv]``. The prefix cache and the host/disk/peer tiers
wait for a later slice.
"""

from __future__ import annotations

import torch

from distllm_tpu_torch.ops.paged_attention import QuantizedKV


class PyBlockAllocator:
    """Free-list + refcount block allocator; block 0 is never handed out."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError('need >= 2 blocks (block 0 is reserved)')
        self._free = list(range(num_blocks - 1, 0, -1))
        self._refcount = [0] * num_blocks
        self._refcount[0] = 1  # trash block, never free

    def alloc(self) -> int:
        if not self._free:
            return -1
        block_id = self._free.pop()
        self._refcount[block_id] = 1
        return block_id

    def incref(self, block_id: int) -> None:
        if self._refcount[block_id] <= 0:
            raise ValueError(f'incref of free block {block_id}')
        self._refcount[block_id] += 1

    def free(self, block_id: int) -> None:
        if self._refcount[block_id] <= 0:
            raise ValueError(f'double free of block {block_id}')
        self._refcount[block_id] -= 1
        if self._refcount[block_id] == 0:
            self._free.append(block_id)

    @property
    def num_free(self) -> int:
        return len(self._free)


class PagedKVCache:
    """Device-resident paged K/V tensors (a pure container: block
    accounting is the scheduler's job). The pool is zero-initialised, so
    the trash block starts finite. ``dtype=torch.int8`` makes ``k`` and
    ``v`` :class:`QuantizedKV` pools (``quantized`` is then true)."""

    def __init__(
        self,
        num_layers: int,
        num_blocks: int,
        block_size: int,
        num_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype,
        device: 'str | torch.device',
    ) -> None:
        self.shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
        self.dtype = dtype
        self.quantized = dtype == torch.int8
        # One fp32 scale per (layer, block, KV head), for K and V each.
        self.scale_shape = (num_layers, num_blocks, num_kv_heads)
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.k = self._zeros(device)
        self.v = self._zeros(device)

    def _zeros(self, device):
        data = torch.zeros(self.shape, dtype=self.dtype, device=device)
        if not self.quantized:
            return data
        return QuantizedKV(
            data, torch.zeros(self.scale_shape, dtype=torch.float32, device=device)
        )

    def blocks_needed(self, num_tokens: int) -> int:
        return (num_tokens + self.block_size - 1) // self.block_size

    @property
    def hbm_bytes(self) -> int:
        """Device bytes of the pool: K and V data, plus their scales."""
        tensors = [*self.k, *self.v] if self.quantized else [self.k, self.v]
        return sum(t.numel() * t.element_size() for t in tensors)
