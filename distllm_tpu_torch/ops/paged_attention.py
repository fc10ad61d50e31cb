"""Paged-KV attention — the attention site of every serving dispatch.

The PyTorch counterpart of ``distllm_tpu.ops.paged_attention``. The KV
cache lives on the device as fixed-size blocks::

    k_cache, v_cache : [num_blocks, block_size, num_kv_heads, head_dim]

and each sequence owns a row of ``block_tables`` (block ids, padded with
the reserved trash block 0) plus a ``context_lens`` entry. Decode rows and
prefill tails are both per-row query SPANS (a decode row is the span-1
case), and one op serves them:

- :func:`ragged_paged_attention_reference` — the plain PyTorch version:
  gather + masked fp32 softmax, the twin of ``ragged_paged_attention_xla``.
  It runs wherever PyTorch runs and is what the CPU tests check against
  the JAX op.
- the CUDA kernel ``csrc/ragged_paged_attention.cu`` — the hand-written
  Hopper twin of ``ragged_paged_attention_pallas``: online fp32 softmax,
  K/V staged once per query tile for the whole GQA group, no score tensor
  in device memory. It has four routes (:func:`kernel_route`):
  ``'wgmma'`` for bf16 query tiles of 64..128 rows over a bf16 pool of
  16-token pages (prefill and long chunks) — a TMA producer warp, two
  consumer warpgroups of 64 rows, Q·Kᵀ and P·V as ``wgmma``;
  ``'tensor_cores'`` for the other bf16 query tiles of 16 or more rows
  (span positions x GQA group: the verify window, short chunks, int8 and
  mixed pools) — Q·Kᵀ and P·V as bf16 ``mma.sync`` with fp32
  accumulators, p rounded to bf16 before P·V as the TPU kernel rounds it
  (as on the wgmma route); ``'split_kv'`` for bf16 tiles of fewer rows
  (decode rows at Mistral's group of 4) — the same products with each
  row's keys split across thread blocks (:func:`split_plan`) and the
  splits merged in one launch; and ``'cuda_cores'`` for fp32, fp32
  products on the CUDA cores.
- :func:`ragged_paged_attention` — the dispatch. A tensor on the CPU goes
  to the plain version; a CUDA tensor launches the kernel or raises. It
  keeps an integer ``launches`` count of kernel launches and a
  ``launches_by_route`` count per route, and the plain version keeps its
  own count of calls, so a run can show which one served it.
- :func:`comparison_tolerance` — the elementwise bound that holds the
  kernel to the plain version, per route.

A pool is a bare tensor in the query's dtype, a bare tensor of the other
full-precision dtype (``EngineConfig(kv_cache_dtype='bf16')`` under an
fp32 model, ``'fp32'`` under a bf16 one: the mixed mode, where K is cast
to q's dtype before Q·Kᵀ and p to V's before P·V, as the Pallas kernel
casts), or an int8 :class:`QuantizedKV` (``kv_cache_dtype='int8'``): int8
codes plus a per-block, per-KV-head fp32 scale, quantized at write time
(:func:`write_token_kv` rescales a block on append as its running absmax
grows; :func:`write_chunk_kv` quantizes a span at its blocks' final
scales) with the JAX package's arithmetic step for step, so the codes
and scales are bitwise the JAX ones. The plain version dequantizes as it
gathers; the kernel folds K's scale into the fp32 score and V's into p,
on every route (its int8-KV mode, ``launches_by_kv['int8']``); the
mixed mode is ``launches_by_kv['mixed']``.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import math
from typing import NamedTuple

import torch

from distllm_tpu_torch.observability import op_cost as _op_cost

from distllm_tpu_torch.ops import _build

# Query rows (span positions x GQA group) one thread block holds on the
# tensor-core route; on the wgmma route, two warpgroups of 64.
_MAX_TILE_ROWS = 64
_WGMMA_TILE_ROWS = 128
# bf16 tiles of at least this many rows over a bf16 pool of 16-token pages
# take the wgmma route (chip_smoke.py times both routes at the main paths'
# shapes; PERF.md has the lines).
WGMMA_MIN_ROWS = 64
WGMMA_BLOCK_SIZE = 16
# The tensor-core route takes bf16 tiles of at least one mma's 16 rows;
# the split-KV route takes the bf16 tiles of fewer.
_MIN_MMA_ROWS = 16
# Head dims of the kernel, on every route and KV mode (256: the Gemma
# families; the Pallas kernel takes any multiple of 128).
KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {'cuda_cores': 0, 'tensor_cores': 1, 'split_kv': 2, 'wgmma': 3}
# The split-KV route's plan: a block takes its split in steps of 64 keys
# (four warps of 16), a split holds at least SPLIT_MIN_KEYS keys when the
# row has that many, and the grid aims at split_blocks_per_sm(head_dim)
# blocks per SM when every row is full: SPLIT_BLOCKS_PER_SM at head dims 64
# and 128, where two blocks' rings fit an SM's shared memory, one at 256.
SPLIT_STEP_KEYS = 64
SPLIT_MIN_KEYS = 128
SPLIT_BLOCKS_PER_SM = 2
# The pool's storage: q's dtype ('model'), int8 codes with scales, or the
# other full-precision dtype ('mixed': a bf16 pool under fp32 q, an fp32
# pool under bf16 q).
KV_MODES = {'model': 0, 'int8': 1, 'mixed': 2}


# The attention selector of the engine and the model functions: 'auto' is
# ragged_paged_attention (K1 for CUDA tensors, its plain version for CPU
# tensors, as every wrapper); 'reference' pins the plain version on any
# device (the card-side identity check).
ATTN_BACKENDS = ('auto', 'reference')


def supports_model(model_cfg) -> bool:
    """Does kernel K1 serve this model? K1 takes the logit softcap, a
    custom scale and a per-layer window natively, so it is the head dim
    alone (the JAX ``supports_model``, over the head dims the port's
    kernel has)."""
    return model_cfg.head_size in KERNEL_HEAD_DIMS


def resolve_attn_backend(attn_backend: str, model_cfg, device: torch.device) -> str:
    """The attention backend an engine serves with, resolved once at its
    construction and never per call (the JAX ``resolve_attn_backend``):
    ``'auto'`` stays ``'auto'`` (kernel K1) on a CUDA device and is
    ``'reference'`` on the CPU; ``'auto'`` on a CUDA device for a head dim
    K1 lacks raises here, naming it, rather than serve the plain op on the
    card."""
    if attn_backend not in ATTN_BACKENDS:
        raise ValueError(
            f'attn_backend must be one of {ATTN_BACKENDS}, got {attn_backend!r}'
        )
    resolved = attn_backend
    if attn_backend == 'auto' and device.type != 'cuda':
        resolved = 'reference'
    elif attn_backend == 'auto' and not supports_model(model_cfg):
        raise ValueError(
            f'kernel K1 has no head dim {model_cfg.head_size} (it has '
            f"{KERNEL_HEAD_DIMS}); attn_backend='reference' pins the plain "
            f'paged-attention op on {device}'
        )
    logging.getLogger(__name__).info(
        'attn_backend=%r resolved to %r on %s', attn_backend, resolved, device
    )
    return resolved


class QuantizedKV(NamedTuple):
    """Int8 paged-KV container, the JAX package's layout: ``data`` int8
    ``[..., num_blocks, block_size, num_kv_heads, head_dim]`` and
    ``scale`` fp32 ``[..., num_blocks, num_kv_heads]`` — symmetric,
    ``x ≈ data * scale`` with ``scale = absmax / 127`` over the block's
    live rows per KV head. The engine's pool carries a leading layer axis
    on both members; ``models.mistral._kv_layer`` slices them together
    into views, so the in-place writes land in the pool."""

    data: torch.Tensor
    scale: torch.Tensor


# Symmetric int8 range: scale = absmax / KV_QUANT_MAX maps the block's
# largest magnitude to +/-127 (-128 unused).
KV_QUANT_MAX = 127.0


def _absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` as a true fp32 division on every device. PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, which
    is one rounding off the CPU's (and JAX's) quotient; a 0-d tensor on
    the same device keeps the division exact, so the card's scales are
    bitwise the CPU's."""
    return amax / amax.new_full((), KV_QUANT_MAX)


def kv_storage_dtype(cache) -> torch.dtype:
    """The dtype KV blocks are stored as (int8 for :class:`QuantizedKV`)."""
    return cache.data.dtype if isinstance(cache, QuantizedKV) else cache.dtype


def _kv_data(cache) -> torch.Tensor:
    return cache.data if isinstance(cache, QuantizedKV) else cache


def _check_pools(k_cache, v_cache) -> bool:
    """Whether the pools are int8; raises unless both are
    :class:`QuantizedKV` or neither is, and on a ``QuantizedKV`` whose
    data is not int8 or whose scale is not fp32 ``[..., nb, Nkv]``."""
    quantized = isinstance(k_cache, QuantizedKV)
    if quantized != isinstance(v_cache, QuantizedKV):
        raise TypeError('K and V pools must both be QuantizedKV or neither')
    if not quantized:
        return False
    for cache in (k_cache, v_cache):
        data, scale = cache
        if data.dtype != torch.int8 or scale.dtype != torch.float32:
            raise TypeError(
                f'QuantizedKV holds int8 data and fp32 scales, got '
                f'{data.dtype} / {scale.dtype}'
            )
        if scale.shape != data.shape[:-3] + data.shape[-2:-1]:
            raise ValueError(
                f'QuantizedKV scale {tuple(scale.shape)} does not match data '
                f'{tuple(data.shape)}: expected [..., num_blocks, num_kv_heads]'
            )
    return True


def quantize_kv_rows(rows: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize ``rows`` (``[..., num_kv_heads, head_dim]``) against a
    per-KV-head ``scale`` (``[..., num_kv_heads]``), the JAX arithmetic
    step for step (a true division, round half to even, clip). Zero
    scales (fresh blocks, trash-block garbage) give exact zeros through a
    guarded denominator, never a NaN."""
    denom = torch.where(scale > 0, scale, 1.0)[..., None]
    q = torch.round(rows.float() / denom)
    q = torch.clamp(q, -KV_QUANT_MAX, KV_QUANT_MAX)
    return torch.where(scale[..., None] > 0, q, 0.0).to(torch.int8)


def _rescale_int8_blocks(
    data: torch.Tensor, old_scale: torch.Tensor, new_scale: torch.Tensor
) -> torch.Tensor:
    """Re-express int8 block rows quantized at ``old_scale`` in units of
    ``new_scale`` (``data [..., block_size, num_kv_heads, head_dim]``,
    scales ``[..., num_kv_heads]``). Appends only grow a block's running
    absmax, so the ratio is <= 1; a zero ``new_scale`` zeroes the rows."""
    denom = torch.where(new_scale > 0, new_scale, 1.0)
    ratio = torch.where(new_scale > 0, old_scale / denom, 0.0)
    out = torch.round(data.float() * ratio[..., None, :, None])
    return torch.clamp(out, -KV_QUANT_MAX, KV_QUANT_MAX).to(torch.int8)


def ragged_paged_attention_reference(
    q: torch.Tensor,  # [B, S, num_heads, head_dim] per-row query spans
    k_cache: torch.Tensor,  # [num_blocks, block_size, num_kv_heads, head_dim]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] int
    context_lens: torch.Tensor,  # [B] total valid tokens incl. the span
    q_positions: torch.Tensor,  # [B, S] absolute position of each query
    q_lens: 'torch.Tensor | None' = None,  # [B] valid queries per row
    sliding_window: 'int | torch.Tensor | None' = None,
    scale: float | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Ragged per-row-query-span attention over paged KV, plain PyTorch.

    Every query attends to the cached positions ``<=`` its own (the span's
    K/V are already written: write-then-attend) and ``< context_lens``.
    ``sliding_window`` limits a query at ``p`` to keys in ``(p - window,
    p]``; a window ``<= 0`` (int or 0-d tensor) is off. ``q_lens`` masks
    each row's padding queries onto key 0 so their softmax stays finite —
    valid rows are unchanged either way, and pad rows are garbage every
    caller discards (the kernel writes zeros there). Scores, softmax and
    the weighted sum run in fp32; the result has ``q``'s dtype. An int8
    :class:`QuantizedKV` pool is dequantized as it is gathered (``data *
    scale`` in fp32, JAX's ``_gather_kv_blocks``).
    """
    _check_pools(k_cache, v_cache)
    ragged_paged_attention_reference.launches += 1
    b, s, num_heads, head_dim = q.shape
    scores, v = _scores_and_values(
        q, k_cache, v_cache, block_tables, context_lens, q_positions, q_lens,
        sliding_window, scale, logit_softcap,
    )
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    pool_dtype = kv_storage_dtype(v_cache)
    if _mixed(q, pool_dtype) and pool_dtype != torch.float32:
        # fp32 q over a narrower pool: p, unnormalised, is rounded to V's
        # dtype before P @ V (the Pallas kernel's probs.astype(vh.dtype)).
        weights = p.to(pool_dtype).float()
    else:
        weights = p
    # l sums the unrounded p.
    out = torch.einsum('bkgst,btkd->bskgd', weights, v)
    out = out / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, num_heads, head_dim).to(q.dtype)


def _mixed(q: torch.Tensor, pool_dtype: torch.dtype) -> bool:
    """Whether a full-precision pool of ``pool_dtype`` differs from q's
    dtype (the mixed mode: bf16 pools under fp32 models, fp32 pools under
    bf16 ones)."""
    return pool_dtype != torch.int8 and pool_dtype != q.dtype


def _scores_and_values(
    q, k_cache, v_cache, block_tables, context_lens, q_positions, q_lens,
    sliding_window, scale, logit_softcap,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's masked fp32 scores ``[B, Nkv, G, S, T]`` (-inf
    where a key is not attended) and its gathered fp32 values
    ``[B, T, Nkv, Hd]``."""
    b, s, num_heads, head_dim = q.shape
    num_kv_heads = _kv_data(k_cache).shape[2]
    group = num_heads // num_kv_heads
    t = block_tables.shape[1] * _kv_data(k_cache).shape[1]
    k, v = _gather_kv(k_cache, block_tables), _gather_kv(v_cache, block_tables)
    if _mixed(q, kv_storage_dtype(k_cache)):
        # K is cast to q's dtype before Q @ K^T (the Pallas kernel's
        # kh.astype(qh.dtype)): exact from bf16 to fp32, a rounding from
        # fp32 to bf16.
        k = k.to(q.dtype).float()
    qg = q.reshape(b, s, num_kv_heads, group, head_dim).float()
    scores = torch.einsum('bskgd,btkd->bkgst', qg, k)
    scores = scores * (scale if scale is not None else head_dim ** -0.5)
    if logit_softcap is not None:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    kv_pos = torch.arange(t, device=q.device)[None, None, :]  # [1, 1, T]
    qp = q_positions.long()[:, :, None]  # [B, S, 1]
    valid = (kv_pos < context_lens.long()[:, None, None]) & (kv_pos <= qp)
    if sliding_window is not None:
        windowed = kv_pos > qp - sliding_window
        valid = valid & (windowed | (torch.as_tensor(sliding_window) <= 0))
    if q_lens is not None:
        q_valid = (
            torch.arange(s, device=q.device)[None, :, None]
            < q_lens.long()[:, None, None]
        )
        valid = valid | (~q_valid & (kv_pos == 0))
    return scores.masked_fill(~valid[:, None, None], float('-inf')), v


def _gather_kv(cache, block_tables: torch.Tensor) -> torch.Tensor:
    """Each row's pages as fp32 ``[B, T, Nkv, Hd]``; an int8 pool is
    dequantized in the same expression (``data[bt] * scale[bt]``)."""
    bt = block_tables.long()
    if isinstance(cache, QuantizedKV):
        x = cache.data[bt].float() * cache.scale[bt][:, :, None, :, None]
    else:
        x = cache[bt].float()
    return x.reshape(bt.shape[0], -1, *x.shape[-2:])


ragged_paged_attention_reference.launches = 0

# The kernel against the plain version on valid rows, elementwise:
#   |out - ref| <= REL * |ref| + ABS                       bf16, cuda_cores
#   |out - ref| <= REL * |ref| + P_REL * (P @ |V|) + ABS   bf16, tensor_cores
#                                                          and split_kv
#   |out - ref| <= ABS                                     fp32
# with P the plain version's normalised fp32 softmax of the query and |V|
# the magnitudes of the values it weighs. On the CUDA cores both sides
# form fp32 p and fp32 sums and round out once to bf16: where their fp32
# values straddle a rounding point they are one bf16 step apart, at most
# 2**-7 * |out|. The tensor-core route rounds each unnormalised p_j to
# bf16 before P @ V (the TPU kernel's probs.astype(vh.dtype)): a relative
# error of at most 2**-8 per key, while l sums the unrounded p. The
# normalised result then moves by at most sum_j 2**-8 * p_j / l * |v_jd|
# = 2**-8 * (P @ |V|)_d before the final rounding, which adds the straddle
# term as on the CUDA cores. That is to first order: the cross term,
# 2**-15 * (P @ |V|), is 1/128 of the p term, which itself assumes every
# p_j rounds by a full half step in one direction (the running maximum's
# p_j = exp(0) = 1 does not round at all). ABS covers fp32 summation-order
# noise at outputs near zero. The split-KV route holds the same bound: each
# p_j is still rounded to bf16 exactly once, unnormalised, relative to the
# running maximum of the warp and split that hold key j — a relative error
# of at most 2**-8 of that p_j, whatever maximum it was taken against —
# and l sums the unrounded p. The merge of the warps and then of the
# splits multiplies each partial (l_s, acc_s) by exp(m_s - M) and adds them
# in fp32: a few more fp32 roundings of each term, relative error ~2**-22,
# inside the summation noise that ABS and the final rounding already cover.
# So the normalised result moves by at most 2**-8 * (P @ |V|) before the
# final rounding, as on the tensor-core route. Stated worst ratios: tests/
# test_torch_paged_attention.py (CPU emulation of each tensor-core route's
# order) and chip_smoke.py phases 3 and 3b (the kernel on the card).
#
# An int8 pool adds one term on every route. The plain version
# dequantizes first (k = c * k_scale, one fp32 rounding per element) and
# then sums q . k; the kernel sums q . c (codes widened exactly: |c| <=
# 127 fits fp32 and bf16) and multiplies by scale and k_scale after. Each
# side's dot product of Hd fp32 products is off by at most Hd * 2**-24 *
# sum_d |q_d| |c_jd| in units of its scales, and each side adds two
# roundings of the score: |ds_j| <= E_j = (2 Hd + 4) * 2**-24 * scale *
# k_scale_j * (|q| . |c_j|) = (2 Hd + 4) * 2**-24 * scale * (|q| . |k_j|).
# The softcap's tanh has slope <= 1, so it passes E_j on unchanged. A
# score error moves the softmax by dP_j = P_j (ds_j - sum_i P_i ds_i),
# hence out_d by sum_j P_j ds_j (v_jd - out_d), which is at most
#   sum_j P_j E_j (|v_jd| + |out_d|)                       (INT8 term)
# (the tensor cores' fp32 accumulation of exact bf16 products stays
# within the same Hd * 2**-24 per score). V's scale needs no term of its
# own: on the CUDA cores p * v_scale is one more fp32 rounding of each
# weight, inside the summation noise ABS covers; on the tensor cores the
# bf16 rounding of p_j * v_scale_j is the rounding of p_j above (on both
# tensor-core routes), so the P_REL term holds with |V| the dequantized
# values. Stated worst ratios:
# tests/test_torch_kv_quant.py (CPU emulation of each route's order, and
# the faults it must catch) and chip_smoke.py phase 3b (the kernel).
#
# A full-precision pool of another dtype than q (the mixed mode) adds
#   TOL_MIXED * (P @ |V|)                                  (MIXED term)
# on every route. fp32 q over a bf16 pool: K widens exactly and both sides
# round each unnormalised p_j to bf16 before P @ V, as the Pallas kernel
# does (probs.astype(vh.dtype)) — the plain version against its global
# maximum, the kernel against its running one — so each side's p_j is
# within 2**-8 of the exact value and the two are within 2**-7 of each
# other; l sums the unrounded p on both. bf16 q over an fp32 pool: both
# sides round K to bf16 the same way (round to nearest even), so the
# scores differ only as in the bf16 mode. The Pallas kernel and the plain
# version then weigh fp32 V by fp32 p; on the tensor-core routes the
# kernel narrows the staged fp32 V to bf16 for mma.sync (one rounding, at
# most 2**-8 of |v_jd|), on top of the rounding of p that P_REL already
# covers: 2**-7 bounds that rounding with room for the cross term (2**-16).
# On the CUDA cores nothing more is rounded and the term is slack.
#
# That sum of worst cases grows with the row: on a long row of N(0, 1)
# values P @ |V| stays near 0.8 while |out| falls toward 0.02, so a kernel
# that drops one page of 4096 keys would hide under it. In the mixed mode
# the bf16 roundings' term (P_REL's and MIXED's weight w) is therefore the
# smaller of that bound and
#   w * (|out| + TOL_MIXED_SIGMAS * sqrt(P**2 @ V**2))   (probabilistic)
# the model of probabilistic rounding-error analysis (Higham and Mary,
# SIAM J. Sci. Comput. 41(5), 2019): out_d moves by sum_j P_j v_jd e_jd
# with |e_jd| <= w; the share of the e_jd that all keys have in common
# moves it by at most w * |out_d|, and the rest, independent and of mean
# zero, exceeds w * lambda * sqrt(sum_j P_j**2 v_jd**2) with probability
# at most 2 exp(-lambda**2 / 2) (Hoeffding): 3e-8 an element at lambda 6.
# Stated worst ratios, and a dropped last page of a 4096-key row caught
# on every route: tests/test_torch_kv_mixed.py (the Pallas kernel in
# interpret mode, and a CPU emulation of each route's rounding) and
# chip_smoke.py phase 3c (the kernel on the card).
TOL_REL, TOL_P_REL, TOL_ABS = 2.0 ** -7, 2.0 ** -8, 1e-5
TOL_INT8_ORDER = 2.0 ** -24
TOL_MIXED = 2.0 ** -7
TOL_MIXED_SIGMAS = 6.0


def kernel_route(
    dtype: torch.dtype, span: int, group: int, *, kv_mode: str = 'model',
    block_size: int = WGMMA_BLOCK_SIZE,
) -> str:
    """The route the kernel takes for queries of ``dtype`` with ``span``
    positions per row and GQA ``group`` over a pool of ``kv_mode``
    (:data:`KV_MODES`) in pages of ``block_size``: for bf16, ``'wgmma'``
    for tiles of ``WGMMA_MIN_ROWS``..128 rows over a bf16 pool of 16-token
    pages (prefill and long chunks), ``'split_kv'`` for tiles of 1..15 rows
    (decode rows, and spans of 2-3 at a group of 4) and ``'tensor_cores'``
    for the other tiles of ``_MIN_MMA_ROWS``..``_MAX_TILE_ROWS`` rows (the
    verify window, short chunks, int8 and mixed pools); ``'cuda_cores'``
    for fp32 (and for a group above 64)."""
    if kv_mode not in KV_MODES:
        raise ValueError(f'kv_mode must be one of {tuple(KV_MODES)}, got {kv_mode!r}')
    if (
        dtype == torch.bfloat16 and kv_mode == 'model' and block_size == WGMMA_BLOCK_SIZE
        and _span_tile(span, group, 'wgmma') * group >= WGMMA_MIN_ROWS
    ):
        return 'wgmma'
    rows = _span_tile(span, group) * group
    if dtype == torch.bfloat16 and rows < _MIN_MMA_ROWS:
        return 'split_kv'
    if dtype == torch.bfloat16 and rows <= _MAX_TILE_ROWS:
        return 'tensor_cores'
    return 'cuda_cores'


def split_blocks_per_sm(head_dim: int) -> int:
    """The split-KV grid's blocks per SM at ``head_dim``: a block's four
    rings take about 206 KiB at 256, so one fits an SM there."""
    return 1 if head_dim > 128 else SPLIT_BLOCKS_PER_SM


def split_plan(
    max_keys: int, batch: int, num_kv_heads: int, sms: int, block_size: int = 16,
    head_dim: int = 128,
) -> tuple[int, int]:
    """The split-KV route's ``(num_splits, split_keys)`` for rows of at
    most ``max_keys`` keys (``max_blocks * block_size``), from shapes the
    host knows, never from ``context_lens`` (a launch reads nothing back):

    - ``split_keys`` is a whole number of pages and of 64-key steps (a
      multiple of ``lcm(64, block_size)``) and at least ``SPLIT_MIN_KEYS``
      unless one split covers every key;
    - the splits tile ``[0, max_keys)`` exactly once: ``(num_splits - 1) *
      split_keys < max_keys <= num_splits * split_keys``;
    - ``1 <= num_splits <= ceil(split_blocks_per_sm(head_dim) * sms /
      (batch * num_kv_heads))``: the grid (splits, Nkv, B) fills the card
      as many times over as a block fits an SM when every row is full,
      and no more.
    """
    unit = math.lcm(SPLIT_STEP_KEYS, block_size)
    target = -(-split_blocks_per_sm(head_dim) * sms // (batch * num_kv_heads))
    splits = max(1, min(target, max_keys // SPLIT_MIN_KEYS))
    split_keys = -(-max_keys // splits // unit) * unit  # ceil(ceil(max_keys / splits) / unit)
    return -(-max_keys // split_keys), split_keys


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# The split-KV route's tickets: int32 zeros per device, which every launch
# leaves at zero. Launches on one device share them, so they must run in
# stream order (one stream, or a CUDA graph replayed on it): two launches
# in flight at once on two streams would mix their tickets. Every buffer
# ever made is kept, the newest (largest) last: a captured graph holds the
# address of the buffer it saw, so growing adds a buffer and frees none.
_split_tickets: dict[int, list[torch.Tensor]] = {}


def _tickets(device: torch.device, count: int) -> torch.Tensor:
    """The device's newest tickets, of at least ``count`` entries. They
    must outlive every CUDA graph that captured a launch: they are never
    first allocated inside a capture (the allocation would come from the
    graph's private pool and dangle once the graph is released), so an
    eager launch at the same shapes before the capture makes them, and
    growing them while the stream captures raises; and a buffer that grew
    out of use stays allocated for the graphs that hold it."""
    made = _split_tickets.get(device.index)
    if not made or made[-1].numel() < count:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f'the split-KV tickets must hold {count} entries but would be '
                'allocated inside a CUDA graph capture; launch once at these '
                'shapes before capturing'
            )
        size = max(count, 256, 2 * made[-1].numel() if made else 0)
        made = _split_tickets.setdefault(device.index, [])
        made.append(torch.zeros(size, dtype=torch.int32, device=device))
    return made[-1]


def comparison_tolerance(
    ref: torch.Tensor,  # the plain version's output [B, S, num_heads, head_dim]
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    q_positions: torch.Tensor,
    q_lens: 'torch.Tensor | None' = None,
    sliding_window: 'int | None' = None,
    scale: float | None = None,
    logit_softcap: float | None = None,
    route: str | None = None,
) -> torch.Tensor:
    """The elementwise bound on ``|kernel - plain|`` stated above, for
    these inputs (fp32, ``ref``'s shape; meaningful on valid rows). The
    route defaults to :func:`kernel_route`'s for these inputs; an int8
    pool adds the INT8 term on every route, a full-precision pool of
    another dtype than q the MIXED term. Plain PyTorch: used by the
    checks on the card and the CPU tests, never on the serving path."""
    b, s, num_heads, head_dim = q.shape
    num_kv_heads = _kv_data(k_cache).shape[2]
    quantized = _check_pools(k_cache, v_cache)
    mixed = _mixed(q, kv_storage_dtype(k_cache))
    if route is None:
        route = kernel_route(
            q.dtype, s, num_heads // num_kv_heads,
            kv_mode='int8' if quantized else 'mixed' if mixed else 'model',
            block_size=_kv_data(k_cache).shape[1],
        )
    if route not in ROUTES:
        raise ValueError(f'route must be one of {tuple(ROUTES)}, got {route!r}')
    if ref.dtype == torch.float32:
        tol = torch.full_like(ref, TOL_ABS)
    else:
        tol = TOL_REL * ref.float().abs() + TOL_ABS
    bf16_tiles = route in ('tensor_cores', 'split_kv', 'wgmma') and ref.dtype != torch.float32
    if not (quantized or bf16_tiles or mixed):
        return tol
    scores, v = _scores_and_values(
        q, k_cache, v_cache, block_tables, context_lens, q_positions,
        q_lens, sliding_window, scale, logit_softcap,
    )
    probs = torch.softmax(scores, dim=-1)  # [B, Nkv, G, S, T]
    if bf16_tiles or mixed:
        spread = torch.einsum('bkgst,btkd->bskgd', probs, v.abs()).reshape(ref.shape)
        weight = (TOL_P_REL if bf16_tiles else 0.0) + (TOL_MIXED if mixed else 0.0)
        term = weight * spread
        if mixed:
            rms = torch.einsum('bkgst,btkd->bskgd', probs.square(), v.square()).sqrt()
            term = torch.minimum(term, weight * (
                ref.float().abs() + TOL_MIXED_SIGMAS * rms.reshape(ref.shape)
            ))
        tol = tol + term
    if quantized:
        k = _gather_kv(k_cache, block_tables)
        qg = q.reshape(b, s, num_kv_heads, -1, head_dim).float().abs()
        score_scale = scale if scale is not None else head_dim ** -0.5
        err = torch.einsum('bskgd,btkd->bkgst', qg, k.abs()) * (
            (2 * head_dim + 4) * TOL_INT8_ORDER * score_scale
        )
        weighted = probs * err  # P_j E_j
        term = torch.einsum('bkgst,btkd->bskgd', weighted, v.abs())
        term = term.reshape(ref.shape) + (
            weighted.sum(-1).permute(0, 3, 1, 2)[..., None].reshape(b, s, num_heads, 1)
            * ref.float().abs()
        )
        tol = tol + term
    return tol


# distllm_rpa_launch's return for a route that needs more shared memory
# than the device gives a block: refused, never served by another route.
_ERR_SHARED_MEMORY = -1


def _kernel():
    """The kernel's C entry point, with its ctypes signature declared."""
    lib = _build.load('ragged_paged_attention')
    fn = lib.distllm_rpa_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = (
            [ptr] * 10 + [i32] * 9
            + [f32, f32, i32, i32, i32, ptr, ptr, i32, i32, i32, ptr]
        )
        fn.restype = ctypes.c_int
        lib.distllm_rpa_error_string.argtypes = [ctypes.c_int]
        lib.distllm_rpa_error_string.restype = ctypes.c_char_p
    return lib, fn


def _span_tile(span: int, group: int, route: str = 'tensor_cores') -> int:
    """Query-span positions one thread block holds: up to
    ``_MAX_TILE_ROWS`` rows after GQA flattening (128 on the wgmma
    route)."""
    rows = _WGMMA_TILE_ROWS if route == 'wgmma' else _MAX_TILE_ROWS
    return max(1, min(span, rows // group))


def ragged_paged_attention_cuda(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    q_positions: torch.Tensor,
    q_lens: 'torch.Tensor | None' = None,
    sliding_window: 'int | None' = None,
    scale: float | None = None,
    logit_softcap: float | None = None,
    route: str | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (builds it at first use).

    Same contract as :func:`ragged_paged_attention_reference` for valid
    queries, plus the kernel's: each row's ``q_positions`` are consecutive
    (only ``q_positions[:, 0]`` is read) and pad queries come out as exact
    zeros. The route is :func:`kernel_route`'s unless ``route`` names one
    (the A/B of the routes on the card); a route that cannot take the
    launch or fails to launch raises, it never gives way to another. Raises on anything the
    kernel does not take: a device other than CUDA, a query dtype other
    than fp32/bf16, a pool other than fp32, bf16 or int8 ``QuantizedKV``
    (or K and V pools of two dtypes), one pool quantized and the other
    not, scales that are not fp32 ``[nb,
    Nkv]``, a head dim other than 64/128/256, a non-contiguous pool or
    scale, a tensor sliding window, or a configuration whose route needs
    more shared memory than the device gives a block.
    """
    quantized = _check_pools(k_cache, v_cache)
    k_data, v_data = _kv_data(k_cache), _kv_data(v_cache)
    b, s, num_heads, head_dim = q.shape
    _, block_size, num_kv_heads, kv_dim = k_data.shape
    tensors = (q, k_data, v_data, block_tables, context_lens, q_positions)
    if quantized:
        tensors += (k_cache.scale, v_cache.scale)
    if any(x.device != q.device or x.device.type != 'cuda' for x in tensors):
        raise ValueError('the CUDA kernel needs every tensor on one CUDA device')
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f'kernel dtypes are fp32 and bf16, got {q.dtype}')
    if not quantized and (
        k_data.dtype not in KERNEL_DTYPES or v_data.dtype != k_data.dtype
    ):
        raise TypeError(
            f'the KV pools must be fp32 or bf16 alike (or int8 QuantizedKV), '
            f'got {k_data.dtype} / {v_data.dtype}'
        )
    if head_dim not in KERNEL_HEAD_DIMS or kv_dim != head_dim:
        raise ValueError(
            f'kernel head dims are {KERNEL_HEAD_DIMS}, got q {head_dim} / '
            f'kv {kv_dim}'
        )
    if v_data.shape != k_data.shape or num_heads % num_kv_heads or k_data.dim() != 4:
        raise ValueError('K/V pools differ in shape or heads do not group')
    if not (k_data.is_contiguous() and v_data.is_contiguous()):
        raise ValueError('the KV pool must be contiguous')
    if quantized and not (
        k_cache.scale.is_contiguous() and v_cache.scale.is_contiguous()
    ):
        raise ValueError('the KV scales must be contiguous')
    if isinstance(sliding_window, torch.Tensor):
        raise TypeError('the CUDA kernel takes a static int sliding_window')
    window = 0 if sliding_window is None else int(sliding_window)
    group = num_heads // num_kv_heads
    q = q.contiguous()
    i32 = torch.int32
    bt = block_tables.to(i32).contiguous()
    ctx = context_lens.to(i32).contiguous()
    q_start = q_positions[:, 0].to(i32).contiguous()
    # No q_lens: a null pointer, every row has s queries (no launch here).
    ql = None if q_lens is None else q_lens.to(i32).contiguous()
    kv_mode = (
        'int8' if quantized else 'mixed' if k_data.dtype != q.dtype else 'model'
    )
    if route is None:
        route = kernel_route(q.dtype, s, group, kv_mode=kv_mode, block_size=block_size)
    if route not in ROUTES:
        raise ValueError(f'route must be one of {tuple(ROUTES)}, got {route!r}')
    if route == 'wgmma' and any(x.data_ptr() % 16 for x in (q, k_data, v_data)):
        raise ValueError('the wgmma route needs q and the pools on 16-byte boundaries')
    scales = (
        (k_cache.scale.data_ptr(), v_cache.scale.data_ptr()) if quantized
        else (None, None)
    )
    span_tile = _span_tile(s, group, route)
    split = (None, None, 0, 0)  # workspace, tickets, splits, keys a split
    if route == 'split_kv':
        max_keys = bt.shape[1] * block_size
        splits, split_keys = split_plan(
            max_keys, b, num_kv_heads, _sm_count(q.device.index), block_size, head_dim
        )
        workspace = torch.empty(
            b * num_kv_heads * splits * span_tile * group * (head_dim + 2),
            dtype=torch.float32, device=q.device,
        )
        tickets = _tickets(q.device, b * num_kv_heads)
        split = (workspace.data_ptr(), tickets.data_ptr(), splits, split_keys)
    lib, fn = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_data.data_ptr(), v_data.data_ptr(), *scales,
            bt.data_ptr(), ctx.data_ptr(), q_start.data_ptr(),
            None if ql is None else ql.data_ptr(), out.data_ptr(),
            b, s, num_heads, num_kv_heads, head_dim, block_size,
            bt.shape[1], span_tile, window,
            float(scale if scale is not None else head_dim ** -0.5),
            float(logit_softcap or 0.0),
            KERNEL_DTYPES[q.dtype], KV_MODES[kv_mode], ROUTES[route], *split,
            k_data.shape[0], torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err == _ERR_SHARED_MEMORY:
        raise ValueError(
            f'ragged_paged_attention: the {route} route at head dim {head_dim} '
            f'over a {kv_mode} pool ({span_tile * group} query rows, '
            f'{bt.shape[1]} table blocks of {block_size}, {split[2]} splits of '
            f'{split[3]} keys) {lib.distllm_rpa_error_string(err).decode()}'
        )
    if err:
        raise RuntimeError(
            f'ragged_paged_attention kernel launch failed ({route} route, '
            f'{kv_mode} KV): CUDA error {err} '
            f'({lib.distllm_rpa_error_string(err).decode()})'
        )
    ragged_paged_attention.launches += 1
    ragged_paged_attention.launches_by_route[route] += 1
    ragged_paged_attention.launches_by_kv[kv_mode] += 1
    ragged_paged_attention.launches_by_head_dim[head_dim] += 1
    if _op_cost.counting():
        _op_cost.add_attention_launch(_op_cost.AttentionLaunch(
            b, s, num_heads, num_kv_heads, head_dim, q.element_size(),
            k_data.element_size(), bt.shape[1], block_size, quantized, window,
        ))
    return out


def ragged_paged_attention(
    q: torch.Tensor,  # [B, S, num_heads, head_dim] per-row query spans
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    q_positions: torch.Tensor,
    q_lens: 'torch.Tensor | None' = None,
    sliding_window: 'int | torch.Tensor | None' = None,
    scale: float | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """THE serving attention callsite (the JAX signature, minus
    ``backend``: the tensors' device selects the implementation).

    CPU tensors go to :func:`ragged_paged_attention_reference`; CUDA
    tensors launch the kernel (:func:`ragged_paged_attention_cuda`) or
    raise — a CUDA tensor never reaches the plain version here. Any other
    device raises. ``ragged_paged_attention.launches`` counts kernel
    launches, ``ragged_paged_attention.launches_by_route`` counts them per
    route (``'tensor_cores'`` / ``'split_kv'`` / ``'cuda_cores'``) and
    ``ragged_paged_attention.launches_by_kv`` per KV mode (``'model'``: a
    pool in q's dtype; ``'int8'``: a :class:`QuantizedKV` pool;
    ``'mixed'``: a full-precision pool of the other dtype), and
    ``ragged_paged_attention.launches_by_head_dim`` per head dim.
    """
    args = (q, k_cache, v_cache, block_tables, context_lens, q_positions)
    kwargs = {
        'q_lens': q_lens, 'sliding_window': sliding_window, 'scale': scale,
        'logit_softcap': logit_softcap,
    }
    if q.device.type == 'cuda':
        return ragged_paged_attention_cuda(*args, **kwargs)
    if q.device.type == 'cpu':
        return ragged_paged_attention_reference(*args, **kwargs)
    raise ValueError(f'ragged_paged_attention: unsupported device {q.device}')


ragged_paged_attention.launches = 0
ragged_paged_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
ragged_paged_attention.launches_by_kv = dict.fromkeys(KV_MODES, 0)
ragged_paged_attention.launches_by_head_dim = dict.fromkeys(KERNEL_HEAD_DIMS, 0)

# Every launch counter of this module, as (function, attribute): what a
# CUDA graph that captured launches adds back on each replay
# (``generate.engine.decode_graph``).
COUNTERS = (
    (ragged_paged_attention, 'launches'),
    (ragged_paged_attention, 'launches_by_route'),
    (ragged_paged_attention, 'launches_by_kv'),
    (ragged_paged_attention_reference, 'launches'),
    (ragged_paged_attention, 'launches_by_head_dim'),
)


def write_token_kv(
    k_cache,
    v_cache,
    new_k: torch.Tensor,  # [B, num_kv_heads, head_dim]
    new_v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks]
    positions: torch.Tensor,  # [B] token index being written
):
    """Scatter one new token's K/V per sequence into its paged block
    (quantizing at write time for int8 :class:`QuantizedKV` pools).

    Writes the pools IN PLACE (the JAX twin is functional and returns new
    arrays) and returns them for symmetry. Rows whose table points at the
    trash block 0 write there harmlessly.
    """
    block_size = _kv_data(k_cache).shape[1]
    rows = torch.arange(positions.shape[0], device=positions.device)
    pos = positions.long()
    block_ids = block_tables.long()[rows, pos // block_size]
    offsets = pos % block_size
    if _check_pools(k_cache, v_cache):
        for cache, new in ((k_cache, new_k), (v_cache, new_v)):
            _write_token_quantized(cache, new, block_ids, offsets)
        return k_cache, v_cache
    k_cache[block_ids, offsets] = new_k.to(k_cache.dtype)
    v_cache[block_ids, offsets] = new_v.to(v_cache.dtype)
    return k_cache, v_cache


def _write_token_quantized(
    cache: QuantizedKV, new: torch.Tensor, block_ids: torch.Tensor,
    offsets: torch.Tensor,
) -> None:
    """Rescale-on-append (JAX ``_write_token_kv_quantized``), in place.
    Each touched block keeps a running absmax: the new row's per-head
    absmax joins the block's scale, the block's int8 rows are re-expressed
    in the new units, and the row is quantized once at the final scale. A
    row at offset 0 starts a fresh block, whose inherited scale resets to
    0. Dead rows arrive routed to the trash block 0 (duplicate indices
    there land in no fixed order: garbage, but finite)."""
    amax = new.float().abs().amax(-1)  # [B, Nkv]
    scale_before = torch.where(
        (offsets == 0)[:, None], 0.0, cache.scale[block_ids]
    )
    new_scale = torch.maximum(scale_before, _absmax_scale(amax))
    blocks = _rescale_int8_blocks(cache.data[block_ids], scale_before, new_scale)
    cache.data[block_ids] = blocks
    cache.data[block_ids, offsets] = quantize_kv_rows(new, new_scale)
    cache.scale[block_ids] = new_scale


def write_chunk_kv(
    k_cache,
    v_cache,
    new_k: torch.Tensor,  # [B, S, num_kv_heads, head_dim] span K
    new_v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks]
    positions: torch.Tensor,  # [B, S] absolute position per span token
    valid: torch.Tensor,  # [B, S] bool — padding tokens route to trash
):
    """Scatter a batch of ragged spans' K/V into their paged blocks, IN
    PLACE (returns the same pools), quantizing for int8 pools. Invalid
    positions write to the reserved trash block 0, the JAX op's
    pad-safety contract."""
    block_size = _kv_data(k_cache).shape[1]
    pos = positions.long()
    block_ids = torch.where(
        valid,
        torch.take_along_dim(block_tables.long(), pos // block_size, dim=1),
        0,
    )
    offsets = torch.where(valid, pos % block_size, 0)
    if _check_pools(k_cache, v_cache):
        for cache, new in ((k_cache, new_k), (v_cache, new_v)):
            _write_chunk_quantized(
                cache, new, block_tables.long(), pos, valid, block_ids, offsets
            )
        return k_cache, v_cache
    k_cache[block_ids, offsets] = new_k.to(k_cache.dtype)
    v_cache[block_ids, offsets] = new_v.to(v_cache.dtype)
    return k_cache, v_cache


def _write_chunk_quantized(
    cache: QuantizedKV, new: torch.Tensor, block_tables: torch.Tensor,
    positions: torch.Tensor, valid: torch.Tensor, block_ids: torch.Tensor,
    offsets: torch.Tensor,
) -> None:
    """Ragged-span quantize-at-write (JAX ``_write_chunk_kv_quantized``),
    in place. A row's span covers a contiguous run of at most ``S //
    block_size + 1`` blocks (spans are position-consecutive with trailing
    padding). Per touched block: the running absmax of the block's prior
    scale (0 when the span covers the block's offset 0: a fresh block)
    and the span tokens landing in it; the block's int8 rows are rescaled
    once and written back, then the span's tokens are quantized at the
    final per-block scales. Dead rows and dead touched slots go to the
    trash block 0."""
    block_size = cache.data.shape[1]
    b, s = positions.shape
    max_blocks = block_tables.shape[1]
    nt = s // block_size + 1  # most blocks a span can touch
    slots = torch.arange(nt, device=positions.device)
    start_blk = positions[:, 0] // block_size  # [B] first logical block
    touched = start_blk[:, None] + slots[None, :]  # [B, nt]
    last_pos = torch.where(valid, positions, -1).amax(1)  # [B]
    live = (touched <= (last_pos // block_size)[:, None]) & (last_pos[:, None] >= 0)
    phys = torch.where(
        live,
        torch.take_along_dim(block_tables, touched.clamp(0, max_blocks - 1), dim=1),
        0,
    )  # [B, nt] physical touched blocks (dead -> trash)
    fresh = touched * block_size >= positions[:, :1]  # span covers offset 0
    tb = (positions // block_size - start_blk[:, None]).clamp(0, nt - 1)  # [B, S]
    onehot = (tb[:, :, None] == slots[None, None, :]) & valid[:, :, None]
    amax_tok = new.float().abs().amax(-1)  # [B, S, Nkv]
    contrib = torch.where(
        onehot[..., None], amax_tok[:, :, None, :], 0.0
    ).amax(1)  # [B, nt, Nkv] span absmax per touched block
    scale_before = torch.where(fresh[..., None], 0.0, cache.scale[phys])
    new_scale = torch.maximum(scale_before, _absmax_scale(contrib))
    blocks = _rescale_int8_blocks(cache.data[phys], scale_before, new_scale)
    flat_phys = phys.reshape(-1)
    cache.data[flat_phys] = blocks.reshape(-1, *blocks.shape[2:])
    cache.scale[flat_phys] = new_scale.reshape(-1, new_scale.shape[-1])
    scale_tok = torch.take_along_dim(new_scale, tb[:, :, None], dim=1)  # [B, S, Nkv]
    codes = quantize_kv_rows(new, scale_tok)
    cache.data[block_ids.reshape(-1), offsets.reshape(-1)] = codes.reshape(
        b * s, *codes.shape[2:]
    )
