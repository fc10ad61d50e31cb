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
  in device memory. It has two routes (:func:`kernel_route`):
  ``'tensor_cores'`` for bf16 query tiles of 16 or more rows (span
  positions x GQA group: prefill and chunk spans) — Q·Kᵀ and P·V as bf16
  ``mma.sync`` with fp32 accumulators, p rounded to bf16 before P·V as
  the TPU kernel rounds it — and ``'cuda_cores'`` for fp32 and for bf16
  tiles of fewer rows (decode rows at Mistral's group of 4), fp32
  products on the CUDA cores.
- :func:`ragged_paged_attention` — the dispatch. A tensor on the CPU goes
  to the plain version; a CUDA tensor launches the kernel or raises. It
  keeps an integer ``launches`` count of kernel launches and a
  ``launches_by_route`` count per route, and the plain version keeps its
  own count of calls, so a run can show which one served it.
- :func:`comparison_tolerance` — the elementwise bound that holds the
  kernel to the plain version, per route.

Int8 :class:`QuantizedKV` pools are not on this slice's path (the engine
stores K/V in the model dtype); the kernel's int8 mode is queued and the
ops raise ``NotImplementedError`` on such a pool.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from distllm_tpu_torch.ops import _build

# Query rows (span positions x GQA group) one thread block holds.
_MAX_TILE_ROWS = 64
# The tensor-core route takes bf16 tiles of at least one mma's 16 rows.
_MIN_MMA_ROWS = 16
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {'cuda_cores': 0, 'tensor_cores': 1}


class QuantizedKV(NamedTuple):
    """Int8 paged-KV container (``data`` int8 blocks + per-block, per-KV-head
    fp32 ``scale``), the JAX package's layout. Recognised only to be
    refused: the int8 mode of the kernel waits for a later slice."""

    data: torch.Tensor
    scale: torch.Tensor


def _refuse_quantized(*caches) -> None:
    for cache in caches:
        if isinstance(cache, QuantizedKV) or cache.dtype == torch.int8:
            raise NotImplementedError(
                'int8 (QuantizedKV) paged KV is not ported yet; serve with '
                'a bf16 or fp32 pool'
            )


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
    the weighted sum run in fp32; the result has ``q``'s dtype.
    """
    _refuse_quantized(k_cache, v_cache)
    ragged_paged_attention_reference.launches += 1
    b, s, num_heads, head_dim = q.shape
    scores, v = _scores_and_values(
        q, k_cache, v_cache, block_tables, context_lens, q_positions, q_lens,
        sliding_window, scale, logit_softcap,
    )
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum('bkgst,btkd->bskgd', probs, v)
    return out.reshape(b, s, num_heads, head_dim).to(q.dtype)


def _scores_and_values(
    q, k_cache, v_cache, block_tables, context_lens, q_positions, q_lens,
    sliding_window, scale, logit_softcap,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version's masked fp32 scores ``[B, Nkv, G, S, T]`` (-inf
    where a key is not attended) and its gathered fp32 values
    ``[B, T, Nkv, Hd]``."""
    b, s, num_heads, head_dim = q.shape
    _, block_size, num_kv_heads, _ = k_cache.shape
    max_blocks = block_tables.shape[1]
    group = num_heads // num_kv_heads
    t = max_blocks * block_size
    bt = block_tables.long()
    k = k_cache[bt].reshape(b, t, num_kv_heads, head_dim).float()
    v = v_cache[bt].reshape(b, t, num_kv_heads, head_dim).float()
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


ragged_paged_attention_reference.launches = 0

# The kernel against the plain version on valid rows, elementwise:
#   |out - ref| <= REL * |ref| + ABS                       bf16, cuda_cores
#   |out - ref| <= REL * |ref| + P_REL * (P @ |V|) + ABS   bf16, tensor_cores
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
# noise at outputs near zero. Stated worst ratios: tests/
# test_torch_paged_attention.py (CPU emulation of the route's order) and
# chip_smoke.py phase 3 (the kernel on the card).
TOL_REL, TOL_P_REL, TOL_ABS = 2.0 ** -7, 2.0 ** -8, 1e-5


def kernel_route(dtype: torch.dtype, span: int, group: int) -> str:
    """The route the kernel takes for queries of ``dtype`` with ``span``
    positions per row and GQA ``group``: ``'tensor_cores'`` for bf16 tiles
    of ``_MIN_MMA_ROWS``..``_MAX_TILE_ROWS`` rows, else ``'cuda_cores'``
    (fp32, and bf16 decode rows whose group gives fewer than 16 rows)."""
    rows = _span_tile(span, group) * group
    if dtype == torch.bfloat16 and _MIN_MMA_ROWS <= rows <= _MAX_TILE_ROWS:
        return 'tensor_cores'
    return 'cuda_cores'


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
    route defaults to :func:`kernel_route`'s for these inputs. Plain
    PyTorch: used by the checks on the card and the CPU tests, never on
    the serving path."""
    if route is None:
        route = kernel_route(q.dtype, q.shape[1], q.shape[2] // k_cache.shape[2])
    if route not in ROUTES:
        raise ValueError(f'route must be one of {tuple(ROUTES)}, got {route!r}')
    if ref.dtype == torch.float32:
        return torch.full_like(ref, TOL_ABS)
    tol = TOL_REL * ref.float().abs() + TOL_ABS
    if route == 'tensor_cores':
        scores, v = _scores_and_values(
            q, k_cache, v_cache, block_tables, context_lens, q_positions,
            q_lens, sliding_window, scale, logit_softcap,
        )
        probs = torch.softmax(scores, dim=-1)
        spread = torch.einsum('bkgst,btkd->bskgd', probs, v.abs())
        tol = tol + TOL_P_REL * spread.reshape(ref.shape)
    return tol


def _kernel():
    """The kernel's C entry point, with its ctypes signature declared."""
    lib = _build.load('ragged_paged_attention')
    fn = lib.distllm_rpa_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr] * 8 + [i32] * 9 + [f32, f32, i32, i32, ptr]
        fn.restype = ctypes.c_int
        lib.distllm_rpa_error_string.argtypes = [ctypes.c_int]
        lib.distllm_rpa_error_string.restype = ctypes.c_char_p
    return lib, fn


def _span_tile(span: int, group: int) -> int:
    """Query-span positions one thread block holds: up to
    ``_MAX_TILE_ROWS`` rows after GQA flattening."""
    return max(1, min(span, _MAX_TILE_ROWS // group))


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
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (builds it at first use).

    Same contract as :func:`ragged_paged_attention_reference` for valid
    queries, plus the kernel's: each row's ``q_positions`` are consecutive
    (only ``q_positions[:, 0]`` is read) and pad queries come out as exact
    zeros. The route is :func:`kernel_route`'s; a route that fails to
    launch raises, it never gives way to the other. Raises on anything the
    kernel does not take: a device other
    than CUDA, a dtype other than fp32/bf16 (shared by q and the pool),
    a head dim other than 64/128, a non-contiguous pool, or a tensor
    sliding window.
    """
    _refuse_quantized(k_cache, v_cache)
    b, s, num_heads, head_dim = q.shape
    _, block_size, num_kv_heads, kv_dim = k_cache.shape
    tensors = (q, k_cache, v_cache, block_tables, context_lens, q_positions)
    if any(x.device != q.device or x.device.type != 'cuda' for x in tensors):
        raise ValueError('the CUDA kernel needs every tensor on one CUDA device')
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f'kernel dtypes are fp32 and bf16, got {q.dtype}')
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f'q ({q.dtype}) and the KV pool ({k_cache.dtype}) must share a dtype'
        )
    if head_dim not in KERNEL_HEAD_DIMS or kv_dim != head_dim:
        raise ValueError(
            f'kernel head dims are {KERNEL_HEAD_DIMS}, got q {head_dim} / '
            f'kv {kv_dim}'
        )
    if v_cache.shape != k_cache.shape or num_heads % num_kv_heads:
        raise ValueError('K/V pools differ in shape or heads do not group')
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError('the KV pool must be contiguous')
    if isinstance(sliding_window, torch.Tensor):
        raise TypeError('the CUDA kernel takes a static int sliding_window')
    window = 0 if sliding_window is None else int(sliding_window)
    group = num_heads // num_kv_heads
    q = q.contiguous()
    i32 = torch.int32
    bt = block_tables.to(i32).contiguous()
    ctx = context_lens.to(i32).contiguous()
    q_start = q_positions[:, 0].to(i32).contiguous()
    if q_lens is None:
        ql = torch.full((b,), s, dtype=i32, device=q.device)
    else:
        ql = q_lens.to(i32).contiguous()
    route = kernel_route(q.dtype, s, group)
    out = torch.empty_like(q)
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            bt.data_ptr(), ctx.data_ptr(), q_start.data_ptr(), ql.data_ptr(),
            out.data_ptr(),
            b, s, num_heads, num_kv_heads, head_dim, block_size,
            bt.shape[1], _span_tile(s, group), window,
            float(scale if scale is not None else head_dim ** -0.5),
            float(logit_softcap or 0.0),
            KERNEL_DTYPES[q.dtype], ROUTES[route],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f'ragged_paged_attention kernel launch failed ({route} route): '
            f'CUDA error {err} ({lib.distllm_rpa_error_string(err).decode()})'
        )
    ragged_paged_attention.launches += 1
    ragged_paged_attention.launches_by_route[route] += 1
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
    launches and ``ragged_paged_attention.launches_by_route`` counts them
    per route (``'tensor_cores'`` / ``'cuda_cores'``).
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


def write_token_kv(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    new_k: torch.Tensor,  # [B, num_kv_heads, head_dim]
    new_v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks]
    positions: torch.Tensor,  # [B] token index being written
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter one new token's K/V per sequence into its paged block.

    Writes the pools IN PLACE (the JAX twin is functional and returns new
    arrays) and returns them for symmetry. Rows whose table points at the
    trash block 0 write there harmlessly.
    """
    _refuse_quantized(k_cache, v_cache)
    block_size = k_cache.shape[1]
    rows = torch.arange(positions.shape[0], device=positions.device)
    pos = positions.long()
    block_ids = block_tables.long()[rows, pos // block_size]
    offsets = pos % block_size
    k_cache[block_ids, offsets] = new_k.to(k_cache.dtype)
    v_cache[block_ids, offsets] = new_v.to(v_cache.dtype)
    return k_cache, v_cache


def write_chunk_kv(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    new_k: torch.Tensor,  # [B, S, num_kv_heads, head_dim] span K
    new_v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks]
    positions: torch.Tensor,  # [B, S] absolute position per span token
    valid: torch.Tensor,  # [B, S] bool — padding tokens route to trash
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter a batch of ragged spans' K/V into their paged blocks, IN
    PLACE (returns the same pools). Invalid positions write to the
    reserved trash block 0, the JAX op's pad-safety contract."""
    _refuse_quantized(k_cache, v_cache)
    block_size = k_cache.shape[1]
    pos = positions.long()
    block_ids = torch.where(
        valid,
        torch.take_along_dim(block_tables.long(), pos // block_size, dim=1),
        0,
    )
    offsets = torch.where(valid, pos % block_size, 0)
    k_cache[block_ids, offsets] = new_k.to(k_cache.dtype)
    v_cache[block_ids, offsets] = new_v.to(v_cache.dtype)
    return k_cache, v_cache
