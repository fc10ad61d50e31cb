"""Encoder attention — the attention site of every embed forward.

The PyTorch counterpart of ``distllm_tpu.ops.encoder_attention``:
bidirectional multi-head attention with the heads packed in the last
dimension, the layout the QKV projections produce::

    q, k, v : [B, S, N * Hd]     mask : [B, S] (nonzero = valid key)
    bias    : optional [S, S] additive fp32 score term shared by every
              row and head (ModernBERT's sliding window)

Invalid keys get a *finite* ``-1e9`` score bias, as in the TPU kernel, so
a fully masked row (a batch-padding row) comes out as a finite uniform
average of V instead of NaN; poolers drop such rows downstream.

- :func:`encoder_attention_reference` — the plain PyTorch version. It
  follows the TPU kernel's ``_kernel`` order: fp32 scores, the normalised
  softmax, ``p`` cast to V's type, then ``p @ v`` accumulated in fp32.
  (The JAX ``encoder_attention_reference`` forms its scores in the input
  type; in fp32 the two agree.)
- the CUDA kernel ``csrc/encoder_attention.cu`` — the hand-written Hopper
  port of the Pallas kernel: flash-style query and key tiles read
  straight from the packed layout, two passes so ``p`` is rounded after
  normalisation exactly where the TPU kernel rounds it. It has three
  routes (:func:`kernel_route`): ``'wgmma'`` for bf16 at head dims 32, 64
  and 128 on long sequences or under a bias (a TMA producer warp, two
  consumer warpgroups of 64 queries, Q·Kᵀ and P·V as ``wgmma``, and the
  key tiles whose every p is exactly 0 skipped), ``'tensor_cores'`` for
  the other bf16 launches at head dims that are a multiple of 16
  (``mma.sync``) and ``'cuda_cores'`` for fp32 and for other head dims
  (fp32 products on the CUDA cores). All round p at the same point, so
  one tolerance holds them all.
- :func:`encoder_attention` — the dispatch. A CPU tensor goes to the
  plain version; a CUDA tensor launches the kernel or raises. Each keeps
  an integer ``launches`` count, and the kernel a ``launches_by_route``
  count per route, so a run can show which one served it.
"""

from __future__ import annotations

import ctypes

import torch

from distllm_tpu_torch.observability import op_cost as _op_cost

from distllm_tpu_torch.ops import _build

NEG_BIG = -1e9
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
ROUTES = {'cuda_cores': 0, 'tensor_cores': 1, 'wgmma': 2}
# Head dims of the wgmma route, and the sequence lengths from which
# kernel_route sends bf16 launches to it: chip_smoke.py times both routes
# at the embed paths' shapes on an H100 (PERF.md). Under an [S, S] bias
# (ModernBERT's local layers) the wgmma route skips the key tiles whose
# every p is 0: it wins at S = 288 and loses at 160. Without one its
# 128-query tiles pad a short batch more than route 1's 64 (S = 288: 384
# rows against 320) and it wins only on long sequences (S = 1024, the
# protein models).
WGMMA_HEAD_DIMS = (32, 64, 128)
WGMMA_MIN_SEQ = 1024
WGMMA_MIN_SEQ_BIAS = 192


def _default_scale(head_dim: int, scale: float | None) -> float:
    return float(head_dim ** -0.5 if scale is None else scale)


def encoder_attention_reference(
    q: torch.Tensor,  # [B, S, N*Hd]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, S] nonzero = valid key
    num_heads: int,
    scale: float | None = None,
    bias: 'torch.Tensor | None' = None,  # [S, S] additive fp32 score term
) -> torch.Tensor:
    """Bidirectional MHA over packed heads, plain PyTorch, in the TPU
    kernel's arithmetic order. Returns ``[B, S, N*Hd]`` in ``q``'s dtype."""
    encoder_attention_reference.launches += 1
    b, s, d = q.shape
    if d % num_heads:
        raise ValueError(f'hidden {d} not divisible by {num_heads} heads')
    hd = d // num_heads

    def heads(x):
        return x.reshape(b, s, num_heads, hd).transpose(1, 2)

    scores = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2))
    key_bias = torch.where(mask != 0, 0.0, NEG_BIG).to(torch.float32)
    key_bias = key_bias[:, None, None, :]
    if bias is not None:
        key_bias = key_bias + bias.to(torch.float32)[None, None]
    scores = scores * _default_scale(hd, scale) + key_bias
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), heads(v).float())
    return out.transpose(1, 2).reshape(b, s, d).to(q.dtype)


encoder_attention_reference.launches = 0

# The kernel against the plain version, elementwise:
#   |out - ref| <= REL * |ref| + REL * p_max * v_max + ABS       (bf16)
#   |out - ref| <= ABS                                           (fp32)
# Both sides form fp32 scores (in different summation orders), the same
# normalised fp32 p, and round out once to bf16: one bf16 step of out,
# at most 2**-7 * |out|. Rounding p to bf16 adds a second case: where the
# two fp32 values of one p_j straddle a bf16 rounding point they round one
# bf16 step of p_j apart (at most 2**-7 * p_j), which moves out[d] by at
# most 2**-7 * p_j * |v_jd| <= 2**-7 * p_max * v_max, with p_max the
# query's largest probability and v_max = max_j |v_jd| of its head. ABS
# covers fp32 summation noise at outputs near zero.
TOL_REL, TOL_ABS = 2.0 ** -7, 1e-5


def comparison_tolerance(
    ref: torch.Tensor,  # the plain version's output [B, S, N*Hd]
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    num_heads: int,
    scale: float | None = None,
    bias: 'torch.Tensor | None' = None,
) -> torch.Tensor:
    """The elementwise bound on ``|kernel - plain|`` stated above, for
    these inputs (fp32 ``[B, S, N*Hd]``). Plain PyTorch: used by the
    checks on the card and the CPU tests, never on the embed path."""
    if ref.dtype == torch.float32:
        return torch.full_like(ref, TOL_ABS)
    b, s, d = q.shape
    hd = d // num_heads

    def heads(x):
        return x.reshape(b, s, num_heads, hd).transpose(1, 2).float()

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2))
    key_bias = torch.where(mask != 0, 0.0, NEG_BIG).to(torch.float32)
    key_bias = key_bias[:, None, None, :]
    if bias is not None:
        key_bias = key_bias + bias.to(torch.float32)[None, None]
    scores = scores * _default_scale(hd, scale) + key_bias
    p_max = torch.softmax(scores, dim=-1).amax(dim=-1)  # [B, N, S]
    del scores
    v_max = heads(v).abs().amax(dim=2)  # [B, N, Hd]
    straddle = (p_max[..., None] * v_max[:, :, None, :]).transpose(1, 2)
    return (
        TOL_REL * ref.float().abs()
        + TOL_REL * straddle.reshape(b, s, d)
        + TOL_ABS
    )


def kernel_route(
    dtype: torch.dtype, head_dim: int, seq: int | None = None, bias: bool = False
) -> str:
    """The route the kernel takes for ``seq`` keys (``None``: any length)
    with or without an ``[S, S]`` ``bias``: ``'wgmma'`` for bf16 at head
    dims 32, 64 and 128 from ``WGMMA_MIN_SEQ`` keys, or from
    ``WGMMA_MIN_SEQ_BIAS`` under a bias; ``'tensor_cores'`` for the other
    bf16 launches at a head dim that is a multiple of 16 (one mma's
    depth); else ``'cuda_cores'``."""
    if (
        dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS and seq is not None
        and seq >= (WGMMA_MIN_SEQ_BIAS if bias else WGMMA_MIN_SEQ)
    ):
        return 'wgmma'
    if dtype == torch.bfloat16 and head_dim % 16 == 0:
        return 'tensor_cores'
    return 'cuda_cores'


def _kernel():
    """The kernel's C entry point, with its ctypes signature declared."""
    lib = _build.load('encoder_attention')
    fn = lib.distllm_ea_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [ptr] * 6 + [i32] * 4 + [f32, i32, i32, ptr]
        fn.restype = ctypes.c_int
        lib.distllm_ea_error_string.argtypes = [ctypes.c_int]
        lib.distllm_ea_error_string.restype = ctypes.c_char_p
    return lib, fn


def encoder_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    num_heads: int,
    scale: float | None = None,
    bias: 'torch.Tensor | None' = None,
    route: str | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (builds it at first use).

    Same contract as :func:`encoder_attention_reference`. The route is
    :func:`kernel_route`'s unless ``route`` names one (the A/B of the
    routes on the card); a route that cannot take the launch or fails to
    launch raises, it never gives way to another. Raises on what the
    kernel does not take: a tensor off the CUDA device of ``q``, a dtype
    other than fp32/bf16 (shared by q, k and v), a head dim that is not a
    multiple of 8 up to 128, or shapes that disagree.
    """
    tensors = (q, k, v, mask) + (() if bias is None else (bias,))
    if any(x.device != q.device or x.device.type != 'cuda' for x in tensors):
        raise ValueError('the CUDA kernel needs every tensor on one CUDA device')
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f'kernel dtypes are fp32 and bf16, got {q.dtype}')
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f'q, k and v must share a dtype, got {q.dtype}/{k.dtype}/{v.dtype}'
        )
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f'q, k, v must be one [B, S, N*Hd] shape, got {tuple(q.shape)} / '
            f'{tuple(k.shape)} / {tuple(v.shape)}'
        )
    b, s, d = q.shape
    if d % num_heads or (d // num_heads) % 8 or d // num_heads > MAX_HEAD_DIM:
        raise ValueError(
            f'kernel head dims are multiples of 8 up to {MAX_HEAD_DIM}, got '
            f'hidden {d} over {num_heads} heads'
        )
    if mask.shape != (b, s):
        raise ValueError(f'mask must be [B, S] = {(b, s)}, got {tuple(mask.shape)}')
    if bias is not None and bias.shape != (s, s):
        raise ValueError(f'bias must be [S, S] = {(s, s)}, got {tuple(bias.shape)}')
    hd = d // num_heads
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError('q, k and v must start on a 16-byte boundary')
    mask_i32 = mask.to(torch.int32).contiguous()
    bias_f32 = None if bias is None else bias.to(torch.float32).contiguous()
    if route is None:
        route = kernel_route(q.dtype, hd, s, bias is not None)
    if route not in ROUTES:
        raise ValueError(f'route must be one of {tuple(ROUTES)}, got {route!r}')
    out = torch.empty_like(q)
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i32.data_ptr(),
            None if bias_f32 is None else bias_f32.data_ptr(), out.data_ptr(),
            b, s, num_heads, hd, _default_scale(hd, scale),
            KERNEL_DTYPES[q.dtype], ROUTES[route],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f'encoder_attention kernel launch failed ({route} route): CUDA '
            f'error {err} ({lib.distllm_ea_error_string(err).decode()})'
        )
    encoder_attention.launches += 1
    encoder_attention.launches_by_route[route] += 1
    if _op_cost.counting():
        # q, k, v read and out written once, the mask and any bias read;
        # 4 * Hd FLOPs per (query, key, head).
        _op_cost.add_kernel_cost(
            4.0 * b * num_heads * s * s * hd,
            4 * b * s * d * q.element_size() + b * s * 4
            + (0 if bias is None else s * s * 4),
        )
    return out


def encoder_attention(
    q: torch.Tensor,  # [B, S, N*Hd]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, S] nonzero = valid key
    num_heads: int,
    scale: float | None = None,
    bias: 'torch.Tensor | None' = None,
) -> torch.Tensor:
    """THE encoder attention callsite (the JAX signature, minus
    ``interpret``: the tensors' device selects the implementation).

    CPU tensors go to :func:`encoder_attention_reference`; CUDA tensors
    launch the kernel (:func:`encoder_attention_cuda`) or raise — a CUDA
    tensor never reaches the plain version here, at any sequence length.
    Any other device raises. ``encoder_attention.launches`` counts kernel
    launches and ``encoder_attention.launches_by_route`` counts them per
    route (``'wgmma'`` / ``'tensor_cores'`` / ``'cuda_cores'``).
    """
    if q.device.type == 'cuda':
        return encoder_attention_cuda(q, k, v, mask, num_heads, scale, bias)
    if q.device.type == 'cpu':
        return encoder_attention_reference(q, k, v, mask, num_heads, scale, bias)
    raise ValueError(f'encoder_attention: unsupported device {q.device}')


encoder_attention.launches = 0
encoder_attention.launches_by_route = dict.fromkeys(ROUTES, 0)

# Every launch counter of this module, as (function, attribute): what a
# CUDA graph that captured launches adds back on each replay
# (``generate.engine.decode_graph``).
COUNTERS = (
    (encoder_attention, 'launches'),
    (encoder_attention, 'launches_by_route'),
    (encoder_attention_reference, 'launches'),
)
