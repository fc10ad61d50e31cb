"""Weight-only int8 matmul — every projection of an int8-quantized forward.

The PyTorch counterpart of ``distllm_tpu.ops.quantized_matmul``:
``(x @ q) * scale`` for activations ``x [M, K]`` (bf16 or fp32), int8
codes ``q [K, N]`` in the JAX ``[in, out]`` layout and a per-output-channel
fp32 ``scale``, summed in fp32 and rounded once to ``x``'s dtype. The
weight stays int8 in device memory; the scale lands on the fp32 sum,
never on the weight.

- :func:`int8_matmul_reference` — the plain PyTorch version, the
  arithmetic of the JAX package's XLA tier (``int8_matmul_xla``):
  ``(x.float() @ q.float()) * scale`` in fp32, one rounding to ``x.dtype``.
- the CUDA kernel ``csrc/int8_matmul.cu`` (K2) — the hand-written Hopper
  port of ``int8_matmul_pallas``: int8 tiles widened in shared memory,
  fp32 register accumulators, split-K for small M. Unlike the TPU kernel
  (M <= 512, K and N multiples of 128) it takes any M >= 1 and K, N that
  are multiples of 16, so one kernel serves prefill, decode and embed.
- :func:`int8_matmul` — the dispatch. A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises. Each keeps an
  integer ``launches`` count.
- :func:`int8_dense` — any leading dims, with an explicit tier:
  ``'auto'`` (the dispatch) or ``'reference'`` (the plain version on any
  device: the card-side identity check). There is no process-global
  default tier; callers pass it, as ``attn_backend`` is passed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from distllm_tpu_torch.ops import _build

QMM_BACKENDS = ('auto', 'reference')
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's tile geometry (csrc/int8_matmul.cu): 128 output columns
# per block, K walked 32 deep, 16 or 64 rows of x per block.
BLOCK_N, BLOCK_K = 128, 32
MAX_SPLITS = 32
# K and N must be multiples of this: one 16-byte load of int8 codes.
VECTOR = 16


def int8_matmul_reference(
    x: torch.Tensor,  # [M, K] float
    q: torch.Tensor,  # [K, N] int8
    scale: torch.Tensor,  # [N] / [1, N] fp32
) -> torch.Tensor:
    """``(x @ q) * scale`` in plain PyTorch: fp32 product of the widened
    operands, the fp32 scale on the product, one rounding to ``x.dtype``."""
    int8_matmul_reference.launches += 1
    y = torch.matmul(x.float(), q.float())
    return (y * scale.reshape(1, -1).float()).to(x.dtype)


int8_matmul_reference.launches = 0

# The kernel against the plain version, elementwise:
#   |out - ref| <= REL * |ref| + ORDER * sqrt(K) * 2**-24 * scale[n] * (|x| @ |q|)[m, n] + ABS
# with REL = 2**-7 in bf16 and 0 in fp32. Both sides form the same exact
# products (bf16 x int8 is exact in fp32) and sum them in fp32 in different
# orders, then multiply by the same scale and round once:
# - one bf16 step: where the two fp32 sums straddle a bf16 rounding point
#   they round one step apart, at most 2**-7 * |ref|;
# - the summation order: each fp32 addition rounds with relative error at
#   most u = 2**-24, on a partial sum no larger than S = sum_k |x q| (the
#   |x| @ |q| term). Round-to-nearest errors are unbiased and independent,
#   so one order's error has a standard deviation of at most
#   u * sqrt(K / 3) * S, two orders' difference at most 0.82 * sqrt(K) * u
#   * S. ORDER = 4 puts the bound near 5 of those standard deviations in
#   the worst case, where every partial sum is as large as S; zero-mean
#   data has partial sums near sqrt(k) times a term, far below it. The
#   rigorous worst case (K * u * S) would be sqrt(K) times looser and let a
#   dropped 16-row K slice pass in fp32 at K = 14336. The term scales with
#   S, not |ref|, because the terms cancel: |ref| can be far smaller.
# ABS (the smallest normal fp32) only keeps an all-zero column (scale 1,
# codes 0: both sides exactly 0) from dividing by zero.
TOL_REL = 2.0 ** -7
ORDER = 4.0
TOL_ABS = torch.finfo(torch.float32).tiny


def comparison_tolerance(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """The elementwise bound on ``|kernel - plain|`` stated above, for
    these inputs, as fp32 ``[M, N]``. Plain PyTorch: used by the checks on
    the card and the CPU tests, never on a serving or embed path."""
    k = q.shape[0]
    s = scale.reshape(1, -1).float()
    ref = (torch.matmul(x.float(), q.float()) * s).to(x.dtype).float()
    magnitude = torch.matmul(x.float().abs(), q.float().abs()) * s
    rel = TOL_REL if x.dtype == torch.bfloat16 else 0.0
    return rel * ref.abs() + ORDER * math.sqrt(k) * 2.0 ** -24 * magnitude + TOL_ABS


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_shape(m: int, k: int, n: int, sms: int) -> tuple[int, int, int]:
    """``(block_rows, splits, k_per_split)`` of one launch: 16 rows of x
    per block for M <= 16, else 64; when the output tiles alone give
    fewer than two blocks per SM, K is split (at least 4 steps of 32 per
    split, at most 32 splits) so the card fills."""
    block_rows = 16 if m <= 16 else 64
    tiles = -(-n // BLOCK_N) * -(-m // block_rows)
    k_steps = -(-k // BLOCK_K)
    splits = 1
    if tiles < 2 * sms:
        splits = max(1, min(-(-2 * sms // tiles), k_steps // 4, MAX_SPLITS))
    per_split = -(-k_steps // splits)
    splits = -(-k_steps // per_split)
    return block_rows, splits, per_split * BLOCK_K


def _kernel():
    """The kernel's C entry point, with its ctypes signature declared."""
    lib = _build.load('int8_matmul')
    fn = lib.distllm_qmm_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        fn.restype = ctypes.c_int
        lib.distllm_qmm_error_string.argtypes = [ctypes.c_int]
        lib.distllm_qmm_error_string.restype = ctypes.c_char_p
    return lib, fn


def int8_matmul_cuda(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """Launch K2 on CUDA tensors (builds it at first use).

    Same contract as :func:`int8_matmul_reference`. Raises on what the
    kernel does not take: a tensor off the CUDA device of ``x``, ``x``
    other than contiguous 2-D fp32/bf16, ``q`` other than contiguous 2-D
    int8, a scale that is not fp32 with N elements, K or N not a multiple
    of 16, M < 1, or a pointer off a 16-byte boundary.
    """
    if any(t.device != x.device or t.device.type != 'cuda' for t in (x, q, scale)):
        raise ValueError('the CUDA kernel needs x, q and scale on one CUDA device')
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f'kernel activation dtypes are fp32 and bf16, got {x.dtype}')
    if q.dtype != torch.int8:
        raise TypeError(f'kernel weights are int8 codes, got {q.dtype}')
    if scale.dtype != torch.float32:
        raise TypeError(f'kernel scales are fp32, got {scale.dtype}')
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(
            f'x must be [M, K] and q [K, N], got {tuple(x.shape)} and {tuple(q.shape)}'
        )
    m, k = x.shape
    n = q.shape[1]
    if scale.numel() != n:
        raise ValueError(f'scale must hold N = {n} values, got {tuple(scale.shape)}')
    if m < 1 or k % VECTOR or n % VECTOR:
        raise ValueError(
            f'kernel shapes are M >= 1 and K, N multiples of {VECTOR}; got '
            f'M={m}, K={k}, N={n}'
        )
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError('x, q and scale must be contiguous')
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError('x and q must start on a 16-byte boundary')
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    block_rows, splits, k_per_split = launch_shape(m, k, n, _sm_count(index))
    if -(-m // block_rows) > 65535:
        raise ValueError(f'M = {m} exceeds the kernel grid ({65535 * block_rows} rows)')
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = (
        torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
        if splits > 1 else None
    )
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            m, k, n, block_rows, splits, k_per_split, KERNEL_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f'int8_matmul kernel launch failed: CUDA error {err} '
            f'({lib.distllm_qmm_error_string(err).decode()})'
        )
    int8_matmul.launches += 1
    return out


def int8_matmul(
    x: torch.Tensor,  # [M, K] float
    q: torch.Tensor,  # [K, N] int8
    scale: torch.Tensor,  # [N] / [1, N] fp32
) -> torch.Tensor:
    """THE int8 product (the JAX ``int8_matmul_pallas`` signature, minus
    ``interpret``: the tensors' device selects the implementation).

    CPU tensors go to :func:`int8_matmul_reference`; CUDA tensors launch
    the kernel (:func:`int8_matmul_cuda`) or raise — a CUDA tensor never
    reaches the plain version here. Any other device raises.
    ``int8_matmul.launches`` counts kernel launches.
    """
    if x.device.type == 'cuda':
        return int8_matmul_cuda(x, q, scale.reshape(-1))
    if x.device.type == 'cpu':
        return int8_matmul_reference(x, q, scale)
    raise ValueError(f'int8_matmul: unsupported device {x.device}')


int8_matmul.launches = 0


def int8_dense(
    x: torch.Tensor,  # [..., K]
    q: torch.Tensor,  # [K, N] int8
    scale: torch.Tensor,  # [1, N] fp32 (a sliced stacked leaf) or [N]
    backend: str = 'auto',
) -> torch.Tensor:
    """``x @ dequant(q, scale)`` for a 2-D int8 weight, any leading dims,
    without ever dequantizing the weight. ``backend='auto'`` takes
    :func:`int8_matmul` (the kernel on CUDA, the plain version on the
    CPU); ``'reference'`` pins the plain version on any device."""
    if backend not in QMM_BACKENDS:
        raise ValueError(
            f'unknown quantized-matmul backend {backend!r}; one of {QMM_BACKENDS}'
        )
    k, n = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if backend == 'reference':
        out = int8_matmul_reference(x2, q, scale)
    else:
        out = int8_matmul(x2, q, scale)
    return out.reshape(*lead, n)
