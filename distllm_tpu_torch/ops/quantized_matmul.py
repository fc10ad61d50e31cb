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
  port of ``int8_matmul_pallas``. Unlike the TPU kernel (M <= 512, K and N
  multiples of 128) it takes any M >= 1 and K, N that are multiples of 16,
  so one kernel serves prefill, decode and embed. It has two routes
  (:func:`kernel_route`): ``'tensor_cores'`` for bf16 activations (the
  codes widened to bf16 exactly in registers, fp32 accumulators; at
  decode, M <= 16, ``mma.sync`` 16-row tiles that stream the weight; at
  prefill and embed ``wgmma`` 128 x 128 tiles) and ``'cuda_cores'`` for
  fp32 (int8 tiles widened to fp32 in shared memory, fmaf). Both split K
  when the output tiles alone cannot fill the card.
- :func:`int8_matmul` — the dispatch. A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel or raises. Each keeps an
  integer ``launches`` count, and the kernel a ``launches_by_route``
  dict.
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

from distllm_tpu_torch.observability import op_cost as _op_cost

from distllm_tpu_torch.ops import _build

QMM_BACKENDS = ('auto', 'reference')
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {'cuda_cores': 0, 'tensor_cores': 1}
# The CUDA-core route's tile geometry: 128 output columns per block, K
# walked 32 deep, 16 or 64 rows of x per block.
BLOCK_N, BLOCK_K = 128, 32
# The tensor-core route's two configurations, (rows, columns, depth of a K
# step, blocks per SM the split-K plan aims for): 16-row tiles that stream
# the weight for M <= SMALL_M, 128 x 128 tiles above. The split targets
# are the fastest of a sweep on an H100 (scripts/profile_torch_qmm_splits.py,
# PERF.md): about two blocks per SM at decode, one at prefill.
TC_SMALL, TC_LARGE = (16, 128, 64, 2), (128, 128, 64, 1)
SMALL_M = TC_SMALL[0]
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
#   |out - ref| <= REL * |ref| + ORDER * sqrt(K) * 2**-24 * scale[n] * (|x| @ |q|)[m, n]
#                  + TRUNC * 2**-24 * scale[n] * W[m, n] + ABS
# with REL = 2**-7 in bf16 and 0 in fp32, and TRUNC = 10 on the
# tensor-core route and 0 on the CUDA-core route. Both sides form the same
# exact products (bf16 x int8 is exact in fp32) and sum them in fp32 in
# different orders, then multiply by the same scale and round once:
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
# - the tensor cores' accumulation (TRUNC): PTX does not state how mma adds
#   a 16-deep atom of products into the fp32 accumulator, so it was
#   measured (scripts/profile_torch_qmm_accumulation.py; H100 80GB HBM3,
#   700 W; PERF.md): the route's raw fp32 sums of one split against fp64.
#   The errors are biased toward zero and grow with the accumulator, not
#   with S: an atom aligns its 16 products and the accumulator to the
#   largest of them, keeps 2 bits below fp32's last place and truncates,
#   then truncates the sum to fp32 (tests/test_torch_quantized_matmul.py
#   emulates this; it reproduces the card's mean error on one-signed data
#   within 4% at K = 768, 4096 and 14336). On average that loses 16
#   halves of a quarter unit in the last place plus half a unit, 2.5 ulp
#   per atom, and an ulp is at most 2u times the accumulator: 5u * |acc|
#   per atom. Cancelling data keeps the
#   accumulator near sqrt(k) terms and the error inside ORDER (worst 0.14
#   units of sqrt(K) * u * S at K = 14336); data whose partial sums stay
#   large and cancel only at the end (ref = 0, so REL gives nothing) reach
#   14.4 units, which no multiple of sqrt(K) * u * S that keeps the faults
#   below in view covers. So the term follows the partial sums: W = sum
#   over the 16-deep atoms j of R_j, the largest |x[:, :16i] @ q[:16i]| for
#   i <= j. A split's accumulator after atom j is the difference of two
#   such prefix sums, so |acc| <= 2 R_j whatever the split plan, and TRUNC
#   = 2 * 5 = 10. On the card the worst error was 4.2 u * W (partial sums
#   that cancel at the end, one split), within the 10. For zero-mean data
#   W grows as K**1.5, as sqrt(K) * S does, so the term adds about a fifth
#   to ORDER's (at most a half) at every K, and a dropped 16-deep K slice
#   at K = 14336 stays more than 25x above the bound in bf16 (CPU tests).
# ABS (the smallest normal fp32) only keeps an all-zero column (scale 1,
# codes 0: both sides exactly 0) from dividing by zero.
TOL_REL = 2.0 ** -7
ORDER = 4.0
TRUNC = 10.0
ATOM = 16  # K depth of one mma atom
TOL_ABS = torch.finfo(torch.float32).tiny


def partial_sum_magnitude(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``W [M, N]``: the sum over the 16-deep K atoms ``j`` of the largest
    ``|x[:, :16 i] @ q[:16 i]|`` for ``i <= j`` (fp32, on ``x``'s device),
    the accumulator magnitude of :data:`TRUNC`'s term."""
    xf, qf = x.float(), q.float()
    prefix = torch.zeros((x.shape[0], q.shape[1]), dtype=torch.float32, device=x.device)
    largest = torch.zeros_like(prefix)
    total = torch.zeros_like(prefix)
    for lo in range(0, x.shape[1], ATOM):
        prefix.addmm_(xf[:, lo:lo + ATOM], qf[lo:lo + ATOM])
        torch.maximum(largest, prefix.abs(), out=largest)
        total.add_(largest)
    return total


def comparison_tolerance(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, route: str | None = None
) -> torch.Tensor:
    """The elementwise bound on ``|kernel - plain|`` stated above, for
    these inputs, as fp32 ``[M, N]``, on ``route`` (by default
    :func:`kernel_route`'s for these inputs). Plain PyTorch: used by the
    checks on the card and the CPU tests, never on a serving or embed
    path."""
    m, k = x.shape
    if route is None:
        route = kernel_route(m, k, q.shape[1], x.dtype)
    if route not in ROUTES:
        raise ValueError(f'route must be one of {tuple(ROUTES)}, got {route!r}')
    s = scale.reshape(1, -1).float()
    ref = (torch.matmul(x.float(), q.float()) * s).to(x.dtype).float()
    magnitude = ORDER * math.sqrt(k) * torch.matmul(x.float().abs(), q.float().abs())
    if route == 'tensor_cores':
        magnitude += TRUNC * partial_sum_magnitude(x, q)
    rel = TOL_REL if x.dtype == torch.bfloat16 else 0.0
    return rel * ref.abs() + 2.0 ** -24 * s * magnitude + TOL_ABS


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_route(m: int, k: int, n: int, dtype: torch.dtype) -> str:
    """The route the kernel takes for ``x [m, k]`` of ``dtype`` against
    ``q [k, n]``: ``'tensor_cores'`` for bf16 at every shape, else
    ``'cuda_cores'`` (fp32: a bf16 tensor core would round x)."""
    del m, k, n  # one route per dtype: no bf16 shape is left on the CUDA cores
    return 'tensor_cores' if dtype == torch.bfloat16 else 'cuda_cores'


def tile_config(route: str, m: int) -> tuple[int, int, int, int]:
    """``(block_rows, block_n, block_k, blocks_per_sm)`` of ``route`` for
    ``m`` rows: the tile a block owns, the depth of one K step and the
    blocks per SM that the split-K plan aims for."""
    if route == 'tensor_cores':
        return TC_SMALL if m <= SMALL_M else TC_LARGE
    if route == 'cuda_cores':
        return (16 if m <= 16 else 64), BLOCK_N, BLOCK_K, 2
    raise ValueError(f'route must be one of {tuple(ROUTES)}, got {route!r}')


def launch_shape(m: int, k: int, n: int, sms: int, route: str) -> tuple[int, int, int]:
    """``(block_rows, splits, k_per_split)`` of one launch on ``route``:
    the rows of :func:`tile_config`; when the output tiles alone give fewer
    than ``blocks_per_sm`` blocks per SM, K is split (the 16-row tiles keep
    at least 2 K steps per split, the other tiles at least 4; at most 32
    splits) so the card fills."""
    block_rows, block_n, block_k, per_sm = tile_config(route, m)
    min_steps = 2 if (route, block_rows) == ('tensor_cores', TC_SMALL[0]) else 4
    tiles = -(-n // block_n) * -(-m // block_rows)
    k_steps = -(-k // block_k)
    splits = 1
    if tiles < per_sm * sms:
        splits = max(1, min(-(-per_sm * sms // tiles), k_steps // min_steps, MAX_SPLITS))
    per_split = -(-k_steps // splits)
    splits = -(-k_steps // per_split)
    return block_rows, splits, per_split * block_k


def _kernel():
    """The kernel's C entry point, with its ctypes signature declared."""
    lib = _build.load('int8_matmul')
    fn = lib.distllm_qmm_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
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
    route = kernel_route(m, k, n, x.dtype)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    block_rows, splits, k_per_split = launch_shape(m, k, n, _sm_count(index), route)
    if route == 'cuda_cores' and -(-m // block_rows) > 65535:
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
            ROUTES[route], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f'int8_matmul kernel launch failed ({route} route): CUDA error {err} '
            f'({lib.distllm_qmm_error_string(err).decode()})'
        )
    int8_matmul.launches += 1
    int8_matmul.launches_by_route[route] += 1
    if _op_cost.counting():
        # x read, codes and scales read, out written once; 2 FLOPs a MAC.
        _op_cost.add_kernel_cost(
            2.0 * m * k * n,
            (m * k + m * n) * x.element_size() + k * n + n * 4,
        )
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
    ``int8_matmul.launches`` counts kernel launches and
    ``int8_matmul.launches_by_route`` counts them per
    :func:`kernel_route`.
    """
    if x.device.type == 'cuda':
        return int8_matmul_cuda(x, q, scale.reshape(-1))
    if x.device.type == 'cpu':
        return int8_matmul_reference(x, q, scale)
    raise ValueError(f'int8_matmul: unsupported device {x.device}')


int8_matmul.launches = 0
int8_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)

# Every launch counter of this module, as (function, attribute): what a
# CUDA graph that captured launches adds back on each replay
# (``generate.engine.decode_graph``).
COUNTERS = (
    (int8_matmul, 'launches'),
    (int8_matmul, 'launches_by_route'),
    (int8_matmul_reference, 'launches'),
)


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
