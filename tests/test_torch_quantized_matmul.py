"""The port's int8 matmul (K2's plain version) against the JAX package's.

Activations and weights are made with numpy from a seed; the int8 codes
and scales come from ``distllm_tpu.ops.quantization.quantize_int8`` and
are handed to both sides. The port's plain version (``int8_dense`` on CPU
tensors) is held to the JAX XLA tier (``int8_matmul_xla``) and to the
Pallas kernel in interpret mode (``int8_matmul_pallas(interpret=True)``,
which needs K and N multiples of 128 and M <= 512): in fp32 within
``1e-5`` relative (summation order only), in bf16 within the kernel's
elementwise tolerance (``comparison_tolerance``).

The fault demonstrations emulate each route's order on the CPU — the
CUDA-core route's sequential fp32 sums over K in split-K ranges, and the
tensor-core route's 16-deep atoms added to the fp32 accumulator with the
truncation measured on the card — the splits added in order, the scale on
the fp32 sum, one rounding; and show that the honest emulation stays
within that route's tolerance while three injected faults (one dropped
16-row K slice, the scale of the neighbouring column, one output row
computed from the wrong row of x) exceed it, in bf16 and in fp32; and
that partial sums which cancel only at the end need the tensor-core
route's truncation term.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from distllm_tpu.models import common as jax_common
from distllm_tpu.ops import quantization as jq
from distllm_tpu.ops import quantized_matmul as jqm
from distllm_tpu_torch.models import common
from distllm_tpu_torch.ops import quantization as tq
from distllm_tpu_torch.ops import quantized_matmul as tqm

RTOL_FP32 = 1e-5


def _case(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (0.02 * rng.normal(size=(k, n))).astype(np.float32)
    qt = jq.quantize_int8(w, 'float32')
    return x, np.array(qt.q), np.array(qt.scale)  # writable copies


def _port(x, q, scale, dtype=torch.float32, backend='auto'):
    return tqm.int8_dense(
        torch.from_numpy(x).to(dtype), torch.from_numpy(q), torch.from_numpy(scale),
        backend=backend,
    )


def _within_tolerance(got, want, x, q, scale):
    """``got`` and ``want`` (fp32 arrays) within the bf16 tolerance of
    plain fp32 sums in another order (the CUDA-core route's bound)."""
    tol = tqm.comparison_tolerance(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(q), torch.from_numpy(scale),
        route='cuda_cores',
    ).numpy()
    ratio = np.abs(got - want) / tol
    assert ratio.max() <= 1.0, float(ratio.max())


def _close_fp32(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL_FP32, atol=RTOL_FP32 * np.abs(want).max())


@pytest.mark.parametrize('m,k,n', [(1, 128, 256), (16, 256, 128), (37, 384, 512), (512, 128, 128)])
def test_plain_matches_jax_xla_and_interpret_kernel_fp32(m, k, n):
    x, q, scale = _case(m + k, m, k, n)
    xla = np.asarray(jqm.int8_matmul_xla(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale)))
    kernel = np.asarray(jqm.int8_matmul_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), interpret=True
    ))
    got = _port(x, q, scale).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    _close_fp32(got, xla)
    _close_fp32(got, kernel)


@pytest.mark.parametrize('m,k,n', [(8, 256, 128), (40, 128, 384)])
def test_plain_matches_jax_within_the_bf16_tolerance(m, k, n):
    x, q, scale = _case(m * n, m, k, n)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = _port(x, q, scale, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    for ref in (
        jqm.int8_matmul_xla(xb, jnp.asarray(q), jnp.asarray(scale)),
        jqm.int8_matmul_pallas(xb, jnp.asarray(q), jnp.asarray(scale), interpret=True),
    ):
        assert ref.dtype == jnp.bfloat16
        _within_tolerance(got.float().numpy(), np.asarray(ref, np.float32), x, q, scale)


def test_row_padding_m5_and_leading_dims():
    x, q, scale = _case(5, 5, 128, 128)
    # The TPU kernel pads M = 5 to 16 rows and slices them away.
    kernel = np.asarray(jqm.int8_matmul_pallas(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), interpret=True
    ))
    got = _port(x, q, scale).numpy()
    assert got.shape == (5, 128)
    _close_fp32(got, kernel)
    x3 = np.random.default_rng(6).normal(size=(2, 3, 128)).astype(np.float32)
    lead = _port(x3, q, scale)
    assert lead.shape == (2, 3, 128)
    torch.testing.assert_close(lead.reshape(6, 128), _port(x3.reshape(6, 128), q, scale))
    ref = np.asarray(jqm.int8_dense(jnp.asarray(x3), jnp.asarray(q), jnp.asarray(scale)))
    _close_fp32(lead.numpy(), ref)


def test_the_jax_interpret_tier_refuses_513_rows_the_port_serves_them():
    """The TPU kernel's VMEM accumulator caps M at 512 and ``int8_dense``
    calls it unchecked, so a pinned Pallas tier raises on any product of
    more than 512 rows (a prefill of more than 512 tokens); the port's
    kernel contract has no such cap."""
    x, q, scale = _case(7, 513, 128, 128)
    with pytest.raises(ValueError, match='outside the pallas tile contract'):
        jqm.int8_dense(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), backend='interpret')
    got = _port(x, q, scale).numpy()
    _close_fp32(got, np.asarray(jqm.int8_matmul_xla(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale)
    )))


def test_common_dense_routes_int8_through_int8_dense_with_bias():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    w = (0.02 * rng.normal(size=(64, 96))).astype(np.float32)
    bias = rng.normal(size=(96,)).astype(np.float32)
    jqt = jq.quantize_int8(w, 'float32')
    tqt = tq.quantize_int8(torch.from_numpy(w), 'float32')
    plain = tqm.int8_matmul_reference.launches
    got = common.dense(torch.from_numpy(x), tqt, torch.from_numpy(bias))
    assert tqm.int8_matmul_reference.launches == plain + 1
    want = np.asarray(jax_common.dense(jnp.asarray(x), jqt, jnp.asarray(bias), qmm_backend='xla'))
    _close_fp32(got.numpy(), want)
    # A float kernel stays torch.matmul, never the int8 path.
    common.dense(torch.from_numpy(x), torch.from_numpy(w))
    assert tqm.int8_matmul_reference.launches == plain + 1


@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
def test_common_dense_dequantizes_nf4_like_jax(out_dtype):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    jqt = jq.quantize_nf4(w, 64, out_dtype)
    tqt = tq.quantize_nf4(torch.from_numpy(w), 64, out_dtype)
    plain = tqm.int8_matmul_reference.launches
    got = common.dense(torch.from_numpy(x), tqt)
    assert tqm.int8_matmul_reference.launches == plain
    want = np.asarray(jax_common.dense(jnp.asarray(x), jqt))
    _close_fp32(got.numpy(), want)


def test_unknown_backend_rejected():
    x, q, scale = _case(10, 2, 16, 16)
    with pytest.raises(ValueError, match='unknown quantized-matmul backend'):
        _port(x, q, scale, backend='pallas')


def test_dispatch_cpu_runs_the_plain_version_only():
    x, q, scale = _case(11, 3, 32, 32)
    plain, kernel = tqm.int8_matmul_reference.launches, tqm.int8_matmul.launches
    _port(x, q, scale)
    _port(x, q, scale, backend='reference')
    assert tqm.int8_matmul_reference.launches == plain + 2
    assert tqm.int8_matmul.launches == kernel


def test_non_cpu_tensors_never_reach_the_plain_version():
    plain = tqm.int8_matmul_reference.launches
    x = torch.empty((2, 16), device='meta')
    q = torch.empty((16, 16), dtype=torch.int8, device='meta')
    s = torch.empty((16,), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tqm.int8_matmul(x, q, s)
    cpu = torch.zeros((2, 16))
    with pytest.raises(ValueError, match='CUDA device'):
        tqm.int8_matmul_cuda(cpu, torch.zeros((16, 16), dtype=torch.int8), torch.ones(16))
    assert tqm.int8_matmul_reference.launches == plain


@pytest.mark.parametrize('m', [1, 5, 8, 16, 17, 128, 1040, 147456])
@pytest.mark.parametrize('k,n', [(16, 16), (4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096), (768, 3072), (3072, 768), (48, 32)])
def test_launch_shape_covers_k_exactly_and_fills_the_card(m, k, n):
    """The split-K plan meets the kernel's launch contract: every split
    has work and together they cover K. A small product whose K is deep
    enough for the wanted splits (at least 4 steps of 32 each) gets at
    least 80% of two blocks per SM of an H100: rounding the steps per
    split up loses at most a fifth of the splits when each has 4 or
    more."""
    sms = 132
    block_rows, splits, per_split = tqm.launch_shape(m, k, n, sms, 'cuda_cores')
    assert block_rows == (16 if m <= 16 else 64)
    assert per_split % tqm.BLOCK_K == 0 and 1 <= splits <= tqm.MAX_SPLITS
    assert per_split * splits >= k > per_split * (splits - 1)
    tiles = -(-n // tqm.BLOCK_N) * -(-m // block_rows)
    wanted = -(-2 * sms // tiles)
    if tiles >= 2 * sms:
        assert splits == 1
    elif wanted <= min(-(-k // tqm.BLOCK_K) // 4, tqm.MAX_SPLITS):
        assert tiles * splits >= 0.8 * 2 * sms


# ---------------------------------------------------------------- faults
def _emulated_kernel(x, q, scale, splits=3, drop_rows=None, neighbour_scale=False,
                     row_from=None):
    """K2's arithmetic on the CPU: every split sums its K range in fp32,
    one k at a time (a bf16 x int8 product is exact in fp32, so each step
    is the kernel's fmaf), the splits are added in order, the fp32 scale
    multiplies the sum and the result rounds once. ``drop_rows`` skips a
    K slice; ``neighbour_scale`` applies column n+1's scale to column n;
    ``row_from=(dst, src)`` computes output row dst from x row src."""
    xf, qf = x.float(), q.float()
    s = scale.reshape(-1).float()
    if neighbour_scale:
        s = torch.roll(s, -1)
    if row_from is not None:
        xf = xf.clone()
        xf[row_from[0]] = xf[row_from[1]]
    k = q.shape[0]
    per_split = -(-k // 32 // splits) * 32
    total = None
    for lo in range(0, k, per_split):
        acc = torch.zeros((x.shape[0], q.shape[1]))
        for kk in range(lo, min(k, lo + per_split)):
            if drop_rows is not None and kk in drop_rows:
                continue
            acc = acc + xf[:, kk:kk + 1] * qf[kk:kk + 1, :]
        total = acc if total is None else total + acc
    return (total * s).to(x.dtype)


FAULT_CASES = [
    # (dtype, M, K, N, least factor by which each fault must exceed it)
    (torch.bfloat16, 48, 512, 256, 10.0),
    (torch.float32, 48, 512, 256, 100.0),
    (torch.bfloat16, 8, 4096, 128, 10.0),
    (torch.float32, 4, 14336, 64, 10.0),
]


@pytest.mark.parametrize('dtype,m,k,n,factor', FAULT_CASES)
def test_injected_faults_exceed_the_tolerance(dtype, m, k, n, factor):
    x, q, scale = _case(12, m, k, n)
    tx = torch.from_numpy(x).to(dtype)
    tqq, ts = torch.from_numpy(q), torch.from_numpy(scale)
    ref = tqm.int8_matmul_reference(tx, tqq, ts)
    tol = tqm.comparison_tolerance(tx, tqq, ts, route='cuda_cores')

    def worst(out):
        return float(((out.float() - ref.float()).abs() / tol).max())

    honest = worst(_emulated_kernel(tx, tqq, ts))
    dropped = worst(_emulated_kernel(tx, tqq, ts, drop_rows=range(k // 2, k // 2 + 16)))
    neighbour = worst(_emulated_kernel(tx, tqq, ts, neighbour_scale=True))
    wrong_row = worst(_emulated_kernel(tx, tqq, ts, row_from=(1, 2)))
    assert honest <= 1.0, honest
    assert min(dropped, neighbour, wrong_row) > factor, (dropped, neighbour, wrong_row)


def test_an_all_zero_column_has_a_finite_zero_tolerance():
    x, q, scale = _case(13, 4, 64, 32)
    q[:, 3], scale[0, 3] = 0, 1.0
    tol = tqm.comparison_tolerance(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(q), torch.from_numpy(scale)
    )
    assert (tol[:, 3] == tqm.TOL_ABS).all() and (tol > 0).all()
    assert (_port(x, q, scale, torch.bfloat16)[:, 3] == 0).all()


# ------------------------------------------------------- tensor-core route
MISTRAL_BERT_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                       (768, 768), (768, 3072), (3072, 768)]


@pytest.mark.parametrize('m', [1, 5, 8, 16, 17, 1040, 2048, 147456])
@pytest.mark.parametrize('k,n', MISTRAL_BERT_SHAPES)
def test_kernel_route_and_tensor_core_launch_shape(m, k, n):
    """bf16 takes the tensor cores at every Mistral-7B and BERT-base
    projection shape, fp32 the CUDA cores. The tensor-core plan uses the
    16-row configuration up to 16 rows and 128-row tiles above, its splits
    cover K exactly in whole K steps, and a product whose tiles cannot
    fill an H100 alone is split until it gives at least 80% of the
    configuration's resident blocks on every SM, where K is deep enough."""
    assert tqm.kernel_route(m, k, n, torch.bfloat16) == 'tensor_cores'
    assert tqm.kernel_route(m, k, n, torch.float32) == 'cuda_cores'
    sms = 132
    block_rows, block_n, block_k, per_sm = tqm.tile_config('tensor_cores', m)
    assert (block_rows, block_n, block_k, per_sm) == (
        tqm.TC_SMALL if m <= tqm.SMALL_M else tqm.TC_LARGE
    )
    rows, splits, per_split = tqm.launch_shape(m, k, n, sms, 'tensor_cores')
    assert rows == block_rows
    assert per_split % block_k == 0 and 1 <= splits <= tqm.MAX_SPLITS
    assert per_split * splits >= k > per_split * (splits - 1)
    tiles = -(-n // block_n) * -(-m // block_rows)
    min_steps = 2 if block_rows == 16 else 4
    if tiles >= per_sm * sms:
        assert splits == 1
    elif -(-per_sm * sms // tiles) <= min(k // block_k // min_steps, tqm.MAX_SPLITS):
        assert tiles * splits >= 0.8 * per_sm * sms


def _toward_zero(v: torch.Tensor) -> torch.Tensor:
    """fp64 ``v`` rounded to fp32 toward zero (as fp64)."""
    f = v.float()
    return torch.where(
        f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f
    ).double()


# Bits kept below fp32's last place when an atom aligns its terms: 2
# reproduces the card's mean error on one-signed data at K = 768, 4096
# and 14336 (scripts/profile_torch_qmm_accumulation.py, PERF.md).
GUARD_BITS = 2


def _atom_add(acc, products):
    """One ``mma`` atom as the card adds it: the fp32 accumulator ``acc``
    [M, N] and the 16 exact products [M, N, 16] are aligned to the largest
    of them, each truncated toward zero to ``GUARD_BITS`` bits below that
    one's last place, summed exactly, and the sum truncated to fp32."""
    terms = torch.cat([acc[..., None], products], -1)
    _, exponent = torch.frexp(terms.abs().amax(-1, keepdim=True))
    grid = torch.pow(2.0, (exponent - 24 - GUARD_BITS).double())
    return _toward_zero((torch.trunc(terms / grid) * grid).sum(-1))


def _emulated_tensor_cores(x, q, scale, drop_rows=None, neighbour_scale=False,
                           row_from=None, sms=132, k_per_split=None):
    """The tensor-core route's arithmetic on the CPU, in its launch plan
    (``launch_shape(..., 'tensor_cores')``, or ``k_per_split``): each
    split walks its K range in 16-deep ``mma`` atoms, each added to the
    fp32 accumulator by :func:`_atom_add`; the splits are added in order
    in fp32, the scale multiplies the sum and the result rounds once. (The
    output-column permutation of the B fragments changes no sum.) Faults
    as in :func:`_emulated_kernel`."""
    xd, qd = x.double(), q.double()
    s = scale.reshape(-1).float()
    if neighbour_scale:
        s = torch.roll(s, -1)
    if row_from is not None:
        xd = xd.clone()
        xd[row_from[0]] = xd[row_from[1]]
    if drop_rows is not None:
        qd = qd.clone()
        qd[list(drop_rows)] = 0.0
    m, k = x.shape
    per_split = k_per_split or tqm.launch_shape(m, k, q.shape[1], sms, 'tensor_cores')[2]
    total = None
    for lo in range(0, k, per_split):
        acc = torch.zeros((m, q.shape[1]), dtype=torch.float64)
        for c in range(lo, min(k, lo + per_split), 16):
            acc = _atom_add(acc, xd[:, None, c:c + 16] * qd[c:c + 16].T[None])
        total = acc.float() if total is None else total + acc.float()
    return (total * s).to(x.dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('m,k,n', [(8, 4096, 128), (40, 768, 256), (512, 128, 128)])
def test_tensor_core_order_matches_jax_within_the_tolerance(dtype, m, k, n):
    """The emulated tensor-core order against JAX's XLA tier and the
    Pallas kernel in interpret mode, within ``comparison_tolerance``."""
    x, q, scale = _case(m + k + n, m, k, n)
    tx = torch.from_numpy(x).to(dtype)
    got = _emulated_tensor_cores(tx, torch.from_numpy(q), torch.from_numpy(scale))
    tol = tqm.comparison_tolerance(tx, torch.from_numpy(q), torch.from_numpy(scale)).numpy()
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(np.asarray(tx.float()), jdtype)
    for ref in (
        jqm.int8_matmul_xla(jx, jnp.asarray(q), jnp.asarray(scale)),
        jqm.int8_matmul_pallas(jx, jnp.asarray(q), jnp.asarray(scale), interpret=True),
    ):
        ratio = np.abs(got.float().numpy() - np.asarray(ref, np.float32)) / tol
        assert ratio.max() <= 1.0, float(ratio.max())


TC_FAULT_CASES = [
    # (dtype, M, K, N, least factor by which each fault must exceed it)
    (torch.bfloat16, 8, 14336, 128, 25.0),
    (torch.bfloat16, 48, 768, 256, 10.0),
    (torch.float32, 8, 14336, 64, 10.0),
    (torch.float32, 48, 4096, 128, 10.0),
]


@pytest.mark.parametrize('dtype,m,k,n,factor', TC_FAULT_CASES)
def test_injected_faults_exceed_the_tensor_core_tolerance(dtype, m, k, n, factor):
    """A dropped 16-deep K slice, the neighbouring column's scale and a
    row computed from the wrong row of x, in the tensor-core order, each
    exceed the tolerance by ``factor``; the honest emulation stays in it."""
    x, q, scale = _case(14, m, k, n)
    tx = torch.from_numpy(x).to(dtype)
    tqq, ts = torch.from_numpy(q), torch.from_numpy(scale)
    ref = tqm.int8_matmul_reference(tx, tqq, ts)
    tol = tqm.comparison_tolerance(tx, tqq, ts)

    def worst(out):
        return float(((out.float() - ref.float()).abs() / tol).max())

    honest = worst(_emulated_tensor_cores(tx, tqq, ts))
    dropped = worst(_emulated_tensor_cores(tx, tqq, ts, drop_rows=range(k // 2, k // 2 + 16)))
    neighbour = worst(_emulated_tensor_cores(tx, tqq, ts, neighbour_scale=True))
    wrong_row = worst(_emulated_tensor_cores(tx, tqq, ts, row_from=(1, 2)))
    assert honest <= 1.0, honest
    assert min(dropped, neighbour, wrong_row) > factor, (dropped, neighbour, wrong_row)


def test_one_signed_data_stays_within_the_tensor_core_tolerance():
    """Every partial sum as large as it can be (|x|, codes >= 0): the
    truncating emulation's bias, linear in the atoms, stays inside the
    tensor-core route's bound (its TRUNC term included), which is the
    default for bf16."""
    x, q, scale = _case(16, 4, 14336, 64)
    tx = torch.from_numpy(np.abs(x)).bfloat16()
    tqq, ts = torch.from_numpy(np.abs(q).astype(np.int8)), torch.from_numpy(scale)
    ref = tqm.int8_matmul_reference(tx, tqq, ts)
    tol = tqm.comparison_tolerance(tx, tqq, ts)
    assert torch.equal(tol, tqm.comparison_tolerance(tx, tqq, ts, route='tensor_cores'))
    got = _emulated_tensor_cores(tx, tqq, ts)
    assert float(((got.float() - ref.float()).abs() / tol).max()) <= 1.0


@pytest.mark.parametrize('k', [4096, 14336])
def test_partial_sums_that_cancel_late_need_the_truncation_term(k):
    """Partial sums that stay near their peak and cancel exactly at the end
    (``chip_smoke.late_cancelling``), in one split as the 128-row tiles
    run when they fill the card: the emulated truncation exceeds the
    bound without the truncation term (the CUDA-core route's), and stays
    within the tensor-core route's."""
    xs, codes = chip_smoke.late_cancelling(np.random.default_rng(5), 2, k, 64)
    tx, tqq = torch.from_numpy(xs).bfloat16(), torch.from_numpy(codes)
    assert torch.equal(tx.float(), torch.from_numpy(xs))
    ts = torch.full((1, 64), 2.0 ** -10)
    ref = tqm.int8_matmul_reference(tx, tqq, ts).float()
    diff = (_emulated_tensor_cores(tx, tqq, ts, k_per_split=k).float() - ref).abs()
    assert float((diff / tqm.comparison_tolerance(tx, tqq, ts)).max()) <= 1.0
    bare = tqm.comparison_tolerance(tx, tqq, ts, route='cuda_cores')
    assert float((diff / bare).max()) > 1.0


def test_comparison_tolerance_per_route():
    """The tensor-core route adds TRUNC * 2**-24 * scale * W to the bound,
    W the sum over 16-deep atoms of the largest |prefix sum| so far; an
    unknown route is refused by the tolerance and the tile plan."""
    x, q, scale = _case(17, 4, 4096, 32)
    tx, tqq, ts = torch.from_numpy(x).bfloat16(), torch.from_numpy(q), torch.from_numpy(scale)
    tc = tqm.comparison_tolerance(tx, tqq, ts, route='tensor_cores')
    cc = tqm.comparison_tolerance(tx, tqq, ts, route='cuda_cores')
    prefix = np.cumsum(np.einsum('mjk,jkn->mjn', tx.double().numpy().reshape(4, 256, 16),
                                 q.astype(np.float64).reshape(256, 16, 32)), axis=1)
    w = np.maximum.accumulate(np.abs(prefix), axis=1).sum(axis=1)
    want = tqm.TRUNC * 2.0 ** -24 * ts.double().numpy() * w
    # The module sums W in fp32 over 256 atoms: about 256 * 2**-24 relative.
    np.testing.assert_allclose((tc - cc).double().numpy(), want, rtol=1e-4)
    with pytest.raises(ValueError, match='route must be one of'):
        tqm.comparison_tolerance(tx, tqq, ts, route='wgmma')
    with pytest.raises(ValueError, match='route must be one of'):
        tqm.tile_config('wgmma', 8)


def test_cpu_dispatch_counts_no_launch_by_route():
    """The CPU dispatch bumps neither count; both counts exist per route."""
    assert set(tqm.int8_matmul.launches_by_route) == set(tqm.ROUTES)
    before = dict(tqm.int8_matmul.launches_by_route)
    x, q, scale = _case(15, 3, 32, 32)
    _port(x, q, scale, torch.bfloat16)
    assert tqm.int8_matmul.launches_by_route == before
