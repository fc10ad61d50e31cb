"""The port's int8 matmul (K2's plain version) against the JAX package's.

Activations and weights are made with numpy from a seed; the int8 codes
and scales come from ``distllm_tpu.ops.quantization.quantize_int8`` and
are handed to both sides. The port's plain version (``int8_dense`` on CPU
tensors) is held to the JAX XLA tier (``int8_matmul_xla``) and to the
Pallas kernel in interpret mode (``int8_matmul_pallas(interpret=True)``,
which needs K and N multiples of 128 and M <= 512): in fp32 within
``1e-5`` relative (summation order only), in bf16 within the kernel's
elementwise tolerance (``comparison_tolerance``).

The fault demonstration emulates the CUDA kernel's order on the CPU —
sequential fp32 sums over K in split-K ranges, the splits added in
order, the scale on the fp32 sum, one rounding — and shows that the
honest emulation stays within the tolerance while three injected faults
(one dropped 16-row K slice, the scale of the neighbouring column, one
output row computed from the wrong row of x) exceed it, in bf16 and in
fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    """``got`` and ``want`` (fp32 arrays) within the bf16 tolerance."""
    tol = tqm.comparison_tolerance(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(q), torch.from_numpy(scale)
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
    block_rows, splits, per_split = tqm.launch_shape(m, k, n, sms)
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
    tol = tqm.comparison_tolerance(tx, tqq, ts)

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
