"""The port's encoder attention (K3) against the JAX package's.

Inputs are made with numpy from a seed and handed to both sides. The
port's plain version (``encoder_attention`` on CPU tensors) is held to the
JAX Pallas kernel in interpret mode and to the JAX
``encoder_attention_reference`` in fp32 with ``atol 2e-5``, the JAX
package's own tolerance (``tests/test_encoder_attention.py``): full and
partial key masks, fully masked batch rows (finite, and equal to the JAX
kernel's uniform average), the ``[S, S]`` window bias, S = 16 / 48 / 37,
3 / 4 / 12 heads. A bf16 case is held to the interpret kernel with the
kernel's elementwise bf16 tolerance (``comparison_tolerance``).

The fault demonstration emulates the CUDA kernel's arithmetic on the CPU
(fp32 scores in another summation order, online max/sum over key tiles of
64, the normalised p rounded to bf16, fp32 p @ V) and shows that the
honest emulation stays within the bf16 tolerance while two injected
faults — one valid key dropped, head slices off by one column — exceed
it many times over.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.ops import encoder_attention as jea
from distllm_tpu_torch.ops import encoder_attention as tea

ATOL = 2e-5


def _inputs(seed, b, s, d, lens=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, d)).astype(np.float32) for _ in range(3))
    lens = [s] * b if lens is None else lens
    mask = (np.arange(s)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    return q, k, v, mask


def _window(s, width=8):
    dist = np.abs(np.arange(s)[:, None] - np.arange(s)[None, :])
    return np.where(dist <= width, 0.0, -1e9).astype(np.float32)


def _port(q, k, v, mask, heads, bias=None, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    b = None if bias is None else torch.from_numpy(bias)
    return tea.encoder_attention(*t, torch.from_numpy(mask), heads, bias=b)


CASES = [
    # (s, heads, head_dim, row lengths (0 = a fully masked batch row),
    #  with the [S, S] window bias)
    (16, 3, 16, None, False),
    (48, 4, 16, [48, 30], False),
    (37, 12, 8, [37, 1, 0], False),
    (16, 4, 32, [0, 0], False),
    (48, 3, 16, [48, 20], True),
    (37, 12, 8, [37, 5, 0], True),
]


@pytest.mark.parametrize('s,heads,hd,lens,with_bias', CASES)
def test_plain_matches_jax_kernel_and_reference(s, heads, hd, lens, with_bias):
    b = 2 if lens is None else len(lens)
    q, k, v, mask = _inputs(s + heads, b, s, heads * hd, lens)
    bias = _window(s) if with_bias else None
    jargs = [jnp.asarray(x) for x in (q, k, v, mask)]
    jbias = None if bias is None else jnp.asarray(bias)
    kernel = np.asarray(jea.encoder_attention(
        *jargs, num_heads=heads, bias=jbias, interpret=True
    ))
    reference = np.asarray(jea.encoder_attention_reference(
        *jargs, num_heads=heads, bias=jbias
    ))
    got = _port(q, k, v, mask, heads, bias).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, kernel, atol=ATOL)
    np.testing.assert_allclose(got, reference, atol=ATOL)


def test_fully_masked_rows_are_the_uniform_average_of_v():
    q, k, v, mask = _inputs(5, 2, 37, 24, [0, 0])
    got = _port(q, k, v, mask, 3).numpy()
    np.testing.assert_allclose(
        got, np.broadcast_to(v.mean(axis=1, keepdims=True), got.shape), atol=ATOL
    )


def test_zero_bias_equals_no_bias():
    q, k, v, mask = _inputs(6, 2, 48, 48, [48, 30])
    zero = _port(q, k, v, mask, 3, np.zeros((48, 48), np.float32))
    assert torch.equal(zero, _port(q, k, v, mask, 3))


def test_bf16_within_the_kernel_tolerance_of_the_jax_kernel():
    q, k, v, mask = _inputs(7, 3, 64, 96, [64, 40, 0])
    to_bf16 = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    kernel = jea.encoder_attention(
        to_bf16(q), to_bf16(k), to_bf16(v), jnp.asarray(mask), num_heads=12,
        interpret=True,
    )
    assert kernel.dtype == jnp.bfloat16
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    tmask = torch.from_numpy(mask)
    got = tea.encoder_attention(tq, tk, tv, tmask, 12)
    assert got.dtype == torch.bfloat16
    tol = tea.comparison_tolerance(got, tq, tk, tv, tmask, 12).numpy()
    err = np.abs(got.float().numpy() - np.asarray(kernel, np.float32))
    assert (err <= tol).all(), float((err / tol).max())


def _emulated_kernel(q, k, v, mask, heads, drop_key=None, head_shift=0):
    """The CUDA kernel's arithmetic on the CPU: scores formed in fp64 and
    rounded to fp32 (another summation order than the plain version's),
    max and sum online over key tiles of 64, the normalised p rounded to
    v's type, p @ V accumulated exactly and rounded once. ``drop_key``
    (row, key) excludes one valid key; ``head_shift`` cuts every head's
    slice one column off."""
    b, s, d = q.shape
    hd = d // heads

    def split(x):
        x = x.float()
        if head_shift:
            x = torch.roll(x, -head_shift, dims=-1)
        return x.reshape(b, s, heads, hd).transpose(1, 2)

    scores = (split(q).double() @ split(k).double().transpose(-1, -2)).float()
    key_bias = torch.where(mask != 0, 0.0, tea.NEG_BIG).float()[:, None, None, :]
    if drop_key is not None:
        key_bias = key_bias.clone()
        key_bias[drop_key[0], ..., drop_key[1]] = float('-inf')
    scores = scores * hd ** -0.5 + key_bias
    m = torch.full(scores.shape[:-1] + (1,), float('-inf'))
    total = torch.zeros_like(m)
    for t0 in range(0, s, 64):
        tile = scores[..., t0:t0 + 64]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        total = total * torch.exp(m - m_new) + torch.exp(tile - m_new).sum(-1, keepdim=True)
        m = m_new
    p = (torch.exp(scores - m) / total).to(v.dtype).float()
    out = (p.double() @ split(v).double()).float()
    return out.transpose(1, 2).reshape(b, s, d).to(q.dtype)


@pytest.mark.parametrize('b,s,lens', [(4, 160, [160, 100, 7, 0]), (16, 16, None)])
def test_injected_faults_exceed_the_bf16_tolerance(b, s, lens):
    q, k, v, mask = _inputs(8, b, s, 12 * 64, lens)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    tmask = torch.from_numpy(mask)
    ref = tea.encoder_attention_reference(tq, tk, tv, tmask, 12)
    tol = tea.comparison_tolerance(ref, tq, tk, tv, tmask, 12)

    def worst(out):
        return float(((out.float() - ref.float()).abs() / tol).max())

    honest = worst(_emulated_kernel(tq, tk, tv, tmask, 12))
    last = int(mask[0].sum()) - 1
    dropped = worst(_emulated_kernel(tq, tk, tv, tmask, 12, drop_key=(0, last)))
    shifted = worst(_emulated_kernel(tq, tk, tv, tmask, 12, head_shift=1))
    assert honest <= 1.0
    assert dropped > 10.0
    assert shifted > 10.0


def test_dispatch_cpu_runs_the_plain_version_only():
    q, k, v, mask = _inputs(9, 2, 16, 32)
    plain, kernel = tea.encoder_attention_reference.launches, tea.encoder_attention.launches
    _port(q, k, v, mask, 2)
    assert tea.encoder_attention_reference.launches == plain + 1
    assert tea.encoder_attention.launches == kernel


def test_non_cpu_tensors_never_reach_the_plain_version():
    plain = tea.encoder_attention_reference.launches
    q = torch.empty((2, 16, 32), device='meta')
    mask = torch.ones((2, 16), dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        tea.encoder_attention(q, q, q, mask, 2)
    # The CUDA wrapper refuses CPU tensors rather than computing anything.
    cpu = torch.zeros((2, 16, 32))
    with pytest.raises(ValueError, match='CUDA device'):
        tea.encoder_attention_cuda(cpu, cpu, cpu, torch.ones((2, 16)), 2)
    assert tea.encoder_attention_reference.launches == plain
