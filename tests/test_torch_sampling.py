"""The port's sampling against the JAX package's.

``filter_logits`` is allclose to the JAX op (fp32, ``atol 1e-6``: the
same elementwise math) over temperature / top-p / min-p / top-k /
``top_window``; greedy tokens are identical. Sampled draws are not
threefry's bits (see ``distllm_tpu_torch.ops.sampling``), so they are
checked as the JAX package checks its own sampled paths: deterministic
per seed, and a chi-square test of the sampled marginals against the
served (filtered) distribution.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.ops import sampling as jax_sampling
from distllm_tpu_torch.ops import sampling

# Chi-square critical values at p = 0.001 for 1..7 degrees of freedom: a
# correct sampler exceeds one once in a thousand seeds (and the draw is
# deterministic, so this test cannot flake).
CHI2_CRIT = (10.828, 13.816, 16.266, 18.467, 20.515, 22.458, 24.322)


def _inputs(seed, b=6, v=40):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    temperature = np.asarray([0.0, 0.7, 1.0, 1.3, 0.5, 1.0], np.float32)[:b]
    top_p = np.asarray([1.0, 0.9, 0.5, 1.0, 0.95, 0.3], np.float32)[:b]
    min_p = np.asarray([0.0, 0.0, 0.05, 0.1, 0.0, 0.0], np.float32)[:b]
    top_k = np.asarray([0, 5, 0, 3, 0, 10], np.int32)[:b]
    return logits, temperature, top_p, min_p, top_k


@pytest.mark.parametrize('top_window', [0, 16])
@pytest.mark.parametrize('with_top_k', [False, True])
def test_filter_logits_matches_jax(top_window, with_top_k):
    logits, temperature, top_p, min_p, top_k = _inputs(0)
    jf, ji = jax_sampling.filter_logits(
        jnp.asarray(logits), jnp.asarray(temperature), jnp.asarray(top_p),
        jnp.asarray(min_p), jnp.asarray(top_k) if with_top_k else None,
        top_window=top_window,
    )
    tf, ti = sampling.filter_logits(
        torch.from_numpy(logits), torch.from_numpy(temperature),
        torch.from_numpy(top_p), torch.from_numpy(min_p),
        torch.from_numpy(top_k) if with_top_k else None,
        top_window=top_window,
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jf = np.asarray(jf)
    assert (np.isinf(tf.numpy()) == np.isinf(jf)).all()
    finite = np.isfinite(jf)
    np.testing.assert_allclose(tf.numpy()[finite], jf[finite], atol=1e-6)


def test_greedy_tokens_identical():
    logits, *_ = _inputs(1)
    b = logits.shape[0]
    zeros, ones = np.zeros(b, np.float32), np.ones(b, np.float32)
    seeds = np.arange(b, dtype=np.uint32)
    jt = jax_sampling.sample_tokens(
        jnp.asarray(logits), None, jnp.asarray(zeros), jnp.asarray(ones),
        jnp.asarray(zeros),
        row_keys=jax_sampling.fold_row_keys(jnp.asarray(seeds), jnp.zeros(b, jnp.int32)),
    )
    keys = sampling.fold_row_keys(torch.from_numpy(seeds.astype(np.int64)), torch.zeros(b))
    args = (torch.from_numpy(logits), torch.zeros(b), torch.ones(b), torch.zeros(b), keys)
    np.testing.assert_array_equal(sampling.sample_tokens(*args).numpy(), np.asarray(jt))
    np.testing.assert_array_equal(
        sampling.sample_tokens(*args, all_greedy=True).numpy(), np.asarray(jt)
    )


def test_sampled_stream_is_a_pure_function_of_seed_counter_tag():
    logits, temperature, top_p, min_p, top_k = _inputs(2)
    b = logits.shape[0]

    def draw(seeds, counters, fold=2):
        keys = sampling.fold_row_keys(
            torch.as_tensor(seeds), torch.as_tensor(counters), fold
        )
        return sampling.sample_tokens(
            torch.from_numpy(logits), torch.from_numpy(temperature),
            torch.from_numpy(top_p), torch.from_numpy(min_p), keys,
            top_k=torch.from_numpy(top_k),
        ).numpy()

    seeds, counters = np.full(b, 7), np.arange(b) + 100
    np.testing.assert_array_equal(draw(seeds, counters), draw(seeds, counters))
    keys = [sampling.fold_row_keys(torch.tensor([s]), torch.tensor([c]), f).item()
            for s, c, f in ((7, 100, 2), (8, 100, 2), (7, 101, 2), (7, 100, 1))]
    assert len(set(keys)) == 4  # seed, counter and tag each change the key
    u = sampling.uniform_from_keys(
        sampling.fold_row_keys(torch.zeros(4096), torch.arange(4096))
    )
    assert 0.0 < u.min().item() and u.max().item() < 1.0


def _counts(logits_row, temperature, top_p, top_k, n=6000):
    v = logits_row.shape[0]
    tokens = sampling.sample_tokens(
        torch.from_numpy(np.tile(logits_row, (n, 1))),
        torch.full((n,), temperature), torch.full((n,), top_p),
        torch.zeros(n),
        sampling.fold_row_keys(torch.full((n,), 1234), torch.arange(n)),
        top_k=torch.full((n,), top_k, dtype=torch.int32),
    )
    return np.bincount(tokens.numpy(), minlength=v)


@pytest.mark.parametrize(
    'temperature,top_p,top_k', [(1.0, 1.0, 0), (0.8, 0.9, 6)],
    ids=['plain', 'top_p+top_k'],
)
def test_sampled_marginals_chi_square(temperature, top_p, top_k):
    """Marginals of 6000 draws over an 8-token vocab against the served
    distribution p̃ (the JAX filter's output, softmaxed)."""
    logits_row = np.asarray([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -1.5], np.float32)
    filtered, idx = jax_sampling.filter_logits(
        jnp.asarray(logits_row[None]), jnp.asarray([temperature]),
        jnp.asarray([top_p]), jnp.asarray([0.0]), jnp.asarray([top_k]),
    )
    p = np.zeros(8)
    p[np.asarray(idx)[0]] = np.asarray(jnp.exp(filtered - filtered.max()))[0]
    p /= p.sum()
    counts = _counts(logits_row, temperature, top_p, top_k)
    assert counts[p == 0].sum() == 0  # nothing outside the kept set
    kept = p > 0
    expected = p[kept] * counts.sum()
    chi2 = float(((counts[kept] - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_CRIT[kept.sum() - 2], (chi2, counts, p)


def test_sample_tokens_windowed_is_sample_tokens_with_a_window_of_at_least_one():
    logits, temperature, top_p, min_p, top_k = _inputs(3)
    b = logits.shape[0]
    keys = sampling.fold_row_keys(torch.full((b,), 5), torch.arange(b) + 40)
    args = (torch.from_numpy(logits), torch.from_numpy(temperature),
            torch.from_numpy(top_p), torch.from_numpy(min_p), keys)
    for window, effective in ((16, 16), (0, 1)):
        np.testing.assert_array_equal(
            sampling.sample_tokens_windowed(*args, window, top_k=torch.from_numpy(top_k)).numpy(),
            sampling.sample_tokens(*args, top_window=effective,
                                   top_k=torch.from_numpy(top_k)).numpy(),
        )
    # A window of one is the argmax of the temperature-scaled logits.
    np.testing.assert_array_equal(
        sampling.sample_tokens_windowed(*args, 0).numpy(), logits.argmax(-1)
    )
