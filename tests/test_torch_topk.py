"""The port's ``ops/topk`` against ``distllm_tpu.ops.topk`` on the CPU.

Same seeded numpy inputs through both: ``topk_inner_product``,
``int8_topk`` and ``hamming_topk`` in their flat and grouped forms, at
slab sizes small enough that the running merge crosses several slabs,
with planted ties (rows repeated across slabs, and queries equal to a
repeated row) so the order among equal scores decides the result: the
indices must be identical to JAX's and the scores within 1e-6 (the int8
and Hamming scores bitwise, being exact integer products scaled in the
same order). ``quantize_int8_rows``, ``pack_sign_bits`` and
``group_rows`` are bitwise JAX's. What JAX refuses is refused: grouped
inputs without ``n_valid`` or under a data-sharded mesh, and rows a data
axis does not divide (the sharded paths themselves are held to JAX in
``test_torch_topk_sharded.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.ops import topk as jtopk
from distllm_tpu_torch.ops import topk as ttopk

N, H, B = 700, 64, 6


def _corpus(seed=0, n=N, h=H):
    """Unit rows with planted ties: rows 3 and 11 repeated across the slabs,
    one all-zero row, queries that equal a repeated row."""
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, h)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    for dst in (150, 151, 333, 334, 699):
        corpus[dst] = corpus[3]
    for dst in (200, 460, 461):
        corpus[dst] = corpus[11]
    corpus[42] = 0.0
    queries = rng.normal(size=(B, h)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    queries[1] = corpus[3]
    queries[4] = corpus[11]
    queries[5] = 0.0  # every score 0: the order is the index order
    return corpus, queries


def _np(pair):
    return np.asarray(pair[0]), np.asarray(pair[1])


def _port(pair):
    return pair[0].numpy(), pair[1].numpy()


def _same(got, want, exact=False):
    np.testing.assert_array_equal(got[1], want[1])
    if exact:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)


@pytest.mark.parametrize('k', [1, 9, 40])
def test_topk_inner_product_matches_jax(k):
    corpus, queries = _corpus()
    want = _np(jtopk.topk_inner_product(jnp.asarray(queries), jnp.asarray(corpus), k))
    for chunk in (128, 700, 1 << 18):
        got = _port(ttopk.topk_inner_product(
            torch.from_numpy(queries), torch.from_numpy(corpus), k, chunk_size=chunk))
        _same(got, want)
    # The tied rows come out in index order.
    if k == 9:
        assert list(got[1][1][:6]) == [3, 150, 151, 333, 334, 699]
        assert list(got[1][5]) == list(range(9))


def test_fp32_scores_ignore_the_callers_matmul_precision():
    corpus, queries = _corpus()
    want = _port(ttopk.topk_inner_product(
        torch.from_numpy(queries), torch.from_numpy(corpus), 9))
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('medium')
    try:
        got = _port(ttopk.topk_inner_product(
            torch.from_numpy(queries), torch.from_numpy(corpus), 9))
        assert torch.get_float32_matmul_precision() == 'medium'
    finally:
        torch.set_float32_matmul_precision(previous)
    _same(got, want, exact=True)


def test_quantize_and_pack_are_bitwise_jax():
    corpus, _ = _corpus()
    codes, scales = jtopk.quantize_int8_rows(corpus)
    got_codes, got_scales = ttopk.quantize_int8_rows(corpus)
    assert got_codes.dtype == np.int8 and got_scales.dtype == np.float32
    np.testing.assert_array_equal(got_codes, codes)
    assert got_scales.tobytes() == scales.tobytes()
    np.testing.assert_array_equal(ttopk.pack_sign_bits(corpus), jtopk.pack_sign_bits(corpus))
    for chunk in (64, 700, 1024):
        np.testing.assert_array_equal(
            ttopk.group_rows(codes, chunk), jtopk.group_rows(codes, chunk))
    with pytest.raises(ValueError, match='divisible by 8'):
        ttopk.pack_sign_bits(np.zeros((1, 7), np.float32))


def test_query_quantization_is_bitwise_jax():
    """The on-the-fly query codes and scales (division by 127 as a tensor,
    round half to even) equal the JAX expressions'."""
    _, queries = _corpus()
    queries = np.concatenate([queries, np.float32([[0.5, -1.5, 2.5] + [0] * (H - 3)])])
    qi, qscale = ttopk.quantize_queries(torch.from_numpy(queries))
    q = jnp.asarray(queries)
    qmax = jnp.abs(q).max(axis=1)
    want_scale = jnp.where(qmax == 0, 1.0, qmax / 127.0)
    want = jnp.clip(jnp.round(q / want_scale[:, None]), -127, 127).astype(jnp.int8)
    assert qscale.numpy().tobytes() == np.asarray(want_scale).tobytes()
    np.testing.assert_array_equal(qi.numpy(), np.asarray(want))


@pytest.mark.parametrize('k', [1, 9, 40])
@pytest.mark.parametrize('form', ['flat', 'grouped'])
def test_int8_topk_matches_jax(k, form):
    corpus, queries = _corpus()
    codes, scales = jtopk.quantize_int8_rows(corpus)
    q = jnp.asarray(queries)
    if form == 'flat':
        want = _np(jtopk.int8_topk(q, jnp.asarray(codes), jnp.asarray(scales), k,
                                   chunk_size=128))
        got = _port(ttopk.int8_topk(torch.from_numpy(queries), torch.from_numpy(codes),
                                    torch.from_numpy(scales), k, chunk_size=128))
    else:
        g_codes, g_scales = jtopk.group_rows(codes, 256), jtopk.group_rows(scales, 256)
        want = _np(jtopk.int8_topk(q, jnp.asarray(g_codes), jnp.asarray(g_scales), k,
                                   n_valid=N))
        got = _port(ttopk.int8_topk(torch.from_numpy(queries), torch.from_numpy(g_codes),
                                    torch.from_numpy(g_scales), k, n_valid=N))
        assert (got[1] < N).all()  # the zero padding never surfaces
    _same(got, want, exact=True)


@pytest.mark.parametrize('k', [1, 9, 40])
@pytest.mark.parametrize('form', ['flat', 'grouped'])
def test_hamming_topk_matches_jax(k, form):
    corpus, queries = _corpus()
    bits, qbits = jtopk.pack_sign_bits(corpus), jtopk.pack_sign_bits(queries)
    if form == 'flat':
        want = _np(jtopk.hamming_topk(jnp.asarray(qbits), jnp.asarray(bits), k,
                                      chunk_size=128))
        got = _port(ttopk.hamming_topk(torch.from_numpy(qbits), torch.from_numpy(bits), k,
                                       chunk_size=128))
    else:
        grouped = jtopk.group_rows(bits, 256)
        want = _np(jtopk.hamming_topk(jnp.asarray(qbits), jnp.asarray(grouped), k,
                                      n_valid=N))
        got = _port(ttopk.hamming_topk(torch.from_numpy(qbits), torch.from_numpy(grouped), k,
                                       n_valid=N))
    assert got[0].dtype == np.int32
    _same(got, want, exact=True)
    if k == 9:  # a query equal to row 3: its five copies at distance 0, in order
        assert list(got[1][1][:6]) == [3, 150, 151, 333, 334, 699]
        assert list(got[0][1][:6]) == [0] * 6


def test_caller_k_beyond_a_slab_is_not_truncated():
    """k larger than a slab: the merge returns the caller's k."""
    corpus, queries = _corpus()
    codes, scales = jtopk.quantize_int8_rows(corpus)
    g_codes, g_scales = jtopk.group_rows(codes, 64), jtopk.group_rows(scales, 64)
    want = _np(jtopk.int8_topk(jnp.asarray(queries), jnp.asarray(g_codes),
                               jnp.asarray(g_scales), 100, n_valid=N))
    got = _port(ttopk.int8_topk(torch.from_numpy(queries), torch.from_numpy(g_codes),
                                torch.from_numpy(g_scales), 100, n_valid=N))
    assert got[1].shape == (B, 100)
    _same(got, want, exact=True)


def test_refusals():
    corpus, queries = _corpus()
    codes, scales = jtopk.quantize_int8_rows(corpus)
    tq, tc, ts = (torch.from_numpy(a) for a in (queries, codes, scales))
    # What JAX cannot run: rows the data axis does not divide (700 over 3
    # shards), and grouped codes with a data-sharded mesh (JAX's message).
    for mesh in ({'data': 3}, {'data': 3, 'model': 1}):
        with pytest.raises(ValueError, match='do not split evenly'):
            ttopk.topk_inner_product(tq, torch.from_numpy(corpus), 3, mesh=mesh)
        with pytest.raises(ValueError, match='do not split evenly'):
            ttopk.int8_topk(tq, tc, ts, 3, mesh=mesh)
    with pytest.raises(ValueError, match='cannot combine with a data-sharded mesh'):
        ttopk.int8_topk(tq, torch.from_numpy(jtopk.group_rows(codes, 256)),
                        torch.from_numpy(jtopk.group_rows(scales, 256)), 3,
                        mesh={'data': 2}, n_valid=N)
    # A data axis of 1 is the single-device path.
    one = ttopk.int8_topk(tq, tc, ts, 3, mesh={'data': 1, 'model': 1})
    _same(_port(one), _port(ttopk.int8_topk(tq, tc, ts, 3)), exact=True)
    grouped = torch.from_numpy(jtopk.group_rows(codes, 256))
    with pytest.raises(ValueError, match='n_valid'):
        ttopk.int8_topk(tq, grouped, torch.from_numpy(jtopk.group_rows(scales, 256)), 3)
    bits = torch.from_numpy(jtopk.group_rows(jtopk.pack_sign_bits(corpus), 256))
    with pytest.raises(ValueError, match='n_valid'):
        ttopk.hamming_topk(torch.from_numpy(jtopk.pack_sign_bits(queries)), bits, 3)


def test_exact_int8_sums_at_esm_width():
    """At H = 1280 int8 x int8 sums pass 2**24, where fp32 is no longer
    exact; the port's int32 product is, and its result is JAX's."""
    rng = np.random.default_rng(5)
    corpus = np.sign(rng.normal(size=(300, 1280))).astype(np.float32)
    corpus[:, 0] = 1.0
    queries = corpus[[7, 8, 9]] + np.float32(1e-3) * rng.normal(size=(3, 1280)).astype(np.float32)
    codes, scales = jtopk.quantize_int8_rows(corpus)
    qi, _ = ttopk.quantize_queries(torch.from_numpy(queries))
    raw = ttopk._int_dot(qi, torch.from_numpy(codes))
    exact = qi.numpy().astype(np.int64) @ codes.astype(np.int64).T
    assert np.abs(exact).max() > 2 ** 24
    np.testing.assert_array_equal(raw.numpy(), exact)
    want = _np(jtopk.int8_topk(jnp.asarray(queries), jnp.asarray(codes),
                               jnp.asarray(scales), 5, chunk_size=128))
    got = _port(ttopk.int8_topk(torch.from_numpy(queries), torch.from_numpy(codes),
                                torch.from_numpy(scales), 5, chunk_size=128))
    _same(got, want, exact=True)
