"""The port's int8 paged KV against the JAX package's (the twin of
``tests/test_kv_quant.py``).

- Quantize-at-write: ``quantize_kv_rows``, ``_rescale_int8_blocks``,
  ``write_token_kv`` (rescale on append: a growing running absmax, the
  scale reset at offset 0, dead rows routed to the trash block) and
  ``write_chunk_kv`` (spans that start fresh at a block's offset 0, spans
  that land mid-block, padded spans) leave int8 codes and fp32 scales
  BITWISE equal to the JAX ops' on the same fp32 inputs, outside the
  trash block 0 (duplicate scatter indices land there in no fixed order).
  The single-shot (``scale / 2``) and append (``1.5 * final scale``)
  error bounds hold.
- Attention: the plain op on a ``QuantizedKV`` pool against
  ``ragged_paged_attention_xla`` (decode and chunk spans, GQA (4,4) /
  (4,2) / (8,2), window, softcap) and against the Pallas kernel in
  interpret mode on valid rows; fp32, ``atol 1e-5``.
- The kernel's int8 tolerance (``comparison_tolerance``): a CPU emulation
  of each route's order — CUDA cores: fp32 scores ``(q . c) * scale *
  k_scale``, fp32 ``p * v_scale``; tensor cores: ``p * v_scale`` rounded
  to bf16 before P @ V, ``l`` over the unscaled p — stays within it
  (worst element at 0.83 of the bound on the CUDA cores in bf16, 0.019 in
  fp32, 0.77 on the tensor cores, 0.73 / 0.019 on the split-KV route in
  bf16 / fp32), and five injected faults exceed it by the factor
  ``FAULT_FACTOR`` at least (measured: 619x for K's scale used for V on
  the tensor-core and split-KV routes, 6,400x to 560,000x for the rest,
  ``l`` summed over p * v_scale included).
- The split-KV route's order over int8 pools (splits, warps, the int8
  folds) against ``ragged_paged_attention_xla`` and the Pallas kernel's
  int8 mode in interpret mode, at GQA groups 1, 4 and 8, with a window
  across the split edges and a softcap: worst element at 0.77 of the
  bound in bf16, 0.011 in fp32.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.ops import paged_attention as jpa
from distllm_tpu_torch.ops import paged_attention as tpa
from test_torch_paged_attention import SPLIT_SPANS, _split_inputs, _split_kv_order

ATOL = 1e-5
RTOL = 1e-4


def _jax_pool(pool):
    return jpa.QuantizedKV(jnp.asarray(pool.data.numpy()), jnp.asarray(pool.scale.numpy()))


def _zero_pools(nb=12, bs=4, nkv=2, hd=8):
    def one():
        return tpa.QuantizedKV(
            torch.zeros((nb, bs, nkv, hd), dtype=torch.int8), torch.zeros((nb, nkv))
        )
    return one(), one()


def _assert_pool_equal(port, jax_pool):
    """Codes and scales bitwise equal, outside the trash block 0."""
    np.testing.assert_array_equal(port.data.numpy()[1:], np.asarray(jax_pool.data)[1:])
    np.testing.assert_array_equal(port.scale.numpy()[1:], np.asarray(jax_pool.scale)[1:])


# ---------------------------------------------------------------- quantize
@pytest.mark.parametrize('magnitude', [1e-3, 1.0, 37.5])
def test_quantize_kv_rows_bitwise(magnitude):
    rng = np.random.default_rng(0)
    rows = (rng.normal(size=(6, 3, 16)) * magnitude).astype(np.float32)
    scale = np.abs(rows).max(-1) / 127.0
    scale[0, 1] = 0.0  # a fresh block: exact zeros
    scale[2] *= 0.7  # codes past 127 clip
    scale = scale.astype(np.float32)
    want = np.asarray(jpa.quantize_kv_rows(jnp.asarray(rows), jnp.asarray(scale)))
    got = tpa.quantize_kv_rows(torch.from_numpy(rows), torch.from_numpy(scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[0, 1].any()
    assert got[2].abs().max() == 127


def test_quantize_kv_rows_rounds_half_to_even():
    rows = torch.tensor([[[0.5, 1.5, 2.5, -0.5, -2.5, 126.5]]])
    codes = tpa.quantize_kv_rows(rows, torch.ones(1, 1))
    assert codes.tolist() == [[[0, 2, 2, 0, -2, 126]]]
    want = jpa.quantize_kv_rows(jnp.asarray(rows.numpy()), jnp.ones((1, 1)))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))


def test_rescale_int8_blocks_bitwise_with_zero_scales():
    rng = np.random.default_rng(1)
    data = rng.integers(-127, 128, size=(5, 4, 3, 8)).astype(np.int8)
    old = rng.uniform(0.01, 0.1, size=(5, 3)).astype(np.float32)
    new = (old * rng.uniform(1.0, 3.0, size=(5, 3))).astype(np.float32)
    new[1, 2] = 0.0  # a zero new scale zeroes the rows
    old[3] = 0.0
    want = jpa._rescale_int8_blocks(jnp.asarray(data), jnp.asarray(old), jnp.asarray(new))
    got = tpa._rescale_int8_blocks(
        torch.from_numpy(data), torch.from_numpy(old), torch.from_numpy(new)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1, :, 2].any() and not got[3].any()


# ------------------------------------------------------------------ writes
def _tables(rng, nb=12, b=3, width=5):
    return np.stack(
        [rng.permutation(np.arange(1, nb))[:width] for _ in range(b)]
    ).astype(np.int32)


def test_write_token_kv_runs_of_appends_bitwise():
    """Row 0 appends across a block boundary (offset-0 reset) with growing
    magnitudes (every append rescales the block), row 1 with shrinking
    ones, row 2's table points at the trash block (a dead row)."""
    rng = np.random.default_rng(2)
    tk, tv = _zero_pools()
    jk, jv = _jax_pool(tk), _jax_pool(tv)
    bt = _tables(rng)
    bt[2] = 0
    pos = np.asarray([1, 5, 2], np.int32)
    growth = np.asarray([1.5, 0.7, 1.0], np.float32)[:, None, None]
    for step in range(9):
        nk = (rng.normal(size=(3, 2, 8)) * growth ** step).astype(np.float32)
        nv = rng.normal(size=(3, 2, 8)).astype(np.float32)
        jk, jv = jpa.write_token_kv(
            jk, jv, jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(bt), jnp.asarray(pos)
        )
        out = tpa.write_token_kv(
            tk, tv, torch.from_numpy(nk), torch.from_numpy(nv),
            torch.from_numpy(bt), torch.from_numpy(pos),
        )
        assert out[0] is tk and out[1] is tv  # in place
        _assert_pool_equal(tk, jk)
        _assert_pool_equal(tv, jv)
        pos = pos + 1
    assert tk.scale[bt[0, 1]].gt(0).all()  # row 0 crossed into a fresh block


@pytest.mark.parametrize(
    'starts,lens',
    [
        ([0, 0, 0], [6, 3, 0]),  # fresh spans from offset 0, a padded row
        ([6, 3, 1], [5, 6, 2]),  # spans landing mid-block
        ([8, 12, 0], [4, 7, 7]),  # block-aligned spans
    ],
    ids=['fresh', 'mid_block', 'aligned'],
)
def test_write_chunk_kv_spans_bitwise(starts, lens):
    """A first span writes positions 0.. of each row; the span under test
    follows it (``starts``, ``lens``, width 7, trailing padding)."""
    rng = np.random.default_rng(3)
    tk, tv = _zero_pools()
    jk, jv = _jax_pool(tk), _jax_pool(tv)
    bt = _tables(rng)
    s = 7
    spans = [(np.asarray(starts), np.asarray(lens))]
    if any(starts):
        spans.insert(0, (np.zeros(3, int), np.asarray(starts)))
    for step, (start, n) in enumerate(spans):
        pos = (start[:, None] + np.arange(s)[None, :]).astype(np.int32)
        valid = np.arange(s)[None, :] < n[:, None]
        nk = (rng.normal(size=(3, s, 2, 8)) * (1 + 2 * step)).astype(np.float32)
        nv = rng.normal(size=(3, s, 2, 8)).astype(np.float32)
        jk, jv = jpa.write_chunk_kv(
            jk, jv, jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(bt),
            jnp.asarray(pos), jnp.asarray(valid),
        )
        out = tpa.write_chunk_kv(
            tk, tv, torch.from_numpy(nk), torch.from_numpy(nv),
            torch.from_numpy(bt), torch.from_numpy(pos), torch.from_numpy(valid),
        )
        assert out[0] is tk and out[1] is tv
        _assert_pool_equal(tk, jk)
        _assert_pool_equal(tv, jv)


def _dequant(pool, block):
    return pool.data[block].float() * pool.scale[block][None, :, None]


def test_single_shot_write_is_within_half_a_step():
    """A span written once at its blocks' final scales: each value is
    within half a quantization step, scale / 2 = absmax / 254."""
    rng = np.random.default_rng(4)
    tk, tv = _zero_pools()
    x = torch.from_numpy(rng.normal(size=(1, 8, 2, 8)).astype(np.float32) * 3)
    bt = torch.tensor([[4, 7, 0, 0, 0]], dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32)[None]
    tpa.write_chunk_kv(tk, tv, x, x, bt, pos, torch.ones(1, 8, dtype=torch.bool))
    for i, block in enumerate((4, 7)):
        rows = x[0, 4 * i:4 * i + 4]
        scale = tk.scale[block]
        torch.testing.assert_close(scale, rows.abs().amax((0, 2)) / 127.0)
        err = (_dequant(tk, block) - rows).abs()
        assert (err <= scale[None, :, None] / 2 + 1e-6).all()


def test_appends_are_within_one_and_a_half_steps():
    """Rescale on append adds a second rounding to the earlier rows: each
    value is within 1.5 steps of the block's FINAL scale, whose absmax is
    exactly the largest row's."""
    rng = np.random.default_rng(5)
    tk, tv = _zero_pools()
    bt = torch.tensor([[3, 0, 0, 0, 0]], dtype=torch.int32)
    rows = [
        torch.from_numpy(rng.normal(size=(1, 2, 8)).astype(np.float32) * (1 + 3 * t))
        for t in range(4)
    ]
    for t, row in enumerate(rows):
        tpa.write_token_kv(tk, tv, row, row * 2, bt, torch.tensor([t], dtype=torch.int32))
    written = torch.cat(rows)  # [block_size, nkv, hd]
    final = tk.scale[3]
    torch.testing.assert_close(final, written.abs().amax((0, 2)) / 127.0)
    err = (_dequant(tk, 3) - written).abs()
    assert (err <= 1.5 * final[None, :, None] + 1e-6).all()


# --------------------------------------------------------------- attention
def _quant_setup(seed, *, span='chunk', nkv=2, nh=4, hd=8, nb=12, bs=4, b=3, s=5):
    """Random int8 pools (codes in [-127, 127], a scale per block and head
    in [0.01, 0.1], as tests/test_kv_quant.py makes them) and the spans of
    tests/test_torch_paged_attention.py's ``_setup``."""
    rng = np.random.default_rng(seed)

    def pool():
        return tpa.QuantizedKV(
            torch.from_numpy(rng.integers(-127, 128, size=(nb, bs, nkv, hd)).astype(np.int8)),
            torch.from_numpy(rng.uniform(0.01, 0.1, size=(nb, nkv)).astype(np.float32)),
        )

    k, v = pool(), pool()
    bt = rng.integers(1, nb, size=(b, 8)).astype(np.int32)
    if span == 'decode':
        s = 1
        ctx = np.asarray([17, 5, 9][:b], np.int32)
        q_lens = np.ones((b,), np.int32)
    else:
        ctx = np.asarray([17, s, 9][:b], np.int32)
        q_lens = np.asarray([s, s, 1][:b], np.int32)
    pos = (ctx - q_lens)[:, None] + np.arange(s, dtype=np.int32)[None, :]
    q = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    return {'q': q, 'k': k, 'v': v, 'bt': bt, 'ctx': ctx, 'pos': pos, 'q_lens': q_lens}


def _jax_attend(fn, a, window, **kw):
    out = fn(
        jnp.asarray(a['q']), _jax_pool(a['k']), _jax_pool(a['v']),
        jnp.asarray(a['bt']), jnp.asarray(a['ctx']), jnp.asarray(a['pos']),
        q_lens=jnp.asarray(a['q_lens']), sliding_window=window, **kw,
    )
    return np.asarray(out)


def _port_attend(a, window, **kw):
    out = tpa.ragged_paged_attention(
        torch.from_numpy(a['q']), a['k'], a['v'], torch.from_numpy(a['bt']),
        torch.from_numpy(a['ctx']), torch.from_numpy(a['pos']),
        q_lens=torch.from_numpy(a['q_lens']), sliding_window=window, **kw,
    )
    return out.numpy()


def _assert_valid_rows_close(out, ref, q_lens):
    assert np.isfinite(out).all()
    valid = np.arange(out.shape[1])[None, :] < q_lens[:, None]
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL, rtol=RTOL)


# JAX window operand, port window operand (a traced JAX 0 is "off").
WINDOWS = {'nowin': (None, None), 'win3': (3, 3), 'win0': (jnp.int32(0), 0)}


@pytest.mark.parametrize('span', ['decode', 'chunk'])
@pytest.mark.parametrize('nh,nkv', [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize('window', sorted(WINDOWS))
def test_reference_on_int8_pool_matches_xla(span, nh, nkv, window):
    a = _quant_setup(1, span=span, nh=nh, nkv=nkv)
    jax_win, port_win = WINDOWS[window]
    ref = _jax_attend(jpa.ragged_paged_attention_xla, a, jax_win)
    _assert_valid_rows_close(_port_attend(a, port_win), ref, a['q_lens'])


@pytest.mark.parametrize('softcap', [None, 30.0], ids=['nocap', 'cap30'])
def test_reference_on_int8_pool_softcap_and_scale(softcap):
    a = _quant_setup(2, nh=8, nkv=2)
    kw = {'scale': 0.25, 'logit_softcap': softcap}
    ref = _jax_attend(jpa.ragged_paged_attention_xla, a, 5, **kw)
    _assert_valid_rows_close(_port_attend(a, 5, **kw), ref, a['q_lens'])


@pytest.mark.parametrize(
    'span,nh,nkv,window',
    [('chunk', 8, 2, 'win3'), ('decode', 4, 2, 'nowin'), ('chunk', 4, 4, 'win0')],
)
def test_reference_on_int8_pool_matches_pallas_interpret(span, nh, nkv, window):
    """Valid rows against the Pallas kernel's int8 mode itself (interpret
    mode, as the JAX package's own tests run it on the CPU)."""
    a = _quant_setup(3, span=span, nh=nh, nkv=nkv)
    jax_win, port_win = WINDOWS[window]
    ref = _jax_attend(jpa.ragged_paged_attention_pallas, a, jax_win, interpret=True)
    _assert_valid_rows_close(_port_attend(a, port_win), ref, a['q_lens'])


def test_pools_must_both_be_quantized_or_neither():
    a = _quant_setup(4)
    q, bt, ctx, pos = (torch.from_numpy(a[key]) for key in ('q', 'bt', 'ctx', 'pos'))
    with pytest.raises(TypeError, match='both be QuantizedKV'):
        tpa.ragged_paged_attention(q, a['k'], a['v'].data.float(), bt, ctx, pos)
    with pytest.raises(TypeError, match='fp32 scales'):
        bad = tpa.QuantizedKV(a['v'].data, a['v'].scale.double())
        tpa.ragged_paged_attention(q, a['k'], bad, bt, ctx, pos)


# ------------------------------------------------ the kernel's tolerance
def _tolerance_inputs(seed, dtype):
    """Mistral-like GQA (8 query heads over 2 KV heads, head dim 64) over
    int8 pools of 16-token pages quantized from N(0, 1) rows times a
    magnitude per block and head in [0.25, 4] (K and V independent, so
    neighbouring pages and K against V differ in scale): row 0 a chunk of
    100 queries over a 37-token prefix, row 1 a fresh 80-token prefill,
    row 2 one live query of a padded span."""
    rng = np.random.default_rng(seed)
    nb, bs, nkv, nh, hd, s = 40, 16, 2, 8, 64, 100

    def pool():
        x = rng.normal(size=(nb, bs, nkv, hd)) * rng.uniform(0.25, 4, size=(nb, 1, nkv, 1))
        x = torch.from_numpy(x.astype(np.float32))
        scale = x.abs().amax((1, 3)) / tpa.KV_QUANT_MAX
        return tpa.QuantizedKV(tpa.quantize_kv_rows(x, scale[:, None]), scale)

    k, v = pool(), pool()
    q = torch.from_numpy(rng.normal(size=(3, s, nh, hd)).astype(np.float32))
    bt = np.stack([rng.permutation(np.arange(1, nb))[:12] for _ in range(3)])
    ctx = np.asarray([137, 80, 150], np.int32)
    q_lens = np.asarray([100, 80, 1], np.int32)
    pos = (ctx - q_lens)[:, None] + np.arange(s, dtype=np.int32)[None, :]
    return {
        'q': q.to(getattr(torch, dtype)), 'k': k, 'v': v,
        'bt': torch.from_numpy(bt.astype(np.int32)), 'ctx': torch.from_numpy(ctx),
        'pos': torch.from_numpy(pos), 'q_lens': torch.from_numpy(q_lens),
    }


def _args(t):
    return t['q'], t['k'], t['v'], t['bt'], t['ctx'], t['pos']


def _emulated_route(t, route, window, softcap, fault=None):
    """A route's order on the CPU over the int8 pool: fp32 scores
    ``(q . c) * scale * k_scale``, softcap, mask; online max and sum over
    key tiles (32 keys on the CUDA cores, 64 on the tensor cores), ``l``
    over the unscaled p; P @ V over the codes with p * v_scale (rounded
    to bf16 on the tensor cores); out = acc / l rounded once. The split-KV
    route runs the same scores through the split and warp order of
    ``test_torch_paged_attention._split_kv_order`` (p * v_scale rounded to
    q's dtype). ``fault``:
    'neighbour_scale' reads each page's scales from the next physical
    block, 'k_scale_after_softcap' applies K's scale after the softcap,
    'l_scaled' sums the V-scaled p into l, 'v_scale_omitted' drops V's
    scale, 'k_scale_for_v' weights p by K's scale instead of V's."""
    q, k, v, bt = t['q'], t['k'], t['v'], t['bt'].long()
    b, s, nh, hd = q.shape
    nkv = k.data.shape[2]
    nb = k.data.shape[0]
    scale_bt = (bt + 1) % nb if fault == 'neighbour_scale' else bt

    def per_key(pool, table):  # codes [B, T, Nkv, Hd], scales [B, Nkv, T]
        codes = pool.data[bt].float().reshape(b, -1, nkv, hd)
        scales = pool.scale[table][:, :, None, :].expand(-1, -1, pool.data.shape[1], -1)
        return codes, scales.reshape(b, -1, nkv).permute(0, 2, 1)

    ck, ks = per_key(k, scale_bt)
    cv, vs = per_key(v, scale_bt)
    if fault == 'k_scale_for_v':
        vs = ks
    valid = torch.isfinite(tpa._scores_and_values(
        q, k, v, t['bt'], t['ctx'], t['pos'], t['q_lens'], window, None, softcap,
    )[0])  # [B, Nkv, G, S, T]
    qg = q.float().reshape(b, s, nkv, -1, hd)
    raw = torch.einsum('bskgd,btkd->bkgst', qg, ck) * hd ** -0.5
    ksg = ks[:, :, None, None, :]
    x = raw if fault == 'k_scale_after_softcap' else raw * ksg
    if softcap is not None:
        x = torch.tanh(x / softcap) * softcap
    if fault == 'k_scale_after_softcap':
        x = x * ksg
    x = x.masked_fill(~valid, float('-inf'))
    if route == 'split_kv':
        out = _split_kv_order(
            x, cv, q.dtype, t['pos'], t['q_lens'],
            v_scale=None if fault == 'v_scale_omitted' else vs,
            fault='l_scaled' if fault == 'l_scaled' else None,
        )
        return out.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)
    tile = 64 if route == 'tensor_cores' else 32
    m = torch.full(x.shape[:-1] + (1,), float('-inf'))
    l = torch.zeros_like(m)
    acc = torch.zeros(x.shape[:-1] + (hd,))
    for t0 in range(0, x.shape[-1], tile):
        m_new = torch.maximum(m, x[..., t0:t0 + tile].amax(-1, keepdim=True))
        base = torch.where(m_new == float('-inf'), 0.0, m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(x[..., t0:t0 + tile] - base)
        pv = p if fault == 'v_scale_omitted' else p * vs[:, :, None, None, t0:t0 + tile]
        l = l * alpha + (pv if fault == 'l_scaled' else p).sum(-1, keepdim=True)
        if route == 'tensor_cores':
            pv = pv.bfloat16().float()
        acc = acc * alpha + torch.einsum('bkgst,btkd->bkgsd', pv, cv[:, t0:t0 + tile])
        m = m_new
    out = (acc / l.clamp_min(1e-9)).permute(0, 3, 1, 2, 4)
    return out.reshape(q.shape).to(q.dtype)


def _worst_ratio(out, ref, tol, q_lens):
    valid = torch.arange(out.shape[1])[None, :] < q_lens[:, None]
    err = (out.float() - ref.float()).abs()[valid]
    if not torch.isfinite(err).all():
        return float('inf')
    return float((err / tol[valid]).max())


ROUTE_CASES = [
    ('cuda_cores', 'float32'), ('cuda_cores', 'bfloat16'), ('tensor_cores', 'bfloat16'),
    ('split_kv', 'bfloat16'), ('split_kv', 'float32'),
]


def _ratio(route, dtype, window, softcap, fault=None):
    t = _tolerance_inputs(12, dtype)
    kw = {'q_lens': t['q_lens'], 'sliding_window': window, 'logit_softcap': softcap}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    tol = tpa.comparison_tolerance(ref, *_args(t), route=route, **kw)
    out = _emulated_route(t, route, window, softcap, fault=fault)
    return _worst_ratio(out, ref, tol, t['q_lens'])


@pytest.mark.parametrize('route,dtype', ROUTE_CASES)
@pytest.mark.parametrize('window,softcap', [(None, None), (24, 30.0)], ids=['plain', 'win24_cap30'])
def test_emulated_int8_routes_within_the_tolerance(route, dtype, window, softcap):
    assert _ratio(route, dtype, window, softcap) <= 1.0


INT8_FAULTS = (
    'k_scale_after_softcap', 'k_scale_for_v', 'l_scaled', 'neighbour_scale',
    'v_scale_omitted',
)
# Each fault exceeds the bound by at least this factor on every route.
FAULT_FACTOR = 100.0


@pytest.mark.parametrize('route,dtype', ROUTE_CASES)
@pytest.mark.parametrize('fault', INT8_FAULTS)
def test_injected_int8_faults_exceed_the_tolerance(route, dtype, fault):
    assert _ratio(route, dtype, 24, 30.0, fault=fault) > FAULT_FACTOR


def test_int8_term_is_added_on_every_route():
    """The INT8 term rides on top of each route's own terms."""
    t = _tolerance_inputs(13, 'bfloat16')
    kw = {'q_lens': t['q_lens']}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    cores = tpa.comparison_tolerance(ref, *_args(t), route='cuda_cores', **kw)
    base = tpa.TOL_REL * ref.float().abs() + tpa.TOL_ABS
    assert (cores >= base).all() and (cores > base).any()
    tensor = tpa.comparison_tolerance(ref, *_args(t), route='tensor_cores', **kw)
    # P @ |V| is 0 only where every attended code of a column is 0 (a
    # query that sees one key).
    assert (tensor >= cores).all() and (tensor > cores).float().mean() > 0.99
    t32 = _tolerance_inputs(13, 'float32')
    ref32 = tpa.ragged_paged_attention(*_args(t32), **kw)
    tol32 = tpa.comparison_tolerance(ref32, *_args(t32), **kw)
    assert (tol32 >= tpa.TOL_ABS).all() and (tol32 > tpa.TOL_ABS).any()


# ------------------------------------------------- the split-KV route (2)
def _int8_split_inputs(seed, dtype, group):
    """``test_torch_paged_attention._split_inputs``'s rows (contexts 1, 63,
    65, 190 and a ``q_lens = 0`` row; three splits of 64 keys) over int8
    pools quantized from its K and V times a magnitude per block and head
    in [0.25, 4]."""
    t = _split_inputs(seed, 'float32', group)
    rng = np.random.default_rng(seed + 1)

    def pool(x):
        x = x * torch.from_numpy(
            rng.uniform(0.25, 4, size=(x.shape[0], 1, x.shape[2], 1)).astype(np.float32))
        scale = x.abs().amax((1, 3)) / tpa.KV_QUANT_MAX
        return tpa.QuantizedKV(tpa.quantize_kv_rows(x, scale[:, None]), scale)

    t['k'], t['v'] = pool(t['k']), pool(t['v'])
    t['q'] = t['q'].to(getattr(torch, dtype))
    return t


def _jax_int8_on(fn, t, window, softcap, **kw):
    q = t['q'].float().numpy()
    out = fn(
        jnp.asarray(q, jnp.bfloat16 if t['q'].dtype == torch.bfloat16 else jnp.float32),
        _jax_pool(t['k']), _jax_pool(t['v']), jnp.asarray(t['bt'].numpy()),
        jnp.asarray(t['ctx'].numpy()), jnp.asarray(t['pos'].numpy()),
        q_lens=jnp.asarray(t['q_lens'].numpy()), sliding_window=window,
        logit_softcap=softcap, **kw,
    )
    return torch.from_numpy(np.array(out, np.float32))


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('group', sorted(SPLIT_SPANS))
@pytest.mark.parametrize('window,softcap', [(None, None), (40, 30.0)],
                         ids=['nowin', 'win40_cap30'])
def test_emulated_int8_split_kv_within_the_tolerance_of_jax(dtype, group, window, softcap):
    """Route 2's order over an int8 pool (the int8 folds: K's scale on the
    score before the softcap, l over the unscaled p, p * v_scale before the
    rounding) against ``ragged_paged_attention_xla`` (and, at group 4,
    the Pallas kernel's int8 mode in interpret mode), within the split-KV
    route's int8 tolerance; a window of 40 crosses the split edges."""
    t = _int8_split_inputs(30 + group, dtype, group)
    out = _emulated_route(t, 'split_kv', window, softcap)
    kw = {'q_lens': t['q_lens'], 'sliding_window': window, 'logit_softcap': softcap}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    tol = tpa.comparison_tolerance(ref, *_args(t), route='split_kv', **kw)
    backends = [jpa.ragged_paged_attention_xla]
    if group == 4:
        backends.append(functools.partial(jpa.ragged_paged_attention_pallas, interpret=True))
    for fn in backends:
        assert _worst_ratio(out, _jax_int8_on(fn, t, window, softcap), tol, t['q_lens']) <= 1.0
    assert not out[4].any()  # q_lens = 0
