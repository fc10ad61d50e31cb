"""The port's paged attention against the JAX package's.

The plain PyTorch op ``ragged_paged_attention_reference`` is held against
``ragged_paged_attention_xla`` (the JAX bit-exactness baseline) over the
``tests/test_ragged_attention.py`` matrix — decode and chunk spans × GQA
(4,4)/(4,2)/(8,2) × window none/static/0 × softcap × scale × ``q_lens`` —
and against the Pallas kernel in interpret mode on valid rows. fp32
everywhere, ``atol 1e-5``: both sides compute the same masked fp32
softmax, so only summation order differs. The in-place KV writes must
leave the same pools as the JAX writes. The CUDA kernel itself runs only
on a GPU (``tests/test_torch_gpu.py``; ``chip_smoke.py`` holds it against
the plain op at Mistral-7B shapes).

The kernel's tolerance (``comparison_tolerance``) is exercised here on the
CPU. The bf16 tensor-core route rounds the unnormalised p to bf16 before
P @ V, as the Pallas kernel does, so its bound carries a second term,
``2**-8 * (P @ |V|)``. Held to it: the Pallas kernel in interpret mode in
bf16 (worst element at 0.66 of its bound), and a plain-PyTorch emulation
of the route's order — key tiles of 64, online max and sum in fp32, p
rounded to the pool's dtype before P @ V (0.64 in bf16; 0.072 in fp32,
against ``1e-5``). Injected faults exceed it, in bf16 / fp32: the newest
key dropped (807 / 3.9e5 times the bound), the window one key wider
(321 / 1.1e5), a wrong page in the block table (385 / 2.0e5), and p
rounded before the running max is subtracted (exp overflows: non-finite
in both).

The split-KV route (bf16 tiles under 16 rows: decode rows) splits each
row's keys across thread blocks. ``kernel_route`` is pinned for every
span and group through the 15 / 16-row bound, and ``split_plan``'s
splits tile every key once in whole pages. A CPU emulation of its order
— splits of 64 keys, four warps of 16 keys a step each with its own
online max and sum, p rounded unnormalised, the warps and then the
splits merged in order with exp(m_s - M) in fp32 — is held against
``ragged_paged_attention_xla`` and the Pallas kernel in interpret mode at
GQA groups 1, 4 and 8, contexts 1, 63, 65 and 190 and a ``q_lens = 0``
row, with and without a window of 40 across the split edges and a
softcap: worst element at 0.565 of the route's bound in bf16, 0.083 in
fp32. Injected faults exceed it, in bf16 / fp32: the merge without the
exp(m_s - M) rescale (154 / 4.8e4 times the bound), the last live split
dropped (85 / 4.1e5), a split edge one key late, counting a key twice
(19 / 8.8e3), and the window floor taken at its split's start (163 /
6.8e4).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.ops.paged_attention import (
    ragged_paged_attention_pallas,
    ragged_paged_attention_xla,
)
from distllm_tpu.ops.paged_attention import write_chunk_kv as jax_write_chunk_kv
from distllm_tpu.ops.paged_attention import write_token_kv as jax_write_token_kv
from distllm_tpu_torch.ops import paged_attention as tpa

ATOL = 1e-5
RTOL = 1e-4


def _setup(seed, *, span='chunk', num_blocks=12, block_size=4, nkv=2, nh=4,
           hd=8, b=3, s=5):
    """numpy inputs shaped like test_ragged_attention's: row 0 a mid-stream
    chunk, row 1 a fresh prefill, row 2 one live query + q_lens padding.
    ``span='decode'`` gives every row a single query at ctx - 1."""
    rng = np.random.default_rng(seed)
    shape = (num_blocks, block_size, nkv, hd)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    bt = rng.integers(1, num_blocks, size=(b, 8)).astype(np.int32)
    if span == 'decode':
        s = 1
        ctx = np.asarray([17, 5, 9][:b], np.int32)
        q_lens = np.ones((b,), np.int32)
    else:
        ctx = np.asarray([17, s, 9][:b], np.int32)
        q_lens = np.asarray([s, s, 1][:b], np.int32)
    pos = (ctx - q_lens)[:, None] + np.arange(s, dtype=np.int32)[None, :]
    q = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    return {'q': q, 'k': k, 'v': v, 'bt': bt, 'ctx': ctx, 'pos': pos,
            'q_lens': q_lens}


def _jax(fn, a, window=None, **kw):
    out = fn(
        jnp.asarray(a['q']), jnp.asarray(a['k']), jnp.asarray(a['v']),
        jnp.asarray(a['bt']), jnp.asarray(a['ctx']), jnp.asarray(a['pos']),
        q_lens=None if a['q_lens'] is None else jnp.asarray(a['q_lens']),
        sliding_window=window, **kw,
    )
    return np.asarray(out)


def _port(a, window=None, **kw):
    t = {key: None if val is None else torch.from_numpy(val)
         for key, val in a.items()}
    out = tpa.ragged_paged_attention(
        t['q'], t['k'], t['v'], t['bt'], t['ctx'], t['pos'],
        q_lens=t['q_lens'], sliding_window=window, **kw,
    )
    return out.numpy()


def _assert_valid_rows_close(out, ref, q_lens):
    assert np.isfinite(out).all()
    valid = np.arange(out.shape[1])[None, :] < q_lens[:, None]
    np.testing.assert_allclose(out[valid], ref[valid], atol=ATOL, rtol=RTOL)


# JAX window operand, port window operand. A static JAX int 0 would mask
# every key; a traced 0 is the JAX "window off" — the port's int 0.
WINDOWS = {
    'nowin': (None, None),
    'win3': (3, 3),
    'win0': (jnp.int32(0), 0),
}


@pytest.mark.parametrize('span', ['decode', 'chunk'])
@pytest.mark.parametrize('nh,nkv', [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize('window', sorted(WINDOWS))
def test_reference_matches_xla(span, nh, nkv, window):
    a = _setup(1, span=span, nh=nh, nkv=nkv)
    jax_win, port_win = WINDOWS[window]
    ref = _jax(ragged_paged_attention_xla, a, jax_win)
    out = _port(a, port_win)
    _assert_valid_rows_close(out, ref, a['q_lens'])


@pytest.mark.parametrize('softcap', [None, 30.0], ids=['nocap', 'cap30'])
@pytest.mark.parametrize('scale', [None, 0.25], ids=['defscale', 'scale'])
def test_reference_softcap_and_scale(softcap, scale):
    a = _setup(2)
    kw = {'scale': scale, 'logit_softcap': softcap}
    ref = _jax(ragged_paged_attention_xla, a, 5, **kw)
    out = _port(a, 5, **kw)
    _assert_valid_rows_close(out, ref, a['q_lens'])


@pytest.mark.parametrize(
    'span,nh,nkv,window',
    [('chunk', 8, 2, 'win3'), ('decode', 4, 2, 'nowin'), ('chunk', 4, 4, 'win0')],
)
def test_reference_matches_pallas_interpret(span, nh, nkv, window):
    """Valid rows against the Pallas kernel itself (interpret mode, as the
    JAX package's own tests run it on the CPU)."""
    a = _setup(3, span=span, nh=nh, nkv=nkv)
    jax_win, port_win = WINDOWS[window]
    ref = _jax(ragged_paged_attention_pallas, a, jax_win, interpret=True)
    out = _port(a, port_win)
    _assert_valid_rows_close(out, ref, a['q_lens'])


def test_q_lens_none_matches_xla_on_every_row():
    a = _setup(4)
    a['ctx'] = np.asarray([17, 9, 12], np.int32)
    a['pos'] = (a['ctx'] - 5)[:, None] + np.arange(5, dtype=np.int32)[None, :]
    a['q_lens'] = None
    np.testing.assert_allclose(
        _port(a), _jax(ragged_paged_attention_xla, a), atol=ATOL, rtol=RTOL
    )


def test_write_ops_leave_the_jax_pools():
    """write_token_kv / write_chunk_kv (in place) vs the functional JAX
    writes: identical pools outside the trash block 0 (pad writes land
    there with duplicate indices, whose winner is unspecified)."""
    rng = np.random.default_rng(5)
    nb, bs, nkv, hd, b, s = 10, 4, 2, 8, 3, 6
    k = rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32)
    bt = np.stack([rng.permutation(np.arange(1, nb))[:4] for _ in range(b)])
    bt = bt.astype(np.int32)
    new_k = rng.normal(size=(b, s, nkv, hd)).astype(np.float32)
    new_v = rng.normal(size=(b, s, nkv, hd)).astype(np.float32)
    pos = np.asarray([[3], [0], [9]], np.int32) + np.arange(s, dtype=np.int32)
    valid = np.arange(s)[None, :] < np.asarray([[6], [2], [4]])

    jk, jv = jax_write_chunk_kv(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(new_k), jnp.asarray(new_v),
        jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(valid),
    )
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    out = tpa.write_chunk_kv(
        tk, tv, torch.from_numpy(new_k), torch.from_numpy(new_v),
        torch.from_numpy(bt), torch.from_numpy(pos), torch.from_numpy(valid),
    )
    assert out[0] is tk and out[1] is tv  # in place
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])

    tok_pos = np.asarray([5, 0, 11], np.int32)
    jk, jv = jax_write_token_kv(
        jk, jv, jnp.asarray(new_k[:, 0]), jnp.asarray(new_v[:, 0]),
        jnp.asarray(bt), jnp.asarray(tok_pos),
    )
    tpa.write_token_kv(
        tk, tv, torch.from_numpy(new_k[:, 0]), torch.from_numpy(new_v[:, 0]),
        torch.from_numpy(bt), torch.from_numpy(tok_pos),
    )
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])


def test_cpu_dispatch_counts_the_plain_op_not_the_kernel():
    a = _setup(6)
    launches = tpa.ragged_paged_attention.launches
    calls = tpa.ragged_paged_attention_reference.launches
    _port(a)
    assert tpa.ragged_paged_attention.launches == launches
    assert tpa.ragged_paged_attention_reference.launches == calls + 1


def test_non_cpu_tensors_never_reach_the_plain_op():
    """Only a CPU tensor is served by the plain version: any other device
    launches the kernel or raises."""
    a = _setup(7)
    t = [torch.from_numpy(a[key]).to('meta')
         for key in ('q', 'k', 'v', 'bt', 'ctx', 'pos')]
    calls = tpa.ragged_paged_attention_reference.launches
    with pytest.raises(ValueError, match='unsupported device'):
        tpa.ragged_paged_attention(*t)
    with pytest.raises(ValueError, match='CUDA device'):
        tpa.ragged_paged_attention_cuda(*t)
    assert tpa.ragged_paged_attention_reference.launches == calls


def test_quantized_pool_is_refused():
    """An int8 pool is served (tests/test_torch_kv_quant.py); what is still
    refused is a QuantizedKV whose scale does not match its data — one
    scale per block and KV head — on the plain op, the kernel wrapper and
    the writes alike."""
    a = _setup(8)
    q = torch.from_numpy(a['q'])
    codes = torch.zeros(a['k'].shape, dtype=torch.int8)
    rest = [torch.from_numpy(a[key]) for key in ('bt', 'ctx', 'pos')]
    for bad_scale in (torch.ones(12, 4, 2), torch.ones(11, 2), torch.ones(12)):
        pool = tpa.QuantizedKV(codes, bad_scale)
        with pytest.raises(ValueError, match='does not match data'):
            tpa.ragged_paged_attention(q, pool, pool, *rest)
        with pytest.raises(ValueError, match='does not match data'):
            tpa.ragged_paged_attention_cuda(q, pool, pool, *rest)
        with pytest.raises(ValueError, match='does not match data'):
            tpa.write_token_kv(
                pool, pool, torch.zeros(3, 2, 8), torch.zeros(3, 2, 8),
                rest[0], torch.zeros(3, dtype=torch.int32),
            )


def _paged_inputs(seed, dtype, *, offset=0.0):
    """Mistral-like GQA (8 query heads over 2 KV heads, head dim 64) over a
    pool of 16-token pages: row 0 a chunk of 100 queries over a 37-token
    prefix (its span starts off a 64-key tile), row 1 a fresh 80-token
    prefill, row 2 one live query of a padded span. ``offset`` adds the
    same score to every key of a query (q[..., 0] = 1, k[..., 0] = offset
    / scale): the softmax is unchanged, exp of an unshifted score is not."""
    rng = np.random.default_rng(seed)
    nb, bs, nkv, nh, hd, s = 40, 16, 2, 8, 64, 100
    k = rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32)
    q = rng.normal(size=(3, s, nh, hd)).astype(np.float32)
    if offset:
        q[..., 0] = 1.0
        k[..., 0] = offset * hd ** 0.5
    bt = np.stack([rng.permutation(np.arange(1, nb))[:12] for _ in range(3)])
    ctx = np.asarray([137, 80, 150], np.int32)
    q_lens = np.asarray([100, 80, 1], np.int32)
    pos = (ctx - q_lens)[:, None] + np.arange(s, dtype=np.int32)[None, :]
    torch_dtype = getattr(torch, dtype)
    return {
        'q': torch.from_numpy(q).to(torch_dtype),
        'k': torch.from_numpy(k).to(torch_dtype),
        'v': torch.from_numpy(v).to(torch_dtype),
        'bt': torch.from_numpy(bt.astype(np.int32)),
        'ctx': torch.from_numpy(ctx), 'pos': torch.from_numpy(pos),
        'q_lens': torch.from_numpy(q_lens),
    }


def _args(t):
    return t['q'], t['k'], t['v'], t['bt'], t['ctx'], t['pos']


def _emulated_tensor_core_route(t, window, fault=None):
    """The tensor-core route's order on the CPU: the plain version's fp32
    scores, key tiles of 64, the online max and sum in fp32, the
    unnormalised p rounded to the pool's dtype before P @ V (fp32
    accumulation), out = acc / l rounded once. ``fault`` injects one error:
    'newest' drops each query's own (newest) key, 'window' widens the
    window by one key, 'page' points page 1 of row 0 at another block,
    'unshifted' rounds p = exp(s) before the running max is subtracted."""
    bt = t['bt'].clone()
    if fault == 'page':
        bt[0, 1] = bt[1, 0]
    win = window + 1 if fault == 'window' else window
    scores, v = tpa._scores_and_values(
        t['q'], t['k'], t['v'], bt, t['ctx'], t['pos'], t['q_lens'], win,
        None, None,
    )  # [B, Nkv, G, S, T], [B, T, Nkv, Hd]
    if fault == 'newest':
        keys = torch.arange(scores.shape[-1])
        own = keys[None, None, :] == t['pos'].long()[:, :, None]  # [B, S, T]
        scores = scores.masked_fill(own[:, None, None], float('-inf'))
    dtype = t['v'].dtype
    m = torch.full(scores.shape[:-1] + (1,), float('-inf'))
    l = torch.zeros_like(m)
    acc = torch.zeros(scores.shape[:-1] + (v.shape[-1],))
    for t0 in range(0, scores.shape[-1], 64):
        tile = scores[..., t0:t0 + 64]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        base = torch.where(m_new == float('-inf'), 0.0, m_new)
        alpha = torch.exp(m - base)
        if fault == 'unshifted':
            p = torch.exp(tile).to(dtype).float() * torch.exp(-base)
        else:
            p = torch.exp(tile - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum('bkgst,btkd->bkgsd', p.to(dtype).float(), v[:, t0:t0 + 64])
        acc = acc * alpha + pv
        m = m_new
    out = (acc / l.clamp_min(1e-9)).permute(0, 3, 1, 2, 4)  # [B, S, Nkv, G, Hd]
    return out.reshape(t['q'].shape).to(t['q'].dtype)


def _worst_ratio(out, ref, tol, q_lens):
    """max |out - ref| / tol over valid rows; a non-finite output is inf."""
    valid = torch.arange(out.shape[1])[None, :] < q_lens[:, None]
    err = (out.float() - ref.float()).abs()[valid]
    if not torch.isfinite(err).all():
        return float('inf')
    return float((err / tol[valid]).max())


@pytest.mark.parametrize('window', [None, 24], ids=['nowin', 'win24'])
def test_pallas_bf16_within_the_tensor_core_tolerance(window):
    """The Pallas kernel (interpret mode, bf16) rounds the unnormalised p
    to bf16 where the tensor-core routes do: it stays within their
    tolerance of the port's plain version (this span takes the wgmma
    route, whose bound is the tensor-core route's)."""
    t = _paged_inputs(11, 'bfloat16')
    assert tpa.kernel_route(t['q'].dtype, 100, 4) == 'wgmma'
    bf = lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)  # noqa: E731
    pallas = ragged_paged_attention_pallas(
        bf(t['q']), bf(t['k']), bf(t['v']), jnp.asarray(t['bt'].numpy()),
        jnp.asarray(t['ctx'].numpy()), jnp.asarray(t['pos'].numpy()),
        q_lens=jnp.asarray(t['q_lens'].numpy()), sliding_window=window,
        interpret=True,
    )
    assert pallas.dtype == jnp.bfloat16
    got = torch.from_numpy(np.asarray(pallas, np.float32))
    kw = {'q_lens': t['q_lens'], 'sliding_window': window}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    tol = tpa.comparison_tolerance(ref, *_args(t), **kw)
    assert _worst_ratio(got, ref, tol, t['q_lens']) <= 1.0


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('window', [None, 24], ids=['nowin', 'win24'])
def test_emulated_route_order_within_the_tolerance(dtype, window):
    t = _paged_inputs(12, dtype, offset=150.0)
    kw = {'q_lens': t['q_lens'], 'sliding_window': window}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    tol = tpa.comparison_tolerance(ref, *_args(t), **kw)
    out = _emulated_tensor_core_route(t, window)
    assert _worst_ratio(out, ref, tol, t['q_lens']) <= 1.0


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('fault', ['newest', 'window', 'page', 'unshifted'])
def test_injected_faults_exceed_the_tolerance(dtype, fault):
    window = 24
    t = _paged_inputs(12, dtype, offset=150.0)
    kw = {'q_lens': t['q_lens'], 'sliding_window': window}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    tol = tpa.comparison_tolerance(ref, *_args(t), **kw)
    out = _emulated_tensor_core_route(t, window, fault=fault)
    assert _worst_ratio(out, ref, tol, t['q_lens']) > 10.0


# ------------------------------------------------- the split-KV route (2)
SPLIT_KEYS = 64  # the smallest split the kernel takes: three splits of 192 keys
# GQA group -> span of the tile (rows = span x group < 16).
SPLIT_SPANS = {1: 7, 4: 3, 8: 1}


def _split_inputs(seed, dtype, group):
    """Route 2's shapes: 2 KV heads x ``group``, head dim 64, 16-token
    pages, 12 pages a row (192 keys: three splits of 64). Rows: context
    1; a split's length - 1 (63); one split + 1 (65); 190 keys, whose
    live keys under a window of 40 sit in the last split alone; and a
    row of 130 keys with ``q_lens = 0``."""
    rng = np.random.default_rng(seed)
    nb, bs, nkv, hd = 48, 16, 2, 64
    span = SPLIT_SPANS[group]
    ctx = np.asarray([1, 63, 65, 190, 130], np.int32)
    q_lens = np.minimum(np.asarray([span] * 4 + [0]), ctx).astype(np.int32)
    pages = -(-ctx // bs)
    perm = rng.permutation(np.arange(1, nb))
    bt = np.zeros((5, 12), np.int32)
    at = 0
    for row, n in enumerate(pages):
        bt[row, :n] = perm[at:at + n]
        at += n
    pos = (ctx - q_lens)[:, None] + np.arange(span, dtype=np.int32)[None, :]
    torch_dtype = getattr(torch, dtype)
    tensor = lambda shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(torch_dtype)
    return {
        'k': tensor((nb, bs, nkv, hd)), 'v': tensor((nb, bs, nkv, hd)),
        'q': tensor((5, span, nkv * group, hd)),
        'bt': torch.from_numpy(bt), 'ctx': torch.from_numpy(ctx),
        'pos': torch.from_numpy(pos.astype(np.int32)), 'q_lens': torch.from_numpy(q_lens),
    }


def _merge_partials(parts, rescale=True):
    """Online-softmax partials (m, l, acc) merged in list order, fp32:
    each rescaled by exp(m_s - M) (a partial with no live key has m =
    -inf, l = 0 and weighs 0; every m -inf rebases on 0)."""
    ms = torch.stack([m for m, _, _ in parts])
    big = ms.amax(0)
    base = torch.where(big == float('-inf'), 0.0, big)
    wt = torch.exp(ms - base) if rescale else torch.ones_like(ms)
    l = sum(w * part[1] for w, part in zip(wt, parts))
    acc = sum(w * part[2] for w, part in zip(wt, parts))
    return big, l, acc


def _split_kv_order(x, v, dtype, pos, q_lens, window=None, v_scale=None, fault=None):
    """Route 2's order on the CPU. ``x``: fp32 scores ``[B, Nkv, G, S, T]``
    with the causal and context masks (-inf); ``v``: fp32 values ``[B, T,
    Nkv, Hd]`` (int8: the codes, with ``v_scale [B, Nkv, T]``). Pad queries
    (``q_lens``) see no key, and the window floor is applied per query,
    here. Splits of SPLIT_KEYS;
    in a split, warp w takes keys 16w .. 16w + 15 of each 64-key step with
    its own online m, l and acc: p unnormalised, ``p * v_scale`` rounded
    to ``dtype`` before P @ V, l over the unscaled p. The warps merge in
    warp order, then the splits in split order (fp32). ``fault``:
    'no_rescale' merges the splits without exp(m_s - M); 'drop_last_split'
    drops each query's last split that holds a live key; 'boundary_off_by_one'
    lets each split run one key into the next (a key counted twice);
    'window_at_split_start' takes the window floor at the start of the
    split it falls in; 'l_scaled' sums p * v_scale into l."""
    t_all = x.shape[-1]
    keys = torch.arange(t_all)
    pad = torch.arange(x.shape[3])[None, :] >= q_lens.long()[:, None]  # [B, S]
    x = x.masked_fill(pad[:, None, None, :, None], float('-inf'))
    if window:
        floor = pos.long()[:, None, None, :, None] - window + 1
        if fault == 'window_at_split_start':
            floor = floor.clamp_min(0) // SPLIT_KEYS * SPLIT_KEYS
        x = x.masked_fill(keys < floor, float('-inf'))
    reach = SPLIT_KEYS + (fault == 'boundary_off_by_one')
    splits = []
    for s0 in range(0, t_all, SPLIT_KEYS):
        warps = []
        for w in range(4):
            m = torch.full(x.shape[:-1] + (1,), float('-inf'))
            l = torch.zeros_like(m)
            acc = torch.zeros(x.shape[:-1] + (v.shape[-1],))
            for k0 in range(s0 + 16 * w, min(s0 + reach, t_all), 64):
                sl = slice(k0, min(k0 + 16, s0 + reach, t_all))
                m_new = torch.maximum(m, x[..., sl].amax(-1, keepdim=True))
                base = torch.where(m_new == float('-inf'), 0.0, m_new)
                alpha = torch.exp(m - base)
                p = torch.exp(x[..., sl] - base)
                pv = p if v_scale is None else p * v_scale[:, :, None, None, sl]
                l = l * alpha + (pv if fault == 'l_scaled' else p).sum(-1, keepdim=True)
                pv = pv.to(dtype).float()
                acc = acc * alpha + torch.einsum('bkgst,btkd->bkgsd', pv, v[:, sl])
                m = m_new
            warps.append((m, l, acc))
        splits.append(_merge_partials(warps))
    if fault == 'drop_last_split':
        live = torch.stack([l > 0 for _, l, _ in splits])  # [splits, ..., 1]
        index = torch.arange(len(splits)).reshape(-1, *([1] * (live.dim() - 1)))
        last = torch.where(live, index, -1).amax(0)
        splits = [
            (torch.where(last == i, float('-inf'), m), torch.where(last == i, 0.0, l),
             torch.where(last == i, 0.0, acc))
            for i, (m, l, acc) in enumerate(splits)
        ]
    _, l, acc = _merge_partials(splits, rescale=fault != 'no_rescale')
    return acc / l.clamp_min(1e-9)  # [B, Nkv, G, S, Hd]


def _emulated_split_kv_route(t, window=None, softcap=None, fault=None):
    """Route 2 on a pool in q's dtype: the plain version's fp32 scores
    (scale, softcap, causal / context / q_lens masks) through
    :func:`_split_kv_order`, rounded once to q's dtype."""
    scores, v = tpa._scores_and_values(
        t['q'], t['k'], t['v'], t['bt'], t['ctx'], t['pos'], t['q_lens'], None,
        None, softcap,
    )
    out = _split_kv_order(scores, v, t['v'].dtype, t['pos'], t['q_lens'], window, fault=fault)
    return out.permute(0, 3, 1, 2, 4).reshape(t['q'].shape).to(t['q'].dtype)


def _jax_on(fn, t, window, softcap, **kw):
    """``fn`` (a JAX backend) on the same tensors, in their dtype."""
    def arr(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy(), jnp.bfloat16)
        return jnp.asarray(x.numpy())
    out = fn(
        arr(t['q']), arr(t['k']), arr(t['v']), arr(t['bt']), arr(t['ctx']),
        arr(t['pos']), q_lens=arr(t['q_lens']), sliding_window=window,
        logit_softcap=softcap, **kw,
    )
    return torch.from_numpy(np.array(out, np.float32))


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('group', sorted(SPLIT_SPANS))
@pytest.mark.parametrize('window,softcap', [(None, None), (40, 30.0)],
                         ids=['nowin', 'win40_cap30'])
def test_emulated_split_kv_within_the_tolerance_of_jax(dtype, group, window, softcap):
    """Route 2's order against ``ragged_paged_attention_xla`` (and, at
    group 4, the Pallas kernel in interpret mode), within the split-KV
    route's tolerance; rows with no live key come out as exact zeros."""
    t = _split_inputs(20 + group, dtype, group)
    assert tpa.kernel_route(torch.bfloat16, t['q'].shape[1], group) == 'split_kv'
    out = _emulated_split_kv_route(t, window, softcap)
    kw = {'q_lens': t['q_lens'], 'sliding_window': window, 'logit_softcap': softcap}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    tol = tpa.comparison_tolerance(ref, *_args(t), route='split_kv', **kw)
    backends = [ragged_paged_attention_xla]
    if group == 4:
        backends.append(functools.partial(ragged_paged_attention_pallas, interpret=True))
    for fn in backends:
        jax_out = _jax_on(fn, t, window, softcap)
        assert _worst_ratio(out, jax_out, tol, t['q_lens']) <= 1.0
    assert not out[4].any()  # q_lens = 0


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize(
    'fault',
    ['no_rescale', 'drop_last_split', 'boundary_off_by_one', 'window_at_split_start'],
)
def test_injected_split_kv_faults_exceed_the_tolerance(dtype, fault):
    """Each fault of the split-KV order exceeds the route's bound at least
    tenfold against the JAX op, at a window of 40 that crosses the split
    edges at 64 and 128 keys, with a softcap."""
    t = _split_inputs(24, dtype, 4)
    kw = {'q_lens': t['q_lens'], 'sliding_window': 40, 'logit_softcap': 30.0}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    tol = tpa.comparison_tolerance(ref, *_args(t), route='split_kv', **kw)
    jax_out = _jax_on(ragged_paged_attention_xla, t, 40, 30.0)
    out = _emulated_split_kv_route(t, 40, 30.0, fault=fault)
    assert _worst_ratio(out, jax_out, tol, t['q_lens']) > 10.0


def test_tolerance_terms_by_route():
    """fp32 is held to 1e-5; bf16 on the CUDA cores to one bf16 step of
    out; bf16 on the tensor cores adds 2**-8 * (P @ |V|)."""
    t = _paged_inputs(13, 'bfloat16')
    kw = {'q_lens': t['q_lens']}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    cores = tpa.comparison_tolerance(ref, *_args(t), route='cuda_cores', **kw)
    torch.testing.assert_close(cores, tpa.TOL_REL * ref.float().abs() + tpa.TOL_ABS)
    tensor = tpa.comparison_tolerance(ref, *_args(t), **kw)
    assert (tensor > cores).all()
    t32 = _paged_inputs(13, 'float32')
    ref32 = tpa.ragged_paged_attention(*_args(t32), **kw)
    assert (tpa.comparison_tolerance(ref32, *_args(t32), **kw) == tpa.TOL_ABS).all()
    with pytest.raises(ValueError, match='route'):
        tpa.comparison_tolerance(ref, *_args(t), route='tma', **kw)


def test_kernel_route_by_dtype_and_tile_rows():
    """bf16 tiles of 64..128 rows (span positions x group) over a bf16 pool
    take the wgmma route, the other tiles of 16..64 rows the tensor cores;
    bf16 tiles under 16 rows (decode rows at group 4, spans of 2-3) take
    the split-KV route; fp32 takes the CUDA cores."""
    assert tpa.kernel_route(torch.bfloat16, 1024, 4) == 'wgmma'
    assert tpa.kernel_route(torch.bfloat16, 1024, 4, kv_mode='int8') == 'tensor_cores'
    assert tpa.kernel_route(torch.bfloat16, 4, 4) == 'tensor_cores'
    assert tpa.kernel_route(torch.bfloat16, 1, 16) == 'tensor_cores'
    assert tpa.kernel_route(torch.bfloat16, 1, 4) == 'split_kv'
    assert tpa.kernel_route(torch.bfloat16, 3, 4) == 'split_kv'
    assert tpa.kernel_route(torch.float32, 1024, 4) == 'cuda_cores'
    assert tpa.kernel_route(torch.float32, 1, 4) == 'cuda_cores'


@pytest.mark.parametrize('group', [1, 2, 4, 8, 16])
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_kernel_route_at_the_16_row_bound(group, dtype):
    """Every span at each group, through the 15 / 16-row bound: bf16 tiles
    of 1..15 rows on the split-KV route, 16..64 on the tensor cores unless
    the wgmma route's tile (up to 128 rows) has 64 rows or more; fp32 on
    the CUDA cores at every tile."""
    for span in range(1, 80):
        rows = min(span, 64 // group) * group
        want = 'split_kv' if rows <= 15 else 'tensor_cores'
        if min(span, 128 // group) * group >= tpa.WGMMA_MIN_ROWS:
            want = 'wgmma'
        if dtype == 'float32':
            want = 'cuda_cores'
        assert tpa.kernel_route(getattr(torch, dtype), span, group) == want, (span, rows)
    if dtype == 'bfloat16' and group <= 15:
        assert tpa.kernel_route(torch.bfloat16, 15 // group, group) == 'split_kv'
        assert tpa.kernel_route(torch.bfloat16, 16 // group, group) == (
            'tensor_cores' if 16 % group == 0 else 'split_kv'
        )


@pytest.mark.parametrize('batch', [1, 8, 32])
@pytest.mark.parametrize('max_keys', [16, 1090, 4096])
@pytest.mark.parametrize('block_size', [16, 32])
def test_split_plan_tiles_every_key_once(batch, max_keys, block_size):
    """The split-KV plan from host-known shapes (the H100's 132 SMs and
    Mistral's 8 KV heads): the splits tile [0, max_blocks * block_size)
    exactly once in whole pages and 64-key steps, hold at least 128 keys
    unless one split covers the row, and number at most enough to fill the
    card about twice over."""
    max_blocks = -(-max_keys // block_size)
    keys = max_blocks * block_size
    splits, split_keys = tpa.split_plan(keys, batch, 8, 132, block_size)
    assert split_keys % block_size == 0 and split_keys % tpa.SPLIT_STEP_KEYS == 0
    assert (splits - 1) * split_keys < keys <= splits * split_keys
    owner = np.arange(keys) // split_keys  # each key's split
    assert np.array_equal(np.bincount(owner, minlength=splits)[:-1],
                          np.full(splits - 1, split_keys))
    assert 1 <= splits <= max(1, -(-tpa.SPLIT_BLOCKS_PER_SM * 132 // (batch * 8)))
    assert split_keys >= tpa.SPLIT_MIN_KEYS or splits == 1


def test_static_zero_window_splits_the_jax_backends():
    """A fault of the JAX package (ROADMAP queue C): with a STATIC
    ``sliding_window=0`` the XLA op masks every key and returns NaN rows,
    while the Pallas kernel treats 0 as 'window off'. The port follows
    the kernel's documented contract (``<= 0`` = off): its result is the
    Pallas one, which is also the no-window result."""
    a = _setup(10)
    assert np.isnan(_jax(ragged_paged_attention_xla, a, 0)).any()
    pallas = _jax(ragged_paged_attention_pallas, a, 0, interpret=True)
    port = _port(a, 0)
    _assert_valid_rows_close(port, pallas, a['q_lens'])
    _assert_valid_rows_close(
        port, _jax(ragged_paged_attention_xla, a, None), a['q_lens']
    )
