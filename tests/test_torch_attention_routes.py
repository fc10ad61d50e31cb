"""The 'wgmma' routes of K1 (paged attention) and K3 (encoder attention)
on the CPU: where the route map sends the main paths' shapes, and a plain
PyTorch emulation of each route's order held against the JAX function.

K1's emulation walks what one block of the route walks: 128 query rows
(span positions x the GQA group, interleaved), keys from the block's
first 64-key tile that holds a key of its range ``[lo, hi)``, an online
max and sum in fp32 over tiles of 64 keys in the log2 domain, each
unnormalised p rounded to bf16 as P V's operand while l sums it unrounded.
It is held to the Pallas kernel in interpret mode within the unchanged
``paged_attention.comparison_tolerance`` of the route, and two faults
(each query's own key dropped, the window one key wide) exceed it.

K3's emulation walks one block's two passes: 128 query rows, key tiles of
64 from the block's diagonal tile round, pass 1's online max and sum
where a warp of 16 rows skips its exponentials on a tile whose scores all
lie 140 or more below its running max, and pass 2 over the tiles not dead
for every warp, with the normalised p rounded to bf16. ``ex2.approx.ftz``
is exp2 with results under 2**-126 flushed to 0. It is held to the JAX
``encoder_attention`` within the unchanged ``comparison_tolerance``, and
the skip rule leaves its output bitwise unchanged under ModernBERT's
window bias, a fully masked row included.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.ops import encoder_attention as jea
from distllm_tpu.ops.paged_attention import ragged_paged_attention_pallas
from distllm_tpu_torch.ops import encoder_attention as tea
from distllm_tpu_torch.ops import paged_attention as tpa

LOG2E = 1.4426950408889634
FLUSH = 2.0 ** -126  # ex2.approx.ftz flushes smaller results to 0


# ------------------------------------------------------------ route maps
@pytest.mark.parametrize('span,group,kv_mode,block_size,want', [
    (1024, 4, 'model', 16, 'wgmma'),          # Mistral prefill
    (4600, 2, 'model', 16, 'wgmma'),          # Gemma-2 prefill
    (16, 4, 'model', 16, 'wgmma'),            # a 64-row chunk tile
    (15, 4, 'model', 16, 'tensor_cores'),     # 60 rows
    (5, 4, 'model', 16, 'tensor_cores'),      # the verify window, 20 rows
    (1, 4, 'model', 16, 'split_kv'),          # decode
    (3, 4, 'model', 16, 'split_kv'),
    (1024, 4, 'int8', 16, 'tensor_cores'),    # int8 pool
    (1024, 4, 'mixed', 16, 'tensor_cores'),   # fp32 pool under bf16 q
    (1024, 4, 'model', 32, 'tensor_cores'),   # pages of 32
    (64, 1, 'model', 16, 'wgmma'),
    (32, 2, 'model', 16, 'wgmma'),
    (31, 2, 'model', 16, 'tensor_cores'),
    (8, 8, 'model', 16, 'wgmma'),
    (7, 8, 'model', 16, 'tensor_cores'),
])
def test_k1_route_map(span, group, kv_mode, block_size, want):
    got = tpa.kernel_route(torch.bfloat16, span, group, kv_mode=kv_mode,
                           block_size=block_size)
    assert got == want
    assert tpa.kernel_route(torch.float32, span, group, kv_mode=kv_mode,
                            block_size=block_size) == 'cuda_cores'


def test_k1_route_map_refuses_an_unknown_pool():
    with pytest.raises(ValueError, match='kv_mode'):
        tpa.kernel_route(torch.bfloat16, 64, 4, kv_mode='fp8')


@pytest.mark.parametrize('head_dim,seq,bias,want', [
    (64, 1024, False, 'wgmma'),           # ESM-2 650M, ESM-C 600M
    (64, 2048, False, 'wgmma'),
    (64, 288, False, 'tensor_cores'),     # BERT-base, ModernBERT global layers
    (64, 160, False, 'tensor_cores'),
    (64, 288, True, 'wgmma'),             # ModernBERT local layers
    (64, 224, True, 'wgmma'),
    (64, 160, True, 'tensor_cores'),
    (32, 1024, False, 'wgmma'),
    (128, 1024, False, 'wgmma'),
    (80, 1024, False, 'tensor_cores'),    # no wgmma tile at head dim 80
    (40, 1024, False, 'cuda_cores'),
])
def test_k3_route_map(head_dim, seq, bias, want):
    assert tea.kernel_route(torch.bfloat16, head_dim, seq, bias) == want
    assert tea.kernel_route(torch.float32, head_dim, seq, bias) == 'cuda_cores'


# --------------------------------------------------- K1, the wgmma route
def _paged(seed):
    """Mistral-like GQA (8 query heads over 2 KV heads, head dim 64) over a
    pool of 16-token pages: a chunk of 100 queries over a 37-token prefix,
    a fresh 80-token prefill, one live query of a padded span."""
    rng = np.random.default_rng(seed)
    nb, bs, nkv, nh, hd, s = 40, 16, 2, 8, 64, 100
    k = rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32)
    q = rng.normal(size=(3, s, nh, hd)).astype(np.float32)
    bt = np.stack([rng.permutation(np.arange(1, nb))[:12] for _ in range(3)])
    ctx = np.asarray([137, 80, 150], np.int32)
    q_lens = np.asarray([100, 80, 1], np.int32)
    pos = (ctx - q_lens)[:, None] + np.arange(s, dtype=np.int32)[None, :]
    bf = lambda x: torch.from_numpy(x).bfloat16()  # noqa: E731
    return {'q': bf(q), 'k': bf(k), 'v': bf(v), 'bt': torch.from_numpy(bt.astype(np.int32)),
            'ctx': torch.from_numpy(ctx), 'pos': torch.from_numpy(pos),
            'q_lens': torch.from_numpy(q_lens)}


def _k1_args(t):
    return t['q'], t['k'], t['v'], t['bt'], t['ctx'], t['pos']


@functools.lru_cache(maxsize=None)
def _k1_pallas(window, softcap):
    t = _paged(31)
    arr = lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)  # noqa: E731
    out = ragged_paged_attention_pallas(
        arr(t['q']), arr(t['k']), arr(t['v']), jnp.asarray(t['bt'].numpy()),
        jnp.asarray(t['ctx'].numpy()), jnp.asarray(t['pos'].numpy()),
        q_lens=jnp.asarray(t['q_lens'].numpy()), sliding_window=window,
        logit_softcap=softcap, interpret=True,
    )
    return torch.from_numpy(np.array(out, np.float32)).bfloat16()


def _k1_wgmma_order(t, window, softcap, fault=None):
    """The wgmma route's order, block by block (see the module note)."""
    q, k, v, bt, ctx, pos = _k1_args(t)
    b, s, nh, hd = q.shape
    bs, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    span_tile = tpa._span_tile(s, group, 'wgmma')
    scale = hd ** -0.5
    win = (window + 1 if fault == 'window' else window) or 0
    out = torch.zeros(b, s, nh, hd)
    for row in range(b):
        q0, q_len, n_ctx = int(pos[row, 0]), int(t['q_lens'][row]), int(ctx[row])
        pages = bt[row].long()
        for h in range(nkv):
            for span_off in range(0, s, span_tile):
                lo = max(q0 + span_off - win + 1, 0) if win > 0 else 0
                hi = min(n_ctx, q0 + min(q_len, span_off + span_tile))
                if q_len <= span_off or hi <= lo:
                    continue
                t_begin = lo // 64 * 64
                r = torch.arange(span_tile * group)
                si, head = span_off + r // group, h * group + r % group
                live_row = si < q_len
                si = si.clamp(max=s - 1)
                qr = q[row, si, head].float()                        # [R, hd]
                qpos = (q0 + si)[:, None]
                m = torch.full((len(r), 1), float('-inf'))
                l = torch.zeros(len(r), 1)
                o = torch.zeros(len(r), hd)
                for t0 in range(t_begin, hi, 64):
                    keys = torch.arange(t0, t0 + 64)
                    kv_ok = keys < n_ctx
                    slot = keys.clamp(max=n_ctx - 1)
                    blk = pages[slot // bs]
                    kt = torch.where(kv_ok[:, None], k[blk, slot % bs, h].float(), 0.0)
                    vt = torch.where(kv_ok[:, None], v[blk, slot % bs, h].float(), 0.0)
                    sc = qr @ kt.T
                    x = (torch.tanh(sc * scale / softcap) * (softcap * LOG2E) if softcap
                         else sc * (scale * LOG2E))
                    valid = live_row[:, None] & kv_ok[None] & (keys[None] <= qpos)
                    if win > 0:
                        valid &= keys[None] > qpos - win
                    if fault == 'newest':
                        valid &= keys[None] != qpos
                    x = x.masked_fill(~valid, float('-inf'))
                    m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                    base = torch.where(m_new == float('-inf'), 0.0, m_new)
                    alpha = torch.exp2(m - base)
                    p = torch.exp2(x - base)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    o = o * alpha + p.bfloat16().float() @ vt
                    m = m_new
                res = (o / l.clamp_min(1e-9)).bfloat16().float()
                keep = live_row & (span_off + r // group < s)
                out[row, si[keep], head[keep]] = res[keep]
    return out.bfloat16()


def _k1_ratio(t, out, ref, window, softcap):
    tol = tpa.comparison_tolerance(
        ref, *_k1_args(t), q_lens=t['q_lens'], sliding_window=window,
        logit_softcap=softcap, route='wgmma',
    )
    valid = torch.arange(out.shape[1])[None, :] < t['q_lens'][:, None]
    err = (out.float() - ref.float()).abs()
    if not torch.isfinite(err[valid]).all():
        return float('inf')
    return float((err / tol)[valid].max())


@pytest.mark.parametrize('window,softcap', [(None, None), (24, None), (40, 30.0)])
def test_k1_wgmma_order_within_the_tolerance_of_pallas(window, softcap):
    t = _paged(31)
    ref = _k1_pallas(window, softcap)
    out = _k1_wgmma_order(t, window, softcap)
    assert _k1_ratio(t, out, ref, window, softcap) <= 1.0
    # and 128-row tiles: 32 positions x the group of 4
    assert tpa._span_tile(100, 4, 'wgmma') * 4 == 128


@pytest.mark.parametrize('fault', ['newest', 'window'])
def test_k1_wgmma_faults_exceed_the_tolerance(fault):
    t = _paged(31)
    ref = _k1_pallas(24, None)
    out = _k1_wgmma_order(t, 24, None, fault=fault)
    assert _k1_ratio(t, out, ref, 24, None) > 2.0


# --------------------------------------------------- K3, the wgmma route
def _ex2(x):
    y = torch.exp2(x)
    return torch.where(y < FLUSH, 0.0, y)


def _k3_wgmma_order(q, k, v, mask, heads, bias=None, skip=True):
    """The wgmma route's two passes, block by block (see the module note):
    q, k, v bf16 [B, S, N*Hd]; returns bf16 and each block's pass-2 tiles."""
    b, s, d = q.shape
    hd = d // heads
    nt = -(-s // 64)
    log2_scale = hd ** -0.5 * LOG2E
    out = torch.zeros(b, s, d)
    computed = 0
    for row in range(b):
        kb = torch.where(mask[row] != 0, 0.0, -1e9 * LOG2E)
        kb = torch.cat([kb, torch.full((nt * 64 - s,), float('-inf'))])
        for h in range(heads):
            cols = slice(h * hd, (h + 1) * hd)
            kh = torch.zeros(nt * 64, hd)
            vh = torch.zeros(nt * 64, hd)
            kh[:s], vh[:s] = k[row, :, cols].float(), v[row, :, cols].float()
            for q0 in range(0, s, 128):
                rows = torch.arange(q0, q0 + 128)
                qr = torch.zeros(128, hd)
                live = rows < s
                qr[live] = q[row, rows[live], cols].float()
                brow = rows.clamp(max=s - 1)
                order = [(q0 // 64 + o) % nt for o in range(nt)]

                def scores(tile):
                    keys = torch.arange(tile * 64, tile * 64 + 64)
                    add = kb[keys][None].expand(128, 64)
                    if bias is not None:
                        bk = bias[brow][:, keys.clamp(max=s - 1)]
                        add = bk * LOG2E + add
                    return (qr @ kh[keys].T) * log2_scale + add

                m = torch.full((128,), float('-inf'))
                l = torch.zeros(128)
                dead = []
                for tile in order:
                    x = scores(tile)
                    mx = x.amax(-1)
                    m_new = torch.maximum(m, mx)
                    warp_skip = ((m_new > float('-inf')) & (mx - m_new < -140.0)).view(8, 16).all(-1)
                    dead.append(warp_skip)
                    warps = (~warp_skip if skip else torch.ones(8, dtype=torch.bool)).repeat_interleave(16)
                    p = _ex2(x - m_new[:, None]).sum(-1)
                    alpha = torch.where(m_new == m, 1.0, _ex2(m - m_new))
                    l = torch.where(warps, l * alpha + p, l)
                    m = torch.where(warps, m_new, m)
                inv_l = 1.0 / l
                acc = torch.zeros(128, hd)
                for o, tile in enumerate(order):
                    if skip and o >= 2 and bool(dead[o].all()):
                        continue
                    computed += 1
                    p = (_ex2(scores(tile) - m[:, None]) * inv_l[:, None]).bfloat16().float()
                    acc = acc + p @ vh[tile * 64:tile * 64 + 64]
                out[row, rows[live], cols] = acc[live]
    return out.bfloat16(), computed


def _k3_inputs(seed, b, s, d, lens):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).bfloat16()
               for _ in range(3))
    mask = (torch.arange(s)[None] < torch.tensor(lens)[:, None]).to(torch.int32)
    return q, k, v, mask


def _window_bias(s, half=16):
    dist = (torch.arange(s)[:, None] - torch.arange(s)[None, :]).abs()
    return torch.where(dist <= half, 0.0, -1e9)


@pytest.mark.parametrize('s,lens,with_bias', [(150, [150, 97, 0], False), (256, [256, 140], True)])
def test_k3_wgmma_order_within_the_tolerance_of_jax(s, lens, with_bias):
    heads, hd = 2, 64
    q, k, v, mask = _k3_inputs(s + len(lens), len(lens), s, heads * hd, lens)
    bias = _window_bias(s) if with_bias else None
    jb = lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)  # noqa: E731
    ref = jea.encoder_attention(
        jb(q), jb(k), jb(v), jnp.asarray(mask.numpy()), num_heads=heads,
        bias=None if bias is None else jnp.asarray(bias.numpy()), interpret=True,
    )
    ref = torch.from_numpy(np.array(ref, np.float32)).bfloat16()
    out, _ = _k3_wgmma_order(q, k, v, mask, heads, bias)
    tol = tea.comparison_tolerance(ref, q, k, v, mask, heads, bias=bias)
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    assert float((err / tol).max()) <= 1.0


def test_k3_skip_rule_leaves_the_output_bitwise_unchanged():
    """ModernBERT's window bias (|i - j| <= 16 here, -1e9 outside) over
    S = 384 (six key tiles), a padded row and a fully masked row: the
    skipped tiles' p are all exactly 0, so skipping them changes no bit,
    while pass 2 computes fewer tiles."""
    heads, hd, s = 2, 64, 384
    q, k, v, mask = _k3_inputs(77, 3, s, heads * hd, [384, 200, 0])
    bias = _window_bias(s)
    skipped, n_skip = _k3_wgmma_order(q, k, v, mask, heads, bias, skip=True)
    every, n_all = _k3_wgmma_order(q, k, v, mask, heads, bias, skip=False)
    assert torch.equal(skipped, every)
    assert n_skip < n_all
    # the fully masked row is what the plain version computes: the uniform
    # average of V over each query's window
    ref = tea.encoder_attention_reference(q, k, v, mask, heads, bias=bias)
    tol = tea.comparison_tolerance(ref, q, k, v, mask, heads, bias=bias)
    assert ((skipped.float() - ref.float()).abs() <= tol).all()
    window = (torch.arange(s)[:, None] - torch.arange(s)[None, :]).abs() <= 16
    uniform = (window.float() / window.sum(-1, keepdim=True)) @ v[2].float()
    assert ((skipped[2].float() - uniform).abs() <= tol[2]).all()
