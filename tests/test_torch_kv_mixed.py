"""K1 over a full-precision pool of another dtype than the queries (the
mixed mode: a bf16 pool under an fp32 model, an fp32 pool under a bf16
one) against the JAX package.

- The plain op casts where the Pallas kernel casts (K to q's dtype before
  Q·Kᵀ, the unnormalised p to V's dtype before P·V, the output to q's):
  its valid rows stay within ``comparison_tolerance`` of the Pallas
  kernel in interpret mode for both pairings, and (fp32 q over a bf16
  pool) of ``ragged_paged_attention_xla``, which rounds no p.
- The kernel's MIXED tolerance term: a CPU emulation of each route's
  rounding — route 0 with fp32 q over a bf16 pool (p rounded to bf16
  against the running maximum of 32-key tiles), routes 1 and 2 with bf16
  q over an fp32 pool (K and V narrowed to bf16, p rounded to bf16; 64-key
  tiles, and the split-KV order) — stays within it, and two injected
  faults exceed it by ``FAULT_FACTOR``; at phase 3c's decode-row geometry
  (4096-key rows) a dropped last page of the longest row, a fault that
  moves the output by a few thousandths, exceeds it by ``PAGE_FAULT_FACTOR``
  on every route.
- The writes cast to the pool's dtype, bitwise as the JAX ops do.
- Engines: an fp32 model with ``kv_cache_dtype='bf16'`` gives the JAX
  engine's greedy tokens on the same config; a bf16 model with ``'fp32'``
  constructs and serves. Both keep their pools in the pinned dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig
from distllm_tpu.generate.engine import LLMEngine as JaxLLMEngine
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu.ops import paged_attention as jpa
from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.ops import paged_attention as tpa
from test_torch_paged_attention import SPLIT_KEYS, _split_kv_order

# (query dtype, pool dtype) of the two pairings.
PAIRS = [('float32', 'bfloat16'), ('bfloat16', 'float32')]
FAULT_FACTOR = 20.0
PAGE_FAULT_FACTOR = 2.0


def _jnp(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _mixed_inputs(seed, q_dtype, kv_dtype, *, nh=8, nkv=2, hd=64, s=100):
    """GQA 8 over 2, head dim 64, 16-token pages: row 0 a chunk of 100
    queries over a 37-token prefix, row 1 a fresh 80-token prefill, row 2
    one live query of a padded span. K and V are N(0, 1) times a magnitude
    per page and head in [0.25, 4]."""
    rng = np.random.default_rng(seed)
    nb, bs = 40, 16

    def pool():
        x = rng.normal(size=(nb, bs, nkv, hd)) * rng.uniform(0.25, 4, size=(nb, 1, nkv, 1))
        return torch.from_numpy(x.astype(np.float32)).to(getattr(torch, kv_dtype))

    k, v = pool(), pool()
    q = torch.from_numpy(rng.normal(size=(3, s, nh, hd)).astype(np.float32))
    bt = np.stack([rng.permutation(np.arange(1, nb))[:12] for _ in range(3)])
    ctx = np.asarray([137, 80, 150], np.int32)
    q_lens = np.asarray([100, 80, 1], np.int32)
    pos = (ctx - q_lens)[:, None] + np.arange(s, dtype=np.int32)[None, :]
    return {
        'q': q.to(getattr(torch, q_dtype)), 'k': k, 'v': v,
        'bt': torch.from_numpy(bt.astype(np.int32)), 'ctx': torch.from_numpy(ctx),
        'pos': torch.from_numpy(pos), 'q_lens': torch.from_numpy(q_lens),
    }


def _args(t):
    return t['q'], t['k'], t['v'], t['bt'], t['ctx'], t['pos']


def _worst_ratio(out, ref, tol, q_lens):
    valid = torch.arange(out.shape[1])[None, :] < q_lens[:, None]
    err = (out.float() - ref.float()).abs()[valid]
    if not torch.isfinite(err).all():
        return float('inf')
    return float((err / tol[valid]).max())


def _jax_on(fn, t, window, softcap, **kw):
    out = fn(
        _jnp(t['q']), _jnp(t['k']), _jnp(t['v']), jnp.asarray(t['bt'].numpy()),
        jnp.asarray(t['ctx'].numpy()), jnp.asarray(t['pos'].numpy()),
        q_lens=jnp.asarray(t['q_lens'].numpy()), sliding_window=window,
        logit_softcap=softcap, **kw,
    )
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


# ------------------------------------------------------------ the plain op
@pytest.mark.parametrize('q_dtype,kv_dtype', PAIRS)
@pytest.mark.parametrize('window,softcap', [(None, None), (24, 30.0)], ids=['plain', 'win24_cap30'])
def test_plain_op_within_tolerance_of_pallas_interpret(q_dtype, kv_dtype, window, softcap):
    """The Pallas kernel's own casts in interpret mode, as the JAX
    package's tests run it on the CPU. The route is the CUDA cores' (no
    P_REL term): the Pallas kernel rounds p only where the plain op does."""
    t = _mixed_inputs(1, q_dtype, kv_dtype)
    kw = {'q_lens': t['q_lens'], 'sliding_window': window, 'logit_softcap': softcap}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    assert ref.dtype == t['q'].dtype
    tol = tpa.comparison_tolerance(ref, *_args(t), route='cuda_cores', **kw)
    pallas = _jax_on(jpa.ragged_paged_attention_pallas, t, window, softcap, interpret=True)
    assert _worst_ratio(pallas, ref, tol, t['q_lens']) <= 1.0


@pytest.mark.parametrize('window', [None, 24])
def test_fp32_queries_over_bf16_pool_within_tolerance_of_xla(window):
    """XLA widens the bf16 pool as the Pallas kernel does but rounds no p:
    the plain op's rounding of p stays inside the MIXED term."""
    t = _mixed_inputs(2, 'float32', 'bfloat16')
    kw = {'q_lens': t['q_lens'], 'sliding_window': window}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    tol = tpa.comparison_tolerance(ref, *_args(t), route='cuda_cores', **kw)
    xla = _jax_on(jpa.ragged_paged_attention_xla, t, window, None)
    ratio = _worst_ratio(xla, ref, tol, t['q_lens'])
    assert 0.0 < ratio <= 1.0  # p is rounded: the two differ


def test_plain_op_rounds_k_to_bf16_queries():
    """bf16 queries over an fp32 pool attend to K rounded to bf16: the
    result equals the same queries over the pool narrowed to bf16 for K
    (V kept fp32), bitwise."""
    t = _mixed_inputs(3, 'bfloat16', 'float32')
    kw = {'q_lens': t['q_lens']}
    mixed = tpa.ragged_paged_attention(*_args(t), **kw)
    k16 = t['k'].bfloat16().float()
    same = tpa.ragged_paged_attention(t['q'], k16, t['v'], *_args(t)[3:], **kw)
    torch.testing.assert_close(mixed, same, atol=0, rtol=0)


# --------------------------------------------------- the kernel's tolerance
def _emulated_route(t, route, window, softcap, fault=None):
    """A route's rounding on the CPU. Route 0 (fp32 q over a bf16 pool):
    fp32 scores, online max and sum over 32-key tiles, p rounded to bf16
    against the running maximum, l over the unrounded p. Routes 1 and 2
    (bf16 q over an fp32 pool): K and V narrowed to bf16, 64-key tiles (the
    tensor cores) or the split-KV order, p rounded to bf16; the output
    rounded once to q's dtype. ``fault``: 'k_from_v' stages K from the V
    pool; 'pool_reinterpreted' reads the pool's bytes as q's dtype;
    'last_page_dropped' skips the keys of row 0's last 16-key page."""
    q, k, v, bt = t['q'], t['k'], t['v'], t['bt'].long()
    ctx = t['ctx']
    if fault == 'last_page_dropped':
        ctx = ctx.clone()
        ctx[0] = (int(ctx[0]) - 1) // 16 * 16
    if fault == 'k_from_v':
        k = v
    if fault == 'pool_reinterpreted':
        k, v = (_as_q_dtype(pool, q.dtype) for pool in (k, v))
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    kq = k.to(q.dtype).float()[bt].reshape(b, -1, nkv, hd)
    vv = v.float()[bt].reshape(b, -1, nkv, hd)
    if route != 'cuda_cores':
        vv = vv.bfloat16().float()
    valid = torch.isfinite(tpa._scores_and_values(
        q, t['k'], t['v'], t['bt'], ctx, t['pos'], t['q_lens'], window, None, softcap,
    )[0])
    x = torch.einsum('bskgd,btkd->bkgst', q.float().reshape(b, s, nkv, -1, hd), kq)
    x = x * hd ** -0.5
    if softcap is not None:
        x = torch.tanh(x / softcap) * softcap
    x = x.masked_fill(~valid, float('-inf'))
    if route == 'split_kv':
        out = _split_kv_order(x, vv, torch.bfloat16, t['pos'], t['q_lens'])
        return out.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)
    tile = 32 if route == 'cuda_cores' else 64
    m = torch.full(x.shape[:-1] + (1,), float('-inf'))
    l = torch.zeros_like(m)
    acc = torch.zeros(x.shape[:-1] + (hd,))
    for t0 in range(0, x.shape[-1], tile):
        m_new = torch.maximum(m, x[..., t0:t0 + tile].amax(-1, keepdim=True))
        base = torch.where(m_new == float('-inf'), 0.0, m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(x[..., t0:t0 + tile] - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            'bkgst,btkd->bkgsd', p.bfloat16().float(), vv[:, t0:t0 + tile]
        )
        m = m_new
    out = (acc / l.clamp_min(1e-9)).permute(0, 3, 1, 2, 4)
    return out.reshape(q.shape).to(q.dtype)


def _as_q_dtype(pool, dtype):
    """The pool's bytes read as elements of ``dtype``, laid out in the
    pool's shape (the wrong-stride reading of a kernel that takes the pool
    for q's dtype: cut short or repeated to fill the shape)."""
    flat = pool.contiguous().reshape(-1).view(dtype)
    reps = -(-pool.numel() // flat.numel())
    flat = flat.repeat(reps)[: pool.numel()]
    return flat.reshape(pool.shape).float().to(pool.dtype)


def _split_case(seed):
    """Decode rows (bf16 q over an fp32 pool) long enough for three
    splits of SPLIT_KEYS, spans of 1..3 at a group of 4."""
    rng = np.random.default_rng(seed)
    nb, bs, nkv, hd, span = 48, 16, 2, 64, 3
    ctx = np.asarray([1, 63, 65, 190], np.int32)
    q_lens = np.minimum(np.asarray([span] * 4), ctx).astype(np.int32)
    pages = -(-ctx // bs)
    perm = rng.permutation(np.arange(1, nb))
    bt = np.zeros((4, 12), np.int32)
    at = 0
    for row, n in enumerate(pages):
        bt[row, :n] = perm[at:at + n]
        at += n
    pos = (ctx - q_lens)[:, None] + np.arange(span, dtype=np.int32)[None, :]
    tensor = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    return {
        'k': tensor((nb, bs, nkv, hd)), 'v': tensor((nb, bs, nkv, hd)),
        'q': tensor((4, span, nkv * 4, hd)).bfloat16(),
        'bt': torch.from_numpy(bt), 'ctx': torch.from_numpy(ctx),
        'pos': torch.from_numpy(pos.astype(np.int32)), 'q_lens': torch.from_numpy(q_lens),
    }


ROUTE_CASES = [
    ('cuda_cores', 'float32', 'bfloat16'), ('tensor_cores', 'bfloat16', 'float32'),
    ('split_kv', 'bfloat16', 'float32'),
]


def _ratio(route, q_dtype, kv_dtype, window, softcap, fault=None):
    t = _split_case(5) if route == 'split_kv' else _mixed_inputs(4, q_dtype, kv_dtype)
    kw = {'q_lens': t['q_lens'], 'sliding_window': window, 'logit_softcap': softcap}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    tol = tpa.comparison_tolerance(ref, *_args(t), route=route, **kw)
    out = _emulated_route(t, route, window, softcap, fault=fault)
    return _worst_ratio(out, ref, tol, t['q_lens'])


@pytest.mark.parametrize('route,q_dtype,kv_dtype', ROUTE_CASES)
@pytest.mark.parametrize('window,softcap', [(None, None), (24, 30.0)], ids=['plain', 'win24_cap30'])
def test_emulated_mixed_routes_within_the_tolerance(route, q_dtype, kv_dtype, window, softcap):
    assert _ratio(route, q_dtype, kv_dtype, window, softcap) <= 1.0


@pytest.mark.parametrize('route,q_dtype,kv_dtype', ROUTE_CASES)
@pytest.mark.parametrize('fault', ['k_from_v', 'pool_reinterpreted'])
def test_injected_mixed_faults_exceed_the_tolerance(route, q_dtype, kv_dtype, fault):
    assert _ratio(route, q_dtype, kv_dtype, None, None, fault=fault) > FAULT_FACTOR


def _long_rows(seed, q_dtype, kv_dtype, span):
    """Phase 3c's decode-row geometry cut to four rows: 32 query heads over
    8, head dim 128, 16-token pages, N(0, 1) K and V, contexts of 4096 (row
    0), 2900, 1200 and 1 keys, spans of ``span`` queries."""
    rng = np.random.default_rng(seed)
    ctx = np.asarray([4096, 2900, 1200, 1], np.int32)
    pages = -(-ctx // 16)
    nb = int(pages.sum()) + 1
    perm = rng.permutation(np.arange(1, nb))
    bt = np.zeros((4, pages.max()), np.int32)
    at = 0
    for row, n in enumerate(pages):
        bt[row, :n] = perm[at:at + n]
        at += n
    q_lens = np.minimum(span, ctx).astype(np.int32)
    pos = (ctx - q_lens)[:, None] + np.arange(span, dtype=np.int32)[None, :]
    tensor = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    kvt = getattr(torch, kv_dtype)
    return {
        'k': tensor((nb, 16, 8, 128)).to(kvt), 'v': tensor((nb, 16, 8, 128)).to(kvt),
        'q': tensor((4, span, 32, 128)).to(getattr(torch, q_dtype)),
        'bt': torch.from_numpy(bt), 'ctx': torch.from_numpy(ctx),
        'pos': torch.from_numpy(pos.astype(np.int32)), 'q_lens': torch.from_numpy(q_lens),
    }


@pytest.mark.parametrize('route,q_dtype,kv_dtype,span', [
    case + (1,) for case in ROUTE_CASES] + [('tensor_cores', 'bfloat16', 'float32', 4)])
def test_long_rows_within_the_tolerance_and_a_dropped_page_beyond_it(route, q_dtype,
                                                                    kv_dtype, span):
    t = _long_rows(9, q_dtype, kv_dtype, span)
    kw = {'q_lens': t['q_lens']}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    tol = tpa.comparison_tolerance(ref, *_args(t), route=route, **kw)
    assert _worst_ratio(_emulated_route(t, route, None, None), ref, tol, t['q_lens']) <= 1.0
    dropped = _emulated_route(t, route, None, None, fault='last_page_dropped')
    assert _worst_ratio(dropped, ref, tol, t['q_lens']) > PAGE_FAULT_FACTOR


def test_split_case_spans_three_splits():
    assert SPLIT_KEYS * 2 < 190 <= SPLIT_KEYS * 3


def test_mixed_term_is_added_on_every_route():
    t = _mixed_inputs(6, 'float32', 'bfloat16')
    kw = {'q_lens': t['q_lens']}
    ref = tpa.ragged_paged_attention(*_args(t), **kw)
    same = tpa.ragged_paged_attention(t['q'], t['k'].float(), t['v'].float(), *_args(t)[3:], **kw)
    plain = tpa.comparison_tolerance(same, t['q'], t['k'].float(), t['v'].float(),
                                     *_args(t)[3:], route='cuda_cores', **kw)
    mixed = tpa.comparison_tolerance(ref, *_args(t), route='cuda_cores', **kw)
    assert (mixed > plain).any() and (mixed >= plain).all()


# ------------------------------------------------------------------- writes
@pytest.mark.parametrize('q_dtype,kv_dtype', PAIRS)
def test_writes_cast_to_the_pool_dtype_bitwise(q_dtype, kv_dtype):
    rng = np.random.default_rng(7)
    nb, bs, nkv, hd = 10, 4, 2, 8
    kvt = getattr(torch, kv_dtype)
    pools = [torch.zeros((nb, bs, nkv, hd), dtype=kvt) for _ in range(2)]
    jpools = [_jnp(p) for p in pools]
    bt = np.stack([rng.permutation(np.arange(1, nb))[:4] for _ in range(2)]).astype(np.int32)
    new = [torch.from_numpy(rng.normal(size=(2, 5, nkv, hd)).astype(np.float32))
           .to(getattr(torch, q_dtype)) for _ in range(2)]
    pos = np.asarray([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    valid = np.asarray([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], bool)
    tpa.write_chunk_kv(*pools, *new, torch.from_numpy(bt), torch.from_numpy(pos),
                       torch.from_numpy(valid))
    jk, jv = jpa.write_chunk_kv(*jpools, *(_jnp(n) for n in new), jnp.asarray(bt),
                                jnp.asarray(pos), jnp.asarray(valid))
    tok = [torch.from_numpy(rng.normal(size=(2, nkv, hd)).astype(np.float32))
           .to(getattr(torch, q_dtype)) for _ in range(2)]
    tpos = np.asarray([8, 5], np.int32)
    tpa.write_token_kv(*pools, *tok, torch.from_numpy(bt), torch.from_numpy(tpos))
    jk, jv = jpa.write_token_kv(jk, jv, *(_jnp(n) for n in tok), jnp.asarray(bt),
                                jnp.asarray(tpos))
    for port, want in zip(pools, (jk, jv)):
        assert port.dtype == kvt
        np.testing.assert_array_equal(
            port[1:].float().numpy(), np.asarray(want.astype(jnp.float32))[1:]
        )


# ------------------------------------------------------------------ engines
TINY = {
    'vocab_size': 128, 'hidden_size': 32, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 64, 'dtype': 'float32',
}
ENGINE = {'block_size': 4, 'max_num_seqs': 3, 'max_model_len': 64, 'decode_steps': 4}
GREEDY = dict(temperature=0.0, max_tokens=7)


class _Tok:
    eos_id = None


@pytest.fixture(scope='module')
def weights():
    jcfg = jax_mistral.MistralConfig(**TINY)
    tree = jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, tree


@pytest.fixture(scope='module')
def prompts():
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(4, 128, size=n)] for n in (3, 11, 6, 17, 9)]


def test_fp32_model_over_bf16_pool_tokens_equal_the_jax_engine(weights, prompts):
    jcfg, tree = weights
    jax_engine = JaxLLMEngine(jcfg, tree, _Tok(), JaxEngineConfig(
        num_blocks=48, attn_backend='xla', prefer_native_allocator=False,
        kv_cache_dtype='bf16', **ENGINE,
    ))
    want = jax_engine.generate_ids(prompts, JaxSamplingParams(**GREEDY))
    jax_engine.shutdown()
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    engine = LLMEngine(tcfg, params, _Tok(), EngineConfig(
        num_blocks=48, kv_cache_dtype='bf16', **ENGINE), device='cpu')
    calls = tpa.ragged_paged_attention_reference.launches
    assert engine.generate_ids(prompts, SamplingParams(**GREEDY)) == want
    assert engine.telemetry['kv_cache_dtype'] == 'bfloat16'
    assert engine.kv.k.dtype == torch.bfloat16 and not engine.kv.quantized
    passes = engine.telemetry['forward_passes']
    assert tpa.ragged_paged_attention_reference.launches - calls == TINY['num_layers'] * passes
    assert engine.kv.k[:, 1:].abs().sum() > 0  # the writes landed in bf16


def test_bf16_model_over_fp32_pool_constructs_and_serves(weights, prompts):
    tcfg = mistral.MistralConfig(**{**TINY, 'dtype': 'bfloat16'})
    params = mistral.params_from_jax(weights[1], tcfg, device='cpu')
    engine = LLMEngine(tcfg, params, _Tok(), EngineConfig(
        num_blocks=48, kv_cache_dtype='fp32', **ENGINE), device='cpu')
    assert engine.kv.k.dtype == torch.float32
    out = engine.generate_ids(prompts, SamplingParams(**GREEDY))
    assert [len(o) for o in out] == [GREEDY['max_tokens']] * len(prompts)
    assert engine.telemetry['kv_cache_dtype'] == 'float32'
    assert engine.sched.num_free_blocks == 48 - 1
