"""Prompt-lookup speculation in the port against the JAX package (the
twin of ``tests/test_spec.py`` and ``tests/test_spec_sampling.py``).

- ``PromptLookupDrafter`` proposes exactly the JAX drafter's tokens on
  seeded random histories with repeated motifs, n-grams 1..3, observed
  incrementally; bad n-grams are refused.
- ``verify_spans``: greedy rows are bitwise JAX's outputs and accept
  lengths on the same fp32 logits. Sampled rows match JAX in
  distribution only (murmur3 keys in place of threefry): the emitted
  token's marginal is chi-square tested against the filtered target,
  plain and under top-p / min-p / top-k / ``top_window``; a draft that is
  the sole support is always accepted, one outside the kept set never;
  a draw is a pure function of seed and position; a span-1 verify draws
  bit for bit the token the port's decode step draws.
- Engines (tiny fp32 Mistral, block size 4, the JAX staggered workload
  with motif prompts, prefix cache, ``prefill_chunk_tokens=4``): the
  port's greedy tokens with ``draft_k=4`` equal the JAX engine's and the
  port's own with speculation off and with ``spec_draft_source='none'``
  (tolerance: identity), and drafting fires. Edge cases: every draft
  accepted, none accepted, a stop token inside the accepted prefix,
  preemption mid-draft, and the rollback state (block rows, free list
  content and order, prefix-cache refcounts) equal to a never-drafted
  run's; sampled rows draft too, deterministically per seed.
- An int8 KV pool under speculation: a rejected draft's span write grows
  its block's absmax scale and requantizes the live codes, in both
  packages alike (codes and scales bitwise JAX's); engine tokens equal
  the JAX engine's (fp32, int8 pool, ``draft_k=4``).
- The verify runner on the CPU: its eager step gives ``mistral.
  spec_window``'s packed result and pool writes bitwise, and the kernel
  counters a capture would record are its launches.
"""

from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig
from distllm_tpu.generate.engine import LLMEngine as JaxLLMEngine
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.generate.engine.spec import PromptLookupDrafter as JaxDrafter
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu.ops import paged_attention as jax_pa
from distllm_tpu.ops import sampling as jax_sampling
from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
from distllm_tpu_torch.generate.engine import decode_graph
from distllm_tpu_torch.generate.engine.spec import PromptLookupDrafter
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.ops import paged_attention as tpa
from distllm_tpu_torch.ops import sampling

TINY = {
    'vocab_size': 64, 'hidden_size': 32, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 64, 'dtype': 'float32',
}
ENGINE = {'block_size': 4, 'num_blocks': 96, 'max_num_seqs': 2, 'max_model_len': 96}
# The JAX staggered workload (tests/test_spec.py): unequal prompts and
# budgets, two prompts behind a shared 2-block prefix, two tiling a motif.
STAGGER_LENS = (5, 21, 3, 33, 7, 13)
STAGGER_OUT = (3, 17, 9, 5, 12, 8)
# Chi-square critical values at p = 0.001 for 1..7 degrees of freedom
# (the draws are deterministic, so the tests cannot flake).
CHI2_CRIT = (10.828, 13.816, 16.266, 18.467, 20.515, 22.458, 24.322)


class _Tok:
    eos_id = None


@pytest.fixture(scope='module')
def tree():
    jcfg = jax_mistral.MistralConfig(**TINY)
    return jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(0), jcfg))


def stagger_prompts(vocab=64, seed=1):
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(1, vocab, size=n)] for n in STAGGER_LENS]
    shared = [int(t) for t in rng.integers(1, vocab, size=8)]
    motif = [int(t) for t in rng.integers(1, vocab, size=4)]
    for i in (1, 3):
        prompts[i] = (motif * (1 + len(prompts[i]) // 4))[:len(prompts[i])]
    prompts[0] = shared + prompts[0]
    prompts[4] = shared + prompts[4]
    return prompts


def jax_engine(tree, **cfg):
    return JaxLLMEngine(
        jax_mistral.MistralConfig(**TINY), tree, _Tok(),
        JaxEngineConfig(attn_backend='xla', prefer_native_allocator=False, **{**ENGINE, **cfg}),
    )


def port_engine(tree, **cfg):
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    return LLMEngine(tcfg, params, _Tok(), EngineConfig(**{**ENGINE, **cfg}), device='cpu')


def run_jax_stagger(engine):
    rids = [
        engine.add_request(p, JaxSamplingParams(temperature=0.0, max_tokens=n))
        for p, n in zip(stagger_prompts(), STAGGER_OUT)
    ]
    engine._run_to_completion()
    return [engine._finished.pop(r).output_ids for r in rids]


def run_stagger(engine):
    return engine.generate_ids(
        stagger_prompts(),
        [SamplingParams(temperature=0.0, max_tokens=n) for n in STAGGER_OUT],
    )


CACHE_CHUNKED = {'enable_prefix_cache': True, 'prefill_chunk_tokens': 4}


@pytest.fixture(scope='module')
def jax_spec_tokens(tree):
    return run_jax_stagger(jax_engine(tree, draft_k=4, **CACHE_CHUNKED))


# ------------------------------------------------------------------ drafter
@pytest.mark.parametrize('ngram', [1, 2, 3])
def test_drafter_proposes_what_the_jax_drafter_proposes(ngram):
    rng = np.random.default_rng(ngram)
    for trial in range(20):
        motif = [int(t) for t in rng.integers(0, 12, size=int(rng.integers(2, 6)))]
        history = []
        while len(history) < 60:  # motifs with random noise between them
            history += motif if rng.random() < 0.6 else [int(rng.integers(0, 12))]
        ours, theirs = PromptLookupDrafter(ngram), JaxDrafter(ngram)
        end = 0
        while end < len(history):
            # Incremental observation: the history grows by 1..4 tokens a call.
            end = min(len(history), end + int(rng.integers(1, 5)))
            k = int(rng.integers(0, 6))
            assert ours.draft(history[:end], k) == theirs.draft(history[:end], k), (trial, end)


def test_drafter_examples_and_bad_ngram():
    d = PromptLookupDrafter(ngram=2)
    assert d.draft([1, 2, 3, 9, 1, 2, 4, 7, 1, 2], 4) == [4, 7, 1, 2]  # most recent match
    assert PromptLookupDrafter(3).draft([1, 2], 4) == []
    assert PromptLookupDrafter(2).draft([1, 2, 3, 4], 3) == []  # terminal n-gram only
    for bad in (0, -1):
        with pytest.raises(ValueError, match='ngram'):
            PromptLookupDrafter(bad)


# ------------------------------------------------------------ verify_spans
def _spans(seed, b=6, s=5, v=48):
    """Random fp32 span logits and spans whose drafts partly follow the
    argmax (so accept lengths vary), with inactive and short rows."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(b, s, v)) * 2).astype(np.float32)
    argmax = logits.argmax(-1)
    ids = rng.integers(0, v, size=(b, s)).astype(np.int32)
    for row in range(b):
        keep = int(rng.integers(0, s))  # drafts 1..keep follow the argmax
        ids[row, 1:keep + 1] = argmax[row, :keep]
    lens = np.asarray([s, s, 3, 1, 0, s][:b], np.int32)
    positions = (rng.integers(3, 40, size=(b, 1)) + np.arange(s)).astype(np.int32)
    return logits, ids, lens, positions


@pytest.mark.parametrize('top_window', [0, 16])
@pytest.mark.parametrize('all_greedy', [False, True])
def test_verify_spans_greedy_rows_bitwise_equal_jax(top_window, all_greedy):
    logits, ids, lens, positions = _spans(0)
    b = logits.shape[0]
    zeros, ones = np.zeros(b, np.float32), np.ones(b, np.float32)
    top_k, seeds = np.zeros(b, np.int32), np.arange(b, dtype=np.uint32)
    want = np.asarray(jax_sampling.verify_spans(
        *(jnp.asarray(x) for x in (logits, ids, lens, positions, zeros, ones, zeros,
                                   top_k, seeds)),
        top_window=top_window,
    ))
    got = sampling.verify_spans(
        *(torch.from_numpy(x) for x in (logits, ids, lens, positions, zeros, ones,
                                        zeros, top_k, seeds.astype(np.int64))),
        top_window=top_window, all_greedy=all_greedy,
    )
    assert got.dtype == torch.int32 and got.shape == (b, logits.shape[1] + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, -1].max() > 0  # some drafts were accepted


def _verify_batch(row, draft, n, temperature=1.0, top_p=1.0, min_p=0.0, top_k=0,
                  top_window=0, seed0=0):
    """``n`` single-draft spans over the same logits row (position 0) and
    a second row (position 1), distinct seeds; returns packed ``[n, 3]``."""
    v = len(row)
    logits = torch.from_numpy(np.stack([row, row[::-1].copy()]))[None].expand(n, 2, v)
    full = lambda x, dt=torch.float32: torch.full((n,), x, dtype=dt)  # noqa: E731
    return sampling.verify_spans(
        logits.contiguous(), torch.tensor([[0, draft]] * n, dtype=torch.int32),
        full(2, torch.int32), torch.tensor([[3, 4]] * n, dtype=torch.int32),
        full(temperature), full(top_p), full(min_p), full(top_k, torch.int32),
        torch.arange(seed0, seed0 + n, dtype=torch.int64), top_window=top_window,
    ).numpy()


def _served(row, temperature=1.0, top_p=1.0, min_p=0.0, top_k=0, top_window=0):
    """The filtered target p~ as a dense [V] vector, through the JAX
    package's own filter."""
    filtered, idx = jax_sampling.filter_logits(
        jnp.asarray(row[None]), jnp.asarray([temperature]), jnp.asarray([top_p]),
        jnp.asarray([min_p]), jnp.asarray([top_k]), top_window=top_window,
    )
    filtered, idx = np.asarray(filtered)[0], np.asarray(idx)[0]
    p = np.zeros(len(row))
    finite = np.isfinite(filtered)
    p[idx[finite]] = np.exp(filtered[finite] - filtered[finite].max())
    return p / p.sum()


def _chi2(counts, p):
    assert counts[p == 0].sum() == 0, (counts, p)  # nothing outside the kept set
    kept = p > 0
    expected = p[kept] * counts.sum()
    return float(((counts[kept] - expected) ** 2 / expected).sum()), int(kept.sum())


ROW = np.asarray([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -1.5], np.float32)


@pytest.mark.parametrize('filt', [
    {}, {'temperature': 0.8, 'top_p': 0.9}, {'min_p': 0.1}, {'top_k': 5},
    {'top_window': 4}, {'temperature': 1.3, 'top_p': 0.95, 'top_k': 6},
], ids=['plain', 'top_p', 'min_p', 'top_k', 'top_window', 'combined'])
@pytest.mark.parametrize('draft', [0, 3])
def test_verify_spans_sampled_marginals_chi_square(filt, draft):
    """6000 single-draft spans (one seed each): the emitted first token
    is distributed as p~ whatever the draft (accepted w.p. p~(d), else the
    residual), and the bonus token after an accepted draft as the second
    position's p~; acceptance happens at rate p~(d)."""
    n = 6000
    packed = _verify_batch(ROW, draft, n, **filt)
    p = _served(ROW, **filt)
    chi2, kept = _chi2(np.bincount(packed[:, 0], minlength=8), p)
    assert chi2 < CHI2_CRIT[kept - 2], (chi2, p)
    accepted = packed[:, 2] == 1
    assert (packed[accepted, 0] == draft).all()
    # Binomial acceptance rate: within 4.5 standard deviations of p~(d).
    sd = np.sqrt(max(p[draft] * (1 - p[draft]), 1e-12) / n)
    assert abs(accepted.mean() - p[draft]) < 4.5 * sd + 1e-9
    if accepted.sum() > 500:
        p2 = _served(ROW[::-1].copy(), **filt)
        chi2, kept = _chi2(np.bincount(packed[accepted, 1], minlength=8), p2)
        assert chi2 < CHI2_CRIT[kept - 2], (chi2, p2)


def test_verify_spans_point_mass_edges():
    # top_k = 1 keeps the argmax alone: a draft of it is always accepted
    # (the residual is empty: the draw comes from p~ itself).
    packed = _verify_batch(ROW, 0, 500, top_k=1)
    assert (packed[:, 2] == 1).all() and (packed[:, 0] == 0).all()
    # A draft outside the kept set is never accepted.
    packed = _verify_batch(ROW, 7, 500, top_k=3)
    assert (packed[:, 2] == 0).all() and np.isin(packed[:, 0], [0, 1, 2]).all()


def test_verify_spans_sampled_rows_are_a_function_of_seed_and_position():
    a = _verify_batch(ROW, 2, 256)
    np.testing.assert_array_equal(a, _verify_batch(ROW, 2, 256))
    b = _verify_batch(ROW, 2, 256, seed0=1000)
    assert (a != b).any()


@pytest.mark.parametrize('top_window', [0, 16])
def test_span_one_verify_draws_the_decode_steps_token(top_window):
    rng = np.random.default_rng(9)
    b, v = 64, 48
    logits = torch.from_numpy((rng.normal(size=(b, v)) * 2).astype(np.float32))
    temperature = torch.from_numpy(rng.uniform(0.3, 1.5, size=b).astype(np.float32))
    top_p = torch.from_numpy(rng.choice([1.0, 0.9, 0.6], size=b).astype(np.float32))
    min_p = torch.from_numpy(rng.choice([0.0, 0.05], size=b).astype(np.float32))
    top_k = torch.from_numpy(rng.choice([0, 5, 20], size=b).astype(np.int32))
    seeds = torch.from_numpy(rng.integers(0, 2**32, size=b))
    pos = torch.from_numpy(rng.integers(0, 500, size=b))
    decode = sampling.sample_tokens(
        logits, temperature, top_p, min_p, sampling.fold_row_keys(seeds, pos + 1),
        top_window=top_window, top_k=top_k,
    )
    packed = sampling.verify_spans(
        logits[:, None], torch.from_numpy(rng.integers(0, v, size=(b, 1))),
        torch.ones(b, dtype=torch.int32), pos[:, None], temperature, top_p, min_p,
        top_k, seeds, top_window=top_window,
    )
    assert torch.equal(packed[:, 0], decode)
    assert (packed[:, 1] == 0).all()


# -------------------------------------------------------------- engines
def test_spec_tokens_equal_the_jax_engine_and_spec_off(tree, jax_spec_tokens):
    engine = port_engine(tree, draft_k=4, **CACHE_CHUNKED)
    plain = tpa.ragged_paged_attention_reference.launches
    on = run_stagger(engine)
    plain = tpa.ragged_paged_attention_reference.launches - plain
    assert on == jax_spec_tokens
    assert run_stagger(port_engine(tree, **CACHE_CHUNKED)) == on
    none = port_engine(tree, draft_k=4, spec_draft_source='none', **CACHE_CHUNKED)
    assert run_stagger(none) == on
    stats = engine.stats
    assert stats['spec_windows'] > 0 and stats['spec_draft_tokens'] > 0
    assert stats['spec_accepted_tokens'] > 0 and stats['prefill_chunks'] > 0
    assert none.stats['spec_draft_tokens'] == 0 and none.stats['spec_windows'] > 0
    # Every forward pass (prefill dispatches and verify passes) attended
    # once a layer through the plain op.
    assert stats['forward_passes'] == stats['prefill_dispatches'] + stats['spec_windows']
    assert plain == TINY['num_layers'] * stats['forward_passes']
    assert engine.sched.num_free_blocks + engine.prefix_cache.num_cached == 95


class _StubDrafter:
    """Proposals indexed by absolute history position."""

    def __init__(self, proposals):
        self.proposals = list(proposals)

    def draft(self, history, k):
        return self.proposals[len(history):len(history) + k]


def _reference(tree, prompt, n):
    out = port_engine(tree).generate_ids([prompt], SamplingParams(temperature=0.0, max_tokens=n))
    return out[0]


@pytest.mark.parametrize('case', ['all_accepted', 'none_accepted'])
def test_acceptance_edges_keep_the_reference_tokens(tree, case):
    prompt, n = [5, 9, 12], 9
    ref = _reference(tree, prompt, n)
    engine = port_engine(tree, draft_k=4)
    rid = engine.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=n))
    proposals = ref if case == 'all_accepted' else [(t + 1) % 64 for t in ref]
    engine._requests[rid].drafter = _StubDrafter([0] * len(prompt) + proposals + [0] * 8)
    while engine.has_unfinished:
        engine.step()
    assert engine._finished.pop(rid).output_ids == ref
    stats = engine.stats
    assert stats['spec_draft_tokens'] > 0
    if case == 'all_accepted':
        assert stats['spec_accepted_tokens'] == stats['spec_draft_tokens']
        assert stats['spec_windows'] < n - 1
    else:
        assert stats['spec_accepted_tokens'] == 0


def test_stop_token_inside_the_accepted_prefix(tree):
    prompt = [5, 9, 12]
    ref = _reference(tree, prompt, 8)
    stop = ref[3]
    engine = port_engine(tree, draft_k=4)
    rid = engine.add_request(
        prompt, SamplingParams(temperature=0.0, max_tokens=20, stop_token_ids=(stop,))
    )
    engine._requests[rid].drafter = _StubDrafter([0] * 3 + ref + [0] * 16)
    while engine.has_unfinished:
        engine.step()
    assert engine._finished.pop(rid).output_ids == ref[:ref.index(stop) + 1]


def test_preemption_mid_draft_keeps_tokens_and_blocks(tree):
    prompts = [[5, 9, 12], [7, 3, 22, 31], [1, 2, 3, 4, 5]]
    greedy = SamplingParams(temperature=0.0, max_tokens=12)
    want = port_engine(tree).generate_ids(prompts, greedy)
    # 9 usable blocks: three rows of up to 17 tokens + 4 drafts need 18.
    engine = port_engine(tree, draft_k=4, num_blocks=10, max_num_seqs=3, max_model_len=64)
    for i, prompt in enumerate(prompts):
        rid = engine.add_request(prompt, greedy)
        # Long always-wrong drafts: each window reserves 4 extra tokens a row.
        engine._requests[rid].drafter = _StubDrafter([63 - i] * 64)
    outs = {}
    while engine.has_unfinished:
        for rid, tok in engine.step():
            outs.setdefault(rid, []).append(tok)
    assert [outs[r] for r in sorted(outs)] == want
    assert engine.stats['preemptions'] > 0
    assert engine.sched.num_free_blocks == 9  # no block leaks


def test_rejected_suffix_rolls_back_to_the_never_drafted_state(tree):
    """After windows whose drafts are all rejected, block rows, the free
    list (content and order) and prefix-cache refcounts equal a
    never-drafted run's (per-row reservation + ``sched.trim``)."""
    prompt = [5, 9, 12, 4, 7, 3, 22, 31]  # two full blocks for the cache
    ref = _reference(tree, prompt, 8)

    def two_windows(draft_k):
        engine = port_engine(tree, draft_k=draft_k, enable_prefix_cache=True, decode_steps=1)
        rid = engine.add_request(prompt, SamplingParams(temperature=0.0, max_tokens=8))
        if draft_k:
            engine._requests[rid].drafter = _StubDrafter(
                [0] * len(prompt) + [(t + 1) % 64 for t in ref] + [1] * 8)
        for _ in range(2):  # each: admission (+ prefill), then a window
            engine.step()
        return engine, rid

    spec, a = two_windows(4)
    base, b = two_windows(0)
    assert spec.stats['spec_draft_tokens'] > 0 and spec.stats['spec_accepted_tokens'] == 0
    assert spec._requests[a].output_ids == base._requests[b].output_ids
    assert spec.sched.block_row(a) == base.sched.block_row(b)
    assert spec.sched.free_list() == base.sched.free_list()
    pa, pb = spec.prefix_cache, base.prefix_cache
    assert set(pa._entries) == set(pb._entries)
    for digest, entry in pa._entries.items():
        assert entry.refcount == pb._entries[digest].refcount


def test_sampled_rows_draft_and_are_deterministic_per_seed(tree):
    prompt = [5, 9, 12, 5, 9, 12, 5, 9]

    def run(seed):
        engine = port_engine(tree, draft_k=4)
        rid = engine.add_request(
            prompt, SamplingParams(temperature=0.9, top_p=0.95, max_tokens=12, seed=seed))
        assert engine._requests[rid].drafter is not None
        engine._requests[rid].drafter = _StubDrafter([7] * 64)
        while engine.has_unfinished:
            engine.step()
        return engine._finished.pop(rid).output_ids, engine.stats

    first, stats = run(3)
    assert len(first) == 12 and run(3)[0] == first
    assert stats['spec_sampled_rows'] > 0 and stats['spec_draft_tokens'] > 0
    assert stats['spec_resampled_tokens'] > 0
    assert run(4)[0] != first


# ------------------------------------------------------- int8 KV pool
def test_a_rejected_span_write_requantizes_live_codes_as_jax_does():
    """A span of [live token, rejected drafts] written over an int8 block
    grows its scale past the live token's, and the live codes are
    re-expressed at it: the same codes and scales in both packages."""
    rng = np.random.default_rng(4)
    nb, bs, nkv, hd = 4, 4, 2, 8
    data = rng.integers(-127, 128, size=(nb, bs, nkv, hd)).astype(np.int8)
    scale = rng.uniform(0.01, 0.02, size=(nb, nkv)).astype(np.float32)
    new = (rng.normal(size=(1, 3, nkv, hd)) * np.asarray([1, 5, 5])[None, :, None, None]).astype(np.float32)
    bt = np.asarray([[2, 3]], np.int32)
    pos = np.asarray([[1, 2, 3]], np.int32)
    valid = np.ones((1, 3), bool)
    ours = tpa.QuantizedKV(torch.from_numpy(data.copy()), torch.from_numpy(scale.copy()))
    tpa.write_chunk_kv(ours, ours, torch.from_numpy(new), torch.from_numpy(new),
                       torch.from_numpy(bt), torch.from_numpy(pos), torch.from_numpy(valid))
    jq = jax_pa.QuantizedKV(jnp.asarray(data), jnp.asarray(scale))
    theirs, _ = jax_pa.write_chunk_kv(jq, jq, jnp.asarray(new), jnp.asarray(new),
                                      jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(valid))
    np.testing.assert_array_equal(ours.data[1:].numpy(), np.asarray(theirs.data)[1:])
    np.testing.assert_array_equal(ours.scale[1:].numpy(), np.asarray(theirs.scale)[1:])
    assert (ours.scale[2] > torch.from_numpy(scale[2])).all()  # the drafts grew it
    assert (ours.data[2, 0] != torch.from_numpy(data[2, 0])).any()  # live codes moved


def test_int8_pool_spec_tokens_equal_the_jax_engine(tree):
    cfg = dict(draft_k=4, kv_cache_dtype='int8', **CACHE_CHUNKED)
    want = run_jax_stagger(jax_engine(tree, **cfg))
    engine = port_engine(tree, **cfg)
    assert run_stagger(engine) == want
    assert engine.stats['spec_accepted_tokens'] > 0


# ---------------------------------------------------- the verify runner
def _verify_inputs(tree, b=3, s=5):
    """A pool with KV history, and one verify window's spans over it."""
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    rng = np.random.default_rng(11)
    shape = (TINY['num_layers'], 24, 4, TINY['num_kv_heads'], 8)
    k = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    bt = np.zeros((b, 6), np.int32)
    bt[0, :5], bt[1, :4] = [3, 7, 1, 9, 12], [2, 5, 6, 8]
    lens = np.asarray([s, 2, 0], np.int32)
    start = np.asarray([13, 9, 0], np.int32)
    positions = (start[:, None] + np.arange(s)).astype(np.int32)
    ids = rng.integers(1, 64, size=(b, s)).astype(np.int32)
    ctx = np.maximum(start + lens, 1).astype(np.int32)
    sampling_in = (np.asarray([0.0, 0.9, 0.0], np.float32), np.asarray([1.0, 0.9, 1.0], np.float32),
                   np.zeros(b, np.float32), np.asarray([0, 8, 0], np.int32),
                   np.asarray([5, 6, 7], np.int64))
    return tcfg, params, k, v, (ids, positions, bt, ctx, lens), sampling_in


@pytest.mark.parametrize('all_greedy', [True, False])
def test_verify_runner_step_equals_spec_window(tree, all_greedy):
    tcfg, params, k, v, spans, samp = _verify_inputs(tree)
    if all_greedy:
        samp = (np.zeros(3, np.float32),) + samp[1:]
    t = torch.from_numpy
    k0, v0 = k.numpy().copy(), v.numpy().copy()
    k_loop, v_loop = k.clone(), v.clone()
    ids, positions, bt, ctx, lens = spans
    want, _, _, _ = mistral.spec_window(
        params, tcfg, t(ids), t(positions), k_loop, v_loop, t(bt), t(ctx), t(lens),
        *(t(x) for x in samp), max_table_positions=64, all_greedy=all_greedy,
    )
    runner = decode_graph.VerifyGraphRunner(
        params, tcfg, k, v, max_num_seqs=3, max_blocks_per_seq=6, span=5,
        max_table_positions=64, attn_backend='auto', device=torch.device('cpu'),
    )
    assert runner.ready
    runner.load(*spans, *samp)
    got = runner.run(all_greedy)
    # Rows 0-1 are live (row 2 is an inactive slot: garbage by contract).
    assert got.shape == (3, 6) and torch.equal(got[:2], want[:2])
    assert torch.equal(k[:, 1:], k_loop[:, 1:]) and torch.equal(v[:, 1:], v_loop[:, 1:])
    # The JAX spec_window on the same pool: greedy rows' packed results
    # exactly, the pool writes within fp32 tolerance (atol 1e-5, rtol 1e-4).
    jpacked, jk, _, _ = jax_mistral.spec_window(
        tree, jax_mistral.MistralConfig(**TINY), jnp.asarray(ids), jnp.asarray(positions),
        jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(bt), jnp.asarray(ctx),
        jnp.asarray(lens), *(jnp.asarray(x) for x in samp[:4]),
        jnp.asarray(samp[4].astype(np.uint32)), max_table_positions=64,
    )
    greedy = np.flatnonzero(samp[0][:2] <= 0)
    np.testing.assert_array_equal(got.numpy()[greedy], np.asarray(jpacked)[greedy])
    np.testing.assert_allclose(k.numpy()[:, 1:], np.asarray(jk)[:, 1:], atol=1e-5, rtol=1e-4)


def test_verify_runner_counts_what_a_capture_records(tree):
    """A capture records each counter's change and takes it back; a
    replay adds it once: one plain-op call a layer per verify pass."""

    class _FakeGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    tcfg, params, k, v, spans, samp = _verify_inputs(tree)
    runner = decode_graph.VerifyGraphRunner(
        params, tcfg, k, v, max_num_seqs=3, max_blocks_per_seq=6, span=5,
        max_table_positions=64, attn_backend='auto', device=torch.device('cpu'),
    )
    runner.load(*spans, *samp)
    before = decode_graph.read_counters()
    captured = decode_graph.capture_step(lambda: runner._step(False), _FakeGraph(), nullcontext())
    assert decode_graph.read_counters() == before
    plain = tpa.ragged_paged_attention_reference.launches
    captured.replay()
    assert tpa.ragged_paged_attention_reference.launches - plain == TINY['num_layers']
    assert tpa.ragged_paged_attention.launches == before[0]  # no kernel on the CPU
