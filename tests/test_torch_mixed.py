"""Chunked prefill and mixed prefill+decode windows in the port against
the JAX package (the twin of the mixed cases of ``tests/test_engine.py``
and of ``tests/test_prefix_cache.py::test_chunked_prefill_matches_dense``).

Tiny fp32 Mistral (``mistral.init(PRNGKey(0))`` bridged with
``params_from_jax``), block size 4, the JAX engine's staggered workload
(more prompts than slots, unequal budgets, two prompts behind a shared
2-block prefix, long prompts that chunk). Tolerance: greedy tokens
identical; pools within the fp32 tolerance of
``tests/test_torch_mistral.py`` (``atol 1e-5``, ``rtol 1e-4``).

- ``mistral.mixed_window`` equals the JAX ``mixed_window`` on the same
  inputs (decode and chunk tokens exactly, pool writes within the fp32
  tolerance).
- Mixed on equals mixed off, and each equals the JAX engine with mixed
  on, with the prefix cache, chunked tails, both, and under a sliding
  window; the on arm rides windows and runs fewer standalone prefills.
- A request added mid-stream through ``step()`` rides windows; a pool
  too small for the batch preempts mid-prefill rows without changing a
  token or leaking a block; ``warmup()`` leaves pool, cache and streams
  alone; bad configs are refused; mixed windows compose with speculation
  (chunks ride verify windows).
- Chunked prefill gives the unchunked engine's tokens and pool and the
  JAX engine's tokens.
- ``TorchGeneratorConfig`` and a chat-server YAML carry the serving
  knobs to the engine.
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
from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
from distllm_tpu_torch.models import mistral

TINY = {
    'vocab_size': 64, 'hidden_size': 32, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 64, 'dtype': 'float32',
}
# The JAX mixed A/B engines (tests/test_engine.py::_mixed_ab_engines).
ENGINE = {
    'block_size': 4, 'num_blocks': 96, 'max_num_seqs': 2, 'max_model_len': 96,
    'decode_steps': 4, 'max_window_prefill_tokens': 8, 'max_window_prefill_seqs': 2,
}
STAGGER_LENS = (5, 21, 3, 33, 7, 13)
STAGGER_OUT = (3, 17, 9, 5, 12, 8)
ATOL, RTOL = 1e-5, 1e-4


class _Tok:
    eos_id = None


@pytest.fixture(scope='module')
def tree():
    return _tree(TINY)


def _tree(model):
    jcfg = jax_mistral.MistralConfig(**model)
    return jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(0), jcfg))


def stagger_prompts(vocab=64, seed=1):
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(1, vocab, size=n)] for n in STAGGER_LENS]
    shared = [int(t) for t in rng.integers(1, vocab, size=8)]
    prompts[0] = shared + prompts[0]
    prompts[4] = shared + prompts[4]
    return prompts


def jax_engine(tree, model=TINY, **cfg):
    return JaxLLMEngine(
        jax_mistral.MistralConfig(**model), tree, _Tok(),
        JaxEngineConfig(attn_backend='xla', prefer_native_allocator=False, **{**ENGINE, **cfg}),
    )


def port_engine(tree, model=TINY, **cfg):
    tcfg = mistral.MistralConfig(**model)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    return LLMEngine(tcfg, params, _Tok(), EngineConfig(**{**ENGINE, **cfg}), device='cpu')


def run_jax(engine, prompts=None, budgets=STAGGER_OUT):
    rids = [
        engine.add_request(p, JaxSamplingParams(temperature=0.0, max_tokens=n))
        for p, n in zip(prompts or stagger_prompts(), budgets)
    ]
    engine._run_to_completion()
    return [engine._finished.pop(r).output_ids for r in rids]


def run_port(engine, prompts=None, budgets=STAGGER_OUT):
    return engine.generate_ids(
        prompts or stagger_prompts(),
        [SamplingParams(temperature=0.0, max_tokens=n) for n in budgets],
    )


def _pools(engine):
    return [engine.kv.k.clone(), engine.kv.v.clone()]


# -------------------------------------------------------- the model twin
def test_mixed_window_equals_the_jax_mixed_window(tree):
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    rng = np.random.default_rng(2)
    shape = (2, 40, 4, 2, 8)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    b, mb = 3, 8
    bt = np.zeros((b, mb), np.int32)
    bt[0, :4], bt[1, :5] = [3, 4, 5, 6], [7, 8, 9, 10, 11]
    pos = np.asarray([9, 14, 0], np.int32)
    decode = (
        rng.integers(1, 64, size=b).astype(np.int32), pos, bt, pos + 1,
        np.asarray([3, 2, 0], np.int32), np.zeros(b, np.float32),
        np.ones(b, np.float32), np.zeros(b, np.float32), np.zeros(b, np.int32),
        np.asarray([1, 2, 3], np.int64),
    )
    cbt = np.zeros((2, mb), np.int32)
    cbt[0, :4] = [20, 21, 22, 23]
    c_pos = (4 + np.arange(8))[None].repeat(2, 0).astype(np.int32)
    chunk = (
        rng.integers(1, 64, size=(2, 8)).astype(np.int32), c_pos, cbt,
        np.asarray([11, 1], np.int32), np.asarray([7, 0], np.int32),
        np.zeros(2, np.float32), np.ones(2, np.float32), np.zeros(2, np.float32),
        np.zeros(2, np.int32), np.asarray([4, 0], np.int64),
    )
    t = torch.from_numpy
    k, v = t(k0.copy()), t(v0.copy())
    ids, positions, tables, ctx, steps, temp, top_p, min_p, top_k, seeds = decode
    tokens, _, _, last, chunk_tokens = mistral.mixed_window(
        params, tcfg, t(ids), t(positions), k, v, t(tables), t(ctx), t(steps),
        t(temp), t(top_p), t(min_p), t(top_k), t(seeds),
        tuple(t(x) for x in chunk), num_steps=3, max_table_positions=64,
    )
    j = jnp.asarray
    jt, jk, jv, _, jc = jax_mistral.mixed_window(
        tree, jax_mistral.MistralConfig(**TINY), j(ids), j(positions), j(k0), j(v0),
        j(tables), j(ctx), j(steps), j(temp), j(top_p), j(min_p), j(top_k),
        j(seeds.astype(np.uint32)), *(j(x) for x in chunk[:9]),
        j(chunk[9].astype(np.uint32)), num_steps=3, max_table_positions=64,
    )
    assert int(chunk_tokens[0]) == int(np.asarray(jc)[0])
    # The live decode rows (three and two steps; row 2 is dead), token for
    # token.
    np.testing.assert_array_equal(tokens[:3, 0].numpy(), np.asarray(jt)[:3, 0])
    np.testing.assert_array_equal(tokens[:2, 1].numpy(), np.asarray(jt)[:2, 1])
    for ours, theirs in ((k, jk), (v, jv)):
        np.testing.assert_allclose(ours[:, 1:].numpy(), np.asarray(theirs)[:, 1:],
                                   atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------- engines
@pytest.mark.parametrize('cache_kw', [
    {'enable_prefix_cache': True},
    {'enable_prefix_cache': True, 'prefill_chunk_tokens': 4},
    {'prefill_chunk_tokens': 4},
], ids=['prefix_cache', 'prefix_cache_chunked', 'chunked'])
def test_mixed_on_equals_off_and_the_jax_engine(tree, cache_kw):
    jax_on = jax_engine(tree, enable_mixed_batching=True, **cache_kw)
    on = port_engine(tree, enable_mixed_batching=True, **cache_kw)
    off = port_engine(tree, **cache_kw)
    passes = 2 if cache_kw.get('enable_prefix_cache') else 1
    # A second pass over the workload: the shared-prefix prompts are cache
    # hits then, the tails a cold batch never has.
    for _ in range(passes):
        want = run_jax(jax_on)
        assert run_port(on) == want
        assert run_port(off) == want
    assert on.stats['mixed_windows'] > 0 and on.stats['mixed_prefill_tokens'] > 0
    assert on.stats['prefill_dispatches'] < off.stats['prefill_dispatches']
    assert on.sched.num_free_blocks == off.sched.num_free_blocks
    assert not on._prefilling


def test_mixed_under_a_sliding_window(tree):
    model = {**TINY, 'sliding_window': 4}
    jtree = _tree(model)
    want = run_jax(jax_engine(jtree, model, enable_mixed_batching=True, prefill_chunk_tokens=4))
    on = port_engine(jtree, model, enable_mixed_batching=True, prefill_chunk_tokens=4)
    assert run_port(on) == want
    assert run_port(port_engine(jtree, model, prefill_chunk_tokens=4)) == want
    assert on.stats['mixed_windows'] > 0


def test_mid_stream_admission_through_step_rides_windows(tree):
    prompts = [[5, 9, 12], [7, 3, 22, 31], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]]
    budgets = [3, 14, 8]
    want = run_port(port_engine(tree), prompts, budgets)
    on = port_engine(tree, enable_mixed_batching=True, prefill_chunk_tokens=2)
    r1 = on.add_request(prompts[0], SamplingParams(temperature=0.0, max_tokens=budgets[0]))
    r2 = on.add_request(prompts[1], SamplingParams(temperature=0.0, max_tokens=budgets[1]))
    seen: dict[int, list[int]] = {}
    r3 = None
    while on.has_unfinished:
        for rid, tok in on.step():
            seen.setdefault(rid, []).append(tok)
        if r3 is None and len(seen.get(r1, [])) >= budgets[0]:
            r3 = on.add_request(prompts[2], SamplingParams(temperature=0.0, max_tokens=budgets[2]))
    assert [seen[r] for r in (r1, r2, r3)] == want
    assert on.stats['mixed_windows'] > 0


def test_preemption_of_mid_prefill_rows(tree):
    cfg = dict(num_blocks=20, max_num_seqs=3, max_model_len=64, prefill_chunk_tokens=4,
               enable_mixed_batching=True)
    want = run_jax(jax_engine(tree, **cfg))
    on = port_engine(tree, **cfg)
    assert run_port(on) == want
    assert on.stats['preemptions'] > 0 and on.stats['mixed_windows'] > 0
    assert on.sched.num_free_blocks == 19  # no block leaks


def test_warmup_leaves_pool_cache_and_streams_alone(tree):
    cfg = dict(enable_mixed_batching=True, prefill_chunk_tokens=4, enable_prefix_cache=True)
    engine = port_engine(tree, **cfg)
    prompts = stagger_prompts()
    run_port(engine, prompts[:3], (4, 4, 4))
    free, cached = engine.sched.num_free_blocks, engine.prefix_cache.num_cached
    pools = _pools(engine)
    engine.warmup()
    assert engine.sched.num_free_blocks == free and engine.prefix_cache.num_cached == cached
    for now, before in zip(_pools(engine), pools):
        assert torch.equal(now[:, 1:], before[:, 1:])
    sampled = [SamplingParams(temperature=0.8, max_tokens=6, seed=s) for s in range(3)]
    fresh = port_engine(tree, **cfg)
    run_port(fresh, prompts[:3], (4, 4, 4))
    assert engine.generate_ids(prompts[3:], sampled) == fresh.generate_ids(prompts[3:], sampled)


def test_mixed_and_spec_config_validation():
    with pytest.raises(ValueError, match='max_window_prefill_tokens'):
        EngineConfig(enable_mixed_batching=True, max_window_prefill_tokens=0,
                     prefill_chunk_tokens=16)
    with pytest.raises(ValueError, match='prefill_chunk_tokens'):
        EngineConfig(enable_mixed_batching=True)
    with pytest.raises(ValueError, match='max_window_prefill_seqs must be >= 1'):
        EngineConfig(max_window_prefill_seqs=0)
    for name in ('sampling_top_window', 'prefill_chunk_tokens', 'max_window_prefill_tokens',
                 'draft_k'):
        with pytest.raises(ValueError, match=f'{name} must be >= 0'):
            EngineConfig(**{name: -1})
    with pytest.raises(ValueError, match='spec_ngram'):
        EngineConfig(spec_ngram=0)
    with pytest.raises(ValueError, match='spec_draft_source'):
        EngineConfig(spec_draft_source='oracle')
    assert EngineConfig(draft_k=4, enable_mixed_batching=True, prefill_chunk_tokens=16).draft_k == 4


def test_mixed_windows_compose_with_speculation(tree):
    cfg = dict(enable_mixed_batching=True, enable_prefix_cache=True, prefill_chunk_tokens=4,
               draft_k=4)
    want = run_jax(jax_engine(tree, **cfg))
    on = port_engine(tree, **cfg)
    assert run_port(on) == want
    assert on.stats['spec_chunk_windows'] > 0 and on.stats['mixed_prefill_tokens'] > 0
    assert on.stats['spec_windows'] > 0
    assert run_port(port_engine(tree, enable_prefix_cache=True, prefill_chunk_tokens=4)) == want


# ------------------------------------------------------- chunked prefill
@pytest.mark.parametrize('extra', [{}, {'enable_prefix_cache': True}], ids=['plain', 'cache'])
def test_chunked_prefill_equals_unchunked_and_the_jax_engine(tree, extra):
    prompts = [list(range(1, 23)), [5, 9, 12], list(range(30, 47))]
    cfg = dict(num_blocks=128, max_num_seqs=3, **extra)
    want = run_jax(jax_engine(tree, prefill_chunk_tokens=8, **cfg), prompts, (6, 6, 6))
    chunked = port_engine(tree, prefill_chunk_tokens=8, **cfg)
    whole = port_engine(tree, **cfg)
    assert run_port(chunked, prompts, (6, 6, 6)) == want
    assert run_port(whole, prompts, (6, 6, 6)) == want
    assert chunked.stats['prefill_chunks'] >= 5  # 22 and 17 tokens in chunks of 8
    # The pools the two wrote (the same blocks: the schedulers agree).
    for a, b in zip(_pools(chunked), _pools(whole)):
        torch.testing.assert_close(a[:, 1:], b[:, 1:], atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------- entry points
def test_generator_config_and_chat_yaml_reach_the_engine(tmp_path):
    from distllm_tpu_torch.chat_server import load_app_config
    from distllm_tpu_torch.generate.generators.torch_backend import (
        TorchGenerator,
        TorchGeneratorConfig,
    )

    knobs = dict(draft_k=3, spec_ngram=3, enable_mixed_batching=True,
                 max_window_prefill_tokens=32, prefill_chunk_tokens=16,
                 sampling_top_window=8, decode_steps=4)
    (tmp_path / 'app.yaml').write_text(
        'system_prompt: You are terse.\n'
        'generator_config:\n'
        '  name: torch\n'
        '  temperature: 0.0\n  max_tokens: 5\n  num_blocks: 64\n  max_num_seqs: 2\n'
        '  max_model_len: 128\n  device: cpu\n'
        '  model: {vocab_size: 128, hidden_size: 32, num_layers: 2, num_heads: 4, '
        'num_kv_heads: 2, intermediate_size: 64, dtype: float32}\n'
        + ''.join(f'  {k}: {str(v).lower()}\n' for k, v in knobs.items())
    )
    config, system_prompt = load_app_config(str(tmp_path / 'app.yaml'))
    assert system_prompt == 'You are terse.'
    generator = TorchGenerator(config)
    engine_cfg = generator.engine.config
    for name, value in knobs.items():
        assert getattr(config, name) == value and getattr(engine_cfg, name) == value
    outs = generator.generate(['a b c a b c a b', 'd e f'])
    assert len(outs) == 2 and generator.engine.stats['spec_windows'] > 0
    generator.shutdown()
    # Unset knobs inherit the engine's defaults; refused values are refused.
    defaults = TorchGeneratorConfig(device='cpu').engine_config()
    assert defaults.draft_k == 0 and not defaults.enable_mixed_batching
    with pytest.raises(ValueError, match='draft_k'):
        TorchGeneratorConfig(draft_k=-1)
    with pytest.raises(ValueError, match='enable_mixed_batching needs'):
        TorchGeneratorConfig(enable_mixed_batching=True)
