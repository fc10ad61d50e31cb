"""The port's automatic prefix cache against the JAX package's (the twin of
``tests/test_prefix_cache.py``).

- ``block_digests`` are byte-equal to the JAX package's, and the port's
  ``PrefixCache`` makes the JAX one's decisions over the same sequence of
  acquires, inserts, releases and evictions.
- Engines: the same tiny fp32 model (``mistral.init(PRNGKey(0))`` bridged
  with ``params_from_jax``, block size 4) behind the JAX ``LLMEngine``
  (``attn_backend='xla'``) and the port's, both with
  ``enable_prefix_cache``: a request sharing a two-block prefix borrows
  those blocks and prefills only its tail; cache on and off give the same
  tokens across a shared-stem workload; an exact block-aligned repeat
  re-prefills its last token into a copy of the shared block
  (copy-on-write, in place); a small pool evicts cached blocks without
  leaking any; recompute preemption keeps borrowed prefixes. In each, the
  port's greedy fp32 tokens equal the JAX engine's (and the cache-off
  engine's), and its hit counts equal the JAX engine's.
- ``warmup()`` leaves the pool outside the trash block, the cache's state
  and the sampled streams as they were (the contract the JAX package's
  own warm-up test, which reads a field its engine no longer has, meant
  to pin).
"""

import jax
import numpy as np
import pytest
import torch

from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig
from distllm_tpu.generate.engine import LLMEngine as JaxLLMEngine
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.generate.engine import kv_cache as jkv
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
from distllm_tpu_torch.generate.engine import kv_cache as tkv
from distllm_tpu_torch.models import mistral

TINY = {
    'vocab_size': 64, 'hidden_size': 32, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 64, 'dtype': 'float32',
}
GREEDY = {'temperature': 0.0, 'max_tokens': 6}


class _Tok:
    eos_id = None


@pytest.fixture(scope='module')
def tree():
    jcfg = jax_mistral.MistralConfig(**TINY)
    return jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(0), jcfg))


def jax_engine(tree, **cfg):
    return JaxLLMEngine(
        jax_mistral.MistralConfig(**TINY), tree, _Tok(),
        JaxEngineConfig(block_size=4, attn_backend='xla', prefer_native_allocator=False, **cfg),
    )


def port_engine(tree, **cfg):
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    return LLMEngine(tcfg, params, _Tok(), EngineConfig(block_size=4, **cfg), device='cpu')


def run_both(jax_eng, port_eng, prompts, sampling=GREEDY):
    want = jax_eng.generate_ids(prompts, JaxSamplingParams(**sampling))
    got = port_eng.generate_ids(prompts, SamplingParams(**sampling))
    assert got == want
    return got


# ------------------------------------------------------------------ digests
@pytest.mark.parametrize('block_size', [1, 4, 16])
@pytest.mark.parametrize('length', [0, 3, 16, 37])
def test_block_digests_byte_equal_to_jax(block_size, length):
    rng = np.random.default_rng(length)
    prompt = [int(t) for t in rng.integers(0, 32000, size=length)]
    got = tkv.block_digests(prompt, block_size)
    assert got == jkv.block_digests(prompt, block_size)
    assert len(got) == length // block_size
    assert tkv.hash_block_tokens(None, prompt) == jkv.hash_block_tokens(None, prompt)


def test_prefix_cache_makes_the_jax_caches_decisions():
    """One sequence of operations through both classes: matches, hit
    counts, first-writer-wins, LRU eviction order and the counts."""
    digests = tkv.block_digests(list(range(40)), 4)
    caches = (tkv.PrefixCache(4), jkv.PrefixCache(4))
    ops = [
        ('insert', 0, 0, 11), ('insert', 0, 1, 12), ('insert', 0, 2, 13),
        ('insert', 1, 1, 99), ('acquire', 1, 4), ('release', 0), ('acquire', 2, 2),
        ('insert', 2, 5, 20), ('release', 1), ('evict', 2), ('match', 6), ('release', 2),
        ('evict', 5), ('acquire', 3, 6),
    ]
    for op in ops:
        results = []
        for cache in caches:
            if op[0] == 'insert':
                results.append(cache.insert(op[1], digests[op[2]], op[3]))
            elif op[0] == 'acquire':
                results.append(cache.acquire(op[1], digests[:op[2]]))
            elif op[0] == 'release':
                results.append(cache.release(op[1]))
            elif op[0] == 'evict':
                results.append(cache.evict_entries(op[1]))
            else:
                results.append(cache.match(digests[:op[1]]))
            results.append((cache.num_cached, cache.num_evictable, cache.num_shared))
        assert results[:2] == results[2:], op
    assert caches[0].stats == caches[1].stats


# ------------------------------------------------------------------ engines
SHARED = [7, 3, 22, 31, 40, 2, 17, 9]  # two full blocks at block size 4


def test_second_request_reuses_prefix_blocks(tree):
    j = jax_engine(tree, num_blocks=64, max_num_seqs=4, max_model_len=64,
                   enable_prefix_cache=True)
    p = port_engine(tree, num_blocks=64, max_num_seqs=4, max_model_len=64,
                    enable_prefix_cache=True)
    run_both(j, p, [SHARED + [11, 12]])
    assert p.prefix_cache.num_evictable == 2
    free_before = p.sched.num_free_blocks
    prompt = SHARED + [33, 34, 35]
    rid = p.add_request(prompt, SamplingParams(**GREEDY))
    request = p._requests[rid]
    assert request.num_cached_tokens == 8 and request.num_borrowed_blocks == 2
    while p.has_unfinished:
        p.step()
    out = p._finished.pop(rid).output_ids
    assert out == j.generate_ids([prompt], JaxSamplingParams(**GREEDY))[0]
    # Only the tail's blocks were allocated, and all came back.
    assert p.sched.num_free_blocks == free_before
    assert p.stats['prefix_hit_tokens'] == 8 == j._stats['prefix_hit_tokens']


def test_cache_on_off_identical_across_workload(tree):
    stem = list(range(1, 13))  # three full blocks
    prompts = [stem + [20 + i] for i in range(4)] + [[5, 9, 12], stem + [20]]
    cfg = dict(num_blocks=128, max_num_seqs=4, max_model_len=64)
    j = jax_engine(tree, enable_prefix_cache=True, **cfg)
    on = port_engine(tree, enable_prefix_cache=True, **cfg)
    off = port_engine(tree, **cfg)
    hits = 0
    for batch in (prompts[:4], prompts[4:]):
        outs = run_both(j, on, batch)
        assert off.generate_ids(batch, SamplingParams(**GREEDY)) == outs
        hits += on.telemetry.get('prefix_hit_tokens', 0)
        assert on.telemetry.get('prefix_hit_tokens', 0) == j.telemetry.get('prefix_hit_tokens', 0)
    assert hits > 0
    assert on.telemetry['prefix_lookup_tokens'] == len(prompts[4]) + len(prompts[5])
    assert 'prefix_hit_tokens' not in off.stats


def test_cow_on_aligned_full_cover_repeat(tree):
    j = jax_engine(tree, num_blocks=64, max_num_seqs=4, max_model_len=64,
                   enable_prefix_cache=True)
    p = port_engine(tree, num_blocks=64, max_num_seqs=4, max_model_len=64,
                    enable_prefix_cache=True)
    k_before = p.kv.k  # the pool tensors the decode graphs hold
    first = run_both(j, p, [SHARED])
    src = p.prefix_cache.match(tkv.block_digests(SHARED, 4))[-1]
    shared_block = p.kv.k[:, src].clone()
    second = run_both(j, p, [SHARED])
    assert first == second
    assert p.telemetry['prefix_cow_copies'] == 1 == j.telemetry['prefix_cow_copies']
    assert p.telemetry['prefix_hit_tokens'] == 7
    assert p.kv.k is k_before  # written in place, never rebound
    assert torch.equal(p.kv.k[:, src], shared_block)  # the shared block untouched


def test_eviction_under_pool_pressure_no_leaks(tree):
    cfg = dict(num_blocks=16, max_num_seqs=2, max_model_len=32, enable_prefix_cache=True)
    j, p = jax_engine(tree, **cfg), port_engine(tree, **cfg)
    rng = np.random.default_rng(7)
    sampling = {'temperature': 0.0, 'max_tokens': 4}
    for _ in range(10):
        run_both(j, p, [[int(t) for t in rng.integers(1, 64, size=9)]], sampling)
    assert p.sched.num_free_blocks + p.prefix_cache.num_cached == 15
    assert p.prefix_cache.stats['evictions'] > 0
    assert p.prefix_cache.stats == j.prefix_cache.stats
    assert p.stats['prefix_evicted_blocks'] == p.prefix_cache.stats['evictions']


def test_preemption_with_borrowed_prefixes(tree):
    cfg = dict(num_blocks=14, max_num_seqs=3, max_model_len=64, enable_prefix_cache=True)
    j, p = jax_engine(tree, **cfg), port_engine(tree, **cfg)
    stem = [7, 3, 22, 31]
    prompts = [stem + [5], stem + [9, 2], [1, 2, 3, 4, 5]]
    run_both(j, p, prompts)
    # A second pass over the same prompts meets their cached stems while
    # the pool runs dry mid-decode.
    run_both(j, p, prompts, {'temperature': 0.0, 'max_tokens': 20})
    assert p.stats['preemptions'] > 0
    assert p.sched.num_free_blocks + p.prefix_cache.num_cached == 13


def test_sampled_streams_equal_with_cache_on_and_off(tree):
    stem = list(range(1, 13))
    prompts = [stem + [20 + i] for i in range(3)]
    sampling = {'temperature': 0.8, 'top_p': 0.9, 'max_tokens': 6, 'seed': 5}
    cfg = dict(num_blocks=64, max_num_seqs=4, max_model_len=64)
    on = port_engine(tree, enable_prefix_cache=True, **cfg)
    off = port_engine(tree, **cfg)
    for _ in range(2):
        assert (on.generate_ids(prompts, SamplingParams(**sampling))
                == off.generate_ids(prompts, SamplingParams(**sampling)))
    assert on.telemetry['prefix_hit_tokens'] > 0


def test_warmup_leaves_cache_pool_and_streams_alone(tree):
    cfg = dict(num_blocks=64, max_num_seqs=4, max_model_len=64, enable_prefix_cache=True)
    warmed = port_engine(tree, **cfg)
    fresh = port_engine(tree, **cfg)
    prompt = [5, 9, 12, 4, 7, 1, 2, 3, 8]
    sampling = SamplingParams(temperature=0.8, max_tokens=6, seed=3)
    for engine in (warmed, fresh):
        engine.generate_ids([prompt], sampling)
    pool = [t.clone() for t in (warmed.kv.k, warmed.kv.v)]
    cached = warmed.prefix_cache.num_cached
    evictable = warmed.prefix_cache.num_evictable
    free = warmed.sched.num_free_blocks
    warmed.warmup()
    for before, after in zip(pool, (warmed.kv.k, warmed.kv.v)):
        assert torch.equal(before[:, 1:], after[:, 1:])
    assert (warmed.prefix_cache.num_cached, warmed.prefix_cache.num_evictable,
            warmed.sched.num_free_blocks) == (cached, evictable, free)
    assert warmed.sched.num_running == 0
    assert (warmed.generate_ids([prompt + [6]], sampling)
            == fresh.generate_ids([prompt + [6]], sampling))
    assert warmed.telemetry['prefix_hit_tokens'] == 8


def test_prefix_cache_off_by_default(tree):
    engine = port_engine(tree, num_blocks=16)
    assert engine.prefix_cache is None and engine.kv_tier is None
    assert engine.tier_summary() == {}


@pytest.mark.parametrize('flag', [None, True, False])
def test_generator_enable_prefix_cache_flag(flag):
    """``TorchGeneratorConfig.enable_prefix_cache`` (the JAX
    ``TpuGeneratorConfig`` field): None inherits ``EngineConfig``'s
    default (off); True serves repeated prompts from the cache."""
    from distllm_tpu_torch.generate.generators.torch_backend import (
        TorchGenerator,
        TorchGeneratorConfig,
    )

    config = TorchGeneratorConfig(
        model=mistral.MistralConfig(**TINY), temperature=0.0, max_tokens=3, block_size=4,
        num_blocks=32, max_num_seqs=2, max_model_len=64, device='cpu',
        enable_prefix_cache=flag,
    )
    generator = TorchGenerator(config)
    assert generator.engine.config.enable_prefix_cache is bool(flag)
    prompt = ' '.join(f'w{i}' for i in range(12))
    first = generator.generate([prompt])
    assert generator.generate([prompt]) == first
    hits = generator.engine.stats['prefix_hit_tokens']
    assert (hits > 0) is bool(flag)
