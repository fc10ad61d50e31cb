"""The port's pipelined ``generate_ids`` against the JAX engine's.

``LLMEngine.generate_ids`` keeps ``pipeline_depth`` decode windows in
flight (``_serve_pipelined``). On one tiny fp32 model (bridged with
``params_from_jax``), block 4 and 3 slots for 7 prompts, the port at
``(decode_steps, pipeline_depth)`` in {(1, 1), (4, 1), (4, 3), (8, 2)} —
the settings ``tests/test_engine.py`` runs the JAX engine at — gives the
JAX engine's greedy tokens and its ``overshoot_tokens``, with stop ids
taken from a first run's outputs so that rows stop inside windows. The
depth-1 run takes no overshoot at one-step windows; deeper pipelines
discard what rows ran past their stop, and count it in
``distllm_engine_overshoot_tokens_total``. The JAX telemetry keys
(``decode_loop_s``, ``windows_per_s``, ``overshoot_frac``, ...) are
computed as the JAX engine computes them, and ``step()`` stays the
synchronous one-window API.
"""

import jax
import numpy as np
import pytest

from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig
from distllm_tpu.generate.engine import LLMEngine as JaxLLMEngine
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.observability import instruments

TINY = {
    'vocab_size': 128, 'hidden_size': 32, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 64, 'dtype': 'float32',
}
BASE = {'block_size': 4, 'num_blocks': 64, 'max_num_seqs': 3, 'max_model_len': 64}
MAX_TOKENS = 9
LENGTHS = (3, 11, 6, 17, 9, 5, 14)


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
    return [[int(t) for t in rng.integers(4, 128, size=n)] for n in LENGTHS]


def port_engine(weights, **config):
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(weights[1], tcfg, device='cpu')
    return LLMEngine(tcfg, params, _Tok(), EngineConfig(**config), device='cpu')


def jax_engine(weights, **config):
    return JaxLLMEngine(
        weights[0], weights[1], _Tok(),
        JaxEngineConfig(attn_backend='xla', prefer_native_allocator=False, **config),
    )


def run_both(weights, prompts, config, stops=(), max_tokens=MAX_TOKENS):
    """Serve ``prompts`` greedily on both engines; returns the port's and
    the JAX engine's ``(tokens, engine)``."""
    port = port_engine(weights, **config)
    out = port.generate_ids(
        prompts, SamplingParams(temperature=0.0, max_tokens=max_tokens, stop_token_ids=stops)
    )
    ref = jax_engine(weights, **config)
    ref_out = ref.generate_ids(
        prompts, JaxSamplingParams(temperature=0.0, max_tokens=max_tokens, stop_token_ids=stops)
    )
    return (out, port), (ref_out, ref)


@pytest.fixture(scope='module')
def stops(weights, prompts):
    """Two token ids the greedy streams emit at their fifth position, so
    those rows stop mid-window."""
    engine = port_engine(weights, decode_steps=4, pipeline_depth=1, **BASE)
    out = engine.generate_ids(prompts, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS))
    return tuple(sorted({o[4] for o in out if len(o) > 4}))[:2]


@pytest.mark.parametrize('steps, depth', [(1, 1), (4, 1), (4, 3), (8, 2)])
def test_depths_give_the_jax_tokens_and_overshoot(weights, prompts, stops, steps, depth):
    config = {**BASE, 'decode_steps': steps, 'pipeline_depth': depth}
    before = instruments.ENGINE_OVERSHOOT_TOKENS.value
    (out, port), (ref_out, ref) = run_both(weights, prompts, config, stops)
    assert out == ref_out
    overshoot = port.telemetry.get('overshoot_tokens', 0)
    assert overshoot == ref.telemetry.get('overshoot_tokens', 0)
    assert instruments.ENGINE_OVERSHOOT_TOKENS.value - before == overshoot
    assert port.telemetry['decode_windows'] == ref.telemetry['decode_windows']
    assert port.telemetry.get('overshoot_frac') == ref.telemetry.get('overshoot_frac')
    assert port.telemetry['pipeline_depth'] == depth
    if depth > 1 and steps > 1:
        assert overshoot > 0  # rows ran past their stop inside windows
    # Every block returns to the free list: nothing in flight is orphaned.
    assert port.sched.num_free_blocks == BASE['num_blocks'] - 1
    assert port._unacked == {}


def test_the_jax_telemetry_keys(weights, prompts, stops):
    """A second run over prompts sharing a cached 8-token prefix (hits are
    decided at add_request, so the first run warms the cache)."""
    config = {**BASE, 'decode_steps': 4, 'pipeline_depth': 2, 'enable_prefix_cache': True}
    shared = [prompts[3][:8] + p for p in prompts[:4]]
    port, ref = port_engine(weights, **config), jax_engine(weights, **config)
    sampling = dict(temperature=0.0, max_tokens=MAX_TOKENS, stop_token_ids=stops)
    port.generate_ids(shared[:1], SamplingParams(**sampling))
    ref.generate_ids(shared[:1], JaxSamplingParams(**sampling))
    out = port.generate_ids(shared[1:], SamplingParams(**sampling))
    assert out == ref.generate_ids(shared[1:], JaxSamplingParams(**sampling))
    jax_keys = {'decode_loop_s', 'windows_per_s', 'prefix_hit_rate', 'overshoot_frac'}
    assert jax_keys <= set(ref.telemetry) and jax_keys <= set(port.telemetry)
    assert port.telemetry['prefix_hit_rate'] == ref.telemetry['prefix_hit_rate'] > 0
    assert port.telemetry['overshoot_frac'] == ref.telemetry['overshoot_frac']
    loop_s = port.telemetry['loop_s']
    assert port.telemetry['decode_loop_s'] == round(loop_s, 3)
    assert port.telemetry['windows_per_s'] == round(port.telemetry['decode_windows'] / loop_s, 2)
    assert port.telemetry['tokens_per_s'] == port.telemetry['generated_tokens'] / loop_s


def test_step_stays_one_synchronous_window(weights, prompts):
    """``step()`` fetches its own window: nothing stays unacked between
    calls, whatever ``pipeline_depth`` says, and its tokens equal the
    pipelined run's."""
    engine = port_engine(weights, decode_steps=4, pipeline_depth=3, **BASE)
    sampling = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS)
    rids = [engine.add_request(p, sampling) for p in prompts]
    while engine.has_unfinished:
        engine.step()
        assert not any(engine._unacked.values())
    stepped = [engine._finished.pop(r).output_ids for r in rids]
    assert stepped == engine.generate_ids(prompts, sampling)
