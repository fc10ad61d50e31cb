"""The pipelined loop's modes against the JAX engine, and its recovery.

At ``pipeline_depth`` 2 on the tiny fp32 model of
``tests/test_torch_pipeline.py`` (stop ids inside windows): ``defer_prefill``
(first tokens scattered into the decode carry and fetched with the
windows), chunked tails, the prefix cache with hits, mixed windows riding
chunk rows, and recompute preemption under a tight pool each give the JAX
engine's greedy tokens, its ``overshoot_tokens`` and its window count.
Recovery and the validators are in ``tests/test_torch_pipeline_recovery.py``.
"""

import pytest

from distllm_tpu.observability import instruments as jax_instruments
from distllm_tpu_torch.generate.engine import SamplingParams
from distllm_tpu_torch.observability import instruments
from tests.test_torch_pipeline import (  # noqa: F401 (fixtures)
    BASE,
    MAX_TOKENS,
    jax_engine,
    port_engine,
    prompts,
    run_both,
    stops,
    weights,
)

DEPTH2 = {**BASE, 'decode_steps': 4, 'pipeline_depth': 2}
MODES = {
    'defer_prefill': {'defer_prefill': True},
    'chunked': {'prefill_chunk_tokens': 4},
    'mixed': {'enable_prefix_cache': True, 'enable_mixed_batching': True,
              'prefill_chunk_tokens': 4},
    'preemption': {'num_blocks': 10},
}


@pytest.mark.parametrize('mode', sorted(MODES))
def test_modes_give_the_jax_tokens_and_overshoot(weights, prompts, stops, mode):
    config = {**DEPTH2, **MODES[mode]}
    preempted = (instruments.SCHED_PREEMPTIONS.value, jax_instruments.SCHED_PREEMPTIONS.value)
    (out, port), (ref_out, ref) = run_both(weights, prompts, config, stops)
    assert out == ref_out
    for key in ('overshoot_tokens', 'decode_windows', 'mixed_windows'):
        assert port.telemetry.get(key, 0) == ref.telemetry.get(key, 0), key
    assert port.telemetry.get('overshoot_tokens', 0) > 0
    # The JAX engine counts preemptions in the series only.
    assert (instruments.SCHED_PREEMPTIONS.value - preempted[0]
            == jax_instruments.SCHED_PREEMPTIONS.value - preempted[1]
            == port.telemetry.get('preemptions', 0))
    if mode == 'preemption':
        assert port.telemetry['preemptions'] > 0
    if mode == 'mixed':
        assert port.telemetry['mixed_windows'] > 0
    assert port.sched.num_free_blocks + (port.prefix_cache.num_cached if port.prefix_cache else 0) \
        == config['num_blocks'] - 1
    assert not any(port._unacked.values())


def test_prefix_cache_hits_give_the_jax_tokens(weights, prompts, stops):
    """Hits are decided at add_request: a first run warms the cache."""
    config = {**DEPTH2, 'enable_prefix_cache': True}
    shared = [prompts[3][:8] + p for p in prompts]
    port, ref = port_engine(weights, **config), jax_engine(weights, **config)
    sampling = dict(temperature=0.0, max_tokens=MAX_TOKENS, stop_token_ids=stops)
    from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams

    assert port.generate_ids(shared[:1], SamplingParams(**sampling)) == ref.generate_ids(
        shared[:1], JaxSamplingParams(**sampling))
    out = port.generate_ids(shared[1:], SamplingParams(**sampling))
    assert out == ref.generate_ids(shared[1:], JaxSamplingParams(**sampling))
    assert port.telemetry['prefix_hit_tokens'] == ref.telemetry['prefix_hit_tokens'] > 0
    assert port.telemetry.get('overshoot_tokens', 0) == ref.telemetry.get('overshoot_tokens', 0)
