"""The pipelined loop's recovery, on the tiny fp32 model of
``tests/test_torch_pipeline.py`` at ``pipeline_depth`` 2.

- A deadline that expires with windows in flight: the loop drains first,
  so no request is failed while it has unacked tokens, and every block is
  freed.
- A ``dispatch`` fault inside the loop, at several dispatches (prefills
  and windows alike): one retry, one recovery, the clean tokens.
- An abnormal drain: a window that cannot be folded back is dropped,
  recorded as an ``abnormal_drain`` flight event, and the retry still
  gives the clean tokens.
- The JAX validators that refuse ``defer_prefill`` with mixed windows and
  with speculation, and the JAX defaults of the new fields.
"""

import pytest

from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig
from distllm_tpu_torch.generate.engine import EngineConfig, SamplingParams
from distllm_tpu_torch.resilience.faults import get_fault_injector
from tests.test_torch_pipeline import (  # noqa: F401 (fixtures)
    BASE,
    MAX_TOKENS,
    port_engine,
    prompts,
    weights,
)

DEPTH2 = {**BASE, 'decode_steps': 4, 'pipeline_depth': 2}


def _clean(weights, prompts, config):
    engine = port_engine(weights, **config)
    return engine.generate_ids(prompts, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS))


def test_deadline_expiry_drains_the_windows_first(weights, prompts):
    injector = get_fault_injector()
    engine = port_engine(weights, **DEPTH2, request_deadline_s=0.25)
    failed_with_unacked = []
    fail = engine._fail_request

    def checked_fail(request, **kw):
        failed_with_unacked.append(engine._unacked.get(request.request_id, 0))
        fail(request, **kw)

    engine._fail_request = checked_fail
    injector.arm('slow_window', times=None, delay_s=0.05)
    try:
        out = engine.generate_ids(prompts, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS))
    finally:
        injector.disarm()
    assert len(out) == len(prompts)
    assert failed_with_unacked and not any(failed_with_unacked)
    assert engine.stats['quarantined_requests'] == len(failed_with_unacked)
    assert engine.sched.num_free_blocks == DEPTH2['num_blocks'] - 1
    assert not engine.has_unfinished


@pytest.mark.parametrize('after', [0, 2, 4, 6])
def test_a_dispatch_fault_in_the_loop_recovers_the_clean_tokens(weights, prompts, after):
    """A fault at the ``after``-th dispatch (prefills and windows alike):
    one retry, one recovery, the clean tokens. (The JAX engine, on this
    workload with ``after=4``, recovers into other tokens than its clean
    run's: a defect of the reference recorded in ROADMAP C, so its
    faulted run is not the yardstick here.)"""
    config = {**DEPTH2, 'max_dispatch_retries': 2, 'retry_backoff_s': 0.0}
    clean = _clean(weights, prompts, config)
    engine = port_engine(weights, **config)
    injector = get_fault_injector()
    injector.arm('dispatch', times=1, after=after)
    try:
        out = engine.generate_ids(prompts, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS))
    finally:
        injector.disarm()
    assert out == clean
    assert (engine.telemetry['window_retries'], engine.telemetry['recoveries']) == (1, 1)
    assert not any(engine._unacked.values())
    assert engine.sched.num_free_blocks == DEPTH2['num_blocks'] - 1


def test_an_abnormal_drain_is_recorded_and_recovered(weights, prompts):
    config = {**DEPTH2, 'max_dispatch_retries': 3, 'retry_backoff_s': 0.0}
    clean = _clean(weights, prompts, config)
    engine = port_engine(weights, **config)
    process = engine._process_window
    calls = {'n': 0}

    def flaky(window):
        calls['n'] += 1
        if calls['n'] in (3, 4):  # the loop's processing, then the drain's
            raise RuntimeError('window fetch failed')
        return process(window)

    engine._process_window = flaky
    before = engine.flight.total_recorded
    out = engine.generate_ids(prompts, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS))
    events = [r for r in engine.flight.snapshot()[-(engine.flight.total_recorded - before):]
              if r.get('event') == 'abnormal_drain']
    assert len(events) == 1 and events[0]['dropped_windows'] >= 1
    assert out == clean
    assert engine.sched.num_free_blocks == DEPTH2['num_blocks'] - 1


@pytest.mark.parametrize('fields', [
    {'enable_mixed_batching': True, 'enable_prefix_cache': True, 'defer_prefill': True},
    {'draft_k': 4, 'defer_prefill': True},
])
def test_the_jax_validator_pairs(fields):
    with pytest.raises(ValueError, match='defer_prefill'):
        JaxEngineConfig(**fields)
    with pytest.raises(ValueError, match='defer_prefill'):
        EngineConfig(**fields)
    ok = {k: v for k, v in fields.items() if k != 'defer_prefill'}
    EngineConfig(**ok)
    EngineConfig(defer_prefill=True)
    # The port's default depth is 1 (measured faster on the H100's
    # device-bound loop), JAX's 2; both take any depth.
    assert EngineConfig().pipeline_depth == 1
    assert JaxEngineConfig().pipeline_depth == 2
    assert EngineConfig().defer_prefill is JaxEngineConfig().defer_prefill is False
    # The port takes the Python scheduler unless asked (its native twin
    # costs the host more a step on the H100's machine); JAX the native.
    assert EngineConfig().prefer_native_allocator is False
    assert JaxEngineConfig().prefer_native_allocator is True
