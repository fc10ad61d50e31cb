"""The port's resilience layer against the JAX package's, on the CPU.

- ``resilience.admission``: ``predict_ttft`` and ``shed_decision`` give
  JAX's numbers exactly over a seeded grid of load views.
- ``resilience.faults``: ``parse_fault_spec`` parses and refuses as JAX's;
  for the same arming and the same call sequence ``FaultInjector`` fires
  the same pattern (schedules, seeded probabilities, unlimited sites).
- The engine, a tiny fp32 Mistral served through ``step()`` in a burst
  (every request added at once, so batches are fixed by admission order):
  a ``dispatch`` fault in each of the four dispatch kinds (prefill, decode
  window, mixed window, verify window) recovers to the fault-free tokens;
  ``dispatch(times=2)`` with ``max_dispatch_retries=3`` gives the JAX
  engine's tokens; more fires than the budget fail the involved requests
  as JAX's engine fails them; a permanent fault (what a sticky device
  error looks like) drains every request into ``FAILED`` and returns;
  deadlines time requests out as JAX's and leave every block free; the
  ``sched_exhausted``, ``device_put`` and ``tier_io`` sites degrade as
  JAX's do; admission control sheds the JAX engine's arrivals with the
  JAX predictions.
"""

import sys

import numpy as np
import pytest

from distllm_tpu.generate.engine import RequestState as JaxRequestState
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.generate.engine.kv_cache import DiskKVTier as JaxDiskKVTier
from distllm_tpu.resilience import EngineOverloaded as JaxEngineOverloaded
from distllm_tpu.resilience import admission as jax_admission
from distllm_tpu.resilience import faults as jax_faults
from distllm_tpu_torch.generate.engine import RequestState, SamplingParams
from distllm_tpu_torch.generate.engine.kv_cache import DiskKVTier
from distllm_tpu_torch.observability import instruments
from distllm_tpu_torch.resilience import EngineOverloaded, admission, faults
from test_torch_observability import jax_engine, jax_tree, port_engine, serve  # noqa: F401

RECOVER = dict(max_dispatch_retries=3, retry_backoff_s=0.0)
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [5, 6, 7, 8, 9, 10, 11], [3, 3, 4, 5, 6, 7]]
GREEDY = SamplingParams(temperature=0.0, max_tokens=6)
JAX_GREEDY = JaxSamplingParams(temperature=0.0, max_tokens=6)
# Budgets that differ, so a slot frees while another request decodes and
# a later admission rides windows (mixed) or drafts against a live batch.
STAGGERED = [SamplingParams(temperature=0.0, max_tokens=n) for n in (2, 12, 6, 6)]


@pytest.fixture
def injectors():
    """Both packages' process injectors, inert before and after."""
    port, ref = faults.get_fault_injector(), jax_faults.get_fault_injector()
    port.disarm()
    ref.disarm()
    yield port, ref
    port.disarm()
    ref.disarm()


# ---------------------------------------------------------------- admission
def _views(mod, seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        yield mod.EngineLoadView(
            waiting_tokens=int(rng.integers(0, 5000)),
            pending_decode_tokens=int(rng.integers(-2, 3000)),
            num_waiting=int(rng.integers(0, 50)),
            num_running=int(rng.integers(0, 32)),
            max_num_seqs=int(rng.integers(0, 64)),
            decode_steps=int(rng.integers(0, 32)),
            prefill_s_per_token=float(rng.choice([-1e-4, 0.0, 1e-5, 3e-4])),
            window_s=float(rng.choice([-0.1, 0.0, 0.02, 0.4])),
            slo_s=float(rng.choice([0.0, 0.1, 1.0, 30.0])),
        ), int(rng.integers(1, 4096))


def test_predict_ttft_and_shed_decision_equal_jax():
    for (view, n), (jview, jn) in zip(_views(admission, 0), _views(jax_admission, 0)):
        assert admission.predict_ttft(view, n) == jax_admission.predict_ttft(jview, jn)
        assert admission.shed_decision(view, n) == jax_admission.shed_decision(jview, jn)
    exc, jexc = EngineOverloaded(1.5, 3.0, 0.5), JaxEngineOverloaded(1.5, 3.0, 0.5)
    assert str(exc) == str(jexc)
    assert (exc.predicted_ttft_s, exc.retry_after_s, exc.slo_s) == (1.5, 3.0, 0.5)


# ------------------------------------------------------------------- faults
SPECS = [
    'dispatch', 'dispatch:times=2:after=4,slow_window:delay_s=0.2',
    ' tier_io:times=inf , device_put:prob=0.5:seed=7', 'sched_exhausted:times=-1',
    '', ',,', 'dispatch:after=3:times=0',
]
BAD_SPECS = ['dispath', 'dispatch:when=3', 'dispatch:times=x', 'slow_window:delay_s=']


def test_parse_fault_spec_equals_jax():
    for spec in SPECS:
        assert faults.parse_fault_spec(spec) == jax_faults.parse_fault_spec(spec), spec
    for spec in BAD_SPECS:
        with pytest.raises(ValueError):
            faults.parse_fault_spec(spec)
        with pytest.raises(ValueError):
            jax_faults.parse_fault_spec(spec)
    assert faults.FAULT_SITES == jax_faults.FAULT_SITES


ARMINGS = [
    dict(times=1), dict(times=3, after=2), dict(times=None), dict(times=None, prob=0.3, seed=1),
    dict(times=5, prob=0.5, seed=11, after=4), dict(times=0), dict(times=2, prob=0.0),
]


@pytest.mark.parametrize('arming', ARMINGS, ids=[str(a) for a in ARMINGS])
def test_fault_injector_fires_the_jax_pattern(arming):
    port, ref = faults.FaultInjector(), jax_faults.FaultInjector()
    rng = np.random.default_rng(3)
    sites = sorted(faults.FAULT_SITES)
    for injector in (port, ref):
        injector.arm('dispatch', **arming)
        injector.arm('tier_io', times=2, after=1)
    pattern = {id(port): [], id(ref): []}
    for site in rng.choice(sites, size=120):
        for injector in (port, ref):
            pattern[id(injector)].append(injector.fire(str(site)) is not None)
    assert pattern[id(port)] == pattern[id(ref)]
    for site in sites:
        assert port.fired(site) == ref.fired(site)
    assert port.fired() == ref.fired()
    port.disarm('dispatch')
    ref.disarm('dispatch')
    assert (port.armed, port.fired('dispatch')) == (ref.armed, ref.fired('dispatch'))
    with pytest.raises(ValueError):
        port.arm('nowhere')
    with pytest.raises(ValueError):
        port.arm('dispatch', prob=1.5)


def test_fail_fail_io_and_sleep_as_jax():
    for mod in (faults, jax_faults):
        injector = mod.FaultInjector(env_spec='dispatch:times=1,tier_io:times=1,slow_window:delay_s=0.01')
        with pytest.raises(mod.InjectedFault) as exc:
            injector.fail('dispatch')
        assert exc.value.site == 'dispatch'
        injector.fail('dispatch')  # spent
        with pytest.raises(OSError):
            injector.fail_io('tier_io')
        assert injector.maybe_sleep('slow_window') == 0.01
        assert injector.maybe_sleep('slow_window') == 0.0


# ------------------------------------------------------------------- engine
def _tokens(finished):
    return [r.output_ids for r in finished]


def _spy_visits(monkeypatch, injector, engine, log):
    """Record each visit to the ``dispatch`` site: the engine method that
    made it and whether chunk rows were pending (a mixed window)."""
    fail = type(injector).fail.__get__(injector)

    def spy(site, message=''):
        if site == 'dispatch':
            log.append((sys._getframe(1).f_code.co_name, bool(engine._prefilling)))
        fail(site, message)

    monkeypatch.setattr(injector, 'fail', spy)


KINDS = {
    'prefill': ('_dispatch_prefill_paged', False, {}),
    'decode': ('_dispatch_window', False, {}),
    'mixed': ('_dispatch_window', True, dict(enable_prefix_cache=True, enable_mixed_batching=True,
                                             prefill_chunk_tokens=2, decode_steps=2)),
    'spec': ('_dispatch_spec_window', False, dict(draft_k=2)),
}


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_a_fault_in_each_dispatch_kind_recovers(jax_tree, injectors, monkeypatch, kind):
    """The first visit of the kind faults twice; the step rolls its host
    state back and the retries land on the fault-free tokens."""
    port, _ = injectors
    method, mixed, knobs = KINDS[kind]
    clean_engine = port_engine(jax_tree, **knobs)
    log: list = []
    _spy_visits(monkeypatch, port, clean_engine, log)
    clean = _tokens(serve(clean_engine, PROMPTS, STAGGERED))
    first = next(i for i, (name, pending) in enumerate(log)
                 if name == method and (pending or not mixed))
    port.arm('dispatch', times=2, after=first)
    engine = port_engine(jax_tree, **knobs, **RECOVER)
    log.clear()
    _spy_visits(monkeypatch, port, engine, log)
    assert _tokens(serve(engine, PROMPTS, STAGGERED)) == clean
    assert port.fired('dispatch') == 2
    assert log[first][0] == method and log[first + 1][0] in (method, '_dispatch_prefill_paged')
    assert engine.stats['window_retries'] == 2 and engine.stats['recoveries'] >= 1
    assert not engine.stats['quarantined_requests']
    assert engine.sched.num_free_blocks + (
        engine.prefix_cache.num_cached if engine.prefix_cache else 0
    ) == engine.config.num_blocks - 1


def test_recovered_tokens_equal_jax(jax_tree, injectors):
    port, ref = injectors
    for injector in (port, ref):
        injector.arm('dispatch', times=2)
    engine = port_engine(jax_tree, **RECOVER)
    jengine = jax_engine(jax_tree, **RECOVER)
    got = _tokens(serve(engine, PROMPTS, GREEDY))
    want = _tokens(serve(jengine, PROMPTS, JAX_GREEDY))
    assert got == want
    assert engine.stats['window_retries'] >= 2
    assert engine.stats['window_retries'] == jengine._stats['window_retries']
    port.disarm()
    clean = _tokens(serve(port_engine(jax_tree), PROMPTS, GREEDY))
    assert got == clean


def test_over_budget_fails_the_involved_requests_as_jax(jax_tree, injectors):
    """Three fires against a budget of two: the first batch (both slots)
    is charged three times and quarantined; the others finish."""
    port, ref = injectors
    for injector in (port, ref):
        injector.arm('dispatch', times=3)
    engine = port_engine(jax_tree, max_dispatch_retries=2, retry_backoff_s=0.0)
    jengine = jax_engine(jax_tree, max_dispatch_retries=2, retry_backoff_s=0.0)
    got = serve(engine, PROMPTS, GREEDY)
    want = serve(jengine, PROMPTS, JAX_GREEDY)
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert [r.finish_reason for r in got] == ['dispatch_failed'] * 2 + ['length'] * 2
    assert [r.state is RequestState.FAILED for r in got] == [
        r.state is JaxRequestState.FAILED for r in want
    ]
    assert all(r.error for r in got[:2])
    assert _tokens(got) == _tokens(want)
    assert engine.sched.num_free_blocks == engine.config.num_blocks - 1
    assert engine.stats['quarantined_requests'] == 2


def test_a_permanent_fault_drains_every_request_into_failed(jax_tree, injectors):
    port, ref = injectors
    for injector in (port, ref):
        injector.arm('dispatch', times=None)
    engine = port_engine(jax_tree, max_dispatch_retries=1, retry_backoff_s=0.0)
    jengine = jax_engine(jax_tree, max_dispatch_retries=1, retry_backoff_s=0.0)
    got = serve(engine, PROMPTS, GREEDY)
    want = serve(jengine, PROMPTS, JAX_GREEDY)
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert {r.finish_reason for r in got} == {'dispatch_failed'}
    assert engine.sched.num_free_blocks == engine.config.num_blocks - 1
    assert engine.sched.num_running == 0 and not engine.has_unfinished


def test_recovery_off_raises(jax_tree, injectors):
    port, _ = injectors
    port.arm('dispatch', times=1)
    engine = port_engine(jax_tree)
    with pytest.raises(faults.InjectedFault):
        engine.generate_ids(PROMPTS, GREEDY)


def test_deadline_times_out_as_jax_and_frees(jax_tree, injectors):
    """One window stalls 1.3 s against a 1 s deadline: every request
    still live times out and frees its blocks; a fresh request then
    serves the fault-free tokens well inside its deadline."""
    port, ref = injectors
    long = SamplingParams(temperature=0.0, max_tokens=40)
    outcomes = {}
    for name, build, params, fresh_params, injector in (
        ('port', port_engine, long, GREEDY, port),
        ('jax', jax_engine, JaxSamplingParams(temperature=0.0, max_tokens=40), JAX_GREEDY, ref),
    ):
        engine = build(jax_tree, decode_steps=2, **RECOVER)
        serve(engine, PROMPTS + [[7, 7]], params)  # compiles every shape used
        engine.config.request_deadline_s = 1.0
        injector.arm('slow_window', times=1, delay_s=1.3)
        finished = serve(engine, PROMPTS[:2], params)
        injector.disarm()
        fresh = serve(engine, [[7, 7]], fresh_params)
        outcomes[name] = (
            [r.finish_reason for r in finished],
            [r.state.value for r in finished],
            engine.sched.num_free_blocks,
            fresh[0].finish_reason, fresh[0].output_ids,
        )
        assert all('request_deadline_s' in (r.error or '') for r in finished)
    assert outcomes['port'] == outcomes['jax']
    assert outcomes['port'][:3] == (['timeout'] * 2, ['failed'] * 2, 31)
    assert outcomes['port'][3] == 'length'


def test_sched_exhausted_recovers(jax_tree, injectors):
    port, _ = injectors
    clean = _tokens(serve(port_engine(jax_tree), PROMPTS, GREEDY))
    port.arm('sched_exhausted', times=2)
    engine = port_engine(jax_tree, **RECOVER)
    assert _tokens(serve(engine, PROMPTS, GREEDY)) == clean
    assert port.fired('sched_exhausted') == 2
    assert engine.stats['window_retries'] == 2


TIER_POOL = dict(num_blocks=12, max_num_seqs=2, max_model_len=48, enable_prefix_cache=True)
PROMPT_A, PROMPT_B = list(range(1, 25)), list(range(30, 54))


def test_device_put_fault_degrades_to_cold_prefill(jax_tree, injectors):
    port, _ = injectors
    engine = port_engine(jax_tree, host_kv_tier_bytes=64 << 20, **TIER_POOL)
    ref = port_engine(jax_tree, **TIER_POOL)
    errors = instruments.PREFIX_TIER_ERRORS.labels(tier='host').value
    port.arm('device_put', times=None)
    for prompt in (PROMPT_A, PROMPT_B, PROMPT_A):
        assert engine.generate_ids([prompt], GREEDY) == ref.generate_ids([prompt], GREEDY)
    assert engine.stats['tier_promotion_failures'] >= 1
    assert engine.stats['tier_promotions'] == 0
    assert instruments.PREFIX_TIER_ERRORS.labels(tier='host').value > errors


def test_tier_io_fault_degrades_to_a_miss_as_jax(tmp_path, injectors):
    port, ref = injectors
    k = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for mod_tier, injector, root in ((DiskKVTier, port, 'p'), (JaxDiskKVTier, ref, 'j')):
        tier = mod_tier(tmp_path / root, 1 << 20)
        injector.arm('tier_io', times=1)
        as_arg = k if mod_tier is JaxDiskKVTier else __import__('torch').from_numpy(k)
        assert tier.put(b'\x01' * 16, as_arg, as_arg) is False  # the write failed
        assert tier.put(b'\x01' * 16, as_arg, as_arg) is True
        injector.arm('tier_io', times=1)
        assert tier.get(b'\x01' * 16) is None  # the read failed: a miss, dropped
        assert tier.get(b'\x01' * 16) is None
        assert tier.num_blocks == 0


def test_tier_io_fault_keeps_tokens(jax_tree, injectors, tmp_path):
    port, _ = injectors
    engine = port_engine(jax_tree, host_kv_tier_bytes=2048,
                         disk_kv_tier_dir=str(tmp_path / 'tier'), **TIER_POOL)
    ref = port_engine(jax_tree, **TIER_POOL)
    port.arm('tier_io', times=None)
    for prompt in (PROMPT_A, PROMPT_B, PROMPT_A, PROMPT_B):
        assert engine.generate_ids([prompt], GREEDY) == ref.generate_ids([prompt], GREEDY)
    assert port.fired('tier_io') >= 1
    assert engine.kv_tier.disk.errors >= 1


def test_quarantine_after_a_promotion_releases_the_prefix_once(jax_tree, injectors):
    """A request whose tier promotion was adopted, then whose prefill kept
    failing: quarantine releases its cache references once, every block
    is either free or held by the cache, and the engine serves on."""
    port, _ = injectors
    engine = port_engine(jax_tree, host_kv_tier_bytes=64 << 20, max_dispatch_retries=1,
                         retry_backoff_s=0.0, **TIER_POOL)
    ref = port_engine(jax_tree, **TIER_POOL)
    for prompt in (PROMPT_A, PROMPT_B):
        engine.generate_ids([prompt], GREEDY)
    promotions = engine.stats['tier_promotions']
    port.arm('dispatch', times=None)
    (failed,) = serve(engine, [PROMPT_A], GREEDY)
    port.disarm()
    assert engine.stats['tier_promotions'] == promotions + 1
    assert failed.state is RequestState.FAILED and failed.finish_reason == 'dispatch_failed'
    cache = engine.prefix_cache
    assert cache.num_evictable == cache.num_cached
    assert engine.sched.num_free_blocks + cache.num_cached == engine.config.num_blocks - 1
    assert engine.generate_ids([PROMPT_A], GREEDY) == ref.generate_ids([PROMPT_A], GREEDY)


def test_admission_control_sheds_as_jax(jax_tree):
    """Cold engines (roofline floors on both sides: the same parameter
    counts over the same placeholder peaks) see the same burst: the same
    arrivals are admitted and shed, with JAX's predictions."""
    prompts = [list(range(1, 2 + 3 * i)) for i in range(12)]
    for slo in (1e-9, 2e-6, 8e-6, 1.0):
        engine = port_engine(jax_tree, ttft_slo_s=slo, admission_control=True)
        jengine = jax_engine(jax_tree, ttft_slo_s=slo, admission_control=True)
        seen = {}
        for name, eng, params, overloaded in (
            ('port', engine, GREEDY, EngineOverloaded),
            ('jax', jengine, JAX_GREEDY, JaxEngineOverloaded),
        ):
            decisions = []
            for prompt in prompts:
                try:
                    eng.add_request(prompt, params)
                    decisions.append(None)
                except overloaded as exc:
                    decisions.append((exc.predicted_ttft_s, exc.retry_after_s))
            seen[name] = decisions
        assert seen['port'] == seen['jax'], slo
        assert engine.stats['shed_requests'] == sum(d is not None for d in seen['port'])
        if slo == 1e-9:
            assert all(d is not None for d in seen['port'])
        if slo == 1.0:
            assert all(d is None for d in seen['port'])
    with pytest.raises(ValueError, match='ttft_slo_s'):
        port_engine(jax_tree, admission_control=True)
    # Flippable at run time, as in JAX.
    engine = port_engine(jax_tree, ttft_slo_s=1e-9, admission_control=True)
    engine.admission_control = False
    engine.add_request([1, 2, 3], GREEDY)
