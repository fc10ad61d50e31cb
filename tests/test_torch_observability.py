"""The port's observability layer against the JAX package's, on the CPU.

- ``observability.metrics``: for the same instruments and the same seeded
  observations, the Prometheus exposition is byte for byte the JAX one;
  ``log_buckets`` and ``quantile_from_cumulative`` give equal numbers over
  a seeded grid.
- ``observability.instruments``: the catalogue equals JAX's in names,
  types, help text, label names and buckets, and
  ``FLIGHT_KINDS`` and the label tuples are equal.
- ``observability.tracing`` and ``observability.flight``: request scopes,
  span nesting and the ring's eviction behave as JAX's.
- ``observability.roofline``: ``CostModel`` over a parameter tree bridged
  with ``params_from_jax`` (float, int8 and nf4) prices every step kind as
  JAX's; the H100 row and the env overrides.
- The engine's lifecycle and step records: a tiny fp32 Mistral served
  through ``step()`` on both sides records the same kinds of flight
  records with the same keys (a port prefill record adds ``fetch_s``), one ``'request'`` record and one TTFT /
  queue-wait observation per request, and attribution off and on give
  identical tokens.
"""

import jax
import numpy as np
import pytest

from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig
from distllm_tpu.generate.engine import LLMEngine as JaxLLMEngine
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu.observability import flight as jax_flight
from distllm_tpu.observability import instruments as jax_instruments
from distllm_tpu.observability import metrics as jax_metrics
from distllm_tpu.observability import roofline as jax_roofline
from distllm_tpu.observability import tracing as jax_tracing
from distllm_tpu.ops import quantization as jax_quant
from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.observability import flight, instruments, metrics, roofline, tracing
from distllm_tpu_torch.ops import quantization as tq

TINY = {
    'vocab_size': 64, 'hidden_size': 32, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 64, 'dtype': 'float32',
}
ENGINE = {'block_size': 4, 'num_blocks': 32, 'max_num_seqs': 2, 'max_model_len': 64}
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [5, 6, 7, 8, 9, 10, 11], [3, 3]]
MAX_TOKENS = 6


class _Tok:
    eos_id = None

    def decode(self, ids):
        return ' '.join(str(i) for i in ids)


@pytest.fixture(scope='module')
def jax_tree():
    jcfg = jax_mistral.MistralConfig(**TINY)
    return jcfg, jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(0), jcfg))


def jax_engine(jax_tree, **overrides):
    jcfg, tree = jax_tree
    return JaxLLMEngine(
        jcfg, tree, _Tok(),
        JaxEngineConfig(attn_backend='xla', prefer_native_allocator=False,
                        **{**ENGINE, **overrides}),
    )


def port_engine(jax_tree, **overrides):
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(jax_tree[1], tcfg, device='cpu')
    return LLMEngine(
        tcfg, params, _Tok(), EngineConfig(**{**ENGINE, **overrides}), device='cpu',
    )


def serve(engine, prompts, params):
    """Every request added at once (a burst), then ``step()`` until done;
    returns each request's finished record, in prompt order. ``params``
    is one ``SamplingParams`` or a list parallel to ``prompts``."""
    per_prompt = params if isinstance(params, list) else [params] * len(prompts)
    rids = [engine.add_request(list(p), sp) for p, sp in zip(prompts, per_prompt)]
    while engine.has_unfinished:
        engine.step()
    return [engine._finished.pop(rid) for rid in rids]


# ------------------------------------------------------------------ metrics
def _observe_all(mod, seed):
    """The same instruments and the same seeded observations, in a fresh
    registry of ``mod``; returns its exposition."""
    registry = mod.MetricsRegistry()
    rng = np.random.default_rng(seed)
    counter = registry.counter('t_requests_total', 'Requests "quoted"\nhelp.')
    labelled = registry.counter('t_steps_total', 'Steps by kind.', labelnames=('kind',))
    gauge = registry.gauge('t_occupancy_ratio', 'Occupancy.')
    lgauge = registry.gauge('t_info', 'Info.', labelnames=('backend', 'dtype'))
    hist = registry.histogram('t_seconds', 'Seconds.', buckets=mod.log_buckets(1e-4, 10.0))
    lhist = registry.histogram('t_tokens', 'Tokens.', labelnames=('path',),
                               buckets=(1, 2, 4, 8, 16, 32))
    for value in rng.exponential(0.05, size=64):
        hist.observe(float(value))
    for value in rng.integers(0, 40, size=32):
        lhist.labels(path=['/a', 'b"c\\d', 'e\nf'][int(value) % 3]).observe(int(value))
    for _ in range(int(rng.integers(1, 9))):
        counter.inc()
    counter.inc(2.5)
    for kind in ('prefill', 'decode', 'mixed'):
        labelled.labels(kind=kind).inc(float(rng.integers(0, 5)))
    gauge.set(float(rng.random()))
    gauge.inc(0.25)
    gauge.dec(1.0)
    lgauge.labels(backend='x', dtype='int8').set(1.0)
    lgauge.labels(backend='y', dtype='bf16').set(float('inf'))
    registry.gauge('t_nan', 'NaN.').set(float('nan'))
    registry.counter('t_never_total', 'Never incremented.')
    return registry.render()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_exposition_is_byte_equal(seed):
    assert _observe_all(metrics, seed) == _observe_all(jax_metrics, seed)


def test_buckets_and_quantiles_equal():
    rng = np.random.default_rng(7)
    for lo, hi, per in ((1e-4, 100.0, 3), (1e-3, 1.0, 5), (1.0, 4096.0, 2)):
        assert metrics.log_buckets(lo, hi, per) == jax_metrics.log_buckets(lo, hi, per)
    buckets = metrics.log_buckets(1e-4, 10.0)
    for _ in range(50):
        counts = np.cumsum(rng.integers(0, 4, size=len(buckets) + 1)).tolist()
        for q in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
            assert metrics.quantile_from_cumulative(buckets, counts, q) == (
                jax_metrics.quantile_from_cumulative(buckets, counts, q)
            )
    assert metrics.quantile_from_cumulative(buckets, [0] * (len(buckets) + 1), 0.5) is None
    with pytest.raises(ValueError):
        metrics.quantile_from_cumulative(buckets, [1] * (len(buckets) + 1), 1.5)
    with pytest.raises(ValueError):
        jax_metrics.quantile_from_cumulative(buckets, [1] * (len(buckets) + 1), 1.5)


def _catalogue(mod):
    out = {}
    for attr in dir(mod):
        value = getattr(mod, attr)
        if isinstance(value, (metrics._Metric, jax_metrics._Metric)):
            out[attr] = (
                value.name, type(value).__name__, value.help, value.labelnames,
                getattr(value, 'buckets', None),
            )
    return out


def test_instrument_catalogue_equals_jax():
    port, ref = _catalogue(instruments), _catalogue(jax_instruments)
    assert len(port) >= 95
    build_info = 'BUILD_INFO'  # labelled by each package's own version
    assert {k: v for k, v in port.items() if k != build_info} == {
        k: v for k, v in ref.items() if k != build_info
    }
    assert port[build_info][:4] == ref[build_info][:4]
    for name in ('FLIGHT_KINDS', 'ATTN_BACKEND_LABELS', 'KV_CACHE_DTYPE_LABELS', 'TIER_LABELS'):
        assert getattr(instruments, name) == getattr(jax_instruments, name), name
    # The whole catalogue renders from the first scrape on.
    text = metrics.render_prometheus()
    for family in port.values():
        assert f'# TYPE {family[0]} ' in text


# ------------------------------------------------------- tracing and flight
def test_request_scope_and_spans_as_jax():
    for mod in (tracing, jax_tracing):
        buffer = mod.TraceBuffer(capacity=3)
        assert mod.current_request_id() is None
        with mod.request_scope('req-1'):
            assert mod.current_request_id() == 'req-1'
            with mod.request_scope(None):
                assert mod.current_request_id() == 'req-1'
            with mod.request_scope('req-2'):
                assert mod.current_request_id() == 'req-2'
            with mod.span('outer', 'a', buffer=buffer, k=1) as outer:
                with mod.span('inner', buffer=buffer) as inner:
                    pass
        assert mod.current_request_id() is None
        assert inner.parent_id == outer.span_id
        assert [s.name for s in buffer.snapshot()] == ['inner', 'outer']
        with pytest.raises(RuntimeError):
            with mod.span('boom', buffer=buffer):
                raise RuntimeError('x')
        assert buffer.snapshot()[-1].status == 'error'
        for i in range(4):
            with mod.span(f's{i}', buffer=buffer):
                pass
        assert [s.name for s in buffer.snapshot()] == ['s1', 's2', 's3']
        assert set(buffer.snapshot()[0].to_dict()) == set(
            jax_tracing.Span('x').to_dict()
        )


def test_flight_ring_as_jax(tmp_path):
    for mod in (flight, jax_flight):
        ring = mod.FlightRecorder(capacity=3)
        for i in range(5):
            entry = ring.record('decode', step=i)
        assert set(entry) == {'kind', 't_wall', 'step'}
        assert [r['step'] for r in ring.snapshot()] == [2, 3, 4]
        assert [r['step'] for r in ring.snapshot(limit=2)] == [3, 4]
        assert len(ring) == 3 and ring.total_recorded == 5
        assert ring.dump_jsonl(tmp_path / 'ring.jsonl') == 3
        ring.clear()
        assert len(ring) == 0 and ring.total_recorded == 5
        with pytest.raises(ValueError):
            mod.FlightRecorder(capacity=0)
    assert flight.get_flight_recorder() is flight.get_flight_recorder()


# --------------------------------------------------------------- roofline
def test_device_peaks_are_the_cards():
    assert roofline.device_peaks('NVIDIA H100 80GB HBM3') == (989.4e12, 3.35e12)
    assert roofline.device_peaks('cpu') == roofline.FALLBACK_PEAKS == jax_roofline.FALLBACK_PEAKS
    assert not any(name.startswith('TPU') for name in roofline.DEVICE_PEAKS)


def test_peak_env_overrides(monkeypatch):
    monkeypatch.setenv('DISTLLM_PEAK_FLOPS', '2e15')
    monkeypatch.setenv('DISTLLM_PEAK_BW_BYTES', '5e12')
    assert roofline.device_peaks('NVIDIA H100 80GB HBM3') == (2e15, 5e12)
    assert roofline.device_peaks('cpu') == (2e15, 5e12)


@pytest.mark.parametrize('mode', [None, 'int8', 'nf4'])
def test_cost_model_equals_jax(jax_tree, mode):
    jcfg, tree = jax_tree
    jtree = jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(0), jcfg))
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    if mode:
        jtree = jax_quant.quantize_pytree(jtree, mode=mode, min_size=0)
        params = tq.quantize_pytree(params, mode=mode, out_dtype='float32', min_size=0)
    port = roofline.CostModel.from_params(params, 4)
    ref = jax_roofline.CostModel.from_params(jtree, 4, device=jax.devices('cpu')[0])
    assert (port.n_params, port.weight_bytes) == (ref.n_params, ref.weight_bytes)
    assert (port.peak_flops, port.peak_hbm_bytes) == (ref.peak_flops, ref.peak_hbm_bytes)
    rng = np.random.default_rng(5)
    for kind in ('prefill', 'decode', 'mixed', 'spec', 'request', 'event'):
        for _ in range(4):
            kw = {key: int(rng.integers(0, 64)) for key in
                  ('tokens', 'batch', 'draft_tokens', 'prefill_tokens')}
            cost, want = port.step_cost(kind, **kw), ref.step_cost(kind, **kw)
            if want is None:
                assert cost is None
                continue
            assert (cost.flops, cost.hbm_bytes) == (want.flops, want.hbm_bytes)
            assert port.utilization(cost, 0.01) == ref.utilization(want, 0.01)
    # The port prices the weight passes a window really ran.
    assert port.step_cost('decode', tokens=3, passes=2).hbm_bytes == 2 * port.weight_bytes
    assert port.step_cost('spec', batch=2, passes=2).hbm_bytes == 2 * port.weight_bytes
    assert port.step_cost('prefill', tokens=3).hbm_bytes == port.weight_bytes


# ------------------------------------------------------ engine step records
def _new_records(ring, before):
    grew = ring.total_recorded - before
    return ring.snapshot()[-grew:] if grew else []


@pytest.mark.parametrize('mixed', [False, True], ids=['plain', 'mixed'])
def test_engine_records_match_jax(jax_tree, mixed):
    knobs = dict(enable_prefix_cache=True, enable_mixed_batching=True,
                 prefill_chunk_tokens=4) if mixed else {}
    greedy = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS)
    runs = {}
    for name, build, params, ttft in (
        ('port', port_engine, greedy, instruments.REQUEST_TTFT),
        ('jax', jax_engine, JaxSamplingParams(temperature=0.0, max_tokens=MAX_TOKENS),
         jax_instruments.REQUEST_TTFT),
    ):
        engine = build(jax_tree, ttft_slo_s=60.0, decode_steps=4, **knobs)
        ring = engine.flight
        before, ttft_before = ring.total_recorded, ttft.count
        finished = serve(engine, PROMPTS, params)
        records = _new_records(ring, before)
        runs[name] = dict(
            tokens=[r.output_ids for r in finished],
            reasons=[r.finish_reason for r in finished],
            kinds={r['kind'] for r in records},
            keys={r['kind']: set(r) for r in records},
            requests=[r for r in records if r['kind'] == 'request'],
            ttft=ttft.count - ttft_before,
            stats=engine.stats if name == 'port' else engine._stats,
            roofline=engine.roofline_summary(),
            priced=engine.roofline_snapshot(),
        )
        for request in finished:
            assert 0 < request.t_enqueue <= request.t_admit <= request.t_first_token
            assert request.t_first_token <= request.t_finish
        engine.shutdown()
    port, ref = runs['port'], runs['jax']
    assert port['tokens'] == ref['tokens']
    assert port['reasons'] == ref['reasons'] == ['length'] * len(PROMPTS)
    # The port has no dense prefill route: its standalone prefills are
    # 'prefill' records as JAX's are.
    assert port['kinds'] == ref['kinds']
    for kind in port['kinds']:
        # A port prefill record also carries its token fetch's seconds.
        extra = {'fetch_s'} if kind == 'prefill' else set()
        assert port['keys'][kind] == ref['keys'][kind] | extra, kind
    assert port['ttft'] == ref['ttft'] == len(PROMPTS)
    assert len(port['requests']) == len(PROMPTS)
    assert [r['output_tokens'] for r in port['requests']] == [MAX_TOKENS] * len(PROMPTS)
    assert port['stats']['slo_met'] == ref['stats']['slo_met'] == len(PROMPTS)
    assert port['stats']['goodput_tokens'] == ref['stats']['goodput_tokens']
    assert set(port['roofline']) == set(ref['roofline'])
    # Shares round to 5 places, which the CPU's placeholder peaks can
    # zero: the accumulators themselves must hold work.
    for acc in port['priced'].values():
        assert acc['windows'] > 0 and acc['seconds'] > 0
        assert acc['flops'] > 0 and acc['hbm_bytes'] > 0


def test_attribution_off_gives_identical_tokens(jax_tree):
    engine = port_engine(jax_tree)
    greedy = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS)
    ring = engine.flight
    before = ring.total_recorded
    on = [r.output_ids for r in serve(engine, PROMPTS, greedy)]
    with_split = [r for r in _new_records(ring, before) if r['kind'] == 'decode']
    assert with_split and all(
        {'host_s', 'put_s', 'dispatch_s', 'fetch_s', 'mfu', 'bw_util'} <= set(r)
        for r in with_split
    )
    engine.attribution = False
    snap = engine.roofline_snapshot()
    before = ring.total_recorded
    off = [r.output_ids for r in serve(engine, PROMPTS, greedy)]
    assert off == on
    bare = [r for r in _new_records(ring, before) if r['kind'] == 'decode']
    assert bare and not any('host_s' in r or 'mfu' in r for r in bare)
    assert engine.roofline_summary(baseline=snap) == {}
    engine.shutdown()


def test_gauges_follow_the_engine(jax_tree):
    engine = port_engine(jax_tree, kv_cache_dtype='int8')
    assert instruments.KV_CACHE_DTYPE_INFO.labels(dtype='int8').value == 1.0
    assert instruments.KV_CACHE_DTYPE_INFO.labels(dtype='float32').value == 0.0
    assert instruments.KV_BLOCKS_TOTAL.value == ENGINE['num_blocks'] - 1
    steps = instruments.ENGINE_STEPS.labels(kind='decode').value
    serve(engine, PROMPTS[:1], SamplingParams(temperature=0.0, max_tokens=3))
    assert instruments.ENGINE_STEPS.labels(kind='decode').value > steps
    assert instruments.SCHED_QUEUE_DEPTH.value == 0
    assert instruments.KV_BLOCKS_IN_USE.value == 0
    engine.shutdown()
