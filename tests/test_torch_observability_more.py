"""The port's history, SLO, baseline, sentinel, Perfetto and aggregate
modules against the JAX package's, on the same inputs.

Each package gets a fresh registry with the same series, fed the same
observations at the same synthetic clock; then:

- ``history``: snapshots (every series kind, ``limit`` and ``prefix``),
  counter and gauge windows, window quantiles and ``history_excerpt``;
- ``slo``: ``burn_rate`` per window and the ``slo_status`` document;
- ``baseline``: ``extract_metrics``, ``load_record``, ``build_envelope``,
  ``envelope_from_records`` and ``load_envelope`` over BENCH-shaped
  records written in ``tmp_path``;
- ``sentinel``: the verdicts of one envelope over one live history;
- ``perfetto``: ``to_trace_events`` of the same flight records (every
  window kind, requests, compile phases, events), spans and history, its
  validator, ``merge_host_traces`` and ``dump_trace``;
- ``aggregate``: the merged stats of ``[timer]`` logs and span / flight
  JSONL, the table, the combined trace and the CLI's output.

Every document equals the JAX function's.
"""

import json

import pytest

from distllm_tpu.observability import aggregate as jax_aggregate
from distllm_tpu.observability import baseline as jax_baseline
from distllm_tpu.observability import history as jax_history
from distllm_tpu.observability import metrics as jax_metrics
from distllm_tpu.observability import perfetto as jax_perfetto
from distllm_tpu.observability import sentinel as jax_sentinel
from distllm_tpu.observability import slo as jax_slo
from distllm_tpu.observability.flight import FlightRecorder as JaxFlightRecorder
from distllm_tpu_torch.observability import aggregate, baseline, history, metrics
from distllm_tpu_torch.observability import perfetto, sentinel, slo
from distllm_tpu_torch.observability.flight import FlightRecorder

T0 = 1_700_000_000.0
BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


def _feed(mod_metrics, mod_history):
    """A registry of the serving series, fed 40 one-second ticks of a
    synthetic load, and its history sampled at every tick."""
    registry = mod_metrics.MetricsRegistry()
    tokens = registry.counter('distllm_engine_generated_tokens_total', 'tokens')
    slo_total = registry.counter('distllm_request_slo_total', 'slo', ('outcome',))
    goodput = registry.counter('distllm_engine_goodput_tokens_total', 'goodput')
    ttft = registry.histogram('distllm_request_ttft_seconds', 'ttft', buckets=BUCKETS)
    tpot = registry.histogram('distllm_request_tpot_seconds', 'tpot', buckets=BUCKETS)
    queue = registry.gauge('distllm_scheduler_queue_depth', 'queue')
    mfu = registry.gauge('distllm_engine_mfu_measured', 'mfu', ('kind',))
    burn = registry.gauge('distllm_slo_burn_rate', 'burn', ('window',))
    hist = mod_history.MetricsHistory(registry, capacity=64)
    for i in range(40):
        slow = i >= 25  # the last 15 s degrade
        tokens.inc(0 if i in (10, 11) else (300 if not slow else 120))
        slo_total.labels(outcome='met').inc(4 if not slow else 1)
        if slow or i % 7 == 0:
            slo_total.labels(outcome='missed').inc(2 if slow else 1)
        goodput.inc(100)
        for j in range(3):
            ttft.observe(0.02 * (j + 1) * (5 if slow else 1))
            tpot.observe(0.004 * (j + 1))
        queue.set(i % 5)
        mfu.labels(kind='decode').set(0.4 if not slow else 0.2)
        burn.labels(window='60s').set(float(i) / 10)
        hist.sample_once(now=T0 + i)
    return registry, hist


@pytest.fixture(scope='module')
def histories():
    return _feed(metrics, history)[1], _feed(jax_metrics, jax_history)[1]


def test_history_documents_equal_jax(histories):
    port, ref = histories
    now = T0 + 39
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot(limit=5, prefix='distllm_request') == ref.snapshot(
        limit=5, prefix='distllm_request')
    for window in (5.0, 20.0, 60.0):
        assert port.counter_window('distllm_engine_generated_tokens_total', window, now=now) \
            == ref.counter_window('distllm_engine_generated_tokens_total', window, now=now)
        for agg in ('mean', 'last', 'min', 'max'):
            kw = dict(labels={'kind': 'decode'}, agg=agg, now=now)
            assert port.gauge_window('distllm_engine_mfu_measured', window, **kw) \
                == ref.gauge_window('distllm_engine_mfu_measured', window, **kw)
        for q in (0.5, 0.95, 0.99):
            assert port.window_quantile('distllm_request_ttft_seconds', q, window, now=now) \
                == ref.window_quantile('distllm_request_ttft_seconds', q, window, now=now)
    assert history.history_excerpt(port, window_s=30, now=now) \
        == jax_history.history_excerpt(ref, window_s=30, now=now)
    assert port.samples == ref.samples == 40


def test_burn_rates_and_slo_status_equal_jax(histories):
    port, ref = histories
    for now in (T0 + 20, T0 + 39):
        for window in (10.0, 60.0, 600.0):
            assert slo.burn_rate(port, window, now=now) == jax_slo.burn_rate(ref, window, now=now)
        doc = slo.slo_status(port, now=now)
        ref_doc = jax_slo.slo_status(ref, now=now)
        doc.pop('uptime_s'), ref_doc.pop('uptime_s')
        assert doc == ref_doc
    for pairs in ((('60s', '600s', 1.5, 'page'),), (('60s', '300s', 0.5, 'warn'),)):
        assert slo.slo_status(port, pairs=pairs, objective=0.9, now=T0 + 39)['verdict'] \
            == jax_slo.slo_status(ref, pairs=pairs, objective=0.9, now=T0 + 39)['verdict']


RECORDS = [
    {'n': 1, 'cmd': 'bench', 'rc': 0, 'parsed': None},
    {'n': 2, 'cmd': 'bench', 'rc': 0, 'parsed': {
        'gen_value': 812.5, 'gen_mfu': 0.31, 'gen_load_ttft_p95': 0.44,
        'gen_load_tpot_p95': 0.021, 'note': 'text', 'gen_kvq_greedy_match': 0.97,
        'nan_key': float('nan')}},
    {'gen_load_tok_s': 901.0, 'gen_history_ttft_p95': 0.5,
     'gen_kernel_xla_bw_util_measured': 0.61, 'nested': {'a': 1.0}},
]


def test_baseline_parsing_and_envelopes_equal_jax(tmp_path):
    paths = []
    for i, record in enumerate(RECORDS):
        path = tmp_path / f'BENCH_r0{i}.json'
        path.write_text(json.dumps(record))
        paths.append(path)
    (tmp_path / 'BENCH_bad.json').write_text('{torn')
    paths.append(tmp_path / 'BENCH_bad.json')
    for record in RECORDS:
        payload = record.get('parsed', record) if 'parsed' in record else record
        assert baseline.extract_metrics(payload) == jax_baseline.extract_metrics(payload)
    loaded = [baseline.load_record(p) for p in paths]
    assert loaded == [jax_baseline.load_record(p) for p in paths]
    for rec in loaded:
        assert baseline.build_envelope(rec['metrics'], source=rec['name']) \
            == jax_baseline.build_envelope(rec['metrics'], source=rec['name'])
    env = baseline.envelope_from_records(loaded)
    assert env == jax_baseline.envelope_from_records(loaded)
    assert env['metrics']
    for key in ('gen_value', 'gen_load_ttft_p95', 'note_mfu', 'queue_wait_s', 'x'):
        assert baseline.gate_direction(key) == jax_baseline.gate_direction(key)
    env_path = tmp_path / 'envelope.json'
    env_path.write_text(json.dumps(env))
    for path in (env_path, paths[1], tmp_path / 'missing.json', paths[-1]):
        assert baseline.load_envelope(path) == jax_baseline.load_envelope(path)


def test_sentinel_verdicts_equal_jax(histories):
    port, ref = histories
    envelope = {'schema': baseline.ENVELOPE_SCHEMA, 'source': 'synthetic', 'metrics': {
        'tok_s': {'value': 300.0, 'direction': 'higher', 'from_key': 'gen_load_tok_s'},
        'ttft_p95_s': {'value': 0.06, 'direction': 'lower', 'from_key': 'gen_load_ttft_p95'},
        'mfu_measured': {'value': 0.4, 'direction': 'higher', 'from_key': 'gen_mfu'},
    }}
    rec, jrec = FlightRecorder(), JaxFlightRecorder()
    ours = sentinel.RegressionSentinel(port, envelope=envelope, window_s=10.0, recorder=rec)
    theirs = jax_sentinel.RegressionSentinel(ref, envelope=envelope, window_s=10.0,
                                             recorder=jrec)
    for now in (T0 + 15, T0 + 30, T0 + 39, T0 + 39):
        fired = ours.evaluate(now=now)
        assert fired == theirs.evaluate(now=now)
        assert ours.status(now=now) == theirs.status(now=now)
    assert {r['metric'] for r in rec.snapshot()} == {r['metric'] for r in jrec.snapshot()} != set()
    for bad in (None, {'schema': 'other'}):
        a = sentinel.RegressionSentinel(port, envelope=bad)
        b = jax_sentinel.RegressionSentinel(ref, envelope=bad)
        assert a.armed == b.armed is False
        assert a.status() == b.status()


def _flight_records():
    """Flight records of every kind the engine writes, on one clock."""
    records, t = [], T0
    for i in range(6):
        t += 0.05
        records.append({'kind': 'compile', 't_wall': t, 'phase': 'kernel_build',
                        'shape': f'k{i}', 'duration_s': 0.04, 'cache_hit': i % 2 == 0})
    for i, kind in enumerate(['prefill', 'decode', 'mixed', 'decode', 'spec', 'decode']):
        t += 0.02
        records.append({'kind': kind, 't_wall': t, 'duration_s': 0.015, 'batch': 4,
                        'tokens': 16 * (i + 1), 'occupancy': 0.5, 'queue_depth': i,
                        'host_s': 0.001, 'put_s': 0.0002, 'dispatch_s': 0.003,
                        'fetch_s': 0.01, 'mfu': 0.2, 'bw_util': 0.6, 'rids': [1, 2]})
    t += 0.01
    records.append({'kind': 'preempt', 't_wall': t, 'rids': [3], 'free_blocks': 0})
    records.append({'kind': 'event', 't_wall': t + 0.001, 'event': 'abnormal_drain',
                    'dropped_windows': 1})
    for rid, trace_id in ((1, 'req-a'), (2, None)):
        records.append({'kind': 'request', 't_wall': t + 0.02 * rid, 'request_id': rid,
                        'trace_id': trace_id, 'prompt_tokens': 12, 'output_tokens': 8,
                        'queue_wait_s': 0.01, 'ttft_s': 0.05, 'tpot_s': 0.01,
                        'e2e_s': 0.2, 'cached_tokens': 0})
    records.append({'kind': 'decode', 't_wall': 'torn'})  # skipped, never fatal
    return records


def _spans():
    return [
        {'name': 'chat-generate', 'tags': [], 'start_ns': int((T0 + 0.1) * 1e9),
         'end_ns': int((T0 + 0.3) * 1e9), 'status': 'ok', 'attrs': {'request_id': 'req-a'},
         'thread': 'worker', 'thread_id': 7, 'wall_start_s': T0 + 0.1},
        {'name': 'embed', 'tags': ['file-1'], 'start_ns': int((T0 + 0.2) * 1e9),
         'end_ns': int((T0 + 0.25) * 1e9), 'status': 'error', 'attrs': {},
         'thread': 'main', 'thread_id': 1, 'wall_start_s': T0 + 0.2},
    ]


def test_perfetto_documents_equal_jax(histories, tmp_path):
    port, ref = histories
    records, spans = _flight_records(), _spans()
    doc = perfetto.to_trace_events(records, spans, history=port.snapshot())
    assert doc == jax_perfetto.to_trace_events(records, spans, history=ref.snapshot())
    assert perfetto.validate_trace_events(doc) == jax_perfetto.validate_trace_events(doc) == []
    names = {e.get('args', {}).get('name') for e in doc['traceEvents'] if e['ph'] == 'M'}
    for kind in ('prefill', 'decode', 'mixed', 'spec', 'startup', 'host'):
        assert any(kind in str(n) for n in names), kind
    broken = {'traceEvents': [{'ph': 'X', 'name': 'x'}, {'ph': 'Q'}]}
    assert perfetto.validate_trace_events(broken) == jax_perfetto.validate_trace_events(broken)
    hosts = [('host-a', records, spans), ('host-b', records[:5], [])]
    assert perfetto.merge_host_traces(hosts) == jax_perfetto.merge_host_traces(hosts)
    assert perfetto.dump_trace(tmp_path / 'a.json', records, spans) \
        == jax_perfetto.dump_trace(tmp_path / 'b.json', records, spans)
    assert json.loads((tmp_path / 'a.json').read_text()) \
        == json.loads((tmp_path / 'b.json').read_text())


TIMER_LOG = '\n'.join([
    'noise line',
    '[timer] tags=load-encoder,file-1 elapsed_s=1.250000000 start_ns=100 end_ns=1250000100',
    '[timer] tags=load-encoder,file-2 elapsed_s=0.750000000 start_ns=200 end_ns=750000200',
    '[timer] tags=embed elapsed_s=3.000000000 start_ns=300 end_ns=3000000300',
    '[timer] tags=embed elapsed_s=2.000000000 start_ns=400 end_ns=2000000400',
])


def test_aggregate_tables_and_traces_equal_jax(tmp_path, capsys):
    logs = tmp_path / 'worker-0.txt'
    logs.write_text(TIMER_LOG)
    spans_path = tmp_path / 'traces.jsonl'
    spans_path.write_text('\n'.join(json.dumps(s) for s in _spans()) + '\n{torn\n')
    flight_path = tmp_path / 'flight.jsonl'
    flight_path.write_text('\n'.join(json.dumps(r) for r in _flight_records()[:-1]) + '\n')
    captures = [TIMER_LOG, spans_path.read_text()]

    def table(mod):
        stats = mod.aggregate_lines(captures)
        return {k: (v.count, v.total_s, v.p50_s, v.p95_s, v.max_s) for k, v in stats.items()}, \
            mod.format_stats_table(stats)

    assert table(aggregate) == table(jax_aggregate)
    paths = [logs, spans_path, flight_path]
    assert {k: v.count for k, v in aggregate.aggregate_logs(paths).items()} \
        == {k: v.count for k, v in jax_aggregate.aggregate_logs(paths).items()}
    for path in paths:
        assert aggregate.load_host_capture(path) == jax_aggregate.load_host_capture(path)
    out = {}
    for name, mod in (('port', aggregate), ('jax', jax_aggregate)):
        (tmp_path / name).mkdir()
        target = tmp_path / name / 'combined.json'
        assert mod.main([str(p) for p in paths] + ['--perfetto', str(target)]) == 0
        out[name] = (capsys.readouterr().out, json.loads(target.read_text()))
    assert out['port'][0].replace('/port/', '/') == out['jax'][0].replace('/jax/', '/')
    assert out['port'][1] == out['jax'][1]
