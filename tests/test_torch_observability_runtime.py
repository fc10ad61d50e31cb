"""The port's debug bundle, stall watchdog, run record, deadline, start-up
watcher, profiler capture, timer shim and op-cost counter, against the
JAX package where it has the same function.

- ``dump_debug_bundle`` writes the JAX bundle's files (the flight and span
  rings, metrics, start-up, history, SLO, Perfetto, meta) and, in place of
  JAX's device-memory profile, ``device.json`` (``torch.cuda`` facts and
  the kernel launch counters); each readable file holds what the JAX one
  holds for the same rings.
- ``StallWatchdog`` fires once on a silent progress function and dumps a
  bundle, counting ``distllm_watchdog_stalls_total`` and
  ``distllm_debug_bundles_total``, as JAX's does; ``RunRecord`` and
  ``Deadline`` behave as JAX's.
- ``CompileWatcher`` writes JAX's ``compile`` records and series, with the
  port's cache-hit rule (a repeat, or a build that found its library).
- ``ProfilerCapture`` captures a ``torch.profiler`` Chrome trace, rejects a
  second capture and stops itself after ``max_seconds``.
- ``timer.Timer`` prints JAX's line, records a span and feeds
  ``distllm_stage_duration_seconds``; JAX's ``TimeLogger`` parses it.
- ``op_cost.count`` on a tiny eager pass equals a hand count, and a kernel
  wrapper's reported work is added; K1's launches re-price at live
  lengths by hand and by ``chip_smoke.case_work``, the formula of K1's
  bound; an engine's warmup prices its decode
  step, its first prefill prices itself, and a window publishes the
  measured MFU and bandwidth gauges and the calibration ratios.
"""

import json
import time

import numpy as np
import pytest
import torch

from distllm_tpu.observability import flight as jax_flight
from distllm_tpu.observability import startup as jax_startup
from distllm_tpu.timer import TimeLogger as JaxTimeLogger
from distllm_tpu_torch import timer
from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.observability import flight, instruments, op_cost, startup
from distllm_tpu_torch.observability.metrics import render_prometheus
from distllm_tpu_torch.observability.profiling import ProfilerCapture
from distllm_tpu_torch.observability.tracing import get_trace_buffer


def _ring(mod):
    recorder = mod.FlightRecorder(capacity=8)
    for i in range(10):
        recorder.record('decode', batch=i, tokens=4 * i, duration_s=0.01, t_wall_hint=i)
    return recorder


def test_debug_bundle_files_match_jax(tmp_path):
    port = flight.dump_debug_bundle(tmp_path / 'port', reason='test', recorder=_ring(flight),
                                    extra={'cell': 'x'})
    ref = jax_flight.dump_debug_bundle(tmp_path / 'jax', reason='test',
                                       recorder=_ring(jax_flight), extra={'cell': 'x'})
    assert set(port) == (set(ref) - {'device_memory'}) | {'device'}
    assert len(open(port['flight']).read().splitlines()) \
        == len(open(ref['flight']).read().splitlines()) == 8
    strip = lambda d: {k: v for k, v in d.items() if k not in ('pid', 'wall_time_s')}  # noqa: E731
    assert strip(json.load(open(port['meta']))) == strip(json.load(open(ref['meta'])))
    assert json.load(open(port['slo'])).keys() == json.load(open(ref['slo'])).keys()
    assert json.load(open(port['startup'])).keys() == json.load(open(ref['startup'])).keys()
    device = json.load(open(port['device']))
    assert 'ragged_paged_attention.launches_by_route' in device['kernels']
    assert device['cuda_initialized'] is False  # no card here


def test_watchdog_fires_once_and_dumps_a_bundle(tmp_path):
    stalls, bundles = instruments.WATCHDOG_STALLS.value, instruments.DEBUG_BUNDLES.value
    dog = flight.StallWatchdog(0.2, progress_fn=lambda: 0, bundle_dir=tmp_path / 'b',
                               poll_s=0.02, name='test')
    with dog:
        deadline = time.monotonic() + 5
        while dog.fired == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.3)
    assert dog.fired == 1
    assert (tmp_path / 'b' / 'meta.json').exists()
    assert json.load(open(tmp_path / 'b' / 'meta.json'))['reason'] == 'test: stalled for 0s'
    assert instruments.WATCHDOG_STALLS.value == stalls + 1
    assert instruments.DEBUG_BUNDLES.value == bundles + 1
    with pytest.raises(ValueError):
        flight.StallWatchdog(0)
    alive = flight.StallWatchdog(0.2, progress_fn=time.monotonic, poll_s=0.02)
    with alive:
        time.sleep(0.4)
    assert alive.fired == 0


def test_run_record_and_deadline_as_jax(tmp_path):
    docs = []
    for mod, name in ((flight, 'port'), (jax_flight, 'jax')):
        record = mod.RunRecord(tmp_path / f'{name}.jsonl')
        record.record('a', {'x': 1, 'y': 2})
        record.record('b', {'y': 3})
        record.record('a', {'z': 4})
        with open(record.path, 'a') as fh:
            fh.write('{torn')
        docs.append((record.stages(), record.compose(),
                     json.loads(record.snapshot_path.read_text())))
    assert docs[0] == docs[1]
    for mod in (flight, jax_flight):
        deadline = mod.Deadline(100.0, reserve_s=10.0)
        assert 0 < deadline.remaining() <= 90.0 and not deadline.expired
        assert deadline.budget(30.0) == 30.0 and deadline.budget(5.0, floor_s=1000.0) == 0.0
        with pytest.raises(ValueError):
            mod.Deadline(0)


def test_compile_watcher_records_as_jax():
    recs = []
    for mod in (startup, jax_startup):
        rec = (flight if mod is startup else jax_flight).FlightRecorder()
        watcher = mod.CompileWatcher(recorder=rec)
        scope = watcher.new_scope()
        for _ in range(2):
            with watcher.phase('decode_window', 'b8', scope=scope) as fields:
                fields['note'] = 'x'
        with pytest.raises(RuntimeError):
            with watcher.phase('prefill', 'p', scope=scope):
                raise RuntimeError('boom')
        recs.append([
            {k: v for k, v in r.items() if k not in ('t_wall', 'duration_s')}
            for r in rec.snapshot()
        ])
        assert watcher.state()['active'] is None
    assert recs[0] == recs[1]
    assert [r['cache_hit'] for r in recs[0]] == [False, True, False]
    # The port's own hit: a body that found its build.
    hits = instruments.COMPILE_CACHE_HITS.value
    with startup.CompileWatcher(recorder=flight.FlightRecorder()).phase('kernel_build', 'k') as f:
        f['cache_hit'] = True
    assert instruments.COMPILE_CACHE_HITS.value == hits + 1
    assert {'kernel_build', 'weight_load', 'decode_window', 'spec_window', 'backend_init',
            'quantize'} <= instruments.COMPILE_PHASES
    startup.record_backend_init('cpu')  # a CPU device: nothing to time


def test_profiler_capture_is_bounded(tmp_path):
    capture = ProfilerCapture()
    before = instruments.PROFILER_CAPTURES.labels(outcome='ok').value
    result = capture.capture(tmp_path / 'one', 0.2)
    assert result['ok'] and not result['rejected']
    events = json.load(open(tmp_path / 'one' / 'trace.json'))['traceEvents']
    assert events
    assert capture.start(tmp_path / 'two', max_seconds=0.2)
    assert not capture.start(tmp_path / 'three')  # one at a time
    assert capture.state()['last_error'].startswith('capture already active')
    deadline = time.monotonic() + 10
    while capture.state()['active'] is not None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert capture.state()['active'] is None  # it stopped itself
    while capture.state()['captures_total'] < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert (tmp_path / 'two' / 'trace.json').exists()
    assert instruments.PROFILER_CAPTURES.labels(outcome='ok').value == before + 2
    assert capture.stop() is False


def _stage_count(status: str) -> int:
    key = f'distllm_stage_duration_seconds_count{{stage="unit-stage",status="{status}"}} '
    for line in render_prometheus().splitlines():
        if line.startswith(key):
            return int(float(line.split()[-1]))
    return 0


def test_timer_line_span_and_stage_series(capsys):
    ok, error = _stage_count('ok'), _stage_count('error')
    with timer.Timer('unit-stage', 'part-1') as t:
        time.sleep(0.001)
    line = capsys.readouterr().out.strip()
    assert line == t.log_line() and line.startswith('[timer] tags=unit-stage,part-1 ')
    stats = JaxTimeLogger().parse_lines(line)
    assert stats[('unit-stage', 'part-1')].count == 1
    assert timer.TimeLogger().parse_lines(line)[('unit-stage', 'part-1')].elapsed_s \
        == stats[('unit-stage', 'part-1')].elapsed_s
    assert get_trace_buffer().snapshot(limit=1)[-1].name == 'unit-stage'
    assert _stage_count('ok') == ok + 1
    with pytest.raises(ValueError):
        with timer.Timer('unit-stage'):
            raise ValueError('x')
    capsys.readouterr()
    assert _stage_count('error') == error + 1


def test_op_cost_hand_count():
    x = torch.randn(4, 8)
    w1, b1, w2 = torch.randn(8, 16), torch.randn(16), torch.randn(16, 8)
    cost, out = op_cost.count(lambda: torch.relu(x @ w1 + b1) @ w2)
    assert out.shape == (4, 8)
    assert cost.flops == 2 * 4 * 8 * 16 + 2 * 4 * 16 * 8
    # Bytes: every operator reads its inputs once and writes its output.
    f32 = 4
    mm1 = (4 * 8 + 8 * 16 + 4 * 16) * f32
    add = (4 * 16 + 16 + 4 * 16) * f32
    relu = (4 * 16 + 4 * 16) * f32
    mm2 = (4 * 16 + 16 * 8 + 4 * 8) * f32
    assert cost.bytes_accessed == mm1 + add + relu + mm2
    # A scatter into a pool (a KV write) moves its values and indices,
    # never the pool; a gather reads the rows it returns.
    for blocks in (10, 1000):
        pool, rows = torch.zeros(blocks, 4, 8), torch.tensor([3, 7])
        cols, values = torch.tensor([0, 1]), torch.ones(2, 8)

        def write():
            pool[rows, cols] = values

        scatter, _ = op_cost.count(write)
        assert scatter.bytes_accessed == 2 * (2 * 8 * 4 + 2 * 8 + 2 * 8)
        gather, _ = op_cost.count(lambda: pool.index_select(0, rows))
        assert gather.bytes_accessed == 2 * (2 * 4 * 8 * 4) + 2 * 8
    kernel, _ = op_cost.count(lambda: op_cost.add_kernel_cost(1e6, 2e3))
    assert (kernel.flops, kernel.bytes_accessed) == (1e6, 2e3)
    assert not op_cost.counting()
    # K1 at its shape: 2 rows x 1 query x 4 heads over 32 keys of head dim 8.
    flops, bytes_ = op_cost.paged_attention_cost(2, 1, 4, 2, 8, 32, 4, 4, 2 * 4, 16, False)
    assert flops == 4 * 2 * 1 * 4 * 32 * 8
    assert bytes_ == 2 * 2 * 4 * 8 * 4 + 2 * 32 * 2 * 8 * 4 * 2 + 8 * 4 + 3 * 2 * 4


def test_op_cost_prices_k1_at_live_lengths():
    """A K1 launch adds its padded price to the pass, and ``at_lengths``
    swaps it for the work of the lengths a window ran; everything else in
    the pass costs what it did, once a pass."""
    launch = op_cost.AttentionLaunch(2, 1, 4, 2, 8, 4, 4, 4, 16, False, 0)
    x = torch.ones(3)
    cost, _ = op_cost.count(lambda: (x * 2, op_cost.add_attention_launch(launch)))
    pad_flops, pad_bytes = op_cost.paged_attention_cost(2, 1, 4, 2, 8, 64, 4, 4, 8, 16, False)
    dense = 3 * 4 * 2
    assert cost.attention == (launch,)
    assert (cost.flops, cost.bytes_accessed) == (pad_flops, dense + pad_bytes)
    # Two decode steps; the second row's budget ran out before the window.
    lengths = op_cost.decode_lengths([10, 3], [2, 0], 2)
    assert lengths.tolist() == [[10, 3], [11, 3]]
    live = cost.at_lengths(lengths)
    keys = 10 + 3 + 11 + 3
    per_pass = 2 * 2 * 1 * 4 * 8 * 4 + 2 * 4 * 4 + 3 * 2 * 4
    assert live.flops == 4 * 4 * 8 * keys
    assert live.bytes_accessed == 2 * dense + keys * 2 * 8 * 4 * 2 + 2 * per_pass
    # A window of 4 over a span of 3 at 10 keys: queries at 7, 8, 9 see 4
    # keys each and the row reads keys 4..9; the idle row reads nothing; an
    # int8 pool adds K's and V's scale of the one page read, per KV head.
    windowed = op_cost.AttentionLaunch(2, 3, 4, 2, 8, 2, 1, 4, 16, True, 4)
    flops, bytes_ = op_cost.attention_work(windowed, [[10, 5]], [[3, 0]])
    assert flops == 4 * 4 * 8 * 12
    assert bytes_ == 6 * 2 * 8 * 1 * 2 + 2 * 4 * 2 + 2 * 2 * 3 * 4 * 8 * 2 + 2 * 4 * 4 + 3 * 2 * 4


@pytest.mark.parametrize('window,int8', [(0, False), (20, False), (0, True), (37, True)])
def test_op_cost_k1_work_is_the_bound_formula(window, int8):
    """``attention_work`` equals ``chip_smoke.case_work`` (the bytes and
    FLOPs behind K1's ``bound_ms``) on random rows at Mistral-7B's heads."""
    import chip_smoke as cs

    rng = np.random.default_rng(window + int8)
    b, s, nb, bs = 6, 5, 8, cs.BLOCK_SIZE
    q_lens = rng.integers(0, s + 1, b)
    ctx = np.maximum(rng.integers(1, nb * bs + 1, b), q_lens)
    case = dict(
        q=torch.empty(b, s, cs.NUM_HEADS, cs.HEAD_DIM, dtype=torch.bfloat16),
        k=torch.empty(1, dtype=torch.bfloat16), int8_kv=int8, block_size=bs,
        bt=torch.zeros(b, nb, dtype=torch.int32), ctx=torch.zeros(b, dtype=torch.int32),
        np_ctx=ctx, np_q_lens=q_lens, np_start=ctx - q_lens,
    )
    bound_bytes, bound_flops = cs.case_work(case, window, 'bfloat16')
    launch = op_cost.AttentionLaunch(
        b, s, cs.NUM_HEADS, cs.NUM_KV_HEADS, cs.HEAD_DIM, 2, 1 if int8 else 2, nb, bs,
        int8, window,
    )
    flops, bytes_ = op_cost.attention_work(launch, ctx[None], q_lens[None])
    assert (flops, bytes_) == (bound_flops, bound_bytes)


TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=64, dtype='float32')


def test_engine_prices_steps_and_publishes_measured_gauges():
    cfg = mistral.MistralConfig(**TINY)
    params = mistral.init(cfg, torch.Generator().manual_seed(0), device='cpu')
    engine = LLMEngine(cfg, params, None, EngineConfig(
        num_blocks=32, max_num_seqs=2, max_model_len=64, decode_steps=4, block_size=4,
        history_interval_s=0.05,
    ), device='cpu')
    engine.warmup()
    decode = engine.measured_costs()['decode']
    # Every decode step runs the model's products for every slot.
    h, i, v = 32, 64, 64
    per_row = 2 * cfg.num_layers * (h * (h + 2 * 16) + h * h + 3 * h * i) + 2 * h * v
    assert decode['flops'] >= per_row * 2
    assert decode['bytes_accessed'] > engine.weight_bytes_float
    engine.generate_ids([[5, 6, 7, 8, 9]] * 3, SamplingParams(temperature=0.0, max_tokens=9))
    assert engine.measured_costs()['prefill']['flops'] > 0
    mfu = instruments.ENGINE_MFU_MEASURED.labels(kind='decode').value
    bw = instruments.ENGINE_BW_UTIL_MEASURED.labels(kind='decode').value
    assert mfu > 0 and bw > 0
    assert instruments.ENGINE_ROOFLINE_FLOPS_RATIO.labels(kind='decode').value > 0
    assert instruments.ENGINE_KV_DISPATCH_BYTES.labels(kind='decode').value \
        == decode['bytes_accessed']
    windows = [r for r in engine.flight.snapshot() if r['kind'] == 'decode']
    assert windows and 'mfu_measured' in windows[-1]
    sampler = engine._history_sampler
    assert sampler is not None and sampler.running
    engine.shutdown()
    assert not sampler.running
    assert np.isfinite(mfu)
