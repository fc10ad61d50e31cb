"""Bounded metric history over the live registry (the port of
``distllm_tpu.observability.history``; the same series, snapshot schema
and quantile estimator).

The registry answers what the counters read now; this module keeps a
bounded, thread-safe time-series ring that folds a full
``MetricsRegistry.collect()`` snapshot into per-series point deques at
each tick, so a serving process can answer "is this replica getting
slower right now" from its own memory:

- **counters** — per-tick deltas with the covering interval, so a
  trailing window reads back as an exact rate;
- **gauges** — sampled values (mean / last / min / max over a window);
- **histograms** — per-tick delta bucket vectors; window quantiles run
  :func:`~distllm_tpu_torch.observability.metrics.quantile_from_cumulative`
  over their sum, so a window quantile covers only that window.

:class:`HistorySampler` is the background thread (``start()`` /
``stop()`` with a joined shutdown, context manager). Every tick is
counted in ``distllm_history_samples_total`` and timed into
``distllm_history_sample_duration_seconds``. Observers (the SLO
burn-rate engine and the regression sentinel) run after each tick,
outside the ring lock; one that raises is counted
(``distllm_history_sample_errors_total``) and never kills the sampler.

Snapshot JSON schema (``GET /debug/history``, ``history.json`` in debug
bundles) — ``distllm-history/v1``::

    {"schema": "distllm-history/v1", "capacity": 512, "samples": N,
     "interval_hint_s": 1.0, "quantiles": [0.5, 0.95, 0.99],
     "series": {
       "<name>": {"kind": "counter", "points": [[t, delta, rate], ...]},
       "<name>{label=value}": {"kind": "gauge", "points": [[t, value], ...]},
       "<name>": {"kind": "histogram",
                  "points": [[t, count_delta, rate, p50, p95, p99], ...]}}}

Series keys are ``name`` or ``name{label=value,...}`` with label pairs
sorted by label name; histogram quantile columns follow ``quantiles``
and are ``null`` for ticks with no observations.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from distllm_tpu_torch.observability import instruments as _metrics
from distllm_tpu_torch.observability.metrics import (
    MetricsRegistry,
    get_registry,
    quantile_from_cumulative,
)

HISTORY_SCHEMA = 'distllm-history/v1'
DEFAULT_QUANTILES = (0.5, 0.95, 0.99)
SAMPLER_THREAD_NAME = 'distllm-history-sampler'


def series_key(name: str, labels: dict | None = None) -> str:
    """Canonical history key for one child series: ``name`` or
    ``name{label=value,...}`` with pairs sorted by label name."""
    if not labels:
        return name
    inner = ','.join(f'{k}={labels[k]}' for k in sorted(labels))
    return f'{name}{{{inner}}}'


class MetricsHistory:
    """Bounded per-series rings over periodic registry snapshots.

    ``capacity`` bounds every series deque (oldest points evicted
    first); at the default 1 s interval the default 512 points retain
    ~8.5 minutes — enough to cover the longest default burn-rate window
    pair's short side and every sentinel window. All reads and writes
    are guarded by one lock; observer callbacks run outside it so they
    can call the window helpers without deadlocking.
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        *,
        capacity: int = 512,
        quantiles: tuple[float, ...] = DEFAULT_QUANTILES,
    ) -> None:
        if capacity < 2:
            raise ValueError('capacity must be >= 2')
        self._registry = registry if registry is not None else get_registry()
        self.capacity = int(capacity)
        self.quantiles = tuple(quantiles)
        self._lock = threading.Lock()
        self._series: dict[str, dict] = {}  # guarded by self._lock
        self._prev: dict[str, tuple] = {}  # guarded by self._lock (t, payload per series)
        self._samples = 0  # guarded by self._lock
        self._observers: list = []  # guarded by self._lock
        self.interval_hint_s: float | None = None  # advisory, set by the sampler

    # ------------------------------------------------------------ sampling
    def add_observer(self, fn) -> None:
        """Register ``fn(history, now)`` to run after every tick (outside
        the ring lock; exceptions are counted and swallowed)."""
        with self._lock:
            self._observers.append(fn)

    def remove_observer(self, fn) -> None:
        with self._lock:
            if fn in self._observers:
                self._observers.remove(fn)

    def sample_once(self, now: float | None = None) -> None:
        """Fold one full registry snapshot into the rings and run the
        observers. Safe from any thread; one tick per call."""
        t_start = time.monotonic()
        now = time.time() if now is None else float(now)
        families = self._registry.collect()
        with self._lock:
            for family in families:
                name = family['name']
                kind = family['kind']
                labelnames = family['labelnames']
                for child in family['children']:
                    labels = dict(zip(labelnames, child['labels']))
                    key = series_key(name, labels)
                    prev = self._prev.get(key)
                    if kind == 'counter':
                        value = child['value']
                        self._prev[key] = (now, value)
                        if prev is None:
                            continue  # first sighting: no interval yet
                        dt = now - prev[0]
                        if dt <= 0:
                            continue
                        delta = max(0.0, value - prev[1])
                        self._ring(key, 'counter').append((now, dt, delta))
                    elif kind == 'gauge':
                        self._ring(key, 'gauge').append((now, child['value']))
                    else:  # histogram
                        cumulative = list(child['cumulative'])
                        self._prev[key] = (now, cumulative)
                        if prev is None:
                            self._series.setdefault(key, {
                                'kind': 'histogram',
                                'buckets': tuple(child['buckets']),
                                'points': deque(maxlen=self.capacity),
                            })
                            continue
                        dt = now - prev[0]
                        if dt <= 0:
                            continue
                        delta_cum = [
                            max(0, a - b)
                            for a, b in zip(cumulative, prev[1])
                        ]
                        entry = self._series.setdefault(key, {
                            'kind': 'histogram',
                            'buckets': tuple(child['buckets']),
                            'points': deque(maxlen=self.capacity),
                        })
                        entry['points'].append(
                            (now, dt, delta_cum[-1], delta_cum)
                        )
            self._samples += 1
            observers = list(self._observers)
        for fn in observers:
            try:
                fn(self, now)
            except Exception:
                _metrics.HISTORY_SAMPLE_ERRORS.inc()
        _metrics.HISTORY_SAMPLES.inc()
        _metrics.HISTORY_SAMPLE_SECONDS.observe(time.monotonic() - t_start)

    def _ring(self, key: str, kind: str) -> deque:
        # distlint: disable=lock-discipline -- internal helper only reached from sample_once's locked section (callers hold self._lock)
        entry = self._series.setdefault(
            key, {'kind': kind, 'points': deque(maxlen=self.capacity)}
        )
        return entry['points']

    # ------------------------------------------------------------- queries
    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    def _points(
        self, name, labels, since, until
    ) -> tuple[str, list, dict] | None:
        key = series_key(name, labels)
        with self._lock:
            entry = self._series.get(key)
            if entry is None:
                return None
            points = [p for p in entry['points'] if since <= p[0] <= until]
            return key, points, entry

    def counter_window(
        self,
        name: str,
        window_s: float,
        *,
        labels: dict | None = None,
        now: float | None = None,
    ) -> dict:
        """Exact trailing-window counter aggregate:
        ``{'delta', 'rate', 'covered_s', 'points'}`` (``rate`` is None
        when the window holds no covered interval)."""
        now = time.time() if now is None else float(now)
        found = self._points(name, labels, now - window_s, now)
        pts = found[1] if found else []
        delta = sum(p[2] for p in pts)
        covered = sum(p[1] for p in pts)
        return {
            'delta': delta,
            'rate': (delta / covered) if covered > 0 else None,
            'covered_s': covered,
            'points': len(pts),
        }

    def counter_rate(
        self,
        name: str,
        window_s: float,
        *,
        labels: dict | None = None,
        now: float | None = None,
    ) -> float | None:
        return self.counter_window(
            name, window_s, labels=labels, now=now
        )['rate']

    def gauge_window(
        self,
        name: str,
        window_s: float,
        *,
        labels: dict | None = None,
        agg: str = 'mean',
        now: float | None = None,
    ) -> float | None:
        """Trailing-window gauge aggregate (``mean``/``last``/``min``/
        ``max``); None when the window holds no samples."""
        now = time.time() if now is None else float(now)
        found = self._points(name, labels, now - window_s, now)
        pts = found[1] if found else []
        if not pts:
            return None
        values = [p[1] for p in pts]
        if agg == 'mean':
            return sum(values) / len(values)
        if agg == 'last':
            return values[-1]
        if agg == 'min':
            return min(values)
        if agg == 'max':
            return max(values)
        raise ValueError(f'unknown agg {agg!r}')

    def window_quantile(
        self,
        name: str,
        q: float,
        window_s: float,
        *,
        labels: dict | None = None,
        now: float | None = None,
    ) -> float | None:
        """Quantile over ONLY the observations of the trailing window:
        sums the per-tick delta cumulative vectors and runs the shared
        delta estimator. None on an empty window (never a division)."""
        now = time.time() if now is None else float(now)
        found = self._points(name, labels, now - window_s, now)
        if found is None:
            return None
        _, pts, entry = found
        buckets = entry.get('buckets')
        if not pts or not buckets:
            return None
        summed = [0] * len(pts[0][3])
        for p in pts:
            for i, c in enumerate(p[3]):
                summed[i] += c
        return quantile_from_cumulative(buckets, summed, q)

    # ------------------------------------------------------------ snapshot
    def snapshot(
        self, *, limit: int | None = None, prefix: str | None = None
    ) -> dict:
        """The stable ``distllm-history/v1`` JSON document (see module
        docstring). ``limit`` trims each series to its newest N points;
        ``prefix`` filters series keys (``/debug/history?prefix=``)."""
        with self._lock:
            series_items = [
                (key, entry['kind'], list(entry['points']),
                 entry.get('buckets'))
                for key, entry in sorted(self._series.items())
                if prefix is None or key.startswith(prefix)
            ]
            samples = self._samples
        out_series: dict[str, dict] = {}
        for key, kind, points, buckets in series_items:
            if limit is not None:
                points = points[-limit:]
            if kind == 'counter':
                rendered = [
                    [p[0], p[2], (p[2] / p[1]) if p[1] > 0 else 0.0]
                    for p in points
                ]
            elif kind == 'gauge':
                rendered = [[p[0], p[1]] for p in points]
            else:
                rendered = []
                for p in points:
                    row = [p[0], p[2], (p[2] / p[1]) if p[1] > 0 else 0.0]
                    for q in self.quantiles:
                        row.append(
                            quantile_from_cumulative(buckets, p[3], q)
                        )
                    rendered.append(row)
            out_series[key] = {'kind': kind, 'points': rendered}
        return {
            'schema': HISTORY_SCHEMA,
            'capacity': self.capacity,
            'samples': samples,
            'interval_hint_s': self.interval_hint_s,
            'quantiles': list(self.quantiles),
            'series': out_series,
        }

    def clear(self) -> None:
        """Drop all retained points and delta state (tests)."""
        with self._lock:
            self._series.clear()
            self._prev.clear()
            self._samples = 0


def history_excerpt(
    history: MetricsHistory,
    *,
    window_s: float = 60.0,
    max_points: int = 30,
    now: float | None = None,
) -> dict:
    """Compact excerpt for LoadReport fragments (``scripts/loadgen.py``):
    the tok/s series tail, the trailing-window token rate, and the
    current burn-rate gauges — a time-resolved record where the report
    would otherwise carry only end-of-run aggregates."""
    now = time.time() if now is None else float(now)
    tok = history.counter_window(
        'distllm_engine_generated_tokens_total', window_s, now=now
    )
    snap = history.snapshot(
        limit=max_points, prefix='distllm_engine_generated_tokens_total'
    )
    tok_series = snap['series'].get(
        'distllm_engine_generated_tokens_total', {'points': []}
    )
    burn: dict[str, float] = {}
    for window in _metrics.SLO_BURN_WINDOW_LABELS:
        value = history.gauge_window(
            'distllm_slo_burn_rate',
            window_s,
            labels={'window': window},
            agg='last',
            now=now,
        )
        if value is not None:
            burn[window] = value
    return {
        'window_s': window_s,
        'tok_s': tok['rate'],
        'tok_points': [
            [round(p[0], 3), round(p[2], 3)] for p in tok_series['points']
        ],
        'burn_rates': burn,
        'samples': history.samples,
    }


# ---------------------------------------------------------------- sampler
class HistorySampler:
    """Daemon thread ticking :meth:`MetricsHistory.sample_once` every
    ``interval_s`` (the StallWatchdog pattern: Event-paced loop,
    ``start()``/``stop()`` with a joined shutdown, context manager).
    A tick that raises is counted and never kills the thread. Exactly
    one sampler should own a history at a time — the chat server owns
    the process singleton in serving, the engine only when
    ``EngineConfig.history_interval_s`` > 0, bench/loadgen own it in
    scripted runs."""

    def __init__(
        self,
        history: MetricsHistory | None = None,
        *,
        interval_s: float = 1.0,
        name: str = SAMPLER_THREAD_NAME,
    ) -> None:
        if interval_s <= 0:
            raise ValueError('interval_s must be > 0')
        self.history = (
            history if history is not None else get_metrics_history()
        )
        self.interval_s = float(interval_s)
        self.name = name
        self._stop_event = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            try:
                self.history.sample_once()
            except Exception:
                _metrics.HISTORY_SAMPLE_ERRORS.inc()

    def start(self) -> 'HistorySampler':
        if self._thread is not None:
            raise RuntimeError('sampler already started')
        self.history.interval_hint_s = self.interval_s
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._run, name=self.name, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent; joins the thread (no leak after shutdown — the
        gen_history smoke asserts no live thread carries our name)."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> 'HistorySampler':
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()


_default_history = MetricsHistory()


def get_metrics_history() -> MetricsHistory:
    """The process-wide history ring (what ``/debug/history`` serves)."""
    return _default_history
