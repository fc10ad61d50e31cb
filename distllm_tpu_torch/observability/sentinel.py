"""Runtime regression sentinel: live history against a baseline envelope
(the port of ``distllm_tpu.observability.sentinel``).

A :class:`RegressionSentinel` is armed with a **baseline envelope** —
tok/s, TTFT / TPOT p95 and the measured roofline shares, distilled by
``observability/baseline.py`` from a benchmark record or read from an
envelope file the user names (``DISTLLM_BASELINE`` or
:meth:`RegressionSentinel.arm_from_file`); no envelope ships with the
port. On every history tick it compares each envelope metric against
the live trailing window.

A live window that degrades past ``threshold`` (default 20%) fires ONE
``regression`` flight record and one
``distllm_sentinel_regressions_total{metric}`` count, then latches until
the metric recovers. Windows with no traffic never fire.

Degraded modes are counted, never raised: a missing or unreadable
envelope disarms the sentinel (``distllm_sentinel_armed`` 0,
``distllm_sentinel_disarmed_total{reason}``) and serving proceeds.
"""

from __future__ import annotations

import threading
import time

from distllm_tpu_torch.observability import instruments as _metrics
from distllm_tpu_torch.observability.baseline import load_envelope
from distllm_tpu_torch.observability.flight import get_flight_recorder
from distllm_tpu_torch.observability.history import MetricsHistory

SENTINEL_SCHEMA = 'distllm-sentinel/v1'

#: Default comparison window and degradation threshold.
DEFAULT_WINDOW_S = 30.0
DEFAULT_THRESHOLD = 0.20


def _live_tok_s(history: MetricsHistory, window_s: float, now):
    win = history.counter_window(
        'distllm_engine_generated_tokens_total', window_s, now=now
    )
    if not win['delta']:
        # Idle window: zero tokens because nothing was asked for is not a
        # throughput regression (a wedge WITH queued work is the stall
        # watchdog's jurisdiction, not the sentinel's).
        return None
    return win['rate']


def _live_ttft_p95(history: MetricsHistory, window_s: float, now):
    return history.window_quantile(
        'distllm_request_ttft_seconds', 0.95, window_s, now=now
    )


def _live_tpot_p95(history: MetricsHistory, window_s: float, now):
    return history.window_quantile(
        'distllm_request_tpot_seconds', 0.95, window_s, now=now
    )


def _live_mfu(history: MetricsHistory, window_s: float, now):
    return history.gauge_window(
        'distllm_engine_mfu_measured', window_s,
        labels={'kind': 'decode'}, agg='max', now=now,
    )


def _live_bw_util(history: MetricsHistory, window_s: float, now):
    return history.gauge_window(
        'distllm_engine_bandwidth_utilization_measured', window_s,
        labels={'kind': 'decode'}, agg='max', now=now,
    )


# Live extractor per envelope metric. Keys mirror
# instruments.SENTINEL_METRIC_LABELS (the counter's pre-registered label
# set); an envelope metric with no extractor here is ignored. The
# measured-roofline gauges compare their window MAX (the best dispatch
# the window saw) so co-scheduled slow kinds don't read as kernel decay.
LIVE_EXTRACTORS = {
    'tok_s': _live_tok_s,
    'ttft_p95_s': _live_ttft_p95,
    'tpot_p95_s': _live_tpot_p95,
    'mfu_measured': _live_mfu,
    'bw_util_measured': _live_bw_util,
}
if set(LIVE_EXTRACTORS) != set(_metrics.SENTINEL_METRIC_LABELS):
    raise RuntimeError(
        'sentinel extractors out of sync with SENTINEL_METRIC_LABELS'
    )


class RegressionSentinel:
    """Latched live-window comparisons against a baseline envelope.

    Construct with an envelope dict (``baseline.load_envelope`` /
    ``build_envelope`` output) or arm later; :meth:`evaluate` runs one
    comparison pass and returns the regressions that fired *this call*;
    :meth:`install` attaches it to a history's observer list so the
    sampler drives it.
    """

    def __init__(
        self,
        history: MetricsHistory,
        *,
        envelope: dict | None = None,
        threshold: float = DEFAULT_THRESHOLD,
        window_s: float = DEFAULT_WINDOW_S,
        recorder=None,
    ) -> None:
        if threshold <= 0:
            raise ValueError('threshold must be > 0')
        if window_s <= 0:
            raise ValueError('window_s must be > 0')
        self.history = history
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self._recorder = recorder
        self._lock = threading.Lock()
        self._metrics: dict[str, dict] = {}  # guarded by self._lock
        self._degraded: set[str] = set()  # guarded by self._lock (episode latch)
        self._source = ''  # guarded by self._lock
        self._fired_total = 0  # guarded by self._lock
        if envelope is not None:
            self.arm(envelope)
        else:
            _metrics.SENTINEL_ARMED.set(0.0)  # not yet armed; not a counted disarm

    # ------------------------------------------------------------- arming
    def arm(self, envelope: dict | None) -> bool:
        """Install an envelope; returns armed state. An empty or invalid
        envelope degrades to a counted disarm, never a raise."""
        metrics = (envelope or {}).get('metrics') or {}
        usable = {
            name: entry
            for name, entry in metrics.items()
            if name in LIVE_EXTRACTORS
        }
        if not usable:
            reason = 'empty' if envelope else 'no_baseline'
            self.disarm(reason)
            return False
        with self._lock:
            self._metrics = usable
            self._degraded = set()
            self._source = str((envelope or {}).get('source', ''))
        _metrics.SENTINEL_ARMED.set(1.0)
        return True

    def arm_from_file(self, path) -> bool:
        """``load_envelope`` + :meth:`arm`; missing/unreadable counts as
        ``no_baseline`` and the sentinel stays disarmed."""
        envelope = load_envelope(path)
        if envelope is None:
            self.disarm('no_baseline')
            return False
        return self.arm(envelope)

    def disarm(self, reason: str) -> None:
        with self._lock:
            self._metrics = {}
            self._degraded = set()
        _metrics.SENTINEL_ARMED.set(0.0)
        _metrics.SENTINEL_DISARMED.labels(reason=reason).inc()

    @property
    def armed(self) -> bool:
        with self._lock:
            return bool(self._metrics)

    # ---------------------------------------------------------- evaluation
    def evaluate(self, now: float | None = None) -> list[dict]:
        """One comparison pass. Returns the regression events that fired
        on THIS call (newly entered degradation episodes); recovered
        metrics unlatch silently."""
        now = time.time() if now is None else float(now)
        with self._lock:
            baseline_metrics = dict(self._metrics)
        fired: list[dict] = []
        for name, entry in sorted(baseline_metrics.items()):
            baseline = entry['value']
            direction = entry.get('direction') or 'higher'
            if baseline <= 0:
                continue  # no meaningful relative comparison
            live = LIVE_EXTRACTORS[name](self.history, self.window_s, now)
            if live is None:
                continue  # no traffic in the window: never a false fire
            if direction == 'higher':
                degraded = live < baseline * (1.0 - self.threshold)
            else:
                degraded = live > baseline * (1.0 + self.threshold)
            with self._lock:
                newly = degraded and name not in self._degraded
                if degraded:
                    self._degraded.add(name)
                else:
                    self._degraded.discard(name)
                if newly:
                    self._fired_total += 1
            if newly:
                event = {
                    'metric': name,
                    'baseline': baseline,
                    'live': live,
                    'direction': direction,
                    'threshold': self.threshold,
                    'window_s': self.window_s,
                    'baseline_key': entry.get('from_key', ''),
                }
                _metrics.SENTINEL_REGRESSIONS.labels(metric=name).inc()
                recorder = (
                    self._recorder
                    if self._recorder is not None
                    else get_flight_recorder()
                )
                recorder.record('regression', **event)
                _metrics.log_event(
                    f'[sentinel] {name} degraded past '
                    f'{self.threshold:.0%}: baseline {baseline:.4g} -> '
                    f'live {live:.4g} over {self.window_s:.0f}s',
                    component='sentinel',
                )
                fired.append(event)
        return fired

    def install(self) -> 'RegressionSentinel':
        """Attach to the history's observer list (sampler-driven)."""
        self.history.add_observer(self._observe)
        return self

    def uninstall(self) -> None:
        self.history.remove_observer(self._observe)

    def _observe(self, history: MetricsHistory, now: float) -> None:
        self.evaluate(now)

    # -------------------------------------------------------------- status
    def status(self, now: float | None = None) -> dict:
        """Bundle/debug document: armed state, envelope, live values,
        and which metrics are currently latched degraded."""
        now = time.time() if now is None else float(now)
        with self._lock:
            baseline_metrics = dict(self._metrics)
            degraded = sorted(self._degraded)
            source = self._source
            fired_total = self._fired_total
        live = {
            name: LIVE_EXTRACTORS[name](self.history, self.window_s, now)
            for name in sorted(baseline_metrics)
        }
        return {
            'schema': SENTINEL_SCHEMA,
            'armed': bool(baseline_metrics),
            'source': source,
            'threshold': self.threshold,
            'window_s': self.window_s,
            'baseline': baseline_metrics,
            'live': live,
            'degraded': degraded,
            'fired_total': fired_total,
        }


_default_sentinel: RegressionSentinel | None = None
_default_sentinel_lock = threading.Lock()


def get_regression_sentinel() -> RegressionSentinel | None:
    """The process-wide sentinel, if one was installed (chat_server arms
    it from DISTLLM_BASELINE; None until then)."""
    return _default_sentinel


def install_regression_sentinel(
    history: MetricsHistory,
    *,
    baseline_path=None,
    envelope: dict | None = None,
    threshold: float = DEFAULT_THRESHOLD,
    window_s: float = DEFAULT_WINDOW_S,
) -> RegressionSentinel:
    """Create + install the process-wide sentinel (replacing any prior
    one). Arms from ``envelope`` if given, else ``baseline_path`` (a
    missing file is the counted disarmed mode)."""
    global _default_sentinel
    sentinel = RegressionSentinel(
        history, envelope=envelope, threshold=threshold, window_s=window_s
    )
    if envelope is None and baseline_path is not None:
        sentinel.arm_from_file(baseline_path)
    sentinel.install()
    with _default_sentinel_lock:
        previous = _default_sentinel
        _default_sentinel = sentinel
    if previous is not None:
        previous.uninstall()
    return sentinel
