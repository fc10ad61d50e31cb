"""Dependency-free metrics registry with Prometheus text exposition (the
port of ``distllm_tpu.observability.metrics``; the exposition is byte for
byte the JAX package's for the same observations).

The measurement substrate for the serving stack: a
process-wide registry of :class:`Counter` / :class:`Gauge` /
:class:`Histogram` instruments, each optionally labeled, rendered on demand
in the Prometheus text exposition format (version 0.0.4) by
:func:`render_prometheus` — no ``prometheus_client`` dependency (this image
has no egress; the format is small and stable).

Design notes:

- ``registry.counter(...)`` is get-or-create: re-instantiating an engine or
  server in one process returns the same instrument instead of raising, so
  call sites never need import-order gymnastics. A name collision across
  *types* (or differing label names) is a programming error and raises.
- Unlabeled instruments are used directly (``c.inc()``); labeled ones vend
  children via ``c.labels(stage='prefill').inc()``. A labeled series only
  renders once a child exists — pre-create children for series that must
  appear in scrapes from the first request (``instruments.py`` does).
- Histograms use **fixed log-scale buckets** (:func:`log_buckets`) so wide
  dynamic ranges (100 µs kernel dispatch .. minutes-long compile) stay
  resolvable with ~20 buckets; bucket counts are cumulative per the
  Prometheus histogram contract.
- Everything is guarded by per-instrument locks: the chat server observes
  from its handler threads while the engine thread increments token
  counters.
"""

from __future__ import annotations

import math
import re
import threading

_NAME_RE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*$')
_LABEL_RE = re.compile(r'^[a-zA-Z_][a-zA-Z0-9_]*$')


def log_buckets(
    lo: float, hi: float, per_decade: int = 3
) -> tuple[float, ...]:
    """Fixed log-scale bucket ladder covering ``[lo, hi]``.

    ``per_decade`` points per power of ten (3 gives the classic
    1 / 2.15 / 4.64 ladder). Upper bounds are rounded to 6 significant
    digits so the ``le`` labels stay readable in scrapes.
    """
    if lo <= 0 or hi <= lo:
        raise ValueError(f'need 0 < lo < hi, got lo={lo} hi={hi}')
    buckets: list[float] = []
    exponent = math.log10(lo)
    while True:
        value = float(f'{10 ** exponent:.6g}')
        buckets.append(value)
        if value >= hi:
            break
        exponent += 1.0 / per_decade
    return tuple(buckets)


# Default for duration histograms: 100 µs .. ~100 s, 3 buckets per decade.
DEFAULT_DURATION_BUCKETS = log_buckets(1e-4, 100.0)


def quantile_from_cumulative(
    buckets: tuple[float, ...], cumulative: list[int], q: float
) -> float | None:
    """Quantile estimate by linear interpolation over cumulative bucket
    counts (the ``histogram_quantile`` estimator, so numbers read off a
    loadgen report match what the same expression over ``/metrics`` would
    say). ``cumulative`` has ``len(buckets) + 1`` entries, the last being
    the +Inf bucket. Returns ``None`` on an empty histogram. Ranks that
    land in the +Inf bucket clamp to the highest finite bound — an
    estimator cannot invent an upper edge the ladder never recorded.

    Also the delta-quantile building block: subtract two
    ``cumulative_counts()`` snapshots element-wise and pass the result, and
    the estimate covers only the observations between them (how the
    ``gen_load`` bench stage isolates its own traffic from warmup's).
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f'quantile must be in [0, 1], got {q}')
    total = cumulative[-1]
    if total <= 0:
        return None
    rank = q * total
    for i, count in enumerate(cumulative):
        if count >= rank and count > 0:
            if i >= len(buckets):  # +Inf bucket: clamp to last finite edge
                return float(buckets[-1])
            lo = buckets[i - 1] if i > 0 else 0.0
            prev = cumulative[i - 1] if i > 0 else 0
            in_bucket = count - prev
            if in_bucket <= 0:
                return float(buckets[i])
            frac = (rank - prev) / in_bucket
            return float(lo + (buckets[i] - lo) * frac)
    return float(buckets[-1])


def _escape_label_value(value: str) -> str:
    return (
        value.replace('\\', '\\\\').replace('"', '\\"').replace('\n', '\\n')
    )


def _format_value(value: float) -> str:
    if value == math.inf:
        return '+Inf'
    if value == -math.inf:
        return '-Inf'
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _label_suffix(labelnames: tuple[str, ...], labelvalues: tuple[str, ...],
                  extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = list(zip(labelnames, labelvalues)) + list(extra)
    if not pairs:
        return ''
    inner = ','.join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in pairs
    )
    return '{' + inner + '}'


class _CounterChild:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0  # guarded by self._lock

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError('counters can only increase')
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0  # guarded by self._lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistogramChild:
    def __init__(self, buckets: tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self.buckets = buckets
        self._counts = [0] * (len(buckets) + 1)  # guarded by self._lock (last slot = +Inf)
        self._sum = 0.0  # guarded by self._lock

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative_counts(self) -> list[int]:
        """Bucket counts as cumulative totals (the exposition contract)."""
        with self._lock:
            out, running = [], 0
            for n in self._counts:
                running += n
                out.append(running)
            return out

    def quantile(self, q: float) -> float | None:
        """Estimated ``q``-quantile of the observed distribution
        (:func:`quantile_from_cumulative` over this child's counts)."""
        return quantile_from_cumulative(
            self.buckets, self.cumulative_counts(), q
        )


class _Metric:
    """Shared labeled-family machinery; vends per-labelset children."""

    kind = 'untyped'

    def __init__(
        self, name: str, help: str, labelnames: tuple[str, ...]
    ) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f'invalid metric name {name!r}')
        for label in labelnames:
            if not _LABEL_RE.match(label):
                raise ValueError(f'invalid label name {label!r}')
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple[str, ...], object] = {}  # guarded by self._lock
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labelvalues: str):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f'{self.name} expects labels {self.labelnames}, '
                f'got {tuple(labelvalues)}'
            )
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(
                f'{self.name} is labeled {self.labelnames}; use .labels()'
            )
        # distlint: disable=lock-discipline -- unlabeled families write {(): child} once in __init__ and never mutate again (labels() guards the mutating path); locking here would put a second lock acquisition on every inc/observe in the serving loop
        return self._children[()]

    def children(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


class Counter(_Metric):
    """Monotonic counter (``*_total`` naming convention)."""

    kind = 'counter'

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class Gauge(_Metric):
    """Instantaneous value that can go up and down."""

    kind = 'gauge'

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class Histogram(_Metric):
    """Cumulative histogram over fixed log-scale buckets."""

    kind = 'histogram'

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: tuple[str, ...] = (),
        buckets: tuple[float, ...] | None = None,
    ) -> None:
        chosen = tuple(buckets) if buckets else DEFAULT_DURATION_BUCKETS
        if list(chosen) != sorted(chosen) or len(set(chosen)) != len(chosen):
            raise ValueError('histogram buckets must be strictly increasing')
        self.buckets = chosen
        super().__init__(name, help, labelnames)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float) -> None:
        self._default_child().observe(value)

    @property
    def count(self) -> int:
        return self._default_child().count

    @property
    def sum(self) -> float:
        return self._default_child().sum

    def quantile(self, q: float) -> float | None:
        """Estimated ``q``-quantile (linear interpolation over cumulative
        bucket counts; ``None`` while the histogram is empty). Labeled
        histograms expose the same method on each ``labels(...)`` child."""
        return self._default_child().quantile(q)

    def cumulative_counts(self) -> list[int]:
        """Cumulative bucket counts of the unlabeled series — snapshot
        two of these and difference them element-wise into
        :func:`quantile_from_cumulative` to get quantiles over just the
        observations in between (the loadgen report does)."""
        return self._default_child().cumulative_counts()


class MetricsRegistry:
    """Named collection of instruments with text exposition."""

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}  # guarded by self._lock
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f'{name} already registered as {existing.kind}'
                    )
                if existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f'{name} already registered with labels '
                        f'{existing.labelnames}'
                    )
                return existing
            metric = cls(name, help, tuple(labelnames), **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str = '', labelnames: tuple[str, ...] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(
        self, name: str, help: str = '', labelnames: tuple[str, ...] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = '',
        labelnames: tuple[str, ...] = (),
        buckets: tuple[float, ...] | None = None,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> list[dict]:
        """Structured snapshot of every instrument — the machine-readable
        twin of :meth:`render`, consumed by the history sampler
        (``history.py``) so it never has to re-parse exposition text.

        One dict per family: ``{'name', 'kind', 'labelnames',
        'children': [...]}``. Each child carries its label values plus
        ``value`` (counter/gauge) or ``buckets``/``cumulative``/``sum``
        (histogram, cumulative counts per the exposition contract).
        Per-child reads take the child locks; the snapshot is coherent
        per-child, not across the whole registry — the same guarantee a
        text scrape gives.
        """
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        families: list[dict] = []
        for metric in metrics:
            children = []
            for labelvalues, child in metric.children():
                if isinstance(child, _HistogramChild):
                    children.append({
                        'labels': labelvalues,
                        'buckets': child.buckets,
                        'cumulative': child.cumulative_counts(),
                        'sum': child.sum,
                    })
                else:
                    children.append({
                        'labels': labelvalues,
                        'value': child.value,
                    })
            families.append({
                'name': metric.name,
                'kind': metric.kind,
                'labelnames': metric.labelnames,
                'children': children,
            })
        return families

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        with self._lock:
            metrics = [self._metrics[k] for k in sorted(self._metrics)]
        lines: list[str] = []
        for metric in metrics:
            if metric.help:
                lines.append(f'# HELP {metric.name} {metric.help}')
            lines.append(f'# TYPE {metric.name} {metric.kind}')
            for labelvalues, child in metric.children():
                if isinstance(child, _HistogramChild):
                    cumulative = child.cumulative_counts()
                    bounds = list(child.buckets) + [math.inf]
                    for bound, count in zip(bounds, cumulative):
                        suffix = _label_suffix(
                            metric.labelnames,
                            labelvalues,
                            extra=(('le', _format_value(bound)),),
                        )
                        lines.append(
                            f'{metric.name}_bucket{suffix} {count}'
                        )
                    base = _label_suffix(metric.labelnames, labelvalues)
                    lines.append(
                        f'{metric.name}_sum{base} '
                        f'{_format_value(child.sum)}'
                    )
                    lines.append(
                        f'{metric.name}_count{base} {cumulative[-1]}'
                    )
                else:
                    suffix = _label_suffix(metric.labelnames, labelvalues)
                    lines.append(
                        f'{metric.name}{suffix} '
                        f'{_format_value(child.value)}'
                    )
        return '\n'.join(lines) + '\n'


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (what ``/metrics`` exposes)."""
    return _default_registry


def render_prometheus() -> str:
    return _default_registry.render()
