"""Nanosecond timers with parseable log lines (the port of
``distllm_tpu.timer``; the same line format and parser).

``Timer`` is a shim over :mod:`distllm_tpu_torch.observability`: each stop
prints the ``[timer]`` line below (so ``TimeLogger.parse_logs`` and
``observability.aggregate`` read it), records a
:class:`~distllm_tpu_torch.observability.tracing.Span` in the process trace
ring, tagged ``ok`` / ``error`` by how the timed block exited, and
observes ``distllm_stage_duration_seconds{stage,status}``.

Line format (one line per completed span)::

    [timer] tags=load-encoder,file-3 elapsed_s=1.234567890 start_ns=... end_ns=...

Device work is asynchronous: a span around GPU work measures the device
only if the timed block ends in a synchronisation.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

from distllm_tpu_torch.observability import instruments, tracing

_LINE_RE = re.compile(
    r'\[timer\] tags=(?P<tags>\S*) '
    r'elapsed_s=(?P<elapsed>[0-9.eE+-]+) '
    r'start_ns=(?P<start>\d+) end_ns=(?P<end>\d+)'
)


@dataclass
class TimeStats:
    """Aggregated statistics for one tag set."""

    tags: tuple[str, ...]
    elapsed_s: list[float] = field(default_factory=list)
    start_ns: list[int] = field(default_factory=list)
    end_ns: list[int] = field(default_factory=list)

    @property
    def total_s(self) -> float:
        return sum(self.elapsed_s)

    @property
    def mean_s(self) -> float:
        return self.total_s / len(self.elapsed_s) if self.elapsed_s else 0.0

    @property
    def count(self) -> int:
        return len(self.elapsed_s)

    def _percentile(self, q: float) -> float:
        """Nearest-rank percentile (0.0 on empty stats, like ``mean_s``)."""
        if not self.elapsed_s:
            return 0.0
        ordered = sorted(self.elapsed_s)
        rank = max(1, math.ceil(q * len(ordered)))
        return ordered[rank - 1]

    @property
    def p50_s(self) -> float:
        return self._percentile(0.50)

    @property
    def p95_s(self) -> float:
        return self._percentile(0.95)

    @property
    def p99_s(self) -> float:
        return self._percentile(0.99)

    @property
    def max_s(self) -> float:
        return max(self.elapsed_s) if self.elapsed_s else 0.0


class Timer:
    """Context manager that times a span and prints a parseable line.

    >>> with Timer('load-encoder', 'file-3'):
    ...     do_work()
    """

    def __init__(self, *tags: str, echo: bool = True) -> None:
        self.tags = tuple(str(t) for t in tags)
        self.echo = echo
        self.start_ns: int | None = None
        self.end_ns: int | None = None
        self.status: str | None = None
        self._span: tracing.Span | None = None

    @property
    def elapsed_s(self) -> float:
        if self.start_ns is None:
            raise RuntimeError(
                'Timer.elapsed_s read before start() — a never-started '
                'timer has no elapsed time'
            )
        end = self.end_ns if self.end_ns is not None else time.monotonic_ns()
        return (end - self.start_ns) / 1e9

    def start(self) -> 'Timer':
        if self._span is not None:  # restart without stop(): drop stale span
            tracing.abandon_span(self._span)
        self._span = tracing.begin_span(
            self.tags[0] if self.tags else 'timer', *self.tags
        )
        self.start_ns = self._span.start_ns
        self.end_ns = None
        self.status = None
        return self

    def stop(self, status: str | None = None,
             error: BaseException | None = None) -> float:
        if self.start_ns is None or self._span is None:
            raise RuntimeError('Timer.stop() called before start()')
        self.status = status or 'ok'
        finished = tracing.end_span(self._span, status=self.status, error=error)
        self.end_ns = finished.end_ns
        self._span = None
        instruments.STAGE_SECONDS.labels(
            stage=self.tags[0] if self.tags else 'untagged',
            status=self.status,
        ).observe(self.elapsed_s)
        if self.echo:
            print(self.log_line(), flush=True)
        return self.elapsed_s

    def log_line(self) -> str:
        return (
            f'[timer] tags={",".join(self.tags)} '
            f'elapsed_s={self.elapsed_s:.9f} '
            f'start_ns={self.start_ns} end_ns={self.end_ns}'
        )

    def __enter__(self) -> 'Timer':
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        # The legacy line is printed either way (log scrapers expect every
        # span); only the span record distinguishes failed work.
        self.stop(
            status='error' if exc_type is not None else 'ok',
            error=exc if isinstance(exc, BaseException) else None,
        )


class TimeLogger:
    """Parse ``[timer]`` lines from captured stdout/log files back to
    stats. Multi-file, multi-host rollups live in
    ``distllm_tpu_torch.observability.aggregate``."""

    def parse_lines(self, lines: list[str] | str) -> dict[tuple[str, ...], TimeStats]:
        if isinstance(lines, str):
            lines = lines.splitlines()
        stats: dict[tuple[str, ...], TimeStats] = {}
        for line in lines:
            m = _LINE_RE.search(line)
            if not m:
                continue
            tags = tuple(t for t in m.group('tags').split(',') if t)
            entry = stats.setdefault(tags, TimeStats(tags=tags))
            entry.elapsed_s.append(float(m.group('elapsed')))
            entry.start_ns.append(int(m.group('start')))
            entry.end_ns.append(int(m.group('end')))
        return stats

    def parse_logs(self, path: str | Path) -> dict[tuple[str, ...], TimeStats]:
        return self.parse_lines(Path(path).read_text().splitlines())
