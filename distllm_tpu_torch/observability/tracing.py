"""In-process span tracing with a bounded ring buffer (the port of
``distllm_tpu.observability.tracing``).

A
:class:`Span` records one timed region (name + tags + outcome + nanosecond
bounds + parent linkage), completed spans land in a process-wide
:class:`TraceBuffer` ring (old spans are evicted, memory stays bounded), and
the buffer dumps to JSONL for offline analysis. Nesting is tracked with a
thread-local stack, so spans opened inside other spans carry
``parent_id`` automatically — including across the engine's worker thread
vs. event loop split (each thread has its own stack, as it should:
cross-thread parentage would be a lie).

The clock is ``time.monotonic_ns`` to match ``timer.Timer``; ``wall_time_s``
is captured once at span start so dumps can be correlated with external
logs.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

_span_ids = itertools.count(1)
_local = threading.local()

# Request-scoped trace propagation (docs/observability.md): the chat server
# binds the inbound X-Request-Id here for the duration of one request's
# work, every span opened inside the scope is stamped with it, and the
# engine copies it onto the Request lifecycle (flight records included) —
# so one id correlates server middleware, RAG retrieval, engine dispatches,
# and the response the client got it echoed in. A ContextVar (not a plain
# thread-local): the binding must survive explicit Context.run handoffs
# while staying isolated between concurrently served requests.
_request_id = contextvars.ContextVar('distllm_request_id', default=None)


def current_request_id() -> str | None:
    """The request id bound by the innermost :func:`request_scope`."""
    return _request_id.get()


@contextmanager
def request_scope(request_id: str | None):
    """Bind ``request_id`` as the current request for this context.

    Spans opened inside the scope carry ``request_id`` in their
    attributes, and ``LLMEngine.add_request`` stamps it onto the request's
    lifecycle (``trace_id``). ``None`` is a no-op scope so call sites can
    pass an optional id through unconditionally.
    """
    if request_id is None:
        yield
        return
    token = _request_id.set(str(request_id))
    try:
        yield
    finally:
        _request_id.reset(token)


def _stack() -> list['Span']:
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


@dataclass
class Span:
    """One timed region. ``status`` is ``'ok'`` or ``'error'``."""

    name: str
    tags: tuple[str, ...] = ()
    span_id: int = 0
    parent_id: int | None = None
    start_ns: int = 0
    end_ns: int | None = None
    status: str = 'ok'
    error: str | None = None
    wall_time_s: float = 0.0
    attributes: dict[str, object] = field(default_factory=dict)
    # Opening thread's ident: the Perfetto exporter keys a track per
    # thread so concurrently open spans from different threads don't
    # render as one impossibly overlapping stack.
    thread_id: int = 0

    @property
    def duration_s(self) -> float:
        if self.end_ns is None:
            raise RuntimeError(f'span {self.name!r} has not finished')
        return (self.end_ns - self.start_ns) / 1e9

    def to_dict(self) -> dict[str, object]:
        record: dict[str, object] = {
            'name': self.name,
            'tags': list(self.tags),
            'span_id': self.span_id,
            'parent_id': self.parent_id,
            'start_ns': self.start_ns,
            'end_ns': self.end_ns,
            'duration_s': self.duration_s if self.end_ns is not None else None,
            'status': self.status,
            'wall_time_s': self.wall_time_s,
            'thread_id': self.thread_id,
        }
        if self.error is not None:
            record['error'] = self.error
        if self.attributes:
            record['attributes'] = dict(self.attributes)
        return record


class TraceBuffer:
    """Bounded ring of completed spans (oldest evicted first)."""

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError('capacity must be >= 1')
        self.capacity = capacity
        self._spans: deque[Span] = deque(maxlen=capacity)  # guarded by self._lock
        self._lock = threading.Lock()
        self._recorded = 0  # guarded by self._lock

    def record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            self._recorded += 1

    def snapshot(self, limit: int | None = None) -> list[Span]:
        """Most recent spans, oldest first (``limit`` trims from the old
        end)."""
        with self._lock:
            spans = list(self._spans)
        if limit is not None:
            spans = spans[-limit:]
        return spans

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    @property
    def total_recorded(self) -> int:
        """Lifetime record count (survives ring eviction)."""
        with self._lock:
            return self._recorded

    def dump_jsonl(self, path: str | Path) -> int:
        """Write one JSON object per span; returns the number written."""
        spans = self.snapshot()
        with open(path, 'w') as handle:
            for span in spans:
                handle.write(json.dumps(span.to_dict()) + '\n')
        return len(spans)


_default_buffer = TraceBuffer()


def get_trace_buffer() -> TraceBuffer:
    """The process-wide trace ring (what ``/debug/traces`` serves)."""
    return _default_buffer


def dump_traces(path: str | Path) -> int:
    return _default_buffer.dump_jsonl(path)


def begin_span(name: str, *tags: str, **attributes: object) -> Span:
    """Open a span and push it on the thread-local nesting stack.

    Prefer the :func:`span` context manager; ``begin_span``/``end_span``
    exist for shims (``timer.Timer``) whose start/stop are separate calls.
    """
    stack = _stack()
    parent = stack[-1].span_id if stack else None
    record = Span(
        name=name,
        tags=tuple(str(t) for t in tags),
        span_id=next(_span_ids),
        parent_id=parent,
        start_ns=time.monotonic_ns(),
        wall_time_s=time.time(),
        attributes=dict(attributes),
        thread_id=threading.get_ident(),
    )
    rid = _request_id.get()
    if rid is not None and 'request_id' not in record.attributes:
        record.attributes['request_id'] = rid
    stack.append(record)
    return record


def end_span(
    record: Span,
    status: str = 'ok',
    error: BaseException | str | None = None,
    buffer: TraceBuffer | None = None,
) -> Span:
    """Close a span, pop it from the nesting stack, record it."""
    record.end_ns = time.monotonic_ns()
    record.status = status
    if error is not None:
        record.error = repr(error) if isinstance(error, BaseException) else str(error)
    stack = _stack()
    if record in stack:  # tolerate out-of-order shim stops
        stack.remove(record)
    # NOT `buffer or ...`: an empty TraceBuffer is falsy (it has __len__).
    target = _default_buffer if buffer is None else buffer
    target.record(record)
    return record


def abandon_span(record: Span) -> None:
    """Drop an open span from the nesting stack without recording it.

    For shims whose start/stop are separate calls (``timer.Timer``): a
    re-``start()`` with no intervening ``stop()`` must not leave the stale
    span on the thread-local stack, where it would parent every later span
    and grow the stack unboundedly.
    """
    stack = _stack()
    if record in stack:
        stack.remove(record)


@contextmanager
def span(name: str, *tags: str, buffer: TraceBuffer | None = None,
         **attributes: object):
    """Trace a region::

        with span('prefill', 'bucket-128', batch=4) as s:
            ...

    Exceptions mark the span ``status='error'`` (with the exception repr)
    and propagate.
    """
    record = begin_span(name, *tags, **attributes)
    try:
        yield record
    except BaseException as exc:
        end_span(record, status='error', error=exc, buffer=buffer)
        raise
    end_span(record, status='ok', buffer=buffer)
