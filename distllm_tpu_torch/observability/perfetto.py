"""Perfetto / Chrome trace-event export of the observability state (the
port of ``distllm_tpu.observability.perfetto``; the same tracks, names
and validator).

:func:`to_trace_events` renders the flight ring, the span ring and the
per-request lifecycles as one Chrome trace-event JSON document, which
``chrome://tracing`` and https://ui.perfetto.dev open directly:

- one track per engine window kind (``prefill`` / ``decode`` / ``mixed``
  / ``spec``), each dispatch a complete slice with its flight fields
  (batch, tokens, MFU, bandwidth share, the host / put / dispatch / fetch
  split) as args;
- a ``startup`` track of start-up phase slices (``compile`` flight
  records from ``observability/startup.py``: CUDA context, kernel
  builds, weight load, graph captures);
- a ``host`` track whose slices are the gaps between windows;
- one track per request (keyed by the ``X-Request-Id`` when present),
  its enqueue -> finish lifecycle with nested TTFT and queue-wait
  slices;
- server spans from the trace ring: a span stamped with a
  ``request_id`` lands on that request's track, the rest on per-thread
  tracks;
- a ``history`` group of counter tracks (ph ``'C'``) from the metric
  history ring.

Served at ``GET /debug/perfetto``, written as ``perfetto.json`` into
every debug bundle, and merged across hosts by
``observability.aggregate --perfetto``. Records are plain dicts, so
bundles from a dead process replay identically.
"""

from __future__ import annotations

import json
from pathlib import Path

from distllm_tpu_torch.observability.instruments import (
    FLIGHT_KINDS,
    TRACE_EVENT_CATEGORIES,
)

# Fixed tid layout: window-kind tracks first (stable ordering in the UI),
# then the startup / host-gap tracks, then dynamically allocated request /
# thread tracks.
_KIND_TIDS = {'prefill': 1, 'decode': 2, 'mixed': 3, 'spec': 4}
_STARTUP_TID = 8
_HOST_TID = 9
_EVENT_TID = 10
_HISTORY_TID = 11
_REQUEST_TID_BASE = 100
_THREAD_TID_BASE = 10_000

# Metric-history series rendered as Perfetto counter tracks (ph 'C'):
# (history series key, counter track name, value column in the rendered
# snapshot points — counters are [t, delta, rate], gauges [t, value]).
# A curated subset, not the whole ring: the load/latency shape an
# incident reader scrubs the trace against.
_HISTORY_TRACK_SERIES = (
    ('distllm_engine_generated_tokens_total', 'tok/s', 2),
    ('distllm_slo_burn_rate{window=60s}', 'slo_burn:60s', 1),
    ('distllm_slo_burn_rate{window=600s}', 'slo_burn:600s', 1),
    ('distllm_scheduler_queue_depth', 'queue_depth', 1),
    ('distllm_kv_cache_occupancy_ratio', 'kv_occupancy', 1),
)

# Flight fields that become their own event structure rather than args.
_STEP_META = ('kind', 't_wall', 'duration_s')


def _slice(name, ts_us, dur_us, pid, tid, args=None, *, cat) -> dict:
    event = {
        'name': str(name),
        'cat': cat,
        'ph': 'X',
        'ts': round(ts_us, 3),
        'dur': round(max(0.0, dur_us), 3),
        'pid': pid,
        'tid': tid,
    }
    if args:
        event['args'] = args
    return event


def _instant(name, ts_us, pid, tid, args=None, *, cat) -> dict:
    event = {
        'name': str(name),
        'cat': cat,
        'ph': 'i',
        's': 't',
        'ts': round(ts_us, 3),
        'pid': pid,
        'tid': tid,
    }
    if args:
        event['args'] = args
    return event


def _meta(name, value, pid, tid=None) -> dict:
    event = {
        'name': name,
        'ph': 'M',
        'ts': 0,
        'pid': pid,
        'args': {'name': value},
    }
    if tid is not None:
        event['tid'] = tid
    return event


def trace_time_origin(flight_records, spans=()) -> float | None:
    """Earliest wall-clock second any record/span covers (slice starts,
    not record times), or ``None`` when there is nothing to render. The
    multi-host merge computes ONE origin across every host's captures so
    their tracks share a timeline."""
    starts: list[float] = []
    for record in flight_records:
        t_wall = record.get('t_wall')
        if not isinstance(t_wall, (int, float)):
            continue
        dur = record.get('duration_s') or record.get('e2e_s') or 0.0
        starts.append(float(t_wall) - float(dur or 0.0))
    for span in spans:
        wall = span.get('wall_time_s')
        if isinstance(wall, (int, float)):
            starts.append(float(wall))
    return min(starts) if starts else None


def to_trace_events(
    flight_records,
    spans=(),
    *,
    pid: int = 1,
    process_name: str = 'distllm',
    time_origin_s: float | None = None,
    history=None,
) -> dict:
    """Render flight records + span dicts into a Chrome trace-event doc.

    ``flight_records`` are ``FlightRecorder.snapshot()`` dicts (or parsed
    ``flight.jsonl`` lines); ``spans`` are ``Span.to_dict()`` dicts (or
    parsed ``traces.jsonl`` lines); ``history`` (optional) is a
    ``MetricsHistory`` or its ``snapshot()`` document, rendered as
    counter tracks (ph ``'C'``, the ``history`` category) for the
    curated ``_HISTORY_TRACK_SERIES`` — tok/s, burn rates, queue depth,
    KV occupancy over the trace window. Returns
    ``{'traceEvents': [...], 'displayTimeUnit': 'ms'}`` with every track's
    events in non-decreasing ``ts`` order — the invariant the exporter
    tests pin. Unknown/torn records are skipped, never fatal: this runs
    inside debug bundles for dying processes.
    """
    origin = time_origin_s
    if origin is None:
        origin = trace_time_origin(flight_records, spans) or 0.0

    def us(wall_s: float) -> float:
        return (float(wall_s) - origin) * 1e6

    events: list[dict] = []
    meta: list[dict] = [_meta('process_name', process_name, pid)]
    request_tids: dict[str, int] = {}
    thread_tids: dict[int, int] = {}

    def request_tid(key: str) -> int:
        tid = request_tids.get(key)
        if tid is None:
            tid = _REQUEST_TID_BASE + len(request_tids)
            request_tids[key] = tid
            meta.append(_meta('thread_name', f'request {key}', pid, tid))
        return tid

    # ---- engine step tracks + the host-gap track -----------------------
    windows: list[tuple[float, float]] = []  # (start_s, end_s)
    for record in flight_records:
        kind = record.get('kind')
        t_wall = record.get('t_wall')
        if kind not in FLIGHT_KINDS or not isinstance(t_wall, (int, float)):
            continue
        args = {
            k: v for k, v in record.items()
            if k not in _STEP_META and v is not None
        }
        if kind in _KIND_TIDS:
            duration = float(record.get('duration_s') or 0.0)
            start = float(t_wall) - duration
            windows.append((start, float(t_wall)))
            events.append(_slice(
                kind, us(start), duration * 1e6,
                pid, _KIND_TIDS[kind], args, cat='engine_step',
            ))
        elif kind == 'compile':
            # Startup track: one slice per compile phase (warmup shapes,
            # backend init, layout migration — observability/startup.py).
            # Deliberately NOT a host-gap window: the gap track measures
            # serving-loop idleness, not the compile ladder.
            duration = float(record.get('duration_s') or 0.0)
            start = float(t_wall) - duration
            name = f"{record.get('phase', 'compile')}:{record.get('shape', '')}"
            events.append(_slice(
                name, us(start), duration * 1e6,
                pid, _STARTUP_TID, args, cat='startup',
            ))
        elif kind == 'request':
            e2e = record.get('e2e_s')
            if not isinstance(e2e, (int, float)):
                continue  # pre-attribution record: no reconstructable start
            key = str(
                record.get('trace_id') or f"rid-{record.get('request_id')}"
            )
            tid = request_tid(key)
            start = float(t_wall) - float(e2e)
            events.append(_slice(
                key, us(start), float(e2e) * 1e6, pid, tid, args,
                cat='request',
            ))
            ttft = record.get('ttft_s')
            if isinstance(ttft, (int, float)):
                events.append(_slice(
                    'ttft', us(start), float(ttft) * 1e6,
                    pid, tid, cat='request',
                ))
            queue_wait = record.get('queue_wait_s')
            if isinstance(queue_wait, (int, float)):
                events.append(_slice(
                    'queue_wait', us(start),
                    float(queue_wait) * 1e6, pid, tid, cat='request',
                ))
        else:  # preempt / event: instants on their own track
            events.append(_instant(
                kind, us(float(t_wall)), pid, _EVENT_TID,
                args, cat='engine_event',
            ))

    windows.sort()
    prev_end = None
    for start, end in windows:
        if prev_end is not None and start > prev_end:
            events.append(_slice(
                'host_gap', us(prev_end),
                (start - prev_end) * 1e6, pid, _HOST_TID, cat='host_gap',
            ))
        prev_end = end if prev_end is None else max(prev_end, end)

    # ---- spans ---------------------------------------------------------
    for span in spans:
        name = span.get('name')
        wall = span.get('wall_time_s')
        duration = span.get('duration_s')
        if (
            name is None
            or not isinstance(wall, (int, float))
            or not isinstance(duration, (int, float))
        ):
            continue  # open span / torn line
        attrs = span.get('attributes') or {}
        args = {
            'tags': span.get('tags') or [],
            'status': span.get('status'),
            **{k: v for k, v in attrs.items() if v is not None},
        }
        rid = attrs.get('request_id')
        if rid is not None:
            tid = request_tid(str(rid))
        else:
            ident = int(span.get('thread_id') or 0)
            tid = thread_tids.get(ident)
            if tid is None:
                tid = _THREAD_TID_BASE + len(thread_tids)
                thread_tids[ident] = tid
                meta.append(_meta(
                    'thread_name', f'spans (thread {ident})', pid, tid,
                ))
        events.append(_slice(
            name, us(float(wall)), float(duration) * 1e6, pid, tid,
            args, cat='span',
        ))

    # ---- metric-history counter tracks ---------------------------------
    if history is not None:
        snap = history if isinstance(history, dict) else history.snapshot()
        hist_series = snap.get('series', {}) if isinstance(snap, dict) else {}
        emitted_any = False
        for key, track_name, value_index in _HISTORY_TRACK_SERIES:
            entry = hist_series.get(key)
            if not isinstance(entry, dict):
                continue
            for point in entry.get('points', ()):
                try:
                    t_point = float(point[0])
                    value = point[value_index]
                except (TypeError, ValueError, IndexError):
                    continue
                if isinstance(value, bool) or not isinstance(
                    value, (int, float)
                ):
                    continue
                emitted_any = True
                events.append({
                    'name': track_name,
                    'cat': 'history',
                    'ph': 'C',
                    'ts': round(us(t_point), 3),
                    'pid': pid,
                    'tid': _HISTORY_TID,
                    'args': {'value': round(float(value), 6)},
                })
        if emitted_any:
            meta.append(_meta(
                'thread_name', 'history (metric counters)',
                pid, _HISTORY_TID,
            ))

    for kind, tid in sorted(_KIND_TIDS.items(), key=lambda kv: kv[1]):
        meta.append(_meta('thread_name', f'engine:{kind}', pid, tid))
    meta.append(_meta('thread_name', 'startup (compile phases)',
                      pid, _STARTUP_TID))
    meta.append(_meta('thread_name', 'host (gaps between windows)',
                      pid, _HOST_TID))
    meta.append(_meta('thread_name', 'engine events', pid, _EVENT_TID))

    # Per-track non-decreasing ts; wider slices first at equal ts so
    # nested children (ttft inside a request slice) follow their parent.
    events.sort(key=lambda e: (e['tid'], e['ts'], -e.get('dur', 0.0)))
    return {'traceEvents': meta + events, 'displayTimeUnit': 'ms'}


def merge_host_traces(hosts: list[tuple[str, list, list]]) -> dict:
    """Merge per-host captures into ONE trace with per-host track groups.

    ``hosts`` is ``[(host_name, flight_records, spans), ...]`` (what
    ``aggregate.py --perfetto`` builds from any mix of ``flight.jsonl`` /
    ``traces.jsonl`` dumps). Each host becomes its own process group
    (pid), and every host shares a single time origin so cross-host skew
    reads directly off the timeline.
    """
    origins = [
        origin
        for _, records, spans in hosts
        if (origin := trace_time_origin(records, spans)) is not None
    ]
    origin = min(origins) if origins else 0.0
    merged: list[dict] = []
    for i, (name, records, spans) in enumerate(hosts):
        doc = to_trace_events(
            records, spans, pid=i + 1, process_name=str(name),
            time_origin_s=origin,
        )
        merged.extend(doc['traceEvents'])
    return {'traceEvents': merged, 'displayTimeUnit': 'ms'}


def validate_trace_events(doc: dict) -> list[str]:
    """Structural validation of a trace-event document; returns a list of
    violations (empty = valid). The invariants the exporter tests (and
    the ``GET /debug/perfetto`` round-trip test) assert:

    - the document is JSON-serializable with a ``traceEvents`` list;
    - every event has ``ph``/``pid``/``ts`` and a registered ``cat``
      (non-metadata events);
    - duration events are complete ``X`` slices (or properly matched
      ``B``/``E`` pairs) with non-negative ``dur``;
    - per ``(pid, tid)`` track, ``ts`` is non-decreasing.
    """
    problems: list[str] = []
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as exc:
        return [f'not JSON-serializable: {exc!r}']
    events = doc.get('traceEvents')
    if not isinstance(events, list):
        return ['traceEvents is not a list']
    last_ts: dict[tuple, float] = {}
    open_stacks: dict[tuple, list[str]] = {}
    for i, event in enumerate(events):
        ph = event.get('ph')
        if ph == 'M':
            continue
        for field in ('ph', 'pid', 'ts'):
            if field not in event:
                problems.append(f'event {i} missing {field!r}')
        if event.get('cat') not in TRACE_EVENT_CATEGORIES:
            problems.append(
                f'event {i} has unregistered cat {event.get("cat")!r}'
            )
        key = (event.get('pid'), event.get('tid'))
        ts = event.get('ts', 0.0)
        if key in last_ts and ts < last_ts[key]:
            problems.append(
                f'event {i}: ts {ts} < previous {last_ts[key]} on track '
                f'{key}'
            )
        last_ts[key] = ts
        if ph == 'X':
            if event.get('dur', -1.0) < 0:
                problems.append(f'event {i}: X slice with negative dur')
        elif ph == 'B':
            open_stacks.setdefault(key, []).append(event.get('name', ''))
        elif ph == 'E':
            stack = open_stacks.get(key) or []
            if not stack:
                problems.append(f'event {i}: E with no open B on {key}')
            else:
                stack.pop()
        elif ph not in ('i', 'I', 'C', 'M'):
            problems.append(f'event {i}: unknown ph {ph!r}')
    for key, stack in open_stacks.items():
        if stack:
            problems.append(f'unclosed B events on track {key}: {stack}')
    return problems


def dump_trace(path: str | Path, flight_records, spans=(), **kwargs) -> int:
    """Write one trace-event JSON file; returns the event count."""
    doc = to_trace_events(flight_records, spans, **kwargs)
    Path(path).write_text(json.dumps(doc))
    return len(doc['traceEvents'])
