"""Roll up multi-host worker logs into one stats table and one trace (the
port of ``distllm_tpu.observability.aggregate``; the same table).

Workers emit ``[timer]`` lines (``timer.py``) into their logs, and every
process can dump its span and flight rings as JSONL
(``observability.dump_traces``, a debug bundle's ``traces.jsonl`` /
``flight.jsonl``). This module merges any number of those captures, both
formats mixed, into one ``{tags: TimeStats}`` view and renders it as a
fixed-width table whose cross-host columns (count / total / mean / p50 /
p95 / p99 / max) match what ``distllm_stage_duration_seconds`` exposes.

``--perfetto OUT.json`` also merges every input's flight and span
records into ONE Perfetto / Chrome trace with a process group per input
file (``observability.perfetto.merge_host_traces``).

CLI::

    python -m distllm_tpu_torch.observability.aggregate run/logs/*.txt \
        run/bundles/*/traces.jsonl \
        run/bundles/*/flight.jsonl --perfetto combined.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def _merge_span_lines(capture: str, add) -> None:
    """Fold span-JSONL records (``TraceBuffer.dump_jsonl`` format) and
    timed flight-ring records (``FlightRecorder.dump_jsonl``) into the
    aggregation via ``add(tags, elapsed_s, start_ns, end_ns)``. A record
    keys by its ``tags`` tuple (falling back to ``(name,)`` / ``(kind,)``)
    so Timer-shim spans merge with their own ``[timer]`` lines; JSON lines
    without a duration and torn lines are skipped."""
    for line in capture.splitlines():
        line = line.strip()
        if not line.startswith('{'):
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn final line from a killed process
        if not isinstance(record, dict):
            continue
        name = record.get('name') or record.get('kind')
        duration = record.get('duration_s')
        if name is None or duration is None:
            continue
        tags = tuple(record.get('tags') or ()) or (str(name),)
        add(
            tags,
            float(duration),
            int(record.get('start_ns') or 0),
            int(record.get('end_ns') or 0),
        )


def aggregate_lines(captures: list[str]) -> dict[tuple[str, ...], object]:
    """Merge multiple log captures (strings) into one stats dict.

    Each capture may hold ``[timer]`` lines, span-JSONL records, or both.
    ``timer.Timer`` emits BOTH formats for every timed region, so the same
    measurement commonly arrives twice (stdout log + trace dump of the
    same process); measurements with real clock bounds are deduplicated on
    ``(tags, start_ns, end_ns)`` across all captures and formats.
    Zero/absent bounds (hand-written lines, flight records) are exempt —
    distinct measurements there would otherwise collapse.
    """
    # Lazy import: timer.py imports this package at module load.
    from distllm_tpu_torch.timer import TimeLogger, TimeStats

    logger = TimeLogger()
    merged: dict[tuple[str, ...], TimeStats] = {}
    seen: set[tuple] = set()

    def add(tags, elapsed_s, start_ns, end_ns):
        if start_ns and end_ns:
            key = (tags, start_ns, end_ns)
            if key in seen:
                return
            seen.add(key)
        entry = merged.setdefault(tags, TimeStats(tags=tags))
        entry.elapsed_s.append(elapsed_s)
        entry.start_ns.append(start_ns)
        entry.end_ns.append(end_ns)

    for capture in captures:
        for tags, stats in logger.parse_lines(capture).items():
            for elapsed, start, end in zip(
                stats.elapsed_s, stats.start_ns, stats.end_ns
            ):
                add(tags, elapsed, start, end)
        _merge_span_lines(capture, add)
    return merged


def aggregate_logs(paths: list[str | Path]) -> dict[tuple[str, ...], object]:
    """Merge ``[timer]`` lines and span-JSONL dumps from many files."""
    return aggregate_lines([Path(p).read_text() for p in paths])


def format_stats_table(stats: dict[tuple[str, ...], object]) -> str:
    """Fixed-width table, one row per tag set, sorted by total time desc."""
    header = ('tags', 'count', 'total_s', 'mean_s', 'p50_s', 'p95_s',
              'p99_s', 'max_s')
    rows = [header]
    ordered = sorted(
        stats.values(), key=lambda s: s.total_s, reverse=True
    )
    for entry in ordered:
        rows.append(
            (
                ','.join(entry.tags) or '-',
                str(entry.count),
                f'{entry.total_s:.3f}',
                f'{entry.mean_s:.3f}',
                f'{entry.p50_s:.3f}',
                f'{entry.p95_s:.3f}',
                f'{entry.p99_s:.3f}',
                f'{entry.max_s:.3f}',
            )
        )
    widths = [max(len(row[i]) for row in rows) for i in range(len(header))]
    lines = []
    for i, row in enumerate(rows):
        lines.append(
            '  '.join(cell.ljust(widths[j]) for j, cell in enumerate(row)).rstrip()
        )
        if i == 0:
            lines.append('  '.join('-' * w for w in widths))
    return '\n'.join(lines)


def load_host_capture(path: str | Path) -> tuple[list[dict], list[dict]]:
    """Split one JSONL capture into ``(flight_records, span_dicts)``.

    Flight records carry ``kind``; span dumps carry ``name``/``span_id``.
    A file may freely mix both (a concatenated bundle); torn lines and
    non-JSON lines (``[timer]`` text) are skipped.
    """
    flight: list[dict] = []
    spans: list[dict] = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line.startswith('{'):
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn final line from a killed process
        if not isinstance(record, dict):
            continue
        if 'kind' in record:
            flight.append(record)
        elif 'span_id' in record or 'start_ns' in record:
            spans.append(record)
    return flight, spans


def host_label(path: str | Path, seen: 'set[str] | None' = None) -> str:
    """Readable per-process label for one capture file.

    Multi-replica captures conventionally land as
    ``<replica-id>/flight.jsonl`` (the bench) or
    ``capture-<host>.jsonl`` — a bare ``Path(path).name`` collapses the
    former to N identical ``flight.jsonl`` process groups, which is
    exactly the unreadable-merge bug this fixes. Generic stems
    (``flight``, ``spans``, ``capture``, ``trace``) take their parent
    directory as the host/replica id; distinctive stems keep it. A
    label already in ``seen`` gets the stem appended, then an index —
    every input must stay distinguishable in the merged trace.
    """
    p = Path(path)
    stem = p.stem
    generic = stem.lower() in ('flight', 'spans', 'capture', 'trace', 'log')
    label = (
        p.parent.name if generic and p.parent.name not in ('', '.') else stem
    )
    if seen is None:
        return label
    if label in seen and label != stem:
        label = f'{label}/{stem}'
    base, n = label, 2
    while label in seen:
        label = f'{base}#{n}'
        n += 1
    seen.add(label)
    return label


def write_combined_perfetto(
    paths: list[str | Path], out: str | Path
) -> int:
    """Merge every input's flight/span JSONL records into one Perfetto
    trace (a process group per input file, shared time origin); returns
    how many inputs contributed renderable records. Process groups are
    named by :func:`host_label` (host/replica id parsed from the capture
    path), so a 3-replica merge reads ``replica-0 / replica-1 /
    replica-2``, not three ``flight.jsonl``."""
    from distllm_tpu_torch.observability.perfetto import merge_host_traces

    hosts = []
    seen: set[str] = set()
    for path in paths:
        flight, spans = load_host_capture(path)
        if flight or spans:
            hosts.append((host_label(path, seen), flight, spans))
    doc = merge_host_traces(hosts)
    Path(out).write_text(json.dumps(doc))
    return len(hosts)


def main(argv: list[str] | None = None) -> int:
    from distllm_tpu_torch.observability.instruments import log_event

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('logs', nargs='+', type=Path, help='worker log files')
    parser.add_argument(
        '--perfetto', type=Path, default=None, metavar='OUT.json',
        help='also merge flight/span JSONL inputs into one combined '
             'Perfetto trace (per-host track groups)',
    )
    args = parser.parse_args(argv)
    stats = aggregate_logs(args.logs)
    if args.perfetto is not None:
        contributed = write_combined_perfetto(args.logs, args.perfetto)
        log_event(
            f'[aggregate] wrote combined Perfetto trace for {contributed} '
            f'host capture(s) to {args.perfetto}',
            component='aggregate',
        )
    if not stats:
        log_event(
            f'No [timer] lines found in {len(args.logs)} files',
            component='aggregate',
        )
        return 1
    log_event(format_stats_table(stats), component='aggregate')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
