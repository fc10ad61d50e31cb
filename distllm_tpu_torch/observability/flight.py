"""The flight recorder's ring (the port of ``FlightRecorder`` and
``get_flight_recorder`` from ``distllm_tpu.observability.flight``).

:class:`FlightRecorder` is a bounded, thread-safe ring of per-engine-step
records (step kind, batch occupancy, token counts, duration, queue depth,
KV occupancy). The serving engine appends one record per prefill
dispatch, decode / mixed / verify window, finished request, shed arrival,
quarantine, recovery and injected fault; the ring is cheap enough to stay
on while serving. Every ``kind`` is one of ``instruments.FLIGHT_KINDS``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path


class FlightRecorder:
    """Bounded ring of per-step flight records (oldest evicted first).

    A record is one dict: ``{'kind': ..., 't_wall': ..., **fields}``.
    Appends are O(1) under a lock, safe from the engine thread and the
    server's handler threads at once.
    """

    def __init__(self, capacity: int = 4096) -> None:
        if capacity < 1:
            raise ValueError('capacity must be >= 1')
        self.capacity = capacity
        self._records: deque[dict] = deque(maxlen=capacity)  # guarded by self._lock
        self._lock = threading.Lock()
        self._recorded = 0  # guarded by self._lock
        self._last_record_monotonic = time.monotonic()  # guarded by self._lock

    def record(self, kind: str, **fields) -> dict:
        entry = {'kind': kind, 't_wall': time.time(), **fields}
        with self._lock:
            self._records.append(entry)
            self._recorded += 1
            self._last_record_monotonic = time.monotonic()
        return entry

    def snapshot(self, limit: int | None = None) -> list[dict]:
        """Most recent records, oldest first (``limit`` trims old ones)."""
        with self._lock:
            records = list(self._records)
        if limit is not None:
            records = records[-limit:]
        return records

    def clear(self) -> None:
        with self._lock:
            self._records.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    @property
    def total_recorded(self) -> int:
        """Lifetime record count (survives ring eviction)."""
        with self._lock:
            return self._recorded

    @property
    def seconds_since_last_record(self) -> float:
        with self._lock:
            return time.monotonic() - self._last_record_monotonic

    def dump_jsonl(self, path: str | Path) -> int:
        records = self.snapshot()
        with open(path, 'w') as handle:
            for entry in records:
                handle.write(json.dumps(entry, default=str) + '\n')
        return len(records)


_default_recorder = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    """The process-wide flight ring."""
    return _default_recorder
