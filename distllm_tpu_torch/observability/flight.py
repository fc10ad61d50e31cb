"""Flight recorder, debug bundles, stall watchdog and run records (the
port of ``distllm_tpu.observability.flight``).

- :class:`FlightRecorder` — a bounded, thread-safe ring of per-engine-step
  records (step kind, batch occupancy, token counts, duration, queue
  depth, KV occupancy). The serving engine appends one record per prefill
  dispatch, decode / mixed / verify window, finished request, shed
  arrival, quarantine, recovery and injected fault; every ``kind`` is one
  of ``instruments.FLIGHT_KINDS``.
- :func:`dump_debug_bundle` — the flight and span rings, the metrics
  exposition, start-up phases, metric history, SLO state, a Perfetto
  trace and the device facts (:func:`device_facts`: ``torch.cuda`` name,
  memory and the kernel launch counters) written to one directory, so a
  dead stage still explains itself.
- :class:`StallWatchdog` — a daemon thread that fires when a progress
  function (by default the ring's record count) stops changing for
  ``stall_s`` seconds; by default it dumps a bundle and never kills the
  watched work.
- :class:`RunRecord` — an append-only JSONL run record plus an atomically
  rewritten composed snapshot.
- :class:`Deadline` — a global wall-clock budget from which per-stage
  budgets are derived.

Host Python only: a bundle reads the device through ``torch.cuda`` only
when CUDA is already initialised.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path

from distllm_tpu_torch.observability import instruments as _metrics
from distllm_tpu_torch.observability.metrics import render_prometheus
from distllm_tpu_torch.observability.tracing import get_trace_buffer


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


# Kernel modules whose launch counters a bundle reports (each lists them
# in its own COUNTERS).
_KERNEL_MODULES = (
    'distllm_tpu_torch.ops.paged_attention',
    'distllm_tpu_torch.ops.quantized_matmul',
    'distllm_tpu_torch.ops.encoder_attention',
)


def device_facts() -> dict:
    """The card and the kernels as this process sees them, without
    ``nvidia-smi``: ``torch.cuda``'s device name, capability and memory
    (allocated, reserved, peak, free and total bytes) when CUDA is
    initialised, and every kernel counter of the kernel modules already
    imported (``'<function>.<counter>'``: an int or a dict of ints)."""
    import sys

    facts: dict = {'cuda_initialized': False, 'kernels': {}}
    torch = sys.modules.get('torch')
    if torch is not None and torch.cuda.is_initialized():
        facts['cuda_initialized'] = True
        index = torch.cuda.current_device()
        free, total = torch.cuda.mem_get_info(index)
        facts.update(
            name=torch.cuda.get_device_name(index),
            capability=list(torch.cuda.get_device_capability(index)),
            device_count=torch.cuda.device_count(),
            memory_allocated=torch.cuda.memory_allocated(index),
            memory_reserved=torch.cuda.memory_reserved(index),
            max_memory_allocated=torch.cuda.max_memory_allocated(index),
            memory_free=free,
            memory_total=total,
        )
    for name in _KERNEL_MODULES:
        module = sys.modules.get(name)
        for fn, attr in getattr(module, 'COUNTERS', ()):
            value = getattr(fn, attr)
            facts['kernels'][f'{fn.__name__}.{attr}'] = (
                dict(value) if isinstance(value, dict) else value
            )
    return facts


# ------------------------------------------------------------ debug bundle
def dump_debug_bundle(
    directory: str | Path,
    *,
    reason: str = 'unspecified',
    recorder: FlightRecorder | None = None,
    extra: dict | None = None,
) -> dict[str, str]:
    """Write the full observability state to ``directory`` and return the
    written paths. Called by the watchdog on stall and by ``GET /debug/bundle``
    on demand.

    Contents: ``flight.jsonl`` (engine-step ring), ``metrics.prom``
    (Prometheus exposition snapshot), ``traces.jsonl`` (span ring),
    ``startup.json`` (compile-phase records + the phase currently in
    progress + profiler-capture state — an init-stall bundle names the
    dead phase instead of arriving empty), ``history.json`` (the
    metric-history ring: the minutes BEFORE the incident, not just the
    final values), ``slo.json`` (burn-rate status + regression-sentinel
    state), ``perfetto.json`` (the same rings as one trace),
    ``device.json`` (:func:`device_facts`) and ``meta.json``
    (reason/pid/time/extra). Every piece is written independently: a
    failure in one never loses the others.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    recorder = recorder if recorder is not None else _default_recorder
    paths: dict[str, str] = {}

    flight_path = directory / 'flight.jsonl'
    try:
        recorder.dump_jsonl(flight_path)
        paths['flight'] = str(flight_path)
    except Exception:
        pass
    metrics_path = directory / 'metrics.prom'
    try:
        metrics_path.write_text(render_prometheus())
        paths['metrics'] = str(metrics_path)
    except Exception:
        pass
    traces_path = directory / 'traces.jsonl'
    try:
        get_trace_buffer().dump_jsonl(traces_path)
        paths['traces'] = str(traces_path)
    except Exception:
        pass
    # Start-up attribution and profiler-capture state: a process wedged in
    # a kernel build or a graph capture has an empty flight ring, but the
    # compile watcher's in-progress phase names where it died. Lazy
    # imports: both modules import this one.
    startup_path = directory / 'startup.json'
    try:
        from distllm_tpu_torch.observability.profiling import get_profiler_capture
        from distllm_tpu_torch.observability.startup import get_compile_watcher

        startup_path.write_text(
            json.dumps(
                {
                    'compile': get_compile_watcher().state(),
                    'profiler': get_profiler_capture().state(),
                },
                default=str,
            )
        )
        paths['startup'] = str(startup_path)
    except Exception:
        pass
    # Metric history + SLO/sentinel state: the time-resolved twin of the
    # instantaneous metrics.prom snapshot — a bundle dumped mid-incident
    # shows the minutes BEFORE the stall, not just the final values.
    # Lazy imports (history/slo/sentinel import instruments, which sits
    # beside this module in the package).
    history_path = directory / 'history.json'
    try:
        from distllm_tpu_torch.observability.history import get_metrics_history

        history_path.write_text(
            json.dumps(get_metrics_history().snapshot(), default=str)
        )
        paths['history'] = str(history_path)
    except Exception:
        pass
    slo_path = directory / 'slo.json'
    try:
        from distllm_tpu_torch.observability.history import get_metrics_history
        from distllm_tpu_torch.observability.sentinel import (
            get_regression_sentinel,
        )
        from distllm_tpu_torch.observability.slo import slo_status

        sentinel = get_regression_sentinel()
        slo_path.write_text(
            json.dumps(
                {
                    'slo': slo_status(get_metrics_history()),
                    'sentinel': (
                        sentinel.status() if sentinel is not None else None
                    ),
                },
                default=str,
            )
        )
        paths['slo'] = str(slo_path)
    except Exception:
        pass
    # Perfetto/Chrome trace of the same state: drop flight.jsonl's raw
    # rings into https://ui.perfetto.dev without any conversion step —
    # the post-mortem view of where the dying process's time went.
    perfetto_path = directory / 'perfetto.json'
    try:
        from distllm_tpu_torch.observability.history import get_metrics_history
        from distllm_tpu_torch.observability.perfetto import dump_trace

        dump_trace(
            perfetto_path,
            recorder.snapshot(),
            [s.to_dict() for s in get_trace_buffer().snapshot()],
            history=get_metrics_history(),
        )
        paths['perfetto'] = str(perfetto_path)
    except Exception:
        pass
    # Device facts from torch.cuda (no nvidia-smi): only when torch is
    # already imported and CUDA already initialised (initialising a context
    # inside a dying process could hang it), with the kernel launch counters.
    device_path = directory / 'device.json'
    try:
        device_path.write_text(json.dumps(device_facts(), default=str))
        paths['device'] = str(device_path)
    except Exception:
        pass
    meta_path = directory / 'meta.json'
    try:
        meta_path.write_text(
            json.dumps(
                {
                    'reason': reason,
                    'pid': os.getpid(),
                    'wall_time_s': time.time(),
                    'flight_records': len(recorder),
                    **(extra or {}),
                },
                default=str,
            )
        )
        paths['meta'] = str(meta_path)
    except Exception:
        pass
    _metrics.DEBUG_BUNDLES.inc()
    return paths


# ---------------------------------------------------------------- watchdog
class StallWatchdog:
    """Detects stalled progress and dumps a debug bundle.

    ``progress_fn`` returns any value; the watchdog fires ``on_stall``
    when the value has not *changed* for ``stall_s`` seconds. The default
    progress function is the process flight ring's lifetime record count,
    so an engine that stops dispatching windows (wedged backend, deadlocked
    host loop) trips the dog without any engine-side wiring. The default
    ``on_stall`` dumps a bundle to ``bundle_dir`` and logs it — it never
    kills the watched work (the stage budget / deadline does that); it
    exists so the corpse carries evidence.

    The chat server arms one around each request's generation when the
    environment sets ``DISTLLM_WATCHDOG_S`` > 0 (``chat_server.py``).

    Fires at most ``max_fires`` times (default 1) per arm; ``beat()``
    force-marks progress for work that is alive but quiet. Use as a
    context manager around a stage, or ``start()``/``stop()`` manually.
    """

    def __init__(
        self,
        stall_s: float,
        *,
        progress_fn=None,
        on_stall=None,
        bundle_dir: str | Path | None = None,
        poll_s: float | None = None,
        max_fires: int = 1,
        name: str = 'watchdog',
    ) -> None:
        if stall_s <= 0:
            raise ValueError('stall_s must be > 0')
        self.stall_s = stall_s
        self.name = name
        self._progress_fn = progress_fn or (
            lambda: _default_recorder.total_recorded
        )
        self._on_stall = on_stall
        self._bundle_dir = bundle_dir
        self._poll_s = poll_s if poll_s is not None else min(1.0, stall_s / 4)
        self._max_fires = max_fires
        self.fired = 0
        self._beats = 0
        self._stop_event = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self) -> None:
        """Mark progress explicitly (for work the ring cannot see)."""
        self._beats += 1

    def _fire(self) -> None:
        self.fired += 1
        _metrics.WATCHDOG_STALLS.inc()
        _metrics.log_event(
            f'[{self.name}] no progress for {self.stall_s:.0f}s — '
            'dumping debug bundle',
            component='watchdog',
        )
        if self._on_stall is not None:
            self._on_stall(self)
        elif self._bundle_dir is not None:
            paths = dump_debug_bundle(
                self._bundle_dir,
                reason=f'{self.name}: stalled for {self.stall_s:.0f}s',
            )
            _metrics.log_event(
                f'[{self.name}] debug bundle: '
                f'{paths.get("meta", self._bundle_dir)}',
                component='watchdog',
            )

    def _run(self) -> None:
        last = (self._progress_fn(), self._beats)
        last_change = time.monotonic()
        while not self._stop_event.wait(self._poll_s):
            try:
                current = (self._progress_fn(), self._beats)
            except Exception:
                continue  # a dying progress probe must not kill the dog
            if current != last:
                last = current
                last_change = time.monotonic()
                continue
            if (
                time.monotonic() - last_change >= self.stall_s
                and self.fired < self._max_fires
            ):
                try:
                    self._fire()
                except Exception:
                    pass  # the watchdog must survive its own handler
                last_change = time.monotonic()

    def start(self) -> 'StallWatchdog':
        if self._thread is not None:
            raise RuntimeError('watchdog already started')
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._run, name=self.name, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> 'StallWatchdog':
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()


# -------------------------------------------------------------- run record
class RunRecord:
    """Append-only on-disk run record with a composed snapshot.

    ``record(stage, fragment)`` appends one JSON line
    ``{"stage": ..., "t_wall": ..., "fragment": {...}}`` to ``path``
    (write + flush + fsync — the line is durable the moment the call
    returns) and atomically rewrites ``snapshot_path`` with the merged
    view of every fragment so far. A crash between stages loses nothing;
    a crash *mid-write* loses at most the in-flight stage (the JSONL
    reader skips a torn final line).

    ``compose()`` merges fragments in record order (later keys win) — the
    exact dict a run's final line is built from.
    """

    def __init__(
        self, path: str | Path, snapshot_path: str | Path | None = None
    ) -> None:
        self.path = Path(path)
        self.snapshot_path = (
            Path(snapshot_path)
            if snapshot_path is not None
            else self.path.with_name(self.path.stem + '_snapshot.json')
        )
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def record(self, stage: str, fragment: dict) -> None:
        line = json.dumps(
            {'stage': stage, 't_wall': time.time(), 'fragment': fragment},
            default=str,
        )
        with self._lock:
            with open(self.path, 'a') as handle:
                handle.write(line + '\n')
                handle.flush()
                os.fsync(handle.fileno())
        self.write_snapshot()

    def entries(self) -> list[dict]:
        """Replay the JSONL (torn/corrupt lines skipped, order kept)."""
        try:
            text = self.path.read_text()
        except OSError:
            return []
        out = []
        for line in text.splitlines():
            if not line.strip():
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn final line from a mid-write crash
        return out

    def stages(self) -> list[str]:
        """Stage names in first-recorded order (duplicates collapsed)."""
        seen: list[str] = []
        for entry in self.entries():
            if entry.get('stage') not in seen:
                seen.append(entry.get('stage'))
        return seen

    def compose(self) -> dict:
        merged: dict = {}
        for entry in self.entries():
            fragment = entry.get('fragment')
            if isinstance(fragment, dict):
                merged.update(fragment)
        return merged

    def write_snapshot(self) -> None:
        """Atomically rewrite the composed snapshot (tmp + rename)."""
        tmp = self.snapshot_path.with_name(self.snapshot_path.name + '.tmp')
        try:
            tmp.write_text(json.dumps(self.compose(), default=str))
            os.replace(tmp, self.snapshot_path)
        except OSError:
            pass  # snapshot is a convenience view; the JSONL is the record


# ---------------------------------------------------------------- deadline
class Deadline:
    """A global wall-clock budget that derives per-stage shares.

    ``remaining()`` never goes below zero; ``budget(nominal, floor=...)``
    is the pattern bench stages use: spend up to ``nominal`` seconds but
    never past the deadline (minus a small reserve kept for composing and
    emitting the final record).
    """

    def __init__(self, total_s: float, reserve_s: float = 15.0) -> None:
        if total_s <= 0:
            raise ValueError('total_s must be > 0')
        self.total_s = float(total_s)
        self.reserve_s = float(reserve_s)
        self._start = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._start

    def remaining(self) -> float:
        return max(0.0, self.total_s - self.reserve_s - self.elapsed())

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def budget(self, nominal_s: float, floor_s: float = 0.0) -> float:
        """Clamp a nominal stage budget into the remaining window.

        Returns 0 when less than ``floor_s`` is left — the caller should
        skip the stage (and say so) rather than start doomed work.
        """
        remaining = self.remaining()
        if remaining < max(floor_s, 1e-9):
            return 0.0
        return min(float(nominal_s), remaining)
