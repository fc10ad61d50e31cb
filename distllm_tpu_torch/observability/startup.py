"""Start-up phase attribution (the port of
``distllm_tpu.observability.startup``).

The port has no XLA compile ladder; its start-up phases are the CUDA
context, the ``nvcc`` build of each kernel (``ops/_build.py``), the
weight load from a checkpoint and its quantization, and the capture of
each CUDA graph (``DecodeGraphRunner.warmup`` / ``VerifyGraphRunner.warmup``).

- :class:`CompileWatcher` — a process-wide watcher whose ``phase(kind,
  shape)`` context manager times one phase and emits one ``compile``
  flight record, the ``distllm_compile_seconds{kind,shape}`` histogram and
  the ``distllm_compile_cache_hits_total`` counter. Phase kinds are
  listed in ``instruments.COMPILE_PHASES``.
- **cache hits** — a phase is a hit when its (scope, kind, shape) already
  completed in this process, or when a kernel build found its library
  already built for the same source and flags.
- **dead-phase attribution** — ``state()`` (``startup.json`` in every
  debug bundle) names the phase in progress, so a bundle dumped during a
  wedged build or capture says which one.
- :func:`record_backend_init` — times the CUDA context's creation.

``compile`` records get a ``startup`` track in the Perfetto export.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

from distllm_tpu_torch.observability import instruments as _metrics
from distllm_tpu_torch.observability.flight import FlightRecorder, get_flight_recorder

# Completed-phase summaries kept for state() and debug bundles; a process's
# start-up is tens of phases, so this only bounds a pathological caller.
_MAX_PHASES = 256


class CompileWatcher:
    """Times startup/compile phases into flight records + metric series.

    One watcher serves the whole process (:func:`get_compile_watcher`);
    tests inject their own ``recorder`` for isolation. Thread-safe: the
    engine thread, the server's threads and bundle dumps may touch it at
    once. ``active`` is a single slot: of the kernel builds that run in
    parallel it names the last one started.
    """

    def __init__(self, recorder: FlightRecorder | None = None) -> None:
        self._recorder = recorder
        self._lock = threading.Lock()
        self._seen: set[tuple[str, str, str]] = set()  # guarded by self._lock
        self._phases: list[dict] = []  # guarded by self._lock
        self._active: dict | None = None  # guarded by self._lock
        self._scopes = itertools.count()

    def new_scope(self, prefix: str = 'engine') -> str:
        """A fresh dedup namespace for :meth:`phase`'s ``scope`` — one
        per engine instance, so rebuilt engines start cold."""
        return f'{prefix}-{next(self._scopes)}'

    @property
    def recorder(self) -> FlightRecorder:
        return (
            self._recorder
            if self._recorder is not None
            else get_flight_recorder()
        )

    @contextlib.contextmanager
    def phase(self, kind: str, shape: str, *, scope: str = '', **fields):
        """Time one start-up phase; yields a mutable fields dict the body
        may enrich. On exit — success or failure — one ``compile`` flight
        record lands in the ring and
        ``distllm_compile_seconds{kind,shape}`` observes the duration;
        failures carry an ``error`` field and never count as cache hits.
        The phase is visible through :meth:`state` while in progress, so a
        bundle dumped mid-stall names it.

        A phase is a cache hit when its ``(scope, kind, shape)`` already
        completed in this process, or when the body sets
        ``fields['cache_hit'] = True`` (a kernel build that found its
        library built for the same source and flags). ``scope``
        namespaces the repeat rule: each engine passes its own, because a
        second engine captures its graphs again."""
        entry: dict = {'phase': kind, 'shape': shape, **fields}
        with self._lock:
            seen = (scope, kind, shape) in self._seen
            self._active = {**entry, 't_start_wall': time.time()}
        t0 = time.monotonic()
        error: str | None = None
        try:
            yield entry
        except BaseException as exc:
            error = repr(exc)[:300]
            raise
        finally:
            duration_s = time.monotonic() - t0
            cache_hit = error is None and (seen or bool(entry.get('cache_hit')))
            entry['duration_s'] = round(duration_s, 6)
            entry['cache_hit'] = cache_hit
            if error is not None:
                entry['error'] = error
            with self._lock:
                self._active = None
                if error is None:
                    self._seen.add((scope, kind, shape))
                self._phases.append({**entry, 't_wall': time.time()})
                del self._phases[:-_MAX_PHASES]
            try:
                self.recorder.record('compile', **entry)
            except Exception:
                pass  # a full disk must not turn start-up fatal
            _metrics.COMPILE_SECONDS.labels(kind=kind, shape=shape).observe(
                duration_s
            )
            if cache_hit:
                _metrics.COMPILE_CACHE_HITS.inc()

    def state(self) -> dict:
        """Snapshot for debug bundles: the completed phase list plus the
        phase currently in progress (``None`` between phases). A bundle
        dumped during a wedged init shows ``active`` naming the exact
        (kind, shape) the process is stuck compiling."""
        with self._lock:
            return {
                'active': dict(self._active) if self._active else None,
                'phases': [dict(p) for p in self._phases],
            }


_default_watcher = CompileWatcher()


def get_compile_watcher() -> CompileWatcher:
    """The process-wide compile watcher (what engines and bundles use)."""
    return _default_watcher


def record_backend_init(device, watcher: CompileWatcher | None = None) -> None:
    """Time the CUDA context's creation on ``device`` as a
    ``backend_init`` phase (a no-op for a CPU device). The first call in a
    process pays, and attributes, the context; later ones return in
    microseconds and count as cache hits, so every engine constructor may
    call it. Exceptions propagate, after the phase record lands with the
    error."""
    import torch

    device = torch.device(device)
    if device.type != 'cuda':
        return
    watcher = watcher if watcher is not None else _default_watcher
    with watcher.phase('backend_init', 'cuda') as fields:
        torch.cuda.init()
        torch.empty(0, device=device)  # creates the context
        index = device.index if device.index is not None else torch.cuda.current_device()
        fields['device_kind'] = torch.cuda.get_device_name(index)
        fields['num_devices'] = torch.cuda.device_count()
