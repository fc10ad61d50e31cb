"""Bounded, error-safe programmatic profiler capture (the port of
``distllm_tpu.observability.profiling``, over ``torch.profiler``).

A capture records ``torch.profiler`` activities — CPU always, CUDA when
the card is there (CUPTI: every kernel, those replayed inside CUDA
graphs too) — and writes one Chrome trace, ``trace.json``, into the
capture's directory. Raw use has two serving-path hazards this helper
removes:

- **unbounded captures** — every capture runs on its own daemon thread
  and stops itself after ``max_seconds``;
- **fatal errors** — every profiler call is caught; failures land in
  :meth:`ProfilerCapture.state` (and debug bundles, through
  ``startup.json``) and in ``distllm_profiler_captures_total{outcome}``,
  never in the caller's stack.

One capture may be active at a time (the profiler is process-global);
concurrent starts are rejected, not queued. ``GET /debug/xprof?seconds=N``
on the chat server (the JAX route's name, kept for its clients) runs a
blocking :meth:`ProfilerCapture.capture` in a worker thread.
"""

from __future__ import annotations

import math
import threading
import time
from pathlib import Path

from distllm_tpu_torch.observability import instruments as _metrics

# Hard ceiling on any capture: traces of a busy engine grow fast, and an
# operator typo ("seconds=3600") must not fill the disk of a serving host.
MAX_CAPTURE_SECONDS = 1800.0
# The Chrome trace each capture writes into its directory.
TRACE_FILE = 'trace.json'


def _clamp_seconds(value, default: float = 60.0) -> float:
    """Clamp into (0.1, MAX_CAPTURE_SECONDS]; NaN, inf and garbage degrade
    to ``default`` instead of raising."""
    try:
        value = float(value)
    except (TypeError, ValueError):
        value = default
    if not math.isfinite(value) or value <= 0:
        value = default
    return min(max(value, 0.1), MAX_CAPTURE_SECONDS)


def _profiler():
    """A ``torch.profiler.profile`` over the CPU and, when there is a card,
    CUDA, recording every thread's operators where this PyTorch can."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        config = None
    return torch.profiler.profile(activities=activities, experimental_config=config)


class ProfilerCapture:
    """At-most-one bounded ``torch.profiler`` session."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._active: dict | None = None  # guarded by self._lock
        # (thread, stop event, result box) of the running session.
        self._session_state = None  # guarded by self._lock
        self._last_error: str | None = None  # guarded by self._lock
        self._captures = 0  # guarded by self._lock

    def start(self, log_dir, max_seconds: float = 60.0) -> bool:
        """Begin a capture into ``log_dir``; returns whether it started.
        ``False`` means rejected (one already active) or the profiler
        failed — both recorded in :meth:`state` and the outcome counter,
        neither raised. A started capture auto-stops after
        ``max_seconds`` (clamped to :data:`MAX_CAPTURE_SECONDS`)."""
        return self._start(log_dir, max_seconds) is None

    def _start(self, log_dir, max_seconds: float) -> tuple[str, str] | None:
        """``None`` on success, else ``(outcome, message)`` with outcome
        ``'rejected'`` or ``'error'``."""
        max_seconds = _clamp_seconds(max_seconds)
        with self._lock:
            if self._active is not None:
                message = f'capture already active in {self._active["log_dir"]}'
                self._last_error = message
                _metrics.PROFILER_CAPTURES.labels(outcome='rejected').inc()
                return 'rejected', message
            # Reserve the slot before the slow profiler start, so two
            # concurrent starts cannot both reach it.
            self._active = {
                'log_dir': str(log_dir),
                'started_wall_s': time.time(),
                'max_seconds': max_seconds,
            }
        started = threading.Event()
        done = threading.Event()
        box: dict = {}
        thread = threading.Thread(
            target=self._session,
            args=(str(log_dir), max_seconds, started, done, box),
            name='profiler-capture', daemon=True,
        )
        thread.start()
        started.wait()
        if 'error' in box:
            thread.join()
            message = box['error']
            with self._lock:
                self._active = None
                self._last_error = message
            _metrics.PROFILER_CAPTURES.labels(outcome='error').inc()
            return 'error', message
        with self._lock:
            self._session_state = (thread, done, box)
        return None

    def _session(self, log_dir, max_seconds, started, done, box) -> None:
        """The capture's own thread: ``torch.profiler`` binds a session to
        the thread that starts it, and stopping it from another thread
        crashes the process. So one thread starts it, waits for
        :meth:`stop` or ``max_seconds`` (the auto-stop), then stops it and
        writes the trace."""
        try:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            profiler = _profiler()
            profiler.start()
        except Exception as exc:
            box['error'] = repr(exc)[:300]
            started.set()
            return
        started.set()
        if not done.wait(max_seconds):
            # The auto-stop: no caller stopped it in time.
            with self._lock:
                self._active = None
                self._session_state = None
        trace = str(Path(log_dir) / TRACE_FILE)
        try:
            profiler.stop()
            profiler.export_chrome_trace(trace)
        except Exception as exc:
            box['error'] = repr(exc)[:300]
            with self._lock:
                self._last_error = box['error']
            _metrics.PROFILER_CAPTURES.labels(outcome='error').inc()
            return
        box['trace'] = trace
        with self._lock:
            self._captures += 1
        _metrics.PROFILER_CAPTURES.labels(outcome='ok').inc()

    def stop(self) -> bool:
        """Stop the active capture and wait until its Chrome trace is
        written; returns whether one was stopped and written. Idempotent
        (the auto-stop and a caller may race); errors go to
        :meth:`state`."""
        with self._lock:
            if self._active is None or self._session_state is None:
                return False
            self._active = None
            (thread, done, box), self._session_state = self._session_state, None
        done.set()
        thread.join()
        return 'trace' in box

    def capture(self, log_dir, seconds: float) -> dict:
        """Blocking convenience for ``GET /debug/xprof``: start, sleep,
        stop; returns ``{'ok', 'rejected', 'trace_dir', 'error'}`` (the
        trace is ``trace_dir/trace.json``). The auto-stop is a backstop
        30 s past ``seconds``, so it never races the deliberate stop."""
        seconds = _clamp_seconds(seconds, default=1.0)
        failure = self._start(log_dir, max_seconds=seconds + 30.0)
        if failure is not None:
            outcome, message = failure
            return {
                'ok': False,
                'rejected': outcome == 'rejected',
                'trace_dir': str(log_dir),
                'error': message,
            }
        time.sleep(seconds)
        ok = self.stop()
        with self._lock:
            error = None if ok else self._last_error
        return {
            'ok': ok,
            'rejected': False,
            'trace_dir': str(log_dir),
            'error': error,
        }

    def state(self) -> dict:
        """Snapshot for bundles and endpoints: the active capture (or
        None), the last error, and the lifetime count of completed
        captures."""
        with self._lock:
            return {
                'active': dict(self._active) if self._active else None,
                'last_error': self._last_error,
                'captures_total': self._captures,
            }


_default_capture = ProfilerCapture()


def get_profiler_capture() -> ProfilerCapture:
    """The process-wide capture slot (the profiler is process-global)."""
    return _default_capture
