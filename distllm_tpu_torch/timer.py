"""Stage timers with parseable log lines (the PyTorch port's copy of the
``distllm_tpu.timer`` line format).

``Timer`` is a context manager that prints one machine-parseable line per
timed span to stdout — the same line the JAX package prints, so the same
log tooling reads both::

    [timer] tags=loaded-encoder,file-3 elapsed_s=1.234567890 start_ns=... end_ns=...

Device work is asynchronous: a span around GPU work measures the device
only if the timed block ends in a synchronisation (the embedder's host
copy of its results does).
"""

from __future__ import annotations

import time


class Timer:
    """Time a block and print its ``[timer]`` line when it exits, whether
    it exits normally or by an exception."""

    def __init__(self, *tags: str) -> None:
        self.tags = tuple(str(t) for t in tags)
        self.start_ns: int | None = None
        self.end_ns: int | None = None

    @property
    def elapsed_s(self) -> float:
        if self.start_ns is None:
            raise RuntimeError('Timer.elapsed_s read before the timer started')
        end = self.end_ns if self.end_ns is not None else time.monotonic_ns()
        return (end - self.start_ns) / 1e9

    def log_line(self) -> str:
        return (
            f'[timer] tags={",".join(self.tags)} '
            f'elapsed_s={self.elapsed_s:.9f} '
            f'start_ns={self.start_ns} end_ns={self.end_ns}'
        )

    def __enter__(self) -> 'Timer':
        self.start_ns = time.monotonic_ns()
        self.end_ns = None
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end_ns = time.monotonic_ns()
        print(self.log_line(), flush=True)
