"""Client-side request batching for the MCQA harness (counterpart of
``distllm_tpu.mcqa.batching``): worker threads enqueue single requests; a
background batch thread collects up to ``batch_size`` requests (or what
arrived within ``batch_timeout`` seconds of the first) and ships them to
the OpenAI-compatible endpoint together, so the server's continuous
batching sees them at once. Prompts that share a ``prefix_hint`` ride
adjacently within a batch, and a failed batch is bisected into single
sends so one poison prompt does not fail the healthy ones.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class _Pending:
    prompt: str
    # Requests sharing a prefix_hint (e.g. one MCQA question's stem, sent
    # once per answer choice) are kept ADJACENT within a batch so the
    # server engine's automatic prefix cache sees
    # the shared stem back-to-back and reuses its KV blocks.
    prefix_hint: str = ''
    arrival: int = 0
    event: threading.Event = field(default_factory=threading.Event)
    result: str | None = None
    error: Exception | None = None
    abandoned: bool = False


class BatchingClient:
    """Queue + condition-variable batcher in front of a generate function.

    ``send_batch(prompts) -> responses`` is the transport (HTTP client or
    in-process generator); callers use :meth:`generate` from any thread.
    """

    def __init__(
        self,
        send_batch: Callable[[list[str]], list[str]],
        batch_size: int = 16,
        batch_timeout: float = 0.5,
    ) -> None:
        self._send_batch = send_batch
        self.batch_size = batch_size
        self.batch_timeout = batch_timeout
        self._queue: list[_Pending] = []
        self._arrivals = 0
        self._cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self.batches_sent = 0
        self.requests_sent = 0

    def generate(
        self,
        prompt: str,
        timeout: float | None = None,
        prefix_hint: str = '',
    ) -> str:
        """``prefix_hint`` marks prompts that share a cacheable prefix
        (same hint = same stem): hinted prompts are grouped adjacently
        within each batch so a prefix-caching server reuses their KV."""
        pending = _Pending(prompt, prefix_hint=prefix_hint)
        with self._cond:
            if self._closed:
                raise RuntimeError('BatchingClient is closed')
            pending.arrival = self._arrivals
            self._arrivals += 1
            self._queue.append(pending)
            self._cond.notify()
        if not pending.event.wait(timeout):
            # Drop the stale entry so a retry doesn't duplicate load on an
            # already-slow backend (if still queued, remove; if in flight,
            # mark so its late result is discarded).
            with self._cond:
                pending.abandoned = True
                if pending in self._queue:
                    self._queue.remove(pending)
            raise TimeoutError('batched request timed out')
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
                # Collect until full or batch_timeout after the first arrival
                # (a fixed per-batch deadline, not a rolling quiet period —
                # steady sub-timeout arrivals must not starve the batch).
                deadline = time.monotonic() + self.batch_timeout
                while len(self._queue) < self.batch_size and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch = [
                    p for p in self._queue[: self.batch_size] if not p.abandoned
                ]
                del self._queue[: self.batch_size]
                if not batch:
                    continue
                # Group shared-stem prompts adjacently (stable on arrival
                # order, un-hinted prompts keep their relative ordering).
                # The engine's prefix match runs at request-add time, so
                # prompts inside ONE server batch all miss a brand-new
                # stem; adjacency makes same-stem prompts land in the same
                # or consecutive server batches, so every batch after the
                # stem's first prefill hits the cache — and keeps the
                # stem's blocks hot (most-recently-used) against eviction.
                if any(p.prefix_hint for p in batch):
                    batch.sort(key=lambda p: (p.prefix_hint, p.arrival))
            self._dispatch(batch)
            self.batches_sent += 1
            self.requests_sent += len(batch)

    def _dispatch(self, batch: list[_Pending], depth: int = 0) -> bool:
        try:
            responses = self._send_batch([p.prompt for p in batch])
            if len(responses) != len(batch):
                raise RuntimeError(
                    f'send_batch returned {len(responses)} responses for '
                    f'{len(batch)} prompts'
                )
            for pending, response in zip(batch, responses):
                pending.result = response
                pending.event.set()
            return True
        except Exception as exc:  # noqa: BLE001 - delivered to callers
            if len(batch) > 1 and depth < 2:
                # Isolate the failure: retry prompts alone so one poison
                # prompt doesn't error the healthy ones. If two retries fail
                # back-to-back, stop serializing backoff ladders — but a
                # failing pair may just be adjacent poison prompts, so the
                # UNTRIED remainder gets one batch-level retry (bounded by
                # ``depth``) instead of inheriting another prompt's error.
                # Backend-down worst case: ~2 batch sends + 4 single sends.
                consecutive = 0
                for i, pending in enumerate(batch):
                    if pending.abandoned:
                        # Caller already timed out; don't burn a transport
                        # backoff ladder on a result nobody will read.
                        continue
                    if consecutive >= 2:
                        remainder = [p for p in batch[i:] if not p.abandoned]
                        self._dispatch(remainder, depth + 1)
                        return False
                    if self._dispatch([pending], depth + 1):
                        consecutive = 0
                    else:
                        consecutive += 1
                return False
            for pending in batch:
                pending.error = exc
                pending.event.set()
            return False

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
