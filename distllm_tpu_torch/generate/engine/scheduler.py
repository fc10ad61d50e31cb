"""Continuous-batching scheduler (the port's copy of
``distllm_tpu.generate.engine.scheduler``: ``PyScheduler``,
``NativeScheduler`` over ``csrc/host/scheduler.cpp`` and
``make_scheduler``; it holds no tensor). The two implementations make the
same decisions; the engine takes the native one unless
``EngineConfig.prefer_native_allocator`` is off or it cannot be built.

Policy, as in the JAX package:

- ``admit_next`` pops the waiting-queue head into the lowest free slot
  when blocks for ``num_tokens + 1`` are available (all-or-nothing);
  blocks a request already carries count toward that budget.
- ``prepare_decode(k, rids=None, ks=None)`` guarantees every running (or
  listed) sequence can take ``k`` more tokens, preempting the youngest
  (highest rid) on exhaustion — recompute preemption: blocks freed,
  request to the FRONT of the waiting queue.
- ``trim(rid)`` returns owned tail blocks beyond ``num_tokens + 1``.
- Block 0 is the reserved trash block and is never allocated.

Borrowed prefixes (``lend_prefix`` / ``release_blocks``) are the prefix
cache's blocks: never freed to the free list, kept across preemption.
"""

from __future__ import annotations

import ctypes
from collections import deque
from dataclasses import dataclass, field


class SchedulerExhausted(RuntimeError):
    """The block pool cannot serve even a lone request. ``preempted``
    carries rids already moved to the waiting queue by the failed call."""

    def __init__(self, message: str, preempted: list[int] | None = None):
        super().__init__(message)
        self.preempted = list(preempted or [])


@dataclass
class _PyRequest:
    rid: int
    num_tokens: int
    blocks: list[int] = field(default_factory=list)
    slot: int = -1
    # First `num_borrowed` blocks are prefix-cache property: never freed
    # to the scheduler free list, and they survive recompute preemption.
    num_borrowed: int = 0


class PyScheduler:
    """Pure-Python scheduler (the JAX package's Python twin)."""

    kind = 'python'

    def __init__(self, num_blocks: int, block_size: int, max_num_seqs: int) -> None:
        if num_blocks < 2:
            raise ValueError('need >= 2 blocks (block 0 is reserved)')
        self._block_size = block_size
        self._free = list(range(num_blocks - 1, 0, -1))
        self._waiting: deque[int] = deque()
        self._slots: list[int] = [-1] * max_num_seqs
        self._requests: dict[int, _PyRequest] = {}

    def _blocks_needed(self, tokens: int) -> int:
        return (tokens + self._block_size - 1) // self._block_size

    def add(
        self, rid: int, num_tokens: int, cached_blocks: 'list[int] | tuple' = ()
    ) -> None:
        if rid in self._requests:
            raise ValueError(f'duplicate request id {rid}')
        self._requests[rid] = _PyRequest(
            rid, num_tokens, blocks=list(cached_blocks),
            num_borrowed=len(cached_blocks),
        )
        self._waiting.append(rid)

    def admit_next(self) -> int | None:
        if not self._waiting or -1 not in self._slots:
            return None
        slot = self._slots.index(-1)
        rid = self._waiting[0]
        req = self._requests[rid]
        short = self._blocks_needed(req.num_tokens + 1) - len(req.blocks)
        if short > len(self._free):
            if self.num_running == 0:
                raise SchedulerExhausted(
                    f'request {rid} needs {short} KV blocks but only '
                    f'{len(self._free)} are free with nothing running; '
                    'increase num_blocks'
                )
            return None
        self._waiting.popleft()
        req.blocks.extend(self._free.pop() for _ in range(short))
        req.slot = slot
        self._slots[slot] = rid
        return rid

    def _free_owned(self, req: _PyRequest) -> None:
        self._free.extend(req.blocks[req.num_borrowed:])
        del req.blocks[req.num_borrowed:]

    def _preempt_youngest(self) -> int | None:
        running = [r for r in self._slots if r >= 0]
        if len(running) <= 1:
            return None
        victim = self._requests[max(running)]
        self._free_owned(victim)
        self._slots[victim.slot] = -1
        victim.slot = -1
        self._waiting.appendleft(victim.rid)
        return victim.rid

    def _extend(self, req: _PyRequest, tokens: int) -> bool:
        while len(req.blocks) < self._blocks_needed(tokens):
            if not self._free:
                return False
            req.blocks.append(self._free.pop())
        return True

    def prepare_decode(
        self,
        k: int = 1,
        rids: 'list[int] | None' = None,
        ks: 'list[int] | None' = None,
    ) -> list[int]:
        """Reserve ``k`` (or per-row ``ks``) more tokens for the running
        rows (all, or only ``rids``); returns the preempted rids."""
        if k < 1:
            raise ValueError('k must be >= 1')
        if ks is not None:
            if rids is None or len(ks) != len(rids):
                raise ValueError('ks must parallel rids')
            if any(kk < 1 for kk in ks):
                raise ValueError('per-row k must be >= 1')
            if len(set(rids)) != len(rids):
                raise ValueError('duplicate rids with per-row ks')
        per_row = dict(zip(rids, ks)) if ks is not None else None
        selected = None if rids is None else set(rids)
        preempted: list[int] = []
        for rid in list(self._slots):
            if rid < 0 or (selected is not None and rid not in selected):
                continue
            req = self._requests[rid]
            if req.slot < 0:
                continue  # preempted earlier in this loop
            k_row = per_row[rid] if per_row is not None else k
            while not self._extend(req, req.num_tokens + k_row):
                victim = self._preempt_youngest()
                if victim is None:
                    raise SchedulerExhausted(
                        'KV cache exhausted with a single running sequence; '
                        'increase num_blocks or reduce max_model_len',
                        preempted=preempted,
                    )
                preempted.append(victim)
                if victim == rid:
                    break
        return preempted

    def append_token(self, rid: int) -> None:
        self._requests[rid].num_tokens += 1

    def trim(self, rid: int) -> int:
        """Free owned tail blocks beyond ``blocks_needed(num_tokens + 1)``,
        newest first; returns the number freed."""
        req = self._requests[rid]
        keep = max(self._blocks_needed(req.num_tokens + 1), req.num_borrowed)
        freed = len(req.blocks) - keep
        if freed <= 0:
            return 0
        self._free.extend(reversed(req.blocks[keep:]))
        del req.blocks[keep:]
        return freed

    def finish(self, rid: int) -> None:
        req = self._requests.pop(rid)
        self._free.extend(req.blocks[req.num_borrowed:])
        if req.slot >= 0:
            self._slots[req.slot] = -1
        if rid in self._waiting:
            self._waiting.remove(rid)

    def lend_prefix(self, rid: int, num_blocks: int) -> None:
        req = self._requests[rid]
        if num_blocks > len(req.blocks):
            raise ValueError(
                f'cannot lend {num_blocks} blocks of a {len(req.blocks)}-row'
            )
        req.num_borrowed = max(req.num_borrowed, num_blocks)

    def release_blocks(self, blocks: list[int]) -> None:
        self._free.extend(blocks)

    def num_borrowed(self, rid: int) -> int:
        return self._requests[rid].num_borrowed

    def slot(self, rid: int) -> int:
        return self._requests[rid].slot

    def running(self) -> list[tuple[int, int]]:
        """Occupied ``(slot, rid)`` pairs in slot order."""
        return [(i, rid) for i, rid in enumerate(self._slots) if rid >= 0]

    def block_row(self, rid: int) -> list[int]:
        return list(self._requests[rid].blocks)

    def num_blocks_of(self, rid: int) -> int:
        """How many blocks ``rid``'s row holds."""
        return len(self._requests[rid].blocks)

    def free_list(self) -> list[int]:
        """The free list, bottom to top (the next block handed out last)."""
        return list(self._free)

    @property
    def num_free_blocks(self) -> int:
        return len(self._free)

    @property
    def num_running(self) -> int:
        return sum(1 for r in self._slots if r >= 0)

    @property
    def num_waiting(self) -> int:
        return len(self._waiting)

    @property
    def has_unfinished(self) -> bool:
        return bool(self._waiting) or self.num_running > 0


class NativeScheduler:
    """ctypes binding over the C++ scheduler core
    (``csrc/host/scheduler.cpp``, built with g++ at first use; raises
    ``RuntimeError`` when it cannot be built)."""

    kind = 'native'

    def __init__(self, num_blocks: int, block_size: int, max_num_seqs: int) -> None:
        from distllm_tpu_torch.ops._build import build_host

        lib = ctypes.CDLL(str(build_host('scheduler')))
        lib.sched_create.restype = ctypes.c_void_p
        lib.sched_create.argtypes = [ctypes.c_int32] * 3
        lib.sched_destroy.argtypes = [ctypes.c_void_p]
        lib.sched_add.restype = ctypes.c_int32
        lib.sched_add.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
        lib.sched_add_cached.restype = ctypes.c_int32
        lib.sched_add_cached.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.sched_lend_prefix.restype = ctypes.c_int32
        lib.sched_lend_prefix.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.sched_release_blocks.restype = ctypes.c_int32
        lib.sched_release_blocks.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.sched_num_borrowed.restype = ctypes.c_int32
        lib.sched_num_borrowed.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sched_admit_next.restype = ctypes.c_int64
        lib.sched_admit_next.argtypes = [ctypes.c_void_p]
        lib.sched_prepare_decode_k.restype = ctypes.c_int32
        lib.sched_prepare_decode_k.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sched_prepare_decode_rows.restype = ctypes.c_int32
        lib.sched_prepare_decode_rows.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sched_prepare_decode_rows_k.restype = ctypes.c_int32
        lib.sched_prepare_decode_rows_k.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sched_trim.restype = ctypes.c_int32
        lib.sched_trim.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        for name in ('sched_append_token', 'sched_finish'):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sched_slot.restype = ctypes.c_int32
        lib.sched_slot.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.sched_running.restype = ctypes.c_int32
        lib.sched_running.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sched_block_row.restype = ctypes.c_int32
        lib.sched_block_row.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.sched_free_list.restype = ctypes.c_int32
        lib.sched_free_list.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        for name in (
            'sched_num_free',
            'sched_num_running',
            'sched_num_waiting',
            'sched_has_unfinished',
        ):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int32
            fn.argtypes = [ctypes.c_void_p]

        handle = lib.sched_create(num_blocks, block_size, max_num_seqs)
        if not handle:
            raise RuntimeError(
                f'sched_create({num_blocks}, {block_size}, {max_num_seqs}) failed'
            )
        self._lib = lib
        self._handle = handle
        self._max_num_seqs = max_num_seqs
        self._num_blocks = num_blocks
        # Output buffers the C calls fill, made once (a row never holds
        # more than the pool's blocks, the slot table more than its slots).
        self._blocks_out = (ctypes.c_int32 * num_blocks)()
        self._slots_out = (ctypes.c_int32 * max_num_seqs)()
        self._rids_out = (ctypes.c_int64 * max_num_seqs)()
        self._preempted_out = (ctypes.c_int64 * max_num_seqs)()

    def add(
        self, rid: int, num_tokens: int, cached_blocks: 'list[int] | tuple' = ()
    ) -> None:
        if cached_blocks:
            arr = (ctypes.c_int32 * len(cached_blocks))(*cached_blocks)
            rc = self._lib.sched_add_cached(
                self._handle, rid, num_tokens, arr, len(cached_blocks)
            )
        else:
            rc = self._lib.sched_add(self._handle, rid, num_tokens)
        if rc == -2:
            raise ValueError(f'duplicate request id {rid}')
        if rc != 0:
            raise RuntimeError(f'sched_add failed: {rc}')

    def admit_next(self) -> int | None:
        rid = int(self._lib.sched_admit_next(self._handle))
        if rid == -2:
            raise SchedulerExhausted(
                'request needs more KV blocks than are free with nothing '
                'running; increase num_blocks'
            )
        return None if rid < 0 else rid

    def prepare_decode(
        self,
        k: int = 1,
        rids: 'list[int] | None' = None,
        ks: 'list[int] | None' = None,
    ) -> list[int]:
        if k < 1:
            raise ValueError('k must be >= 1')
        if ks is not None:
            if rids is None or len(ks) != len(rids):
                raise ValueError('ks must parallel rids')
            if any(kk < 1 for kk in ks):
                raise ValueError('per-row k must be >= 1')
            if len(set(rids)) != len(rids):
                raise ValueError('duplicate rids with per-row ks')
        out = self._preempted_out
        if rids is None:
            n = int(self._lib.sched_prepare_decode_k(self._handle, k, out))
        else:
            arr = (ctypes.c_int64 * max(1, len(rids)))(*rids)
            ks_arr = (
                (ctypes.c_int32 * max(1, len(ks)))(*ks)
                if ks is not None
                else None
            )
            n = int(
                self._lib.sched_prepare_decode_rows_k(
                    self._handle, k, arr, ks_arr, len(rids), out
                )
            )
        if n < 0:
            # Fatal encoding is -(1 + n_preempted): preemptions already
            # performed are not rolled back and must reach the engine.
            raise SchedulerExhausted(
                'KV cache exhausted with a single running sequence; '
                'increase num_blocks or reduce max_model_len',
                preempted=out[:-n - 1],
            )
        return out[:n]

    def append_token(self, rid: int) -> None:
        if self._lib.sched_append_token(self._handle, rid) != 0:
            raise KeyError(rid)

    def trim(self, rid: int) -> int:
        n = int(self._lib.sched_trim(self._handle, rid))
        if n < 0:
            raise KeyError(rid)
        return n

    def finish(self, rid: int) -> None:
        if self._lib.sched_finish(self._handle, rid) != 0:
            raise KeyError(rid)

    def lend_prefix(self, rid: int, num_blocks: int) -> None:
        rc = self._lib.sched_lend_prefix(self._handle, rid, num_blocks)
        if rc == -1:
            raise KeyError(rid)
        if rc != 0:
            raise ValueError(
                f'cannot lend {num_blocks} blocks of request {rid}\'s row'
            )

    def release_blocks(self, blocks: list[int]) -> None:
        if not blocks:
            return
        arr = (ctypes.c_int32 * len(blocks))(*blocks)
        if self._lib.sched_release_blocks(self._handle, arr, len(blocks)) != 0:
            raise RuntimeError('sched_release_blocks failed')

    def num_borrowed(self, rid: int) -> int:
        n = int(self._lib.sched_num_borrowed(self._handle, rid))
        if n < 0:
            raise KeyError(rid)
        return n

    def slot(self, rid: int) -> int:
        return int(self._lib.sched_slot(self._handle, rid))

    def running(self) -> list[tuple[int, int]]:
        n = int(self._lib.sched_running(self._handle, self._slots_out, self._rids_out))
        return list(zip(self._slots_out[:n], self._rids_out[:n]))

    def block_row(self, rid: int) -> list[int]:
        n = int(self._lib.sched_block_row(self._handle, rid, self._blocks_out, self._num_blocks))
        if n < 0:
            raise KeyError(rid)
        return self._blocks_out[:n]

    def num_blocks_of(self, rid: int) -> int:
        """How many blocks ``rid``'s row holds (its ``block_row``'s length,
        nothing copied)."""
        n = int(self._lib.sched_block_row(self._handle, rid, None, 0))
        if n < 0:
            raise KeyError(rid)
        return n

    def free_list(self) -> list[int]:
        """The free list, bottom to top (the next block handed out last)."""
        n = int(self._lib.sched_free_list(self._handle, self._blocks_out, self._num_blocks))
        return self._blocks_out[:n]

    @property
    def num_free_blocks(self) -> int:
        return int(self._lib.sched_num_free(self._handle))

    @property
    def num_running(self) -> int:
        return int(self._lib.sched_num_running(self._handle))

    @property
    def num_waiting(self) -> int:
        return int(self._lib.sched_num_waiting(self._handle))

    @property
    def has_unfinished(self) -> bool:
        return bool(self._lib.sched_has_unfinished(self._handle))

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        lib = getattr(self, '_lib', None)
        handle = getattr(self, '_handle', None)
        if lib is not None and handle:
            lib.sched_destroy(handle)
            self._handle = None


def make_scheduler(
    num_blocks: int,
    block_size: int,
    max_num_seqs: int,
    prefer_native: bool = True,
) -> 'NativeScheduler | PyScheduler':
    """The native scheduler when ``prefer_native`` and it builds, else the
    Python twin, with a log line saying so (``.kind`` names which)."""
    if prefer_native:
        try:
            return NativeScheduler(num_blocks, block_size, max_num_seqs)
        except (RuntimeError, OSError) as exc:
            # The Python twin is a tested drop-in, but the substitution
            # is never silent.
            from distllm_tpu_torch.observability.instruments import log_event

            log_event(
                f'[engine] native scheduler unavailable ({exc!r:.120}); '
                'using the Python twin',
                component='engine',
            )
    return PyScheduler(num_blocks, block_size, max_num_seqs)
