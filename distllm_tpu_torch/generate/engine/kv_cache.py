"""Paged KV cache: the device block pool, the block allocator, the
automatic prefix cache and its host and disk tiers (PyTorch counterpart of
``distllm_tpu.generate.engine.kv_cache``).

K/V live as ``[L, num_blocks, block_size, N_kv, Hd]`` device tensors and
sequences own lists of block ids. Block 0 is the reserved TRASH block —
padded and out-of-budget writes land there (``ops/paged_attention``).
An int8 pool (``EngineConfig.kv_cache_dtype='int8'``) holds each of K and
V as a ``QuantizedKV``: int8 data of the same shape and an fp32 scale
``[L, num_blocks, N_kv]``.

:class:`PrefixCache` maps chained digests of full prompt blocks
(:func:`block_digests`, byte-equal to the JAX package's) to pool blocks,
with per-block request refcounts and LRU eviction of unreferenced blocks;
it owns the reuse policy only, and the scheduler marks cache-held blocks
as a request's borrowed prefix. :class:`HostKVTier` and
:class:`DiskKVTier` extend it past the device: evicted blocks spill to a
bounded host pool (writing through to digest-named ``.kvblock`` files)
and come back by promotion. Both keep CPU tensors; the ``.kvblock`` v2
payload (:func:`encode_kvblock` / :func:`decode_kvblock`) is the JAX
package's byte for byte, bf16 included (raw bytes under the header dtype
``'bfloat16'``), so either package reads the other's files.
:class:`PeerKVTier` reads sibling replicas' spilled blocks over the ZMQ
fabric (``parallel.fabric.KVBlockClient``) in that same payload, one hop
under disk: host -> disk -> peer, a peer hit re-entering the host pool.
"""

from __future__ import annotations

import ctypes

import hashlib
import json
import math
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import torch

from distllm_tpu_torch.ops.paged_attention import QuantizedKV
from distllm_tpu_torch.resilience.faults import get_fault_injector


class PyBlockAllocator:
    """Free-list + refcount block allocator; block 0 is never handed out."""

    def __init__(self, num_blocks: int) -> None:
        if num_blocks < 2:
            raise ValueError('need >= 2 blocks (block 0 is reserved)')
        self._free = list(range(num_blocks - 1, 0, -1))
        self._refcount = [0] * num_blocks
        self._refcount[0] = 1  # trash block, never free

    def alloc(self) -> int:
        if not self._free:
            return -1
        block_id = self._free.pop()
        self._refcount[block_id] = 1
        return block_id

    def incref(self, block_id: int) -> None:
        if self._refcount[block_id] <= 0:
            raise ValueError(f'incref of free block {block_id}')
        self._refcount[block_id] += 1

    def free(self, block_id: int) -> None:
        if self._refcount[block_id] <= 0:
            raise ValueError(f'double free of block {block_id}')
        self._refcount[block_id] -= 1
        if self._refcount[block_id] == 0:
            self._free.append(block_id)

    @property
    def num_free(self) -> int:
        return len(self._free)


class NativeBlockAllocator:
    """ctypes wrapper over the C++ allocator (``csrc/host/block_allocator.cpp``,
    built with g++ at first use; raises ``RuntimeError`` when it cannot be
    built). The same policy as :class:`PyBlockAllocator`."""

    def __init__(self, num_blocks: int) -> None:
        from distllm_tpu_torch.ops._build import build_host

        lib = ctypes.CDLL(str(build_host('block_allocator')))
        lib.ba_create.restype = ctypes.c_void_p
        lib.ba_create.argtypes = [ctypes.c_int32]
        for fn in ('ba_alloc', 'ba_incref', 'ba_free', 'ba_num_free'):
            getattr(lib, fn).restype = ctypes.c_int32
        lib.ba_alloc.argtypes = [ctypes.c_void_p]
        lib.ba_num_free.argtypes = [ctypes.c_void_p]
        lib.ba_incref.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.ba_free.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.ba_destroy.argtypes = [ctypes.c_void_p]
        handle = lib.ba_create(num_blocks)
        if not handle:
            raise RuntimeError(f'ba_create({num_blocks}) failed')
        self._lib = lib
        self._handle = handle

    def alloc(self) -> int:
        return int(self._lib.ba_alloc(self._handle))

    def incref(self, block_id: int) -> None:
        if self._lib.ba_incref(self._handle, block_id) < 0:
            raise ValueError(f'incref of unallocated block {block_id}')

    def free(self, block_id: int) -> None:
        if self._lib.ba_free(self._handle, block_id) < 0:
            raise ValueError(f'double free of block {block_id}')

    @property
    def num_free(self) -> int:
        return int(self._lib.ba_num_free(self._handle))

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        lib = getattr(self, '_lib', None)
        handle = getattr(self, '_handle', None)
        if lib is not None and handle:
            lib.ba_destroy(handle)
            self._handle = None


def make_allocator(
    num_blocks: int, prefer_native: bool = True
) -> 'NativeBlockAllocator | PyBlockAllocator':
    """The native allocator when ``prefer_native`` and it builds, else the
    Python one, with a log line saying so."""
    if prefer_native:
        try:
            return NativeBlockAllocator(num_blocks)
        except (RuntimeError, OSError) as exc:
            # The Python twin is a designed drop-in (same policy, same
            # tests), but WHICH allocator served must never be a silent
            # guess in a perf investigation.
            from distllm_tpu_torch.observability.instruments import log_event

            log_event(
                f'[engine] native block allocator unavailable '
                f'({exc!r:.120}); using the Python fallback',
                component='engine',
            )
    return PyBlockAllocator(num_blocks)


class PagedKVCache:
    """Device-resident paged K/V tensors (a pure container: block
    accounting is the scheduler's job). The pool is zero-initialised, so
    the trash block starts finite. ``dtype=torch.int8`` makes ``k`` and
    ``v`` :class:`QuantizedKV` pools (``quantized`` is then true). Under
    tensor parallelism the engine sizes it with its rank's
    ``num_kv_heads / model`` heads (an int8 pool's scales per block and
    local head)."""

    def __init__(
        self,
        num_layers: int,
        num_blocks: int,
        block_size: int,
        num_kv_heads: int,
        head_dim: int,
        dtype: torch.dtype,
        device: 'str | torch.device',
    ) -> None:
        self.shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
        self.dtype = dtype
        self.quantized = dtype == torch.int8
        # One fp32 scale per (layer, block, KV head), for K and V each.
        self.scale_shape = (num_layers, num_blocks, num_kv_heads)
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.k = self._zeros(device)
        self.v = self._zeros(device)

    def _zeros(self, device):
        data = torch.zeros(self.shape, dtype=self.dtype, device=device)
        if not self.quantized:
            return data
        return QuantizedKV(
            data, torch.zeros(self.scale_shape, dtype=torch.float32, device=device)
        )

    def blocks_needed(self, num_tokens: int) -> int:
        return (num_tokens + self.block_size - 1) // self.block_size

    @property
    def hbm_bytes(self) -> int:
        """Device bytes of the pool: K and V data, plus their scales."""
        tensors = [*self.k, *self.v] if self.quantized else [self.k, self.v]
        return sum(t.numel() * t.element_size() for t in tensors)


def hash_block_tokens(parent: bytes | None, tokens: Sequence[int]) -> bytes:
    """Digest of one full token block, chained through its prefix
    (``h_i = H(h_{i-1} || tokens_i)``), so a block's digest identifies the
    whole prefix up to and including it and a flat digest -> block map
    matches the longest cached prefix by walking digests until one misses.
    sha256: a collision would serve another prompt's KV."""
    h = hashlib.sha256(parent or b'')
    h.update(b','.join(str(int(t)).encode() for t in tokens))
    return h.digest()


def block_digests(prompt_ids: Sequence[int], block_size: int) -> list[bytes]:
    """Chained digests for every FULL block of ``prompt_ids`` (a partial
    trailing block is not final yet, so reuse is whole blocks)."""
    digests: list[bytes] = []
    parent: bytes | None = None
    for start in range(0, len(prompt_ids) - block_size + 1, block_size):
        parent = hash_block_tokens(parent, prompt_ids[start:start + block_size])
        digests.append(parent)
    return digests


@dataclass
class _CacheEntry:
    block_id: int
    refcount: int = 0  # live requests referencing this block
    holders: set = field(default_factory=set)  # rids


class PrefixCache:
    """Digest-chain -> KV-block map with refcounts and LRU eviction.

    - ``acquire(rid, digests)``: longest-prefix match; increfs every
      matched block for ``rid`` (matched blocks leave the evictable LRU).
    - ``insert(rid, digest, block_id)``: adopt a freshly prefilled prompt
      block; False when the digest is already cached (first writer wins,
      the caller keeps its duplicate block private).
    - ``release(rid)``: drop ``rid``'s references; blocks at refcount 0
      become LRU-evictable and keep their KV.
    - ``evict`` / ``evict_entries``: pop least-recently-used evictable
      blocks for the scheduler's free list.

    Host bookkeeping only: it never touches the pool and never frees a
    block itself.
    """

    def __init__(self, block_size: int) -> None:
        self.block_size = block_size
        self._entries: dict[bytes, _CacheEntry] = {}
        # digest -> block_id of refcount-0 entries, oldest first.
        self._evictable: 'OrderedDict[bytes, int]' = OrderedDict()
        self._held: dict[int, list[bytes]] = {}  # rid -> digests referenced
        # insert_dupes: first-writer-wins losses (same-prefix requests
        # prefilled before either's blocks entered the cache).
        self.stats = {'hit_blocks': 0, 'evictions': 0, 'inserts': 0, 'insert_dupes': 0}

    def match(self, digests: Sequence[bytes]) -> list[int]:
        """Block ids of the longest cached prefix of ``digests`` (no ref)."""
        blocks: list[int] = []
        for digest in digests:
            entry = self._entries.get(digest)
            if entry is None:
                break
            blocks.append(entry.block_id)
        return blocks

    def acquire(self, rid: int, digests: Sequence[bytes]) -> list[int]:
        """Longest-prefix match, each matched block incref'd for ``rid``."""
        blocks: list[int] = []
        matched: list[bytes] = []
        for digest in digests:
            entry = self._entries.get(digest)
            if entry is None:
                break
            entry.refcount += 1
            entry.holders.add(rid)
            self._evictable.pop(digest, None)
            matched.append(digest)
            blocks.append(entry.block_id)
        if matched:
            self._held.setdefault(rid, []).extend(matched)
        self.stats['hit_blocks'] += len(blocks)
        return blocks

    def insert(self, rid: int, digest: bytes, block_id: int) -> bool:
        """Adopt ``block_id`` for ``digest``, ``rid`` holding the first ref;
        False when the digest is already cached."""
        if digest in self._entries:
            self.stats['insert_dupes'] += 1
            return False
        self._entries[digest] = _CacheEntry(block_id, refcount=1, holders={rid})
        self._held.setdefault(rid, []).append(digest)
        self.stats['inserts'] += 1
        return True

    def release(self, rid: int) -> None:
        """Drop every reference ``rid`` holds (finish and abort)."""
        for digest in self._held.pop(rid, []):
            entry = self._entries.get(digest)
            if entry is None:
                continue
            entry.refcount -= 1
            entry.holders.discard(rid)
            if entry.refcount <= 0:
                # Most recently released = most likely reused next: MRU end.
                self._evictable[digest] = entry.block_id

    def evict(self, max_blocks: int) -> list[int]:
        """Pop up to ``max_blocks`` LRU evictable blocks."""
        return [bid for _, bid in self.evict_entries(max_blocks)]

    def evict_entries(self, max_blocks: int) -> list[tuple[bytes, int]]:
        """``evict`` returning ``(digest, block_id)`` pairs, so the engine
        can spill the blocks' KV to the host tier before they are reused."""
        evicted: list[tuple[bytes, int]] = []
        while self._evictable and len(evicted) < max_blocks:
            digest, block_id = self._evictable.popitem(last=False)
            del self._entries[digest]
            evicted.append((digest, block_id))
        self.stats['evictions'] += len(evicted)
        return evicted

    @property
    def num_cached(self) -> int:
        return len(self._entries)

    @property
    def num_evictable(self) -> int:
        return len(self._evictable)

    @property
    def num_shared(self) -> int:
        return sum(1 for e in self._entries.values() if len(e.holders) >= 2)


# ------------------------------------------------------------- .kvblock v2
# Header dtype names (numpy's, as the JAX package writes them) and the
# torch dtypes they hold.
KVBLOCK_DTYPES = {
    'float32': torch.float32, 'bfloat16': torch.bfloat16, 'float16': torch.float16,
    'int8': torch.int8,
}
_KVBLOCK_NAMES = {dtype: name for name, dtype in KVBLOCK_DTYPES.items()}


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A CPU tensor's bytes in C order (a bf16 tensor through uint8: numpy
    has no bfloat16), equal to numpy's ``tobytes()`` of the same array."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _from_bytes(chunk: bytes, dtype: torch.dtype, shape: tuple[int, ...]) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype)
    if chunk:
        out.reshape(-1).view(torch.uint8).copy_(
            torch.frombuffer(bytearray(chunk), dtype=torch.uint8)
        )
    return out


def encode_kvblock(
    k: torch.Tensor,
    v: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> bytes:
    """One block's KV (plus an int8 pool's scale rows) as ``.kvblock`` v2:
    one JSON header line (``version``, ``shape``, ``dtype``, ``scales``,
    compact separators), then the raw K bytes, the V bytes, and the K and
    V scale bytes — the JAX package's payload byte for byte."""
    meta = {'version': 2, 'shape': list(k.shape), 'dtype': _KVBLOCK_NAMES[k.dtype]}
    meta['scales'] = (
        None if k_scale is None
        else {'shape': list(k_scale.shape), 'dtype': _KVBLOCK_NAMES[k_scale.dtype]}
    )
    header = json.dumps(meta, separators=(',', ':')).encode() + b'\n'
    payload = header + _raw_bytes(k) + _raw_bytes(v)
    if k_scale is not None:
        payload += _raw_bytes(k_scale) + _raw_bytes(v_scale)
    return payload


def _dtype_of(name) -> torch.dtype:
    dtype = KVBLOCK_DTYPES.get(name)
    if dtype is None:
        raise TypeError(f'unknown .kvblock dtype {name!r}')
    return dtype


def decode_kvblock(payload: bytes) -> tuple[torch.Tensor, ...]:
    """Parse a ``.kvblock`` payload into CPU tensors ``(K, V)``, or ``(K,
    V, K_scale, V_scale)`` for a quantized spill. A version-less (v1)
    payload is K then V, halving the body. Raises ``ValueError`` /
    ``KeyError`` / ``TypeError`` on corruption (no header line, a bad
    header, a short body, trailing bytes, an unknown version or dtype):
    the tiers count it and degrade to a miss."""
    header, sep, body = payload.partition(b'\n')
    if not sep:
        raise ValueError('missing header line')
    meta = json.loads(header)
    if not isinstance(meta, dict):
        raise TypeError('.kvblock header is not an object')
    version = int(meta.get('version', 1))
    if version > 2:
        raise ValueError(f'unknown .kvblock version {version}')
    dtype = _dtype_of(meta['dtype'])
    shape = tuple(int(d) for d in meta['shape'])
    specs = [(shape, dtype), (shape, dtype)]
    if version < 2:
        half = len(body) // 2
        chunks = [body[:half], body[half:]]
    else:
        scales_meta = meta.get('scales')
        if scales_meta is not None:
            s_shape = tuple(int(d) for d in scales_meta['shape'])
            specs += [(s_shape, _dtype_of(scales_meta['dtype']))] * 2
        chunks, offset = [], 0
        for a_shape, a_dtype in specs:
            count = math.prod(a_shape) * a_dtype.itemsize
            chunks.append(body[offset:offset + count])
            offset += count
        if offset < len(body):
            raise ValueError('trailing bytes in .kvblock body')
    arrays = []
    for chunk, (a_shape, a_dtype) in zip(chunks, specs):
        if len(chunk) != math.prod(a_shape) * a_dtype.itemsize:
            raise ValueError('truncated .kvblock body')
        arrays.append(_from_bytes(chunk, a_dtype, a_shape))
    return tuple(arrays)


def _nbytes(arrays) -> int:
    return sum(a.numel() * a.element_size() for a in arrays)


class DiskKVTier:
    """Digest-keyed ``.kvblock`` files, the persistence tier under the host
    pool: one ``<digest-hex>.kvblock`` per spilled block, so a fresh engine
    on the same corpus (of either package) promotes straight from a
    previous process's spills. Bounded by ``max_bytes``, LRU on use, the
    index rebuilt from file mtimes at construction. A file that cannot be
    read or parsed (a torn spill, bit rot, a foreign file, a newer
    version) counts into ``errors``, is dropped and reads as a miss.
    Thread-safe."""

    _SUFFIX = '.kvblock'

    def __init__(self, root: 'str | os.PathLike', max_bytes: int) -> None:
        self._lock = threading.Lock()
        self._root = Path(root)
        self._root.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self._index: 'OrderedDict[str, int]' = OrderedDict()  # hex -> size; guarded by _lock
        self._bytes = 0  # guarded by _lock
        # Blocks read back, and tier errors (unreadable or undeletable files).
        self.reads = self.errors = 0
        entries = []
        for path in self._root.glob(f'*{self._SUFFIX}'):
            try:
                stat = path.stat()
            except OSError:  # unlinked meanwhile: never indexed
                continue
            entries.append((stat.st_mtime, path.stem, stat.st_size))
        for _, hexdigest, size in sorted(entries):
            self._index[hexdigest] = size
            self._bytes += size
        self._evict_over_budget_locked()

    def _path(self, hexdigest: str) -> Path:
        return self._root / f'{hexdigest}{self._SUFFIX}'

    def _evict_over_budget_locked(self) -> None:
        while self._bytes > self.max_bytes and self._index:
            hexdigest, size = self._index.popitem(last=False)
            self._bytes -= size
            try:
                self._path(hexdigest).unlink()
            except OSError:
                self.errors += 1  # a file left outside the budget

    def contains(self, digest: bytes) -> bool:
        with self._lock:
            return digest.hex() in self._index

    def _drop_entry(self, hexdigest: str, *, unlink: bool = False) -> None:
        """Forget one entry after a read error; counted only when it was
        still indexed (a read racing an eviction is a plain miss)."""
        with self._lock:
            size = self._index.pop(hexdigest, None)
            if size is not None:
                self._bytes -= size
                self.errors += 1
        if unlink:
            try:
                os.unlink(self._path(hexdigest))
            except OSError:  # already gone; the error is counted above
                pass

    def put(self, digest: bytes, k, v, k_scale=None, v_scale=None) -> bool:
        """Persist one block; False when already present (the contents are
        digest-determined) or when the write fails (counted)."""
        hexdigest = digest.hex()
        payload = encode_kvblock(k, v, k_scale, v_scale)
        with self._lock:
            if hexdigest in self._index:
                self._index.move_to_end(hexdigest)
                return False
            path = self._path(hexdigest)
            tmp = path.with_suffix('.tmp')
            try:
                get_fault_injector().fail_io('tier_io')
                tmp.write_bytes(payload)
                os.replace(tmp, path)
            except OSError:
                self.errors += 1  # a full or read-only disk: no tier
                return False
            self._index[hexdigest] = len(payload)
            self._bytes += len(payload)
            self._evict_over_budget_locked()
        return True

    def get(self, digest: bytes) -> tuple[torch.Tensor, ...] | None:
        """One block's tensors, refreshing its LRU slot; the file is read
        outside the lock. None on a miss or a counted error."""
        hexdigest = digest.hex()
        with self._lock:
            if hexdigest not in self._index:
                return None
            self._index.move_to_end(hexdigest)
        try:
            get_fault_injector().fail_io('tier_io')
            payload = self._path(hexdigest).read_bytes()
        except OSError:
            self._drop_entry(hexdigest)
            return None
        try:
            arrays = decode_kvblock(payload)
        except (ValueError, KeyError, TypeError):
            self._drop_entry(hexdigest, unlink=True)
            return None
        self.reads += 1
        return arrays

    @property
    def num_blocks(self) -> int:
        with self._lock:
            return len(self._index)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes


class PeerKVTier:
    """Sibling replicas' spilled KV blocks, fetched over the ZMQ fabric: the
    tier under disk (the JAX ``PeerKVTier``).

    Each endpoint is a sibling's ``parallel.fabric.KVBlockServer``,
    answering HAS / GET by digest with the ``.kvblock`` v2 payload the disk
    tier writes. A read tier only: spills never land here, and a fetched
    block re-enters the local host pool as a disk hit does. Every failure
    degrades to a miss: an unreachable peer is backed off for
    ``failure_backoff_s``, and it and a corrupt payload count
    ``distllm_prefix_tier_errors_total{tier="peer"}``; the serving loop
    never sees a network exception. Endpoints may be added after
    construction (:meth:`add_endpoint`): a sibling's port is often known
    only once it has bound its server.
    """

    def __init__(
        self,
        endpoints: Sequence[str] = (),
        *,
        timeout_ms: int = 500,
        failure_backoff_s: float = 5.0,
    ) -> None:
        # The fabric (and with it zmq) only when a peer tier is built.
        from distllm_tpu_torch.parallel.fabric import KVBlockClient

        self._lock = threading.Lock()
        self.endpoints: list[str] = list(endpoints)  # guarded by self._lock
        self.failure_backoff_s = float(failure_backoff_s)
        self._client = KVBlockClient(timeout_ms=timeout_ms)
        # endpoint -> monotonic instant its backoff ends.
        self._backoff_until: dict[str, float] = {}  # guarded by self._lock
        # digest -> the endpoint that answered HAS, asked first by get().
        self._hit_memo: 'OrderedDict[bytes, str]' = OrderedDict()  # guarded by self._lock
        self.fetched_blocks = 0
        self.fetched_bytes = 0

    def add_endpoint(self, endpoint: str) -> None:
        with self._lock:
            if endpoint not in self.endpoints:
                self.endpoints.append(endpoint)

    def _live_endpoints(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return [ep for ep in self.endpoints if self._backoff_until.get(ep, 0.0) <= now]

    def _note_failure(self, endpoint: str) -> None:
        from distllm_tpu_torch.observability import instruments

        instruments.PREFIX_TIER_ERRORS.labels(tier='peer').inc()
        with self._lock:
            self._backoff_until[endpoint] = time.monotonic() + self.failure_backoff_s

    def _memo(self, digest: bytes, endpoint: str) -> None:
        with self._lock:
            self._hit_memo[digest] = endpoint
            self._hit_memo.move_to_end(digest)
            while len(self._hit_memo) > 1024:
                self._hit_memo.popitem(last=False)

    def contains(self, digest: bytes) -> bool:
        """Membership across the live peers (the first hit wins and is
        remembered for the ``get`` that follows); each probe is bounded by
        the client's timeout and the per-peer backoff."""
        from distllm_tpu_torch.parallel.fabric import KV_HIT

        for endpoint in self._live_endpoints():
            reply = self._client.request(endpoint, b'HAS', digest)
            if reply is None:
                self._note_failure(endpoint)
                continue
            if reply[0] == KV_HIT:
                self._memo(digest, endpoint)
                return True
        return False

    def get(self, digest: bytes) -> tuple[torch.Tensor, ...] | None:
        """One block's CPU tensors from a sibling, the remembered endpoint
        first. A hit lands a ``peer_fetch`` flight record; a timeout, a
        miss or a corrupt payload returns None (a cold prefill)."""
        from distllm_tpu_torch.observability import instruments
        from distllm_tpu_torch.observability.flight import get_flight_recorder
        from distllm_tpu_torch.parallel.fabric import KV_HIT

        with self._lock:
            memo = self._hit_memo.get(digest)
        ordered = self._live_endpoints()
        if memo in ordered:
            ordered.remove(memo)
            ordered.insert(0, memo)
        for endpoint in ordered:
            t_start = time.monotonic()
            reply = self._client.request(endpoint, b'GET', digest)
            if reply is None:
                self._note_failure(endpoint)
                continue
            status, payload = reply
            if status != KV_HIT:
                continue  # evicted on the sibling since the HAS probe
            try:
                arrays = decode_kvblock(payload)
            except (ValueError, KeyError, TypeError):
                instruments.PREFIX_TIER_ERRORS.labels(tier='peer').inc()
                continue
            fetch_s = time.monotonic() - t_start
            self.fetched_blocks += 1
            self.fetched_bytes += len(payload)
            get_flight_recorder().record(
                'peer_fetch', endpoint=endpoint, blocks=1, bytes=len(payload),
                fetch_s=round(fetch_s, 6),
            )
            return arrays
        return None

    def close(self) -> None:
        self._client.close()


class HostKVTier:
    """Bounded digest-keyed host pool of spilled KV blocks, between the
    prefix cache's device blocks and the optional disk tier. Entries are
    CPU tensors of one block (``[L, block_size, N_kv, Hd]`` each for K and
    V; an int8 pool's two ``[L, N_kv]`` scale rows after them), LRU-ordered
    and bounded by ``max_bytes``. With a :class:`DiskKVTier` attached,
    spills write through to disk and host misses fall through to it, a
    disk hit re-entering the host pool; with a :class:`PeerKVTier` the
    fallthrough goes one hop further (host -> disk -> peer) and a peer hit
    re-enters the host pool the same way. Thread-safe."""

    def __init__(
        self,
        max_bytes: int,
        disk: DiskKVTier | None = None,
        peer: PeerKVTier | None = None,
    ) -> None:
        self._lock = threading.Lock()
        self.max_bytes = int(max_bytes)
        self.disk = disk
        self.peer = peer
        self._entries: 'OrderedDict[bytes, tuple[torch.Tensor, ...]]' = OrderedDict()  # guarded by _lock
        self._bytes = 0  # guarded by _lock

    def _evict_over_budget_locked(self) -> None:
        while self._bytes > self.max_bytes and self._entries:
            _, arrays = self._entries.popitem(last=False)
            self._bytes -= _nbytes(arrays)

    def lookup(self, digest: bytes) -> str | None:
        """Which tier holds ``digest`` (``'host'``, ``'disk'``, ``'peer'``
        or None): membership only, no load and no LRU touch; the peer
        probe (a bounded fabric round trip) comes last."""
        with self._lock:
            if digest in self._entries:
                return 'host'
        if self.disk is not None and self.disk.contains(digest):
            return 'disk'
        if self.peer is not None and self.peer.contains(digest):
            return 'peer'
        return None

    def contains_local(self, digest: bytes) -> bool:
        """Host or disk membership, the ``KVBlockServer``'s HAS answer:
        never this replica's own peers (two replicas would bounce a miss
        between them)."""
        with self._lock:
            if digest in self._entries:
                return True
        return self.disk is not None and self.disk.contains(digest)

    def encoded_local(self, digest: bytes) -> bytes | None:
        """One block as a ``.kvblock`` payload from the host or disk tier
        only, the ``KVBlockServer``'s GET answer."""
        arrays = self.get(digest, allow_peer=False)
        return None if arrays is None else encode_kvblock(*arrays)

    def put(self, digest: bytes, k, v, k_scale=None, v_scale=None) -> bool:
        """Adopt one spilled block (CPU tensors the tier may keep)."""
        arrays = (k, v) if k_scale is None else (k, v, k_scale, v_scale)
        if self.disk is not None:
            self.disk.put(digest, k, v, k_scale, v_scale)
        with self._lock:
            if digest in self._entries:
                self._entries.move_to_end(digest)
                return False
            self._entries[digest] = arrays
            self._bytes += _nbytes(arrays)
            self._evict_over_budget_locked()
        return True

    def get(self, digest: bytes, *, allow_peer: bool = True) -> tuple[torch.Tensor, ...] | None:
        """``(K, V)`` or ``(K, V, K_scale, V_scale)`` for ``digest``,
        refreshing its LRU slot; a host miss falls through to disk, then
        (``allow_peer``) to the peers, and a hit there re-enters the host
        pool."""
        with self._lock:
            entry = self._entries.get(digest)
            if entry is not None:
                self._entries.move_to_end(digest)
                return entry
        loaded = self.disk.get(digest) if self.disk is not None else None
        if loaded is None and allow_peer and self.peer is not None:
            loaded = self.peer.get(digest)
        if loaded is None:
            return None
        with self._lock:
            if digest not in self._entries:
                self._entries[digest] = loaded
                self._bytes += _nbytes(loaded)
                self._evict_over_budget_locked()
        return loaded

    @property
    def num_blocks(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes
