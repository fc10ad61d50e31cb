"""Prefix-affinity bookkeeping for the multi-replica router (counterpart of
``distllm_tpu.router.affinity``, digest for digest).

The routing signal is the content address the replicas key their KV tiers
by: a chained digest sequence (``kv_cache.block_digests``) over the
request's prompt prefix. The router has no tokenizer, so the chain runs
over the canonical UTF-8 bytes of the OpenAI message list instead of token
ids. Both sides (the router's pick, the replica's response headers) compute
it with :func:`prompt_prefix_digests`, so the addresses agree without the
router loading a model. Two requests sharing a message prefix share a
chain prefix, and a request extending a session extends its chain.

Learning: every completion carries ``X-Distllm-Prefix-Digest`` (hex of the
deepest chain digest the replica now holds) and ``X-Distllm-Prefix-Depth``
(its index + 1). The router checks the advertised digest against its own
chain for that request (a mismatch drops the sample instead of poisoning
the map), then inserts ``chain[:depth]`` into that replica's bounded LRU
:class:`AffinityMap`. Routing scores each replica by the longest chain
prefix in its map; depth 0 everywhere falls back to least-loaded.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Mapping, Sequence

from distllm_tpu_torch.generate.engine.kv_cache import block_digests

# Digest-chain block granularity in bytes of rendered prompt prefix; router
# and replicas must agree, and both default to it.
DEFAULT_BLOCK_BYTES = 64

HEADER_DIGEST = 'X-Distllm-Prefix-Digest'
HEADER_DEPTH = 'X-Distllm-Prefix-Depth'
HEADER_RETRY = 'X-Distllm-Router-Retry'
HEADER_REPLICA = 'X-Distllm-Router-Replica'


def prompt_prefix_bytes(messages: Iterable[Mapping]) -> bytes:
    """Canonical, append-only bytes of an OpenAI message list: 0x1f between
    role and content and 0x1e after each message keep it injective
    (``[{'a'}, {'b'}]`` and ``[{'ab'}]`` differ), and appending a message
    appends bytes."""
    parts = []
    for message in messages:
        role = str(message.get('role', ''))
        content = str(message.get('content', ''))
        parts.append(f'{role}\x1f{content}\x1e')
    return ''.join(parts).encode('utf-8', 'replace')


def prompt_prefix_digests(
    messages: Iterable[Mapping], block_bytes: int = DEFAULT_BLOCK_BYTES
) -> list[bytes]:
    """Chained digests over the full ``block_bytes`` blocks of the rendered
    prompt (the replicas' own ``block_digests`` over the bytes); a prompt
    shorter than one block has an empty chain, and no affinity signal."""
    return block_digests(prompt_prefix_bytes(messages), block_bytes)


class AffinityMap:
    """Bounded per-replica digest LRU maps learned from response headers.
    Not thread-safe: the router calls it under its own lock."""

    def __init__(self, max_entries_per_replica: int = 4096) -> None:
        self.max_entries = int(max_entries_per_replica)
        self._maps: dict[str, OrderedDict[bytes, None]] = {}

    def learn(self, replica: str, chain: Sequence[bytes]) -> None:
        lru = self._maps.setdefault(replica, OrderedDict())
        for digest in chain:
            lru[digest] = None
            lru.move_to_end(digest)
        while len(lru) > self.max_entries:
            lru.popitem(last=False)

    def verify_and_learn(
        self, replica: str, chain: Sequence[bytes],
        digest_hex: str | None, depth_text: str | None,
    ) -> int:
        """Apply one response's learning sample; the depth learned (0: the
        sample was dropped). The advertised digest must equal our own
        ``chain[depth - 1]``: both sides hashed the same bytes at the same
        granularity."""
        if not digest_hex or not depth_text:
            return 0
        try:
            depth = int(depth_text)
            advertised = bytes.fromhex(digest_hex)
        except ValueError:  # a malformed header is a sample to drop
            return 0
        if depth < 1 or depth > len(chain) or chain[depth - 1] != advertised:
            return 0
        self.learn(replica, chain[:depth])
        return depth

    def score(self, replica: str, chain: Sequence[bytes]) -> int:
        """The longest prefix of ``chain`` in ``replica``'s map (the warm
        depth expected if routed there)."""
        lru = self._maps.get(replica)
        if not lru:
            return 0
        depth = 0
        for digest in chain:
            if digest not in lru:
                break
            depth += 1
        return depth

    def drop(self, replica: str) -> None:
        """Forget a replica that left rotation for good (its cache is gone)."""
        self._maps.pop(replica, None)

    def entries(self) -> int:
        return sum(len(lru) for lru in self._maps.values())
