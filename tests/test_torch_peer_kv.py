"""The port's peer KV tier (``kv_cache.PeerKVTier``, the host tier's host ->
disk -> peer fallthrough, the engine's ``peer_kv_*`` fields and its
``KVBlockServer``) against the JAX package's.

- The JAX ``gen_router`` stage's peer arm on the tiny fp32 model of
  ``test_torch_prefix_cache.py`` (weights carried across by
  ``params_from_jax``), on a pool that every admission after the first
  evicts: engine A serves a prompt and spills it, engine B starts cold with
  a dead peer and A as its peers and adopts A's blocks (at least one peer
  fetch, A's ``peer_served_blocks`` positive; the dead peer costs one
  counted error, then its backoff); B's greedy tokens equal the peer-less
  control C's and the JAX engine's.
- The tier alone: backoff on an unreachable peer, ``add_endpoint``, the hit
  memo, a corrupt payload counted as ``distllm_prefix_tier_errors_total
  {tier="peer"}``, the fetch counters and the ``peer_fetch`` flight
  record; a port tier fetching from a JAX replica's server, and the JAX
  tier from the port's, with equal tensors.
- ``EngineConfig`` refuses the peer fields without a host tier, as JAX's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip('zmq')

from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams  # noqa: E402
from distllm_tpu.generate.engine import kv_cache as jkv  # noqa: E402
from distllm_tpu.parallel import fabric as jax_fabric  # noqa: E402
from distllm_tpu_torch.generate.engine import EngineConfig, SamplingParams  # noqa: E402
from distllm_tpu_torch.generate.engine import kv_cache as tkv  # noqa: E402
from distllm_tpu_torch.observability import instruments  # noqa: E402
from distllm_tpu_torch.observability.flight import get_flight_recorder  # noqa: E402
from distllm_tpu_torch.parallel import fabric  # noqa: E402
from distllm_tpu_torch.parallel.multihost import free_port  # noqa: E402
from test_torch_prefix_cache import jax_engine, port_engine, tree  # noqa: E402,F401

GREEDY = {'temperature': 0.0, 'max_tokens': 6}
# 11 usable blocks vs 24-token (6-block) prompts: every admission after the
# first evicts cached blocks, so A spills its first prompt.
POOL = dict(num_blocks=12, max_num_seqs=2, max_model_len=48, enable_prefix_cache=True,
            host_kv_tier_bytes=64 << 20)
PROMPT = list(range(1, 25))
JUNK = [list(range(30 + 7 * j, 54 + 7 * j)) for j in range(2)]


def _new_records(before: int) -> list[dict]:
    """The flight records made since the ring's count was ``before``."""
    recorder = get_flight_recorder()
    new = recorder.total_recorded - before
    return recorder.snapshot(limit=new) if new else []


def _peer_errors() -> float:
    return instruments.PREFIX_TIER_ERRORS.labels(tier='peer').value


# ------------------------------------------------------------- the engines
def test_peer_handoff_gives_the_control_and_jax_tokens(tree):  # noqa: F811
    want = jax_engine(tree, **{k: v for k, v in POOL.items() if k != 'host_kv_tier_bytes'}
                      ).generate_ids([PROMPT], JaxSamplingParams(**GREEDY))
    engine_a = port_engine(tree, **POOL, peer_kv_serve_endpoint='tcp://127.0.0.1:0')
    engine_b = None
    try:
        assert engine_a.peer_kv_endpoint.startswith('tcp://127.0.0.1:')
        engine_a.generate_ids([PROMPT], SamplingParams(**GREEDY))
        for junk in JUNK:
            engine_a.generate_ids([junk], SamplingParams(**GREEDY))
        assert engine_a.tier_summary()['spilled_blocks'] >= 6
        # B's first peer is down: one timed-out probe, counted, then backed
        # off; the live one (A) serves every block.
        dead = f'tcp://127.0.0.1:{free_port()}'
        errors = _peer_errors()
        engine_b = port_engine(tree, **POOL, peer_kv_endpoints=[dead, engine_a.peer_kv_endpoint],
                               peer_kv_timeout_ms=100, peer_kv_backoff_s=60.0)
        before = get_flight_recorder().total_recorded
        tokens_b = engine_b.generate_ids([PROMPT], SamplingParams(**GREEDY))
        summary_b = engine_b.tier_summary()
        summary_a = engine_a.tier_summary()
        records = _new_records(before)
    finally:
        if engine_b is not None:
            engine_b.shutdown()
        engine_a.shutdown()
    engine_c = port_engine(tree, **POOL)
    tokens_c = engine_c.generate_ids([PROMPT], SamplingParams(**GREEDY))
    engine_c.shutdown()
    assert tokens_b == tokens_c == want
    assert _peer_errors() - errors == 1
    # The prompt's five full blocks before the last token's (one stays to
    # prefill) came from A.
    assert summary_b['peer_fetched_blocks'] == 5 and summary_b['promoted_blocks'] == 5
    assert summary_b['peer_fetched_bytes'] > 0
    assert summary_a['peer_served_blocks'] == 5
    assert summary_a['peer_served_bytes'] == summary_b['peer_fetched_bytes']
    assert sum(1 for r in records if r.get('kind') == 'peer_fetch') == 5
    assert 'peer_fetched_blocks' not in summary_a and 'peer_served_blocks' not in summary_b


@pytest.mark.parametrize('fields,match', [
    ({'peer_kv_endpoints': ()}, 'peer_kv_endpoints needs host_kv_tier_bytes'),
    ({'peer_kv_serve_endpoint': 'tcp://127.0.0.1:0'}, 'peer_kv_serve_endpoint needs'),
    ({'host_kv_tier_bytes': 1, 'peer_kv_timeout_ms': -1}, 'peer_kv_timeout_ms'),
    ({'host_kv_tier_bytes': 1, 'peer_kv_backoff_s': -1.0}, 'peer_kv_backoff_s'),
])
def test_engine_config_refuses_as_jax(fields, match):
    with pytest.raises(ValueError):
        JaxEngineConfig(enable_prefix_cache=True, **fields)
    with pytest.raises(ValueError, match=match):
        EngineConfig(enable_prefix_cache=True, **fields)
    cfg = EngineConfig(enable_prefix_cache=True, host_kv_tier_bytes=1,
                       peer_kv_endpoints=['tcp://a:1'])
    assert cfg.peer_kv_endpoints == ('tcp://a:1',)
    defaults = JaxEngineConfig()
    for name in ('peer_kv_endpoints', 'peer_kv_serve_endpoint', 'peer_kv_timeout_ms',
                 'peer_kv_backoff_s'):
        assert getattr(EngineConfig(), name) == getattr(defaults, name)


# ---------------------------------------------------------------- the tier
def _arrays(seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(2, 4, 2, 8, generator=gen).to(dtype),
            torch.randn(2, 4, 2, 8, generator=gen).to(dtype))


def _digest(i):
    return tkv.block_digests(list(range(4 * i, 4 * i + 4)), 4)[0]


def _serve(blocks: dict, corrupt=()):
    def get(digest):
        if digest in corrupt:
            return b'{"version":2,"shape":[2],"dtype":"float32","scales":null}\n' + bytes(3)
        arrays = blocks.get(digest)
        return None if arrays is None else tkv.encode_kvblock(*arrays)

    return fabric.KVBlockServer(lambda d: d in blocks or d in corrupt, get).start()


def test_peer_tier_backoff_memo_and_counters():
    blocks = {_digest(1): _arrays(1), _digest(2): _arrays(2)}
    bad = _digest(3)
    first, second = _serve({}), _serve(blocks, corrupt={bad})
    dead = f'tcp://127.0.0.1:{free_port()}'
    tier = tkv.PeerKVTier([dead, first.endpoint], timeout_ms=100, failure_backoff_s=60.0)
    try:
        errors = _peer_errors()
        assert not tier.contains(_digest(1))  # the dead peer times out, backs off
        assert _peer_errors() - errors == 1
        tier.add_endpoint(second.endpoint)
        tier.add_endpoint(second.endpoint)
        assert tier.endpoints == [dead, first.endpoint, second.endpoint]
        assert tier.contains(_digest(1))  # the dead one is skipped while backed off
        assert _peer_errors() - errors == 1
        before = get_flight_recorder().total_recorded
        got = tier.get(_digest(1))
        assert all(torch.equal(a, b) for a, b in zip(got, blocks[_digest(1)]))
        assert tier.fetched_blocks == 1
        assert tier.fetched_bytes == len(tkv.encode_kvblock(*blocks[_digest(1)]))
        record = _new_records(before)[-1]
        assert record['kind'] == 'peer_fetch' and record['endpoint'] == second.endpoint
        assert record['bytes'] == tier.fetched_bytes and record['blocks'] == 1
        # The memo sent the GET to the peer that answered HAS: the first
        # live peer was not asked again.
        assert first.served_blocks == 0 and second.served_blocks == 1
        assert tier.get(bad) is None  # corrupt: counted, a miss
        assert _peer_errors() - errors == 2
        assert tier.get(_digest(9)) is None and tier.fetched_blocks == 1
    finally:
        tier.close()
        first.close()
        second.close()


def test_host_tier_falls_through_disk_then_peer(tmp_path):
    blocks = {_digest(1): _arrays(1), _digest(2): _arrays(2, torch.bfloat16)}
    server = _serve(blocks)
    peer = tkv.PeerKVTier([server.endpoint], timeout_ms=2000)
    disk = tkv.DiskKVTier(tmp_path, 1 << 20)
    disk.put(_digest(4), *_arrays(4))
    host = tkv.HostKVTier(1 << 20, disk=disk, peer=peer)
    host.put(_digest(5), *_arrays(5))
    try:
        assert [host.lookup(_digest(i)) for i in (5, 4, 1, 9)] == ['host', 'disk', 'peer', None]
        assert host.contains_local(_digest(4)) and not host.contains_local(_digest(1))
        assert host.encoded_local(_digest(1)) is None  # never asks the peers
        assert server.served_blocks == 0
        blocks_before = host.num_blocks
        got = host.get(_digest(2))
        assert got[0].dtype == torch.bfloat16 and torch.equal(got[0], blocks[_digest(2)][0])
        assert host.num_blocks == blocks_before + 1  # the peer hit re-entered the host pool
        assert host.contains_local(_digest(2))
        assert host.encoded_local(_digest(2)) == tkv.encode_kvblock(*blocks[_digest(2)])
        assert host.get(_digest(2)) is got and server.served_blocks == 1
        assert host.get(_digest(1), allow_peer=False) is None
    finally:
        peer.close()
        server.close()


def _np(t):
    import jax.numpy as jnp

    return t.float().numpy().astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize('server_side', ['jax', 'port'])
def test_tiers_fetch_across_packages(server_side):
    """A port replica's tier reads a JAX replica's spills and the reverse:
    each side's ``HostKVTier`` behind its ``KVBlockServer``."""
    arrays = {_digest(1): _arrays(1), _digest(2): _arrays(2, torch.bfloat16)}
    if server_side == 'jax':
        host = jkv.HostKVTier(1 << 20)
        for digest, (k, v) in arrays.items():
            host.put(digest, _np(k), _np(v))
        server = jax_fabric.KVBlockServer(host.contains_local, host.encoded_local).start()
        tier = tkv.PeerKVTier([server.endpoint], timeout_ms=2000)
    else:
        host = tkv.HostKVTier(1 << 20)
        for digest, (k, v) in arrays.items():
            host.put(digest, k, v)
        server = fabric.KVBlockServer(host.contains_local, host.encoded_local).start()
        tier = jkv.PeerKVTier([server.endpoint], timeout_ms=2000)
    try:
        for digest, (k, v) in arrays.items():
            assert tier.contains(digest)
            got = tier.get(digest)
            if server_side == 'jax':
                assert torch.equal(got[0], k) and torch.equal(got[1], v)
            else:
                assert got[0].tobytes() == _np(k).tobytes()
                assert got[1].tobytes() == _np(v).tobytes()
        assert not tier.contains(_digest(7))
        assert server.served_bytes == tier.fetched_bytes > 0
    finally:
        tier.close()
        server.close()
    assert np.isfinite(tier.fetched_blocks)
