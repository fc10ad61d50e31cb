"""The port's host and disk KV tiers against the JAX package's (the twin
of ``tests/test_kv_tier.py``).

- ``.kvblock`` v2 payloads are byte-identical both ways for bf16, fp32
  and int8 with scales, and each package decodes the other's; version-less
  (v1) payloads load, and corrupt files, an unknown version and trailing
  bytes degrade to a counted miss.
- ``HostKVTier`` (LRU, byte budget, membership-only lookup, write-through)
  and ``DiskKVTier`` (round trip, budget, index rebuilt from the files).
- Engines (the tiny fp32 model of ``test_torch_prefix_cache.py``, an
  11-usable-block pool under 24-token prompts, so every admission after
  the first evicts): spill and promotion give the JAX tier engine's greedy
  tokens and the tier-off engine's, for fp32 and int8 pools, with the
  promoted pool bytes bitwise equal to the spilled ones; a cascade of
  evictions leaks no block; a fresh engine on the same disk directory
  promotes from disk — also from a directory the JAX engine wrote; an fp32
  engine meeting an int8 pool's spills counts payload mismatches and
  prefills cold; corrupt files fall through to cold prefill; a request
  that arrives while a promotion's copy is queued borrows the promoted
  blocks and gives the tier-off engine's tokens, as the promoting one does.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.generate.engine import kv_cache as jkv
from distllm_tpu_torch.generate.engine import EngineConfig, SamplingParams
from distllm_tpu_torch.generate.engine import kv_cache as tkv
from test_torch_prefix_cache import jax_engine, port_engine, tree  # noqa: F401
from test_torch_prefix_cache import run_both as _run_both

GREEDY = {'temperature': 0.0, 'max_tokens': 4}
# 11 usable blocks vs 24-token (6-block) prompts: every admission after the
# first evicts cached blocks.
TIER_POOL = dict(num_blocks=12, max_num_seqs=2, max_model_len=48, enable_prefix_cache=True)
PROMPT_A = list(range(1, 25))
PROMPT_B = list(range(30, 54))
HOST = 64 << 20


def run_both(jax_eng, port_eng, prompts):
    return _run_both(jax_eng, port_eng, prompts, GREEDY)


def _digest(i: int) -> bytes:
    return tkv.block_digests(list(range(i * 4 + 1, i * 4 + 5)), 4)[0]


def _block(i: int, nbytes: int = 256):
    half = nbytes // 2
    k = torch.full((half // 4,), float(i))
    return k, k + 1


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(jnp.bfloat16)
    return t.numpy()


def _payload_arrays(kind, rng):
    shape = (2, 4, 2, 8)
    if kind == 'int8':
        data = [torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8))
                for _ in range(2)]
        scales = [torch.from_numpy(rng.uniform(0.01, 0.1, size=(2, 2)).astype(np.float32))
                  for _ in range(2)]
        return data + scales
    x = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for _ in range(2)]
    return [t.to(getattr(torch, kind)) for t in x]


# ------------------------------------------------------------------ .kvblock
@pytest.mark.parametrize('kind', ['bfloat16', 'float32', 'int8'])
def test_kvblock_bytes_identical_both_ways(kind):
    arrays = _payload_arrays(kind, np.random.default_rng(0))
    ours = tkv.encode_kvblock(*arrays)
    theirs = jkv.encode_kvblock(*(_np(a) for a in arrays))
    assert ours == theirs
    assert ours.split(b'\n', 1)[0].decode().startswith(f'{{"version":2,"shape":[2,4,2,8],"dtype":"{kind}"')
    for got, want in zip(tkv.decode_kvblock(theirs), arrays):
        assert got.dtype == want.dtype and torch.equal(got, want)
    for got, want in zip(jkv.decode_kvblock(ours), arrays):
        assert got.tobytes() == _np(want).tobytes()


def test_versionless_kvblock_loads():
    k = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    header = json.dumps({'shape': [2, 3, 4], 'dtype': 'float32'}).encode() + b'\n'
    rk, rv = tkv.decode_kvblock(header + k.numpy().tobytes() + (k * 2).numpy().tobytes())
    assert torch.equal(rk, k) and torch.equal(rv, k * 2)


@pytest.mark.parametrize('payload', [
    b'garbage with no newline header',
    b'{"not": "a shape record"}\n1234',
    b'{"version":3,"shape":[8],"dtype":"float32"}\n' + bytes(64),
    b'{"version":2,"shape":[8],"dtype":"float32","scales":null}\n' + bytes(65),
    b'{"version":2,"shape":[8],"dtype":"float32","scales":null}\n' + bytes(63),
    b'{"version":2,"shape":[8],"dtype":"float99","scales":null}\n' + bytes(128),
], ids=['no-header', 'no-shape', 'version-3', 'trailing', 'short', 'dtype'])
def test_corrupt_kvblock_raises_as_jax_does(payload):
    with pytest.raises((ValueError, KeyError, TypeError)):
        tkv.decode_kvblock(payload)
    with pytest.raises((ValueError, KeyError, TypeError)):
        jkv.decode_kvblock(payload)


# ---------------------------------------------------------------- host tier
def test_host_tier_lru_order_and_byte_budget():
    tier = tkv.HostKVTier(max_bytes=3 * 256)
    for i in range(3):
        assert tier.put(_digest(i), *_block(i))
    assert tier.num_blocks == 3 and tier.bytes_used == 3 * 256
    k0, v0 = tier.get(_digest(0))  # refreshes 0: the next put evicts 1
    assert k0[0] == 0 and v0[0] == 1
    tier.put(_digest(3), *_block(3))
    assert tier.bytes_used == 3 * 256
    assert tier.get(_digest(1)) is None
    assert tier.get(_digest(0)) is not None
    assert not tier.put(_digest(0), *_block(9))  # first writer wins
    assert tier.bytes_used == 3 * 256 and tier.get(_digest(0))[0][0] == 0


def test_host_tier_lookup_is_membership_only():
    tier = tkv.HostKVTier(max_bytes=2 * 256)
    tier.put(_digest(0), *_block(0))
    tier.put(_digest(1), *_block(1))
    assert tier.lookup(_digest(0)) == 'host'  # no LRU touch: 0 stays oldest
    tier.put(_digest(2), *_block(2))
    assert tier.lookup(_digest(0)) is None and tier.lookup(_digest(1)) == 'host'
    assert tier.num_blocks == 2 and tier.bytes_used == 2 * 256


def test_disk_tier_round_trip_budget_and_rebuild(tmp_path):
    block = len(tkv.encode_kvblock(*_block(0)))
    disk = tkv.DiskKVTier(tmp_path, max_bytes=2 * block)
    for i in range(3):
        assert disk.put(_digest(i), *_block(i))
    assert disk.num_blocks == 2 and disk.bytes_used == 2 * block
    assert disk.get(_digest(0)) is None
    assert not (tmp_path / f'{_digest(0).hex()}.kvblock').exists()
    k, v = disk.get(_digest(2))
    assert k[0] == 2 and v[0] == 3
    assert not disk.put(_digest(2), *_block(7))
    fresh = tkv.DiskKVTier(tmp_path, max_bytes=2 * block)
    assert fresh.num_blocks == 2 and fresh.get(_digest(1))[0][0] == 1


def test_host_tier_write_through_and_disk_fallback(tmp_path):
    disk = tkv.DiskKVTier(tmp_path, max_bytes=1 << 20)
    tier = tkv.HostKVTier(max_bytes=256, disk=disk)  # host holds one block
    tier.put(_digest(0), *_block(0))
    tier.put(_digest(1), *_block(1))
    assert disk.num_blocks == 2
    assert tier.lookup(_digest(0)) == 'disk'
    assert tier.get(_digest(0))[0][0] == 0
    assert tier.lookup(_digest(0)) == 'host'  # the disk hit re-entered the host pool


def test_disk_tier_corrupt_files_degrade_to_counted_misses(tmp_path):
    disk = tkv.DiskKVTier(tmp_path, max_bytes=1 << 20)
    k = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    for i in range(4):
        assert disk.put(_digest(i), k + i, k * 2)

    def path(i):
        return tmp_path / f'{_digest(i).hex()}.kvblock'

    payload = path(2).read_bytes()
    path(0).write_bytes(b'garbage with no newline header')
    path(1).write_bytes(b'{"not": "a shape record"}\n1234')
    path(2).write_bytes(payload[: len(payload) // 2 + 7])
    path(3).write_bytes(b'{"version":3,"shape":[24],"dtype":"float32"}\n' + bytes(192))
    for i in range(4):
        assert disk.get(_digest(i)) is None
    assert disk.errors == 4 and disk.num_blocks == 0
    assert not any(path(i).exists() for i in range(4))
    assert disk.put(_digest(5), k, k * 2)
    assert torch.equal(disk.get(_digest(5))[0], k)


def test_disk_tier_reads_jax_written_files(tmp_path):
    rng = np.random.default_rng(1)
    jdisk = jkv.DiskKVTier(tmp_path, max_bytes=1 << 20)
    arrays = _payload_arrays('int8', rng)
    jdisk.put(_digest(0), *(_np(a) for a in arrays))
    bf16 = _payload_arrays('bfloat16', rng)
    jdisk.put(_digest(1), *(_np(a) for a in bf16))
    disk = tkv.DiskKVTier(tmp_path, max_bytes=1 << 20)
    for digest, want in ((_digest(0), arrays), (_digest(1), bf16)):
        got = disk.get(digest)
        assert len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------------ engines
def test_tier_config_validation():
    with pytest.raises(ValueError, match='enable_prefix_cache'):
        EngineConfig(host_kv_tier_bytes=1 << 20)
    with pytest.raises(ValueError, match='host_kv_tier_bytes'):
        EngineConfig(enable_prefix_cache=True, disk_kv_tier_dir='/nonexistent/x')
    with pytest.raises(ValueError, match='>= 0'):
        EngineConfig(enable_prefix_cache=True, host_kv_tier_bytes=-1)


def _planes(engine):
    return engine._pool_planes()


def _blocks_of(engine, prompt):
    return engine.prefix_cache.match(tkv.block_digests(prompt, 4))


@pytest.mark.parametrize('kv', ['auto', 'int8'])
def test_spill_promote_round_trip_bit_exact(tree, kv):  # noqa: F811
    """A spilled-then-promoted prefix gives the JAX tier engine's tokens and
    the tier-off engine's, and its promoted pool bytes equal the bytes
    that were spilled, codes and scales alike."""
    j = jax_engine(tree, host_kv_tier_bytes=HOST, kv_cache_dtype=kv, **TIER_POOL)
    on = port_engine(tree, host_kv_tier_bytes=HOST, kv_cache_dtype=kv, **TIER_POOL)
    off = port_engine(tree, kv_cache_dtype=kv, **TIER_POOL)
    planes = _planes(on)
    want = run_both(j, on, [PROMPT_A])
    cached = {b: [p[:, b].clone() for p in planes] for b in _blocks_of(on, PROMPT_A)}
    digests = tkv.block_digests(PROMPT_A, 4)
    before = dict(zip(digests, cached.values()))
    run_both(j, on, [PROMPT_B])
    assert on.tier_summary()['spilled_blocks'] > 0
    for digest, arrays in before.items():  # what reached the tier is bitwise the pool's
        held = on.kv_tier.get(digest)
        if held is not None:
            assert all(torch.equal(h, a) for h, a in zip(held, arrays))
    assert run_both(j, on, [PROMPT_A]) == want
    assert off.generate_ids([PROMPT_A, PROMPT_B], SamplingParams(**GREEDY))[0] == want[0]
    summary = on.tier_summary()
    assert summary['promotions'] >= 1 and summary['promoted_blocks'] >= 1
    assert summary['payload_mismatches'] == 0 and summary['promotion_failures'] == 0
    assert _planes(on)[0] is planes[0]  # written in place
    for digest, block in zip(digests, _blocks_of(on, PROMPT_A)):
        assert all(torch.equal(p[:, block], a) for p, a in zip(planes, before[digest]))


def test_refcount_invariants_under_cascaded_eviction(tree):  # noqa: F811
    j = jax_engine(tree, host_kv_tier_bytes=3 * 2 * 2 * 4 * 4 * 16 * 4, **TIER_POOL)
    p = port_engine(tree, host_kv_tier_bytes=3 * 2 * 2 * 4 * 4 * 16 * 4, **TIER_POOL)
    rng = np.random.default_rng(3)
    for _ in range(8):
        run_both(j, p, [[int(t) for t in rng.integers(1, 64, size=17)]])
    assert p.sched.num_free_blocks + p.prefix_cache.num_cached == TIER_POOL['num_blocks'] - 1
    assert p.kv_tier.bytes_used <= p.kv_tier.max_bytes
    assert p.tier_summary()['spilled_blocks'] > 0


@pytest.mark.parametrize('kv', ['auto', 'int8'])
def test_disk_warm_restart(tree, tmp_path, kv):  # noqa: F811
    cfg = dict(host_kv_tier_bytes=HOST, disk_kv_tier_dir=str(tmp_path), kv_cache_dtype=kv,
               **TIER_POOL)
    first = port_engine(tree, **cfg)
    want = first.generate_ids([PROMPT_A], SamplingParams(**GREEDY))
    first.generate_ids([PROMPT_B], SamplingParams(**GREEDY))  # A's blocks -> disk
    assert first.kv_tier.disk.num_blocks > 0
    first.shutdown()
    fresh = port_engine(tree, **cfg)
    assert fresh.generate_ids([PROMPT_A], SamplingParams(**GREEDY)) == want
    assert fresh.stats['tier_promotions'] >= 1 and fresh.stats['prefix_hit_tokens'] > 0
    assert fresh.kv_tier.disk.reads >= 1


@pytest.mark.parametrize('kv', ['auto', 'int8'])
def test_jax_written_disk_tier_warm_restarts_the_port(tree, tmp_path, kv):  # noqa: F811
    cfg = dict(host_kv_tier_bytes=HOST, disk_kv_tier_dir=str(tmp_path), kv_cache_dtype=kv,
               **TIER_POOL)
    j = jax_engine(tree, **cfg)
    want = j.generate_ids([PROMPT_A], JaxSamplingParams(**GREEDY))
    j.generate_ids([PROMPT_B], JaxSamplingParams(**GREEDY))
    assert j.kv_tier.disk.num_blocks > 0
    j.shutdown()
    port = port_engine(tree, **cfg)
    assert port.generate_ids([PROMPT_A], SamplingParams(**GREEDY)) == want
    assert port.stats['tier_promotions'] >= 1 and port.kv_tier.disk.reads >= 1
    assert port.stats['tier_payload_mismatches'] == 0


def test_fp32_engine_over_int8_spills_cold_prefills(tree, tmp_path):  # noqa: F811
    q = port_engine(tree, host_kv_tier_bytes=1, disk_kv_tier_dir=str(tmp_path),
                    kv_cache_dtype='int8', **TIER_POOL)
    q.generate_ids([PROMPT_A], SamplingParams(**GREEDY))
    q.generate_ids([PROMPT_B], SamplingParams(**GREEDY))
    assert q.kv_tier.disk.num_blocks > 0
    j = jax_engine(tree, **TIER_POOL)
    fp = port_engine(tree, host_kv_tier_bytes=HOST, disk_kv_tier_dir=str(tmp_path),
                     **TIER_POOL)
    run_both(j, fp, [PROMPT_A])
    assert fp.stats['tier_payload_mismatches'] >= 1
    assert not fp.stats['tier_promoted_blocks']


def test_corrupt_disk_tier_falls_through_to_cold_prefill(tree, tmp_path):  # noqa: F811
    tier_dir = tmp_path / 'tier'
    engine = port_engine(tree, host_kv_tier_bytes=1, disk_kv_tier_dir=str(tier_dir),
                         **TIER_POOL)
    first = engine.generate_ids([PROMPT_A], SamplingParams(**GREEDY))
    engine.generate_ids([PROMPT_B], SamplingParams(**GREEDY))
    files = list(tier_dir.glob('*.kvblock'))
    assert files
    for path in files:
        path.write_bytes(b'corrupt')
    assert engine.generate_ids([PROMPT_A], SamplingParams(**GREEDY)) == first
    assert engine.kv_tier.disk.errors > 0
    assert not engine.stats['tier_promotions']


def test_promotion_under_warmup_and_preemption_pressure(tree):  # noqa: F811
    cfg = dict(host_kv_tier_bytes=HOST, num_blocks=14, max_num_seqs=3, max_model_len=48,
               decode_steps=4, enable_prefix_cache=True)
    j, p = jax_engine(tree, **cfg), port_engine(tree, **cfg)
    p.warmup()
    assert p.sched.num_running == 0
    stem = list(range(1, 13))
    prompts = [stem + [20 + i] for i in range(3)] + [PROMPT_B[:9]]
    for _ in range(2):  # the second pass re-arrives after eviction and spill
        run_both(j, p, prompts)
    assert p.sched.num_free_blocks + p.prefix_cache.num_cached == 13
    assert not p._promotions


def serve_with_arrival(engine, first, arrival, sampling):
    """Serve ``first``, whose admission promotes its prefix from the tier;
    the moment that promotion has queued its copy, ``arrival`` is added,
    so it borrows the promoted blocks. Returns both outputs as
    ``generate_ids`` gives them, and the blocks each borrowed then."""
    added, borrowed = [], []
    promote = engine._promote

    def promote_then_add(request):
        promote(request)
        if not added:
            added.append(engine.add_request(arrival, sampling))
            borrowed.extend((request.num_borrowed_blocks,
                             engine._requests[added[0]].num_borrowed_blocks))

    engine._promote = promote_then_add
    out = engine.generate_ids([first], sampling)[0]
    late = engine._finished.pop(added[0])
    tail = late.output_ids
    if tail and tail[-1] in engine._stop_ids(late):
        tail = tail[:-1]
    return [out, tail], borrowed


def test_a_request_arriving_during_a_promotion_borrows_its_blocks(tree):  # noqa: F811
    on = port_engine(tree, host_kv_tier_bytes=HOST, **TIER_POOL)
    off = port_engine(tree, **{**TIER_POOL, 'enable_prefix_cache': False})
    sampling = SamplingParams(**GREEDY)
    on.generate_ids([PROMPT_A], sampling)
    on.generate_ids([PROMPT_B], sampling)  # evicts and spills PROMPT_A's blocks
    first, arrival = PROMPT_A + [40, 41], PROMPT_A + [50, 51, 52]
    got, (first_borrowed, arrival_borrowed) = serve_with_arrival(on, first, arrival, sampling)
    assert on.stats['tier_promotions'] >= 1 and on.stats['tier_promoted_blocks'] >= 1
    assert arrival_borrowed == first_borrowed > 0
    assert got == off.generate_ids([first, arrival], sampling)
