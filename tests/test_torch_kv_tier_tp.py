"""The host and disk KV tiers under tensor parallelism against the JAX
engine (the port's tiers are rank 0's and hold whole blocks, every KV
head, as the JAX engine's do on its model-sharded pool).

The tiny fp32 model and the 11-usable-block pool of
``test_torch_kv_tier.py`` (24-token prompts: every admission after the
first evicts): prompt A, then B (A's blocks spill), then A again (they
promote). At ``tensor_parallel_size`` 2 (rank 0 here, rank 1 spawned,
gloo on the CPU, a 60 s collective timeout and a bounded join):

- from the same directory the JAX engine wrote (A's blocks on disk),
  greedy tokens equal the JAX engine's on its ``model=2`` virtual mesh
  with the same host and disk tiers (and the one-device JAX engine's),
  A promoted from the JAX-written disk with 0 payload mismatches, spills
  and promotions above 0 in both; the tiers hold the same blocks and
  bytes; the payloads have JAX's full-head shape and its values; every
  rank ran the spill and promotion programs and sampled the same tokens;
- a directory the tp2 engine wrote promotes into a one-rank port engine
  with 0 payload mismatches and the JAX tokens, and an int8 pool's
  directory written at one rank into a fresh tp2 engine (scale rows
  sliced by KV head) with the one-rank engine's tokens.
"""

import shutil

import jax
import numpy as np
import pytest

from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from distllm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distllm_tpu.parallel.sharding import shard_pytree as jax_shard_pytree
from distllm_tpu_torch.generate.engine import EngineConfig, SamplingParams
from distllm_tpu_torch.generate.engine import kv_cache as tkv
from distllm_tpu_torch.generate.engine.sharded import ShardedEngine, WeightSource
from distllm_tpu_torch.models import mistral
from test_torch_kv_tier import GREEDY, HOST, PROMPT_A, PROMPT_B, TIER_POOL
from test_torch_prefix_cache import TINY, _Tok, jax_engine, port_engine, tree  # noqa: F401

TIMEOUT_S = 60
SEQUENCE = ([PROMPT_A], [PROMPT_B], [PROMPT_A])


def _tier_cfg(tmp, kv='auto'):
    return dict(host_kv_tier_bytes=HOST, disk_kv_tier_dir=str(tmp), kv_cache_dtype=kv,
                **TIER_POOL)


def _jax_mesh_engine(tree, **cfg):  # noqa: F811
    """The JAX engine with its weights on a ``model=2`` virtual mesh."""
    from distllm_tpu.generate.engine.engine import EngineConfig as JaxEngineConfig
    from distllm_tpu.generate.engine.engine import LLMEngine as JaxLLMEngine

    jcfg = jax_mistral.MistralConfig(**TINY)
    mesh = jax_make_mesh(JaxMeshSpec(data=1, model=2), devices=jax.devices()[:2])
    params = jax_shard_pytree(tree, jax_mistral.param_specs(jcfg, tree), mesh)
    return JaxLLMEngine(
        jcfg, params, _Tok(),
        JaxEngineConfig(block_size=4, attn_backend='xla', prefer_native_allocator=False, **cfg),
        mesh=mesh,
    )


def _tp2(tree, **cfg):  # noqa: F811
    tcfg = mistral.MistralConfig(**TINY)
    return ShardedEngine(
        2, tcfg, WeightSource('tree', tree=mistral.params_from_jax(tree, tcfg, device='cpu')),
        EngineConfig(block_size=4, **cfg), backend='gloo', devices='cpu', tokenizer=_Tok(),
        timeout_s=TIMEOUT_S,
    )


def _serve(engine, prompts, jax_side=False):
    params = (JaxSamplingParams if jax_side else SamplingParams)(**GREEDY)
    return engine.generate_ids(prompts, params)


def _check_ranks(reports):
    """Every rank ran the same programs, sampled the same tokens and took
    part in every spill and promotion."""
    assert len({(r['programs'], r['results'], r['digest']) for r in reports}) == 1, reports
    tiers = [r['tier'] for r in reports]
    assert len({(t['spills'], t['promotions']) for t in tiers}) == 1, tiers
    assert tiers[0]['spills'] > 0 and tiers[0]['promotions'] > 0
    # Rank 0 alone holds the tier; each rank moved its own heads' half.
    assert tiers[0]['host_blocks'] > 0 and 'host_blocks' not in tiers[1]
    assert tiers[0]['spilled_bytes'] == tiers[1]['spilled_bytes'] > 0


@pytest.fixture(scope='module')
def jax_written(tree, tmp_path_factory):  # noqa: F811
    """A disk tier directory the JAX engine wrote (prompts A then B: A's
    blocks on disk), and the JAX engine's tokens for the whole sequence."""
    disk = tmp_path_factory.mktemp('jax_tier')
    j = jax_engine(tree, **_tier_cfg(disk))
    want = [_serve(j, prompts, jax_side=True) for prompts in SEQUENCE]
    assert j.kv_tier.disk.num_blocks > 0
    j.shutdown()
    return disk, want


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


@pytest.fixture(scope='module')
def tp2_tiers(tree, jax_written, tmp_path_factory):  # noqa: F811
    """One tp2 engine with host and disk tiers on a copy of the JAX-written
    directory; its reports after the last case."""
    disk = _copy(jax_written[0], tmp_path_factory.mktemp('tp2') / 'tier')
    sharded = _tp2(tree, **_tier_cfg(disk))
    sharded.disk = disk
    yield sharded
    if not sharded.reports:
        sharded.close()


def test_tp2_tiers_match_the_jax_engine_on_its_mesh(tree, jax_written, tp2_tiers,  # noqa: F811
                                                    tmp_path):
    """From the same JAX-written directory, the tp2 engine and the JAX
    engine on its 2-device mesh serve A (promoted from disk), B (A's
    blocks spill) and A again (promoted from the host tier) alike: the
    same tokens, the JAX one-device engine's too, and the same tier."""
    j = _jax_mesh_engine(tree, **_tier_cfg(_copy(jax_written[0], tmp_path / 'jax')))
    engine = tp2_tiers.engine
    for prompts, want in zip(SEQUENCE, jax_written[1][2:] + jax_written[1][1:]):
        got = _serve(engine, prompts)
        assert got == _serve(j, prompts, jax_side=True) == want
    assert engine.kv_tier.disk.reads >= 1  # the JAX-written blocks
    mine, theirs = engine.tier_summary(), j.tier_summary()
    assert mine['payload_mismatches'] == 0 and mine['promotion_failures'] == 0
    assert j._stats.get('tier_payload_mismatches', 0) == 0
    # The tiers hold the same blocks at the same bytes (whole blocks).
    for key in ('host_blocks', 'host_bytes', 'disk_blocks', 'disk_bytes'):
        assert mine[key] == theirs[key], (key, mine, theirs)
    for summary in (mine, theirs):
        assert summary['spilled_blocks'] > 0 and summary['promoted_blocks'] > 0
    digest = tkv.block_digests(PROMPT_B, 4)[0]  # B's blocks spilled last
    held, want = engine.kv_tier.get(digest), j.kv_tier.get(digest)
    assert held is not None and want is not None
    assert [tuple(a.shape) for a in held] == [(2, 4, 2, 8)] * 2  # every KV head
    for a, w in zip(held, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    assert engine.kv.k.shape[3] == 1  # the pool holds the rank's one head
    j.shutdown()


def test_a_tp2_written_directory_promotes_into_one_rank(tree, jax_written,  # noqa: F811
                                                        tp2_tiers):
    one = port_engine(tree, **_tier_cfg(tp2_tiers.disk))
    assert _serve(one, [PROMPT_B]) == jax_written[1][1]
    assert one.stats['tier_promotions'] >= 1 and one.kv_tier.disk.reads >= 1
    assert one.stats['tier_payload_mismatches'] == 0
    one.shutdown()
    _check_ranks(tp2_tiers.close())


def test_a_one_rank_int8_directory_promotes_into_tp2(tree, tmp_path):  # noqa: F811
    """An int8 pool's spills (codes and scale rows, sliced by KV head on
    the way to each rank and gathered back on the next spill), from a
    directory a one-rank port engine wrote (whose int8 tokens and files
    are the JAX engine's: ``test_torch_kv_tier.py``)."""
    cfg = _tier_cfg(tmp_path, 'int8')
    one = port_engine(tree, **cfg)
    want = [_serve(one, prompts) for prompts in SEQUENCE[:2]]
    assert one.kv_tier.disk.num_blocks > 0
    one.shutdown()
    sharded = _tp2(tree, **cfg)
    engine = sharded.engine
    got = [_serve(engine, [PROMPT_A])]
    assert engine.stats['tier_promotions'] >= 1 and engine.kv_tier.disk.reads >= 1
    # B evicts A's blocks (a spill of both ranks' heads), then A promotes
    # them from the host tier.
    got += [_serve(engine, prompts) for prompts in SEQUENCE[1:]]
    assert got == [want[0], want[1], want[0]]
    assert engine.stats['tier_payload_mismatches'] == 0
    assert engine.stats['tier_promotions'] >= 2
    _check_ranks(sharded.close())
