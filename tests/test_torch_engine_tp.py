"""Tensor and expert parallelism of the port against the JAX package.

The twins of ``tests/test_engine_tp.py``: the same tiny fp32 models and
prompts served greedily by the JAX engine on one device (and, for Mistral
and Gemma-2, on the 2-device virtual mesh; the JAX suite holds its mesh
tokens to its one-device tokens for the others), and by the port's engine at
``tensor_parallel_size`` 2 — rank 0 in this process, rank 1 spawned, gloo
on the CPU (``generate.engine.sharded.ShardedEngine``). Tokens must be
identical (fp32 greedy: exact), and every rank must hold the same tokens
(equal digests of everything it sampled, ``LLMEngine.tp_report``).

- Mistral tp2, and under continuous-batching churn on the same ranks;
  tp4 refused on ``num_kv_heads``; Qwen2 biases; Gemma-2 (sandwich norms,
  softcaps, alternating windows, tied embeddings); int8 and nf4 weights
  (quantized whole, then sharded: int8 row-parallel codes with whole
  scales, nf4 replicated and sliced at use).
- The prefix cache (with copy-on-write), chunked prefill, mixed windows,
  the int8 KV pool and ``pipeline_depth`` 2 together, and speculation,
  at tp2 against the JAX engine in the same modes on the same weights.

Mixtral and the generator at tp2 are in ``test_torch_mixtral_tp.py``.

Collectives carry a 60 s timeout and the ranks are joined within a limit,
so a hang fails in seconds.
"""

import jax
import numpy as np
import pytest
import torch

from distllm_tpu.generate.engine.engine import EngineConfig as JaxEngineConfig
from distllm_tpu.generate.engine.engine import LLMEngine as JaxLLMEngine
from distllm_tpu.generate.engine.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.models import gemma as jax_gemma
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu.models import mixtral as jax_mixtral
from distllm_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from distllm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distllm_tpu.parallel.sharding import shard_pytree as jax_shard_pytree
from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
from distllm_tpu_torch.generate.engine.sharded import ShardedEngine, WeightSource
from distllm_tpu_torch.models import gemma, mistral
from distllm_tpu_torch.ops import quantization as tq
from distllm_tpu_torch.parallel import mesh

TIMEOUT_S = 60
ENGINE = dict(block_size=4, num_blocks=64, max_num_seqs=4, max_model_len=128,
              prefill_min_bucket=8)
MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             intermediate_size=128, dtype='float32')
GEMMA2 = dict(
    name='gemma2', vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=128, max_position_embeddings=128,
    dtype='float32', activation='gelu_new', embedding_multiplier=64 ** 0.5,
    norm_plus_one=True, post_norms=True, query_scale=16 ** -0.5,
    attn_logit_softcap=50.0, final_logit_softcap=30.0, sliding_window=6,
    sliding_window_pattern='alternating', tie_word_embeddings=True, rms_norm_eps=1e-6,
)


class _Tok:
    eos_id = None


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, size=n)] for n in lens]


def _jax_tokens(jcfg, jtree, prompts, max_tokens, mesh_size=1, **knobs):
    """The JAX engine's greedy tokens, on one device or on the
    ``model=mesh_size`` virtual mesh."""
    mesh = None
    params = jtree
    if mesh_size > 1:
        mesh = jax_make_mesh(JaxMeshSpec(data=1, model=mesh_size),
                             devices=jax.devices()[:mesh_size])
        family = jax_mixtral if 'router' in jtree['layers'] else jax_mistral
        params = jax_shard_pytree(jtree, family.param_specs(jcfg, jtree), mesh)
    engine = JaxLLMEngine(
        jcfg, params, _Tok(),
        JaxEngineConfig(attn_backend='xla', prefer_native_allocator=False, **ENGINE, **knobs),
        mesh=mesh,
    )
    out = engine.generate_ids(prompts, JaxSamplingParams(temperature=0.0, max_tokens=max_tokens))
    engine.shutdown()
    return out


def _sharded(tcfg, tree, world=2, **knobs):
    return ShardedEngine(
        world, tcfg, WeightSource('tree', tree=tree), EngineConfig(**ENGINE, **knobs),
        backend='gloo', devices=['cpu'] * world, tokenizer=_Tok(), timeout_s=TIMEOUT_S,
    )


def _greedy(engine, prompts, max_tokens):
    return engine.generate_ids(prompts, SamplingParams(temperature=0.0, max_tokens=max_tokens))


def _rank_mesh(model: int) -> mesh.Mesh:
    """Rank 0's view of a ``model``-wide mesh without process groups (what
    the engine checks before any collective)."""
    shape = mesh.MeshSpec(data=1, model=model).resolve(model)
    return mesh.Mesh(shape=shape, rank=0, coords=dict.fromkeys(shape, 0), groups=None,
                     backend='gloo', device=torch.device('cpu'), num_devices=1)


def _assert_same_tokens_on_every_rank(reports, world=2):
    assert len(reports) == world
    assert reports[0]['results'] > 0
    assert len({(r['programs'], r['results'], r['digest']) for r in reports}) == 1, reports


@pytest.fixture(scope='module')
def mistral_model():
    jcfg = jax_mistral.MistralConfig(**MODEL)
    jtree = jax_mistral.init(jax.random.PRNGKey(0), jcfg)
    tcfg = mistral.MistralConfig(**MODEL)
    tree = mistral.params_from_jax(jax.tree.map(np.asarray, jtree), tcfg, device='cpu')
    return jcfg, jtree, tcfg, tree


@pytest.fixture(scope='module')
def mistral_tp2(mistral_model):
    """One tp2 engine on the Mistral model, shared by the cases on it; its
    ranks' reports after the last."""
    _, _, tcfg, tree = mistral_model
    sharded = _sharded(tcfg, tree)
    yield sharded
    if not sharded.reports:
        sharded.close()


def test_tp2_matches_jax_on_one_device_and_on_the_mesh(mistral_model, mistral_tp2):
    jcfg, jtree, _, _ = mistral_model
    prompts = _prompts(0, (5, 17, 9, 26))
    single = _jax_tokens(jcfg, jtree, prompts, 12)
    assert _jax_tokens(jcfg, jtree, prompts, 12, mesh_size=2) == single
    got = _greedy(mistral_tp2.engine, prompts, 12)
    assert all(len(o) == 12 for o in got)
    assert got == single
    engine = mistral_tp2.engine
    # Each rank holds half the KV heads of the pool and half of each
    # column-parallel kernel; the vocab-split head is gathered.
    assert engine.kv.k.shape[3] == MODEL['num_kv_heads'] // 2
    assert engine.params['layers']['q']['kernel'].shape[-1] == 64 // 2
    assert engine.params['lm_head'].shape == (64, 256 // 2)
    assert engine.model_cfg.tp.model_size == 2 and engine.mesh.num_devices == 1


def test_tp2_with_continuous_batching_churn(mistral_model, mistral_tp2):
    jcfg, jtree, _, _ = mistral_model
    prompts = _prompts(1, (3, 30, 7, 21, 12, 5))
    want = _jax_tokens(jcfg, jtree, prompts, 8)
    got = _greedy(mistral_tp2.engine, prompts, 8)
    assert got == want
    assert mistral_tp2.engine.sched.num_free_blocks == ENGINE['num_blocks'] - 1


def test_every_rank_holds_the_same_tokens(mistral_tp2):
    _greedy(mistral_tp2.engine, _prompts(2, (6, 11)), 5)
    reports = mistral_tp2.close()
    _assert_same_tokens_on_every_rank(reports)
    assert reports[0]['rank'] == 0 and reports[1]['rank'] == 1


def test_tp4_rejected_on_num_kv_heads(mistral_model):
    """num_kv_heads=2 < tp=4 is refused, not silently wrong: before any
    rank starts, and by the engine itself on a rank's mesh."""
    _, _, tcfg, tree = mistral_model
    with pytest.raises(ValueError, match='num_kv_heads'):
        _sharded(tcfg, tree, world=4)
    with pytest.raises(ValueError, match='num_kv_heads'):
        LLMEngine(tcfg, tree, _Tok(), EngineConfig(**ENGINE), device='cpu',
                  mesh=_rank_mesh(4))


def test_tp2_qwen2_biases_match_jax():
    cfg = dict(MODEL, attention_bias=True)
    jcfg = jax_mistral.MistralConfig(**cfg)
    jtree = jax_mistral.init(jax.random.PRNGKey(3), jcfg)
    assert 'bias' in jtree['layers']['q']
    prompts = _prompts(2, (5, 18, 9))
    single = _jax_tokens(jcfg, jtree, prompts, 12)
    tcfg = mistral.MistralConfig(**cfg)
    sharded = _sharded(tcfg, mistral.params_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                                                     device='cpu'))
    assert sharded.engine.params['layers']['q']['bias'].shape == (2, 32)
    assert _greedy(sharded.engine, prompts, 12) == single
    _assert_same_tokens_on_every_rank(sharded.close())


def test_tp2_gemma2_matches_jax():
    jcfg = jax_gemma.GemmaConfig(**GEMMA2)
    jtree = jax_gemma.init(jax.random.PRNGKey(5), jcfg)
    assert 'post_attn_ln' in jtree['layers']
    prompts = _prompts(4, (5, 18, 9))
    single = _jax_tokens(jcfg, jtree, prompts, 12)
    assert _jax_tokens(jcfg, jtree, prompts, 12, mesh_size=2) == single
    tcfg = gemma.GemmaConfig(**GEMMA2)
    sharded = _sharded(tcfg, gemma.params_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                                                   device='cpu'))
    assert _greedy(sharded.engine, prompts, 12) == single
    _assert_same_tokens_on_every_rank(sharded.close())


@pytest.mark.parametrize('mode', ['int8', 'nf4'])
def test_tp2_quantized_weights_match_jax(mistral_model, mode):
    """Quantized whole (the port's codes are JAX's bitwise), then sharded:
    int8 column-parallel codes with their scales, row-parallel codes with
    the whole scales; nf4 codes replicated, each rank's slice taken at the
    point of use. The JAX engine quantizes on one device."""
    jcfg, jtree, tcfg, tree = mistral_model
    prompts = _prompts(0, (5, 17, 9, 26))
    want = _jax_tokens(jcfg, jtree, prompts, 10, quantization=mode)
    qtree = tq.quantize_pytree(tree, mode=mode, out_dtype='float32')
    sharded = _sharded(tcfg, qtree, quantization=mode)
    o_kernel = sharded.engine.params['layers']['o']['kernel']
    assert isinstance(o_kernel, tq.QTensor) and o_kernel.shape == (2, 32, 64)
    if mode == 'int8':
        assert torch.equal(o_kernel.scale, qtree['layers']['o']['kernel'].scale)
    else:
        assert o_kernel.view is not None
        assert torch.equal(o_kernel.q, qtree['layers']['o']['kernel'].q)
    assert _greedy(sharded.engine, prompts, 10) == want
    _assert_same_tokens_on_every_rank(sharded.close())
    # Float slices are not quantized on a rank: their row-parallel scales
    # would span only its rows.
    with pytest.raises(ValueError, match='quantize before sharding'):
        LLMEngine(tcfg, tree, _Tok(), EngineConfig(**ENGINE, quantization=mode),
                  device='cpu', mesh=_rank_mesh(2))


def _jax_passes(jcfg, jtree, prompts, budgets, passes, **knobs):
    """The JAX engine's greedy tokens on one device, request i capped at
    ``budgets[i]`` new tokens, for ``passes`` runs of the same prompts on
    one engine (a later run hits the prefix cache the first filled)."""
    engine = JaxLLMEngine(
        jcfg, jtree, _Tok(),
        JaxEngineConfig(attn_backend='xla', prefer_native_allocator=False, **ENGINE, **knobs),
    )
    runs = []
    for _ in range(passes):
        rids = [engine.add_request(p, JaxSamplingParams(temperature=0.0, max_tokens=n))
                for p, n in zip(prompts, budgets)]
        engine._run_to_completion()
        runs.append([engine._finished.pop(r).output_ids for r in rids])
    engine.shutdown()
    return runs


# The serving modes at tp2 against the JAX engine on one device, in the
# same modes on the same prompts.
MODES = {
    'cache_mixed_int8kv_depth2': dict(
        enable_prefix_cache=True, enable_mixed_batching=True, prefill_chunk_tokens=8,
        kv_cache_dtype='int8', pipeline_depth=2),
    'spec': dict(draft_k=3, enable_prefix_cache=True),
}


@pytest.mark.parametrize('mode', sorted(MODES))
def test_serving_modes_at_tp2_match_one_rank(mistral_model, mode):
    jcfg, jtree, tcfg, tree = mistral_model
    knobs = MODES[mode]
    shared = _prompts(5, (12,))[0]
    prompts = [shared + p for p in _prompts(6, (4, 9, 0, 13, 6))]
    prompts[2] = list(shared)  # block-aligned: a full-cover hit copies on write
    # Staggered lengths: slots free while others decode, so later tails
    # ride the windows as chunk rows.
    budgets = (3, 11, 5, 13, 7)
    sampling = [SamplingParams(temperature=0.0, max_tokens=n) for n in budgets]
    want = _jax_passes(jcfg, jtree, prompts, budgets, 2, **knobs)
    sharded = _sharded(tcfg, tree, **knobs)
    for run in want:  # the second pass hits the cache the first filled
        assert sharded.engine.generate_ids(prompts, sampling) == run
    stats = sharded.engine.stats
    assert stats['prefix_hit_tokens'] > 0 and stats['prefix_cow_copies'] > 0
    if mode == 'spec':
        assert stats['spec_windows'] > 0
    else:
        assert stats['mixed_windows'] > 0 and sharded.engine.kv_cache_dtype == 'int8'
    _assert_same_tokens_on_every_rank(sharded.close())
