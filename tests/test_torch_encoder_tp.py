"""The encoders on a mesh against the JAX package's (``Encoder.shard`` /
``param_specs``; the twin of ``tests/test_models.py``'s sharded BERT).

- The port's ``param_specs`` of BERT, ESM-2 and ModernBERT equal JAX's
  axis for axis (ModernBERT's without the JAX tree's flag vectors, which
  the port's tree does not carry); ESM-C has none in either package, and
  ``TorchEncoder.shard`` refuses it.
- ``TorchEncoder.shard`` over 2 ranks (rank 0 here, rank 1 spawned, gloo
  on the CPU: a 60 s collective timeout, a bounded join, one rank group
  for the module) equals the JAX ``apply`` on its virtual mesh ``data=4,
  model=2`` at ``atol = rtol = 1e-5``, fp32, for the three models, and
  for BERT with int8 weights (JAX replicates the quantized leaves; the
  port shards the codes with their scales), on the valid positions.
  Each rank holds half the heads and widths; the row layers' replicated
  biases are added once.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distllm_tpu.models import bert as jax_bert
from distllm_tpu.models import esm2 as jax_esm2
from distllm_tpu.models import esmc as jax_esmc
from distllm_tpu.models import modernbert as jax_modernbert
from distllm_tpu.ops.quantization import quantize_pytree as jax_quantize_pytree
from distllm_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from distllm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distllm_tpu.parallel.sharding import shard_pytree as jax_shard_pytree
from distllm_tpu_torch.embed.encoders.base import TorchEncoder
from distllm_tpu_torch.models import bert, esm2, esmc, modernbert
from distllm_tpu_torch.parallel import mesh as tmesh
from distllm_tpu_torch.parallel import multihost
from test_torch_rank_tasks import serve_rank, sharded_encoder_forward

TIMEOUT_S = 60
TOL = 1e-5
B, S = 3, 16
FAMILIES = {
    'bert': (jax_bert, bert, dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
                                  intermediate_size=128, max_position_embeddings=32)),
    'esm2': (jax_esm2, esm2, dict(vocab_size=33, hidden_size=64, num_layers=2, num_heads=4,
                                  intermediate_size=128)),
    'modernbert': (jax_modernbert, modernbert,
                   dict(vocab_size=64, hidden_size=64, num_layers=3, num_heads=4,
                        intermediate_size=96, local_attention=8,
                        max_position_embeddings=32)),
}


def _spec_tuples(specs):
    if isinstance(specs, dict):
        return {k: _spec_tuples(v) for k, v in specs.items()}
    return tuple(specs)


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_param_specs_match_jax_axis_for_axis(family):
    jmod, tmod, cfg = FAMILIES[family]
    want = _spec_tuples(jmod.param_specs(jmod.__dict__[_cfg_name(jmod)](**cfg)))
    got = _spec_tuples(tmod.param_specs(tmod.__dict__[_cfg_name(tmod)](**cfg)))
    if family == 'modernbert':  # the JAX tree's flag vectors, replicated
        assert want.pop('attn_norm_flag') == want.pop('global_flag') == (None, None)
    assert got == want


def test_esmc_has_no_param_specs_and_refuses_a_mesh():
    assert not hasattr(jax_esmc, 'param_specs') and not hasattr(esmc, 'param_specs')
    cfg = esmc.EsmcConfig(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
                          dtype='float32')
    encoder = TorchEncoder(None, esmc.apply, cfg, esmc.init(cfg, device='cpu'), None, 64,
                           device='cpu')
    rank = tmesh.single_device_mesh('cpu')
    with pytest.raises(NotImplementedError, match='no param_specs'):
        encoder.shard(rank, {})


def _cfg_name(module):
    return {'bert': 'BertConfig', 'esm2': 'Esm2Config',
            'modernbert': 'ModernBertConfig'}[module.__name__.rsplit('.', 1)[1]]


@pytest.fixture(scope='module')
def ranks():
    """Rank 0's mesh (``data=1, model=2`` over gloo) with rank 1 spawned."""
    group = multihost.RankGroup(2, serve_rank, (2,), backend='gloo', timeout_s=TIMEOUT_S)
    try:
        mesh = tmesh.make_mesh(tmesh.MeshSpec(data=1, model=2), devices=['cpu'] * 2,
                               backend='gloo')
    except BaseException:
        group.close(join_s=10.0)
        raise
    yield group, mesh
    assert group.close(join_s=30.0) == [group.calls]


def _inputs(vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 11:] = 0
    mask[2, 5:] = 0
    return ids, mask


def _jax_sharded(jmod, jcfg, tree, ids, mask):
    mesh = jax_make_mesh(JaxMeshSpec(data=4, model=2))
    sharded = jax_shard_pytree(tree, jmod.param_specs(jcfg), mesh)
    fn = jax.jit(lambda p, i, m: jmod.apply(p, jcfg, i, m))
    return np.asarray(fn(sharded, jnp.asarray(ids), jnp.asarray(mask)).astype(jnp.float32))


def _run_both_ranks(ranks, *args):
    group, mesh = ranks
    group.send(('sharded_encoder_forward', args))
    group.calls = getattr(group, 'calls', 0) + 1
    return sharded_encoder_forward(mesh, *args)


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_sharded_apply_matches_jax_sharded_apply(ranks, family):
    jmod, _, cfg = FAMILIES[family]
    jcfg = getattr(jmod, _cfg_name(jmod))(**cfg, dtype='float32')
    tree = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(3), jcfg))
    # Non-zero biases and norms: a bias added on every rank, or a norm
    # left out, would show.
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: (x + rng.normal(0, 0.1, x.shape).astype(x.dtype))
        if path[-1].key in ('bias', 'scale') else x, tree)
    ids, mask = _inputs(cfg['vocab_size'], 1)
    want = _jax_sharded(jmod, jcfg, tree, ids, mask)
    got, encoder = _run_both_ranks(ranks, family, dict(cfg, dtype='float32'), tree, None,
                                   ids, mask)
    # Valid positions (a padded query row is not compared: ROADMAP C).
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL, rtol=TOL)
    q = encoder.params['layers']['q']['kernel']
    assert q.shape == (cfg['num_layers'], 64, 32)  # half the heads on rank 0
    assert encoder.model_cfg.tp.model_size == 2


def test_sharded_int8_bert_matches_jax(ranks):
    """int8 weights: JAX replicates each quantized leaf, the port shards
    its codes (q / k / v / up with their scales, o / down with the whole
    scales) and sums the row products."""
    jmod, _, cfg = FAMILIES['bert']
    jcfg = jax_bert.BertConfig(**cfg, dtype='float32')
    tree = jax.tree.map(np.asarray, jax_bert.init(jax.random.PRNGKey(4), jcfg))
    ids, mask = _inputs(cfg['vocab_size'], 2)
    jq = jax_quantize_pytree(jax.tree.map(jnp.asarray, tree), mode='int8')
    want = _jax_sharded(jax_bert, jcfg, jq, ids, mask)
    got, encoder = _run_both_ranks(ranks, 'bert', dict(cfg, dtype='float32'), tree, 'int8',
                                   ids, mask)
    kernel = encoder.params['layers']['down']['kernel']
    assert kernel.kind == 'int8' and kernel.q.shape == (2, 64, 64)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=TOL, rtol=TOL)


def test_auto_encoder_param_specs_match_jax(tmp_path, monkeypatch):
    """``AutoEncoder.param_specs`` over a tiny BERT checkpoint (safetensors
    in HF key names; the tokenizer stubbed): the family's specs for the
    loaded tree, which equal JAX's."""
    from safetensors.numpy import save_file

    from distllm_tpu_torch.embed.encoders import auto

    _, _, cfg_kwargs = FAMILIES['bert']
    cfg = bert.BertConfig(**cfg_kwargs, dtype='float32')
    tree = bert.init(cfg, device='cpu')
    names = {'q': 'attention.self.query', 'k': 'attention.self.key',
             'v': 'attention.self.value', 'o': 'attention.output.dense',
             'up': 'intermediate.dense', 'down': 'output.dense',
             'attn_ln': 'attention.output.LayerNorm', 'mlp_ln': 'output.LayerNorm'}
    emb = tree['embeddings']
    state = {'embeddings.word_embeddings.weight': emb['word'],
             'embeddings.position_embeddings.weight': emb['position'],
             'embeddings.token_type_embeddings.weight': emb['token_type'],
             'embeddings.LayerNorm.weight': emb['ln']['scale'],
             'embeddings.LayerNorm.bias': emb['ln']['bias']}
    for li in range(cfg.num_layers):
        for ours, theirs in names.items():
            leaf = tree['layers'][ours]
            weight = leaf['scale' if 'ln' in ours else 'kernel'][li]
            state[f'encoder.layer.{li}.{theirs}.weight'] = weight if 'ln' in ours else weight.T
            state[f'encoder.layer.{li}.{theirs}.bias'] = leaf['bias'][li]
    save_file({k: np.ascontiguousarray(v.numpy()) for k, v in state.items()},
              str(tmp_path / 'model.safetensors'))
    (tmp_path / 'config.json').write_text(json.dumps({
        'model_type': 'bert', 'vocab_size': cfg.vocab_size, 'hidden_size': cfg.hidden_size,
        'num_hidden_layers': cfg.num_layers, 'num_attention_heads': cfg.num_heads,
        'intermediate_size': cfg.intermediate_size,
        'max_position_embeddings': cfg.max_position_embeddings}))
    monkeypatch.setattr(auto, 'HFTokenizer', lambda *args, **kwargs: None)
    encoder = auto.AutoEncoder(auto.AutoEncoderConfig(
        pretrained_model_name_or_path=str(tmp_path), half_precision=False), device='cpu')
    want = _spec_tuples(jax_bert.param_specs(jax_bert.BertConfig(**cfg_kwargs)))
    assert _spec_tuples(encoder.param_specs()) == want
