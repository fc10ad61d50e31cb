"""The port's BERT encoder against the JAX package's.

Weights come from ``distllm_tpu.models.bert.init(PRNGKey(0), cfg)`` at a
tiny fp32 config (vocab 128, hidden 48, 2 layers, 3 heads, intermediate
96) and cross the weight bridge (``params_from_jax``) as numpy arrays.
``apply`` on the CPU (attention through the plain K3) is held to JAX
``bert.apply`` with ``'pallas'`` (the Pallas kernel in interpret mode,
monkeypatched in as ``tests/test_encoder_attention.py`` does) and with
``'xla'``, at ``atol 1e-4``; the port's ``'xla'`` form to JAX's ``'xla'``
too. Batch rows include a partial mask and a fully masked row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.models import bert as jax_bert
from distllm_tpu_torch.models import bert

ATOL = 1e-4
TINY = dict(
    vocab_size=128, hidden_size=48, num_layers=2, num_heads=3,
    intermediate_size=96, max_position_embeddings=64, dtype='float32',
)


@pytest.fixture(scope='module')
def models():
    jcfg = jax_bert.BertConfig(**TINY)
    tree = jax.tree.map(np.asarray, jax_bert.init(jax.random.PRNGKey(0), jcfg))
    tcfg = bert.BertConfig(**TINY)
    return jcfg, tree, tcfg, bert.params_from_jax(tree, tcfg, device='cpu')


@pytest.fixture(scope='module')
def batch():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, size=(3, 32)).astype(np.int32)
    mask = np.zeros((3, 32), np.int32)
    mask[0, :] = 1
    mask[1, :20] = 1  # row 2 stays fully masked (a batch-padding row)
    return ids, mask


def _jax_apply(jcfg, tree, ids, mask, attn_impl):
    import distllm_tpu.ops.encoder_attention as ea

    orig = ea.encoder_attention
    try:
        ea.encoder_attention = lambda *a, **kw: orig(*a, **{**kw, 'interpret': True})
        out = jax_bert.apply(
            tree, jcfg, jnp.asarray(ids), jnp.asarray(mask), attn_impl=attn_impl
        )
    finally:
        ea.encoder_attention = orig
    return np.asarray(out)


@pytest.mark.parametrize('port_impl,jax_impl', [
    ('auto', 'pallas'), ('auto', 'xla'), ('xla', 'xla'), ('reference', 'pallas'),
])
def test_apply_matches_jax(models, batch, port_impl, jax_impl):
    jcfg, tree, tcfg, params = models
    ids, mask = batch
    want = _jax_apply(jcfg, tree, ids, mask, jax_impl)
    got = bert.apply(
        params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
        attn_impl=port_impl,
    )
    assert got.dtype == torch.float32 and got.shape == (3, 32, 48)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _hf_state(tree, cfg):
    """An HF ``BertModel`` state dict holding the JAX tree's weights (the
    inverse of the JAX ``params_from_hf``)."""
    emb, layers = tree['embeddings'], tree['layers']
    state = {
        'embeddings.word_embeddings.weight': emb['word'],
        'embeddings.position_embeddings.weight': emb['position'],
        'embeddings.token_type_embeddings.weight': emb['token_type'],
        'embeddings.LayerNorm.weight': emb['ln']['scale'],
        'embeddings.LayerNorm.bias': emb['ln']['bias'],
    }
    names = {
        'q': 'attention.self.query', 'k': 'attention.self.key',
        'v': 'attention.self.value', 'o': 'attention.output.dense',
        'up': 'intermediate.dense', 'down': 'output.dense',
    }
    for li in range(cfg.num_layers):
        p = f'bert.encoder.layer.{li}'
        for ours, theirs in names.items():
            state[f'{p}.{theirs}.weight'] = np.ascontiguousarray(layers[ours]['kernel'][li].T)
            state[f'{p}.{theirs}.bias'] = layers[ours]['bias'][li]
        for ours, theirs in (('attn_ln', 'attention.output.LayerNorm'),
                             ('mlp_ln', 'output.LayerNorm')):
            state[f'{p}.{theirs}.weight'] = layers[ours]['scale'][li]
            state[f'{p}.{theirs}.bias'] = layers[ours]['bias'][li]
    return state


def test_params_from_hf_matches_the_jax_mapping(models):
    jcfg, tree, tcfg, params = models
    state = _hf_state(tree, tcfg)
    jax_tree = jax_bert.params_from_hf(state, jcfg)
    via_jax = bert.params_from_jax(jax_tree, tcfg, device='cpu')
    torch_state = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
    direct = bert.params_from_hf(torch_state, tcfg, device='cpu')
    flat = lambda t, pre='': (  # noqa: E731
        [x for k, v in t.items() for x in flat(v, f'{pre}/{k}')]
        if isinstance(t, dict) else [(pre, t)]
    )
    for (name_a, a), (name_b, b) in zip(flat(direct), flat(via_jax)):
        assert name_a == name_b
        assert torch.equal(a, b), name_a
    assert len(flat(direct)) == len(flat(params))


def test_mismatched_tree_is_refused(models):
    _, tree, tcfg, _ = models
    missing = {**tree, 'layers': {k: v for k, v in tree['layers'].items() if k != 'q'}}
    with pytest.raises(ValueError, match='not a bert param tree'):
        bert.params_from_jax(missing, tcfg, device='cpu')
    wider = bert.BertConfig(**{**TINY, 'hidden_size': 96})
    with pytest.raises(ValueError, match='does not match the config'):
        bert.params_from_jax(tree, wider, device='cpu')


def test_init_is_seeded_and_keeps_the_jax_dtypes():
    cfg = bert.BertConfig(**{**TINY, 'dtype': 'bfloat16'})

    def make(seed):
        return bert.init(cfg, torch.Generator().manual_seed(seed), device='cpu')

    a, b, c = make(0), make(0), make(1)
    assert torch.equal(a['layers']['q']['kernel'], b['layers']['q']['kernel'])
    assert torch.equal(a['embeddings']['word'], b['embeddings']['word'])
    assert not torch.equal(a['layers']['q']['kernel'], c['layers']['q']['kernel'])
    assert a['layers']['up']['kernel'].shape == (2, 48, 96)
    assert a['layers']['up']['kernel'].dtype == torch.bfloat16
    assert a['embeddings']['word'].dtype == torch.float32
    assert a['layers']['mlp_ln']['scale'].dtype == torch.float32
    assert torch.equal(a['layers']['mlp_ln']['scale'], torch.ones(2, 48))
    out = bert.apply(
        a, cfg, torch.zeros((2, 16), dtype=torch.int32),
        torch.ones((2, 16), dtype=torch.int32),
    )
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_config_from_hf_and_validation():
    hf = {
        'vocab_size': 30522, 'hidden_size': 768, 'num_hidden_layers': 12,
        'num_attention_heads': 12, 'intermediate_size': 3072,
    }
    assert bert.BertConfig.from_hf_config(hf) == bert.BertConfig()
    with pytest.raises(ValueError, match='multiple of num_heads'):
        bert.BertConfig(hidden_size=50, num_heads=12)
    with pytest.raises(ValueError, match='hidden_act'):
        bert.BertConfig(hidden_act='swish2')
