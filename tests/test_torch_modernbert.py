"""The port's ModernBERT encoder against the JAX package's.

Weights come from the JAX ``init`` at a tiny fp32 config (hidden 64, 4
heads of 16, intermediate 96, 4 layers: 0 and 3 global, 1 and 2 local)
with a window of 16 at S = 32, so every local layer's window cuts, and
cross the weight bridge as numpy arrays (norm scales and biases redrawn
from a seed so they matter). In fp32 the port's ``apply`` equals the JAX
one within ``rtol 1e-5, atol 1e-5``: against JAX's ``'pallas'`` (the
Pallas kernel in interpret mode, the window as an ``[S, S]`` bias) and
``'xla'`` (the window as a boolean mask), with a padded row and a fully
masked one. bf16 is held by ``test_torch_esm``'s rule. A checkpoint
written from a seed (HF key names, safetensors) in the bare and the task
layout, with and without biases, loads to the JAX mapping's tree.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distllm_tpu.models import modernbert as jax_modernbert
from distllm_tpu_torch.models import modernbert
from distllm_tpu_torch.models.loader import read_checkpoint
from distllm_tpu_torch.ops import encoder_attention as tea
from tests.test_torch_esm import _bf16_within_jax_error, _flat, _jax_apply

RTOL = ATOL = 1e-5
S = 32
TINY = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
            intermediate_size=96, local_attention=16, max_position_embeddings=128)


def _redraw_norms(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-1] == 'scale':
            return (1.0 + 0.2 * rng.standard_normal(node.shape)).astype(np.float32)
        if path[-1] == 'bias':
            return (0.2 * rng.standard_normal(node.shape)).astype(np.float32)
        if path[-1] == 'kernel':
            return (0.1 * rng.standard_normal(node.shape)).astype(np.float32)
        return node

    return walk(tree, ())


@pytest.fixture(scope='module')
def models():
    jcfg = jax_modernbert.ModernBertConfig(**TINY, dtype='float32')
    tree = jax.tree.map(np.asarray, jax_modernbert.init(jax.random.PRNGKey(0), jcfg))
    tree = _redraw_norms(tree, 1)
    tcfg = modernbert.ModernBertConfig(**TINY, dtype='float32')
    return jcfg, tree, tcfg, modernbert.params_from_jax(tree, tcfg, device='cpu')


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 256, size=(3, S)).astype(np.int32)
    mask = np.ones((3, S), np.int32)
    mask[1, 23:] = 0
    mask[2] = 0  # a batch-padding row
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize('port_impl,jax_impl', [
    ('auto', 'pallas'), ('auto', 'xla'), ('xla', 'xla'), ('reference', 'pallas'),
])
def test_apply_matches_jax(models, port_impl, jax_impl):
    jcfg, tree, tcfg, params = models
    ids, mask = _batch(0)
    want = _jax_apply(jax_modernbert, tree, jcfg, ids, mask, jax_impl)
    got = modernbert.apply(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
                           attn_impl=port_impl)
    assert got.dtype == torch.float32 and got.shape == (3, S, 64)
    if jax_impl == 'xla':
        # JAX's XLA branch masks with -0.7 * fp32 max, the kernels with a
        # finite -1e9 added to the window's -1e9: a fully masked row's
        # uniform average then spans different keys. Valid rows only.
        got, want = got.numpy()[mask != 0], want[mask != 0]
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=ATOL)


def test_window_bias_on_local_layers_none_on_global(models, monkeypatch):
    """K3 gets the ``[S, S]`` window bias (0 inside ``|i - j| <= 8``,
    -1e9 outside) on layers 1 and 2, and no bias on the global layers 0
    and 3; the bias is one tensor, built once per forward."""
    _, _, tcfg, params = models
    seen = []
    orig = tea.encoder_attention

    def spy(q, k, v, mask, num_heads, scale=None, bias=None):
        seen.append(bias)
        return orig(q, k, v, mask, num_heads, scale, bias)

    monkeypatch.setattr(tea, 'encoder_attention', spy)
    ids, mask = _batch(1)
    modernbert.apply(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert [b is None for b in seen] == [True, False, False, True]
    assert seen[1] is seen[2] and seen[1].dtype == torch.float32
    pos = np.arange(S)
    inside = np.abs(pos[:, None] - pos[None, :]) <= 8
    np.testing.assert_array_equal(seen[1].numpy(), np.where(inside, 0.0, -1e9))


def test_a_window_that_covers_every_key_equals_all_global_layers(models):
    """With the window past 2 S and one RoPE theta, the local layers'
    bias cuts nothing: the forward equals a config whose every layer is
    global, as the JAX package's own test holds."""
    _, tree, tcfg, _ = models
    wide = dataclasses.replace(tcfg, local_attention=4 * S,
                               local_rope_theta=tcfg.global_rope_theta)
    params = modernbert.params_from_jax(tree, wide, device='cpu')
    ids, mask = _batch(2)
    a = modernbert.apply(params, wide, torch.from_numpy(ids), torch.from_numpy(mask))
    every = dataclasses.replace(wide, global_attn_every_n_layers=1)
    b = modernbert.apply(params, every, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_bf16_within_the_jax_bf16_error(models):
    jcfg, tree, tcfg, _ = models
    ids, mask = _batch(3)
    ref32 = _jax_apply(jax_modernbert, tree, jcfg, ids, mask, 'xla')
    jax_bf16 = _jax_apply(jax_modernbert, tree, jcfg.model_copy(update={'dtype': 'bfloat16'}),
                          ids, mask, 'xla')
    tcfg16 = dataclasses.replace(tcfg, dtype='bfloat16')
    params16 = modernbert.params_from_jax(tree, tcfg16, device='cpu')
    got = modernbert.apply(params16, tcfg16, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    _bf16_within_jax_error(got.numpy(), jax_bf16, ref32, mask != 0)


def test_mismatched_flags_or_tree_are_refused(models):
    _, tree, tcfg, _ = models
    other = dataclasses.replace(tcfg, global_attn_every_n_layers=2)
    with pytest.raises(ValueError, match='global_flag'):
        modernbert.params_from_jax(tree, other, device='cpu')
    biased = dataclasses.replace(tcfg, attention_bias=True)
    with pytest.raises(ValueError, match='not a modernbert param tree'):
        modernbert.params_from_jax(tree, biased, device='cpu')


def hf_config(**update):
    """A tiny ModernBERT ``config.json`` (HF's keys)."""
    return {
        'model_type': 'modernbert', 'vocab_size': 256, 'hidden_size': 64,
        'num_hidden_layers': 4, 'num_attention_heads': 4, 'intermediate_size': 96,
        'max_position_embeddings': 128, 'global_attn_every_n_layers': 3,
        'local_attention': 16, 'global_rope_theta': 160000.0,
        'local_rope_theta': 10000.0, 'norm_eps': 1e-5, 'pad_token_id': 0,
        'hidden_activation': 'gelu', **update,
    }


def hf_state(cfg: dict, seed: int, prefix: str = '') -> dict:
    """A ModernBERT state dict with HF's key names drawn from a seed: the
    fused ``Wqkv`` and ``Wi``, no ``attn_norm`` on layer 0, biases where
    the config asks for them."""
    rng = np.random.default_rng(seed)
    h, i = cfg['hidden_size'], cfg['intermediate_size']

    def normal(*shape, base=0.0, scale=0.1):
        return torch.from_numpy((base + scale * rng.standard_normal(shape)).astype(np.float32))

    def norm(key):
        out = {f'{key}.weight': normal(h, base=1.0)}
        if cfg.get('norm_bias'):
            out[f'{key}.bias'] = normal(h)
        return out

    def lin(key, n_in, n_out, biased):
        out = {f'{key}.weight': normal(n_out, n_in)}
        if biased:
            out[f'{key}.bias'] = normal(n_out)
        return out

    state = {'embeddings.tok_embeddings.weight': normal(cfg['vocab_size'], h)}
    state.update(norm('embeddings.norm'))
    for li in range(cfg['num_hidden_layers']):
        p = f'layers.{li}'
        if li:
            state.update(norm(f'{p}.attn_norm'))
        state.update(lin(f'{p}.attn.Wqkv', h, 3 * h, cfg.get('attention_bias')))
        state.update(lin(f'{p}.attn.Wo', h, h, cfg.get('attention_bias')))
        state.update(norm(f'{p}.mlp_norm'))
        state.update(lin(f'{p}.mlp.Wi', h, 2 * i, cfg.get('mlp_bias')))
        state.update(lin(f'{p}.mlp.Wo', i, h, cfg.get('mlp_bias')))
    state.update(norm('final_norm'))
    return {prefix + k: v for k, v in state.items()}


@pytest.mark.parametrize('prefix', ['', 'model.'], ids=['bare', 'task'])
@pytest.mark.parametrize('biases', [False, True], ids=['no_bias', 'biased'])
def test_params_from_hf_match_the_jax_mapping(tmp_path, prefix, biases):
    from safetensors.torch import save_file

    hf = hf_config(norm_bias=biases, attention_bias=biases, mlp_bias=biases)
    save_file(hf_state(hf, 4, prefix), str(tmp_path / 'model.safetensors'))
    state = read_checkpoint(tmp_path)
    jcfg = jax_modernbert.ModernBertConfig.from_hf_config(hf)
    tcfg = modernbert.ModernBertConfig.from_hf_config(hf)
    assert dataclasses.asdict(tcfg) == {
        k: v for k, v in jcfg.model_dump().items() if k != 'name'}
    tcfg.dtype = jcfg.dtype = 'float32'
    jax_tree = jax_modernbert.params_from_hf({k: v.numpy() for k, v in state.items()}, jcfg)
    via_jax = modernbert.params_from_jax(jax_tree, tcfg, device='cpu')
    direct = modernbert.params_from_hf(state, tcfg, device='cpu')
    assert [n for n, _ in _flat(direct)] == [n for n, _ in _flat(via_jax)]
    for (name, a), (_, b) in zip(_flat(direct), _flat(via_jax)):
        assert torch.equal(a, b), name
    # The forward on the loaded weights equals JAX's on its own load.
    ids, mask = _batch(5)
    want = _jax_apply(jax_modernbert, jax_tree, jcfg, ids, mask, 'pallas')
    got = modernbert.apply(direct, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_init_is_seeded_with_the_jax_dtypes():
    cfg = modernbert.ModernBertConfig(**TINY, dtype='bfloat16')
    a = modernbert.init(cfg, torch.Generator().manual_seed(0), device='cpu')
    b = modernbert.init(cfg, torch.Generator().manual_seed(0), device='cpu')
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_flat(a), _flat(b)))
    assert a['layers']['wi_in']['kernel'].dtype == torch.bfloat16
    assert a['embed'].dtype == a['layers']['attn_norm']['scale'].dtype == torch.float32
    assert 'bias' not in a['layers']['q']
    out = modernbert.apply(a, cfg, torch.ones((2, S), dtype=torch.int32),
                           torch.ones((2, S), dtype=torch.int32))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
