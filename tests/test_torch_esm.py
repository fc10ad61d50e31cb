"""The port's protein models, ESM-2 and ESM-C, against the JAX package's.

Weights come from the JAX ``init`` at tiny fp32 configs (hidden 64, 4
heads of 16, 2 layers) and cross the weight bridge (``params_from_jax``)
as numpy arrays; inputs are made from a numpy seed. In fp32 the port's
``apply`` equals the JAX one within ``rtol 1e-5, atol 1e-5`` (the same
math in another summation order): ESM-2 with ``<mask>`` tokens (the
token-dropout rescale), padding and a fully masked row, against JAX's
``'pallas'`` (the Pallas kernel in interpret mode) and ``'xla'``; ESM-C at
the 30-layer residual scale on a depth-2 tree. In bf16 the port is held
by the rule of :func:`_bf16_within_jax_error`. Checkpoints written from a
seed (``safetensors`` for ESM-2, an ``esm``-package ``.pth`` through
``torch.save`` for ESM-C) load to the same trees as in JAX, and the
``esm2`` / ``esmc`` encoders embed as JAX's do. ``EsmcSequenceTokenizer``
is bitwise JAX's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.embed import get_encoder as jax_get_encoder
from distllm_tpu.embed import get_pooler as jax_get_pooler
from distllm_tpu.embed.embedders import full_sequence as jax_full_sequence
from distllm_tpu.embed.encoders import esm2 as jax_esm_encoders
from distllm_tpu.models import esm2 as jax_esm2
from distllm_tpu.models import esmc as jax_esmc
from distllm_tpu_torch.embed import get_encoder, get_pooler
from distllm_tpu_torch.embed.embedders.full_sequence import compute_embeddings
from distllm_tpu_torch.embed.encoders import esm2 as esm_encoders
from distllm_tpu_torch.models import esm2, esmc
from distllm_tpu_torch.models.loader import read_checkpoint
from distllm_tpu_torch.ops import encoder_attention as tea

RTOL = ATOL = 1e-5
S = 32  # a multiple of 32, as the Pallas kernel takes
ESM2_TINY = dict(vocab_size=33, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128)
ESMC_TINY = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4)


def _jax_apply(module, params, cfg, ids, mask, attn_impl):
    """The JAX ``apply``, with ``'pallas'`` running the kernel in interpret
    mode (as ``tests/test_encoder_attention.py`` does)."""
    import distllm_tpu.ops.encoder_attention as ea

    orig = ea.encoder_attention
    try:
        ea.encoder_attention = lambda *a, **kw: orig(*a, **{**kw, 'interpret': True})
        out = module.apply(params, cfg, jnp.asarray(ids), jnp.asarray(mask),
                           attn_impl=attn_impl)
    finally:
        ea.encoder_attention = orig
    return np.asarray(out.astype(jnp.float32))


def _bf16_within_jax_error(got, jax_bf16, ref32, valid):
    """The bf16 rule: on valid positions, the port's bf16 output is no
    further from the fp32 JAX output than twice the JAX package's own bf16
    output is, plus one bf16 step of the output's scale (``2**-8`` of its
    largest magnitude). Both round at the same points; only their
    summation orders differ, which moves each rounding by at most a step."""
    got, jax_bf16, ref32 = (x[valid] for x in (got, jax_bf16, ref32))
    port_err = float(np.abs(got - ref32).max())
    jax_err = float(np.abs(jax_bf16 - ref32).max())
    assert port_err <= 2 * jax_err + 2.0 ** -8 * float(np.abs(ref32).max()), (
        port_err, jax_err)


def _protein_batch(seed, vocab_lo, vocab_hi, mask_id, pad_id, rows=4):
    """``[rows, S]`` ids and mask: full, partial (with ``<mask>`` tokens),
    short, and one fully masked row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(vocab_lo, vocab_hi, size=(rows, S)).astype(np.int32)
    lengths = [S, 21, 9, 0][:rows]
    mask = np.zeros((rows, S), np.int32)
    for r, n in enumerate(lengths):
        mask[r, :n] = 1
        ids[r, n:] = pad_id
    if mask_id is not None:
        ids[0, [3, 7, 11]] = mask_id
        ids[1, 5] = mask_id
    return ids, mask


# ---------------------------------------------------------------- ESM-2
@pytest.fixture(scope='module')
def esm2_models():
    jcfg = jax_esm2.Esm2Config(**ESM2_TINY, dtype='float32')
    tree = jax.tree.map(np.asarray, jax_esm2.init(jax.random.PRNGKey(0), jcfg))
    tcfg = esm2.Esm2Config(**ESM2_TINY, dtype='float32')
    return jcfg, tree, tcfg, esm2.params_from_jax(tree, tcfg, device='cpu')


@pytest.mark.parametrize('port_impl,jax_impl', [
    ('auto', 'pallas'), ('auto', 'xla'), ('xla', 'xla'), ('reference', 'pallas'),
])
def test_esm2_apply_matches_jax(esm2_models, port_impl, jax_impl):
    jcfg, tree, tcfg, params = esm2_models
    ids, mask = _protein_batch(0, 4, 29, jcfg.mask_token_id, jcfg.pad_token_id)
    want = _jax_apply(jax_esm2, tree, jcfg, ids, mask, jax_impl)
    plain = tea.encoder_attention_reference.launches
    got = esm2.apply(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
                     attn_impl=port_impl)
    assert got.dtype == torch.float32 and got.shape == (4, S, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if port_impl != 'xla':  # one plain K3 call a layer on the CPU
        assert tea.encoder_attention_reference.launches - plain == 2


def test_esm2_token_dropout_rescales_as_jax(esm2_models):
    """The embedding stage alone against the JAX ``apply``'s first lines
    (``esm2.py:116-129``) written out in numpy: ``<mask>`` rows zeroed,
    the observed-mask rescale and the padding zeroed, in fp32."""
    jcfg, tree, tcfg, params = esm2_models
    ids, mask = _protein_batch(1, 4, 29, jcfg.mask_token_id, jcfg.pad_token_id)
    got = esm2.embed_tokens(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    emb = tree['embed'][ids]
    is_mask = ids == jcfg.mask_token_id
    emb = np.where(is_mask[..., None], 0.0, emb)
    observed = (is_mask & (mask != 0)).sum(1) / np.maximum(mask.sum(1), 1)
    want = emb * ((1 - 0.12) / (1 - observed))[:, None, None] * mask[..., None]
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert (got[0, [3, 7, 11]] == 0).all() and (got[3] == 0).all()


def test_esm2_bf16_within_the_jax_bf16_error(esm2_models):
    jcfg, tree, tcfg, _ = esm2_models
    ids, mask = _protein_batch(2, 4, 29, jcfg.mask_token_id, jcfg.pad_token_id)
    ref32 = _jax_apply(jax_esm2, tree, jcfg, ids, mask, 'xla')
    jcfg16 = jcfg.model_copy(update={'dtype': 'bfloat16'})
    jax_bf16 = _jax_apply(jax_esm2, tree, jcfg16, ids, mask, 'xla')
    tcfg16 = dataclasses.replace(tcfg, dtype='bfloat16')
    params16 = esm2.params_from_jax(tree, tcfg16, device='cpu')
    got = esm2.apply(params16, tcfg16, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32  # the final norm is fp32, as in JAX
    _bf16_within_jax_error(got.numpy(), jax_bf16, ref32, mask != 0)


ESM2_HF_CONFIG = {
    'model_type': 'esm', 'vocab_size': 33, 'hidden_size': 64,
    'num_hidden_layers': 2, 'num_attention_heads': 4, 'intermediate_size': 128,
    'position_embedding_type': 'rotary', 'token_dropout': True,
    'mask_token_id': 32, 'pad_token_id': 1, 'layer_norm_eps': 1e-5,
}


def _esm2_hf_checkpoint(root):
    """A tiny HF ``EsmForMaskedLM`` checkpoint written from a seed as
    safetensors (HF's key names with the ``esm.`` prefix, the contact and
    LM heads included), with ``config.json`` and an ``EsmTokenizer``."""
    from safetensors.torch import save_file
    from transformers import EsmTokenizer

    vocab = ['<cls>', '<pad>', '<eos>', '<unk>', *'LAGVSERTIDPKQNFYMHWCXBUZO',
             '.', '-', '<null_1>', '<mask>']
    (root / 'vocab.txt').write_text('\n'.join(vocab) + '\n')
    EsmTokenizer(vocab_file=str(root / 'vocab.txt')).save_pretrained(root)
    (root / 'config.json').write_text(json.dumps(ESM2_HF_CONFIG))
    rng = np.random.default_rng(10)
    h, i = 64, 128

    def normal(*shape, base=0.0):
        return torch.from_numpy((base + 0.1 * rng.standard_normal(shape)).astype(np.float32))

    state = {'esm.embeddings.word_embeddings.weight': normal(33, h)}
    for li in range(2):
        p = f'esm.encoder.layer.{li}'
        for name, (n_in, n_out) in {
            'attention.self.query': (h, h), 'attention.self.key': (h, h),
            'attention.self.value': (h, h), 'attention.output.dense': (h, h),
            'intermediate.dense': (h, i), 'output.dense': (i, h),
        }.items():
            state[f'{p}.{name}.weight'] = normal(n_out, n_in)
            state[f'{p}.{name}.bias'] = normal(n_out)
        for name in ('attention.LayerNorm', 'LayerNorm'):
            state[f'{p}.{name}.weight'] = normal(h, base=1.0)
            state[f'{p}.{name}.bias'] = normal(h)
    state['esm.encoder.emb_layer_norm_after.weight'] = normal(h, base=1.0)
    state['esm.encoder.emb_layer_norm_after.bias'] = normal(h)
    state['esm.contact_head.regression.weight'] = normal(1, 8)
    state['lm_head.dense.weight'] = normal(h, h)
    state['lm_head.bias'] = normal(33)
    save_file(state, str(root / 'model.safetensors'))
    return root


@pytest.fixture(scope='module')
def esm2_checkpoint(tmp_path_factory):
    return _esm2_hf_checkpoint(tmp_path_factory.mktemp('esm2_t2_tiny'))


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f'{prefix}/{k}')]
    return [(prefix, tree)]


def test_esm2_params_from_hf_match_the_jax_mapping(esm2_checkpoint):
    state = read_checkpoint(esm2_checkpoint)
    hf = json.loads((esm2_checkpoint / 'config.json').read_text())
    jcfg = jax_esm2.Esm2Config.from_hf_config(hf)
    tcfg = esm2.Esm2Config.from_hf_config(hf)
    assert dataclasses.asdict(tcfg) == {
        k: v for k, v in jcfg.model_dump().items() if k != 'name'}
    tcfg.dtype = 'float32'
    numpy_state = {k: v.numpy() for k, v in state.items()}
    via_jax = esm2.params_from_jax(
        jax_esm2.params_from_hf(numpy_state, jcfg), tcfg, device='cpu')
    direct = esm2.params_from_hf(state, tcfg, device='cpu')
    assert [n for n, _ in _flat(direct)] == [n for n, _ in _flat(via_jax)]
    for (name, a), (_, b) in zip(_flat(direct), _flat(via_jax)):
        assert torch.equal(a, b), name


def test_esm2_encoder_embeds_as_jax(esm2_checkpoint):
    kwargs = {'name': 'esm2', 'pretrained_model_name_or_path': str(esm2_checkpoint),
              'half_precision': False}
    # One batch of 4 (one padding row): one JAX compile.
    seqs = ['MKTAYIAKQR', 'acdefghik<mask>', 'MQIFVKTLTGKTITLEVEPSDTIENVKAKIQ']
    want = jax_full_sequence.compute_embeddings(
        seqs, jax_get_encoder(kwargs), jax_get_pooler({'name': 'mean'}), 4)
    encoder = get_encoder(kwargs, device='cpu')
    assert isinstance(encoder, esm_encoders.Esm2Encoder)
    got = compute_embeddings(seqs, encoder, get_pooler({'name': 'mean'}), 4, device='cpu')
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- ESM-C
@pytest.fixture(scope='module')
def esmc_models():
    jcfg = jax_esmc.EsmcConfig(**ESMC_TINY, dtype='float32')
    tree = jax.tree.map(np.asarray, jax_esmc.init(jax.random.PRNGKey(1), jcfg))
    tcfg = esmc.EsmcConfig(**ESMC_TINY, dtype='float32')
    return jcfg, tree, tcfg, esmc.params_from_jax(tree, tcfg, device='cpu')


def _scaled_weights(tree, seed):
    """The tree with unit-scale norms and larger kernels drawn from a
    seed, so the QK norms, the residual scale and the SwiGLU gate all
    move the output (``init``'s 0.02 kernels leave it near the embedding)."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        scale = 0.1 if path[-1] in ('scale', 'bias') else 0.3
        base = 1.0 if path[-1] == 'scale' else 0.0
        return (base + scale * rng.standard_normal(node.shape)).astype(np.float32)

    return walk(tree, ())


@pytest.mark.parametrize('num_layers', [2, 30], ids=['depth2', 'scale30'])
@pytest.mark.parametrize('port_impl,jax_impl', [
    ('auto', 'pallas'), ('auto', 'xla'), ('xla', 'xla'),
])
def test_esmc_apply_matches_jax(esmc_models, num_layers, port_impl, jax_impl):
    """``scale30``: the depth-2 tree under a config of 30 layers, so the
    residual branches are multiplied by ``1 / sqrt(30 / 36)``."""
    jcfg, tree, tcfg, _ = esmc_models
    tree = _scaled_weights(tree, 4)
    params = esmc.params_from_jax(tree, tcfg, device='cpu')
    jcfg = jcfg.model_copy(update={'num_layers': num_layers})
    tcfg = dataclasses.replace(tcfg, num_layers=num_layers)
    tok = esmc.EsmcSequenceTokenizer(model_max_length=S)
    ids, mask = _protein_batch(5, 4, 29, None, tok.pad_id)
    want = _jax_apply(jax_esmc, tree, jcfg, ids, mask, jax_impl)
    got = esmc.apply(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
                     attn_impl=port_impl)
    assert got.dtype == torch.float32 and got.shape == (4, S, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_esmc_bf16_within_the_jax_bf16_error(esmc_models):
    jcfg, tree, tcfg, _ = esmc_models
    tree = _scaled_weights(tree, 6)
    ids, mask = _protein_batch(7, 4, 29, None, 1)
    jcfg16 = jcfg.model_copy(update={'dtype': 'bfloat16', 'num_layers': 30})
    jax_bf16 = _jax_apply(jax_esmc, tree, jcfg16, ids, mask, 'xla')
    ref32 = _jax_apply(jax_esmc, tree, jcfg.model_copy(update={'num_layers': 30}),
                       ids, mask, 'xla')
    tcfg16 = dataclasses.replace(tcfg, dtype='bfloat16')
    params16 = esmc.params_from_jax(tree, tcfg16, device='cpu')
    got = esmc.apply(params16, dataclasses.replace(tcfg16, num_layers=30),
                     torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16  # the final norm returns the model dtype
    _bf16_within_jax_error(got.float().numpy(), jax_bf16, ref32, mask != 0)


def test_esmc_config_sizes_match_jax():
    for hidden in (960, 1152):
        port, ref = esmc.EsmcConfig.from_hidden_size(hidden), jax_esmc.EsmcConfig.from_hidden_size(hidden)
        assert (port.num_layers, port.num_heads, port.ffn_hidden) == (
            ref.num_layers, ref.num_heads, ref.ffn_hidden)
        assert port.residue_scale == ref.residue_scale
    with pytest.raises(ValueError, match='hidden size'):
        esmc.EsmcConfig.from_hidden_size(768)


def _esmc_state(cfg, rng):
    """An ``esm``-package ESMC state dict from a seed; block 1's ``ffn.0``
    ships no bias (zeros are substituted)."""
    h, f = cfg.hidden_size, cfg.ffn_hidden

    def normal(*shape, scale=0.05, base=0.0):
        return torch.from_numpy((base + scale * rng.standard_normal(shape)).astype(np.float32))

    state = {'embed.weight': normal(cfg.vocab_size, h, scale=0.1)}
    for i in range(cfg.num_layers):
        p = f'transformer.blocks.{i}'
        state.update({
            f'{p}.attn.layernorm_qkv.0.weight': normal(h, scale=0.1, base=1.0),
            f'{p}.attn.layernorm_qkv.0.bias': normal(h, scale=0.1),
            f'{p}.attn.layernorm_qkv.1.weight': normal(3 * h, h),
            f'{p}.attn.out_proj.weight': normal(h, h),
            f'{p}.attn.q_ln.weight': normal(h, scale=0.1, base=1.0),
            f'{p}.attn.k_ln.weight': normal(h, scale=0.1, base=1.0),
            f'{p}.ffn.0.weight': normal(h, scale=0.1, base=1.0),
            f'{p}.ffn.1.weight': normal(2 * f, h),
            f'{p}.ffn.3.weight': normal(h, f),
        })
        if i == 0:
            state[f'{p}.ffn.0.bias'] = normal(h, scale=0.1)
    state['transformer.norm.weight'] = normal(h, scale=0.1, base=1.0)
    return state


def test_esmc_params_from_esm_match_the_jax_mapping(tmp_path):
    cfg = esmc.EsmcConfig(**ESMC_TINY, dtype='float32')
    torch.save(_esmc_state(cfg, np.random.default_rng(8)), tmp_path / 'tiny.pth')
    state = read_checkpoint(tmp_path)
    jcfg = jax_esmc.EsmcConfig(**ESMC_TINY, dtype='float32')
    via_jax = esmc.params_from_jax(
        jax_esmc.params_from_esm({k: v.numpy() for k, v in state.items()}, jcfg),
        cfg, device='cpu')
    direct = esmc.params_from_esm(state, cfg, device='cpu')
    assert [n for n, _ in _flat(direct)] == [n for n, _ in _flat(via_jax)]
    for (name, a), (_, b) in zip(_flat(direct), _flat(via_jax)):
        assert torch.equal(a, b), name
    assert not direct['layers']['ffn_ln']['bias'][1].any()


def test_esmc_encoder_reads_depth_from_the_pth_and_embeds_as_jax(tmp_path):
    """The encoder at the 300M register's width (960 / 15 heads) with a
    2-block checkpoint: the depth comes from the ``.pth`` keys."""
    cfg = esmc.EsmcConfig.from_hidden_size(960)
    cfg.num_layers = 2
    ckpt = tmp_path / 'esmc-300m-2024-12' / 'data' / 'weights'
    ckpt.mkdir(parents=True)
    torch.save(_esmc_state(cfg, np.random.default_rng(9)), ckpt / 'esmc_300m_2024_12_v0.pth')
    kwargs = {'name': 'esmc', 'half_precision': False,
              'pretrained_model_name_or_path': str(tmp_path / 'esmc-300m-2024-12')}
    seqs = ['MKTAYIAKQR', 'acdef ghik', 'MQIFVKTLTGKTITLEVEPS*', 'M']
    want = jax_full_sequence.compute_embeddings(
        seqs, jax_get_encoder(kwargs), jax_get_pooler({'name': 'mean'}), 2)
    encoder = get_encoder(kwargs, device='cpu')
    assert encoder.model_cfg.num_layers == 2 and encoder.embedding_size == 960
    got = compute_embeddings(seqs, encoder, get_pooler({'name': 'mean'}), 2, device='cpu')
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    hf_dir = tmp_path / 'esmc-600m-2024-12'
    hf_dir.mkdir()
    torch.save({'embeddings.word_embeddings.weight': torch.zeros(2, 2)}, hf_dir / 'x.pth')
    with pytest.raises(ValueError, match='not in esm-package ESMC layout'):
        get_encoder({**kwargs, 'pretrained_model_name_or_path': str(hf_dir)}, device='cpu')


@pytest.mark.parametrize('path,size', [
    ('EvolutionaryScale/esmc-300m-2024-12', None),
    ('/ckpt/esmc-600m-2024-12/', None),
    ('/some/finetune', 960),
    ('/some/finetune', None),
])
def test_esmc_resolved_embedding_size_matches_jax(path, size):
    port = esm_encoders.EsmCambrianEncoderConfig(
        pretrained_model_name_or_path=path, embedding_size=size)
    ref = jax_esm_encoders.EsmCambrianEncoderConfig(
        pretrained_model_name_or_path=path, embedding_size=size)
    try:
        want = ref.resolved_embedding_size()
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            port.resolved_embedding_size()
        assert str(got.value) == str(exc)
    else:
        assert port.resolved_embedding_size() == want


TOKENIZER_TEXTS = [
    'MKTAYIAKQRQISFVKSHFSRQ',
    ' acdefghiklmnpqrstvwy \n',
    'MK*V#J',  # unknown letters
    'M' * 40,  # cut at max_length - 2, eos kept
    '',
    'XBUZO.-|',
]


@pytest.mark.parametrize('max_length', [None, 24])
def test_esmc_tokenizer_ids_and_buckets_equal_jax(max_length):
    port = esmc.EsmcSequenceTokenizer(model_max_length=32)
    ref = jax_esmc.EsmcSequenceTokenizer(model_max_length=32)
    assert port.buckets == ref.buckets and port.vocab == ref.vocab
    assert (port.pad_id, port.cls_id, port.eos_id, port.unk_id) == (
        ref.pad_id, ref.cls_id, ref.eos_id, ref.unk_id)
    for texts in (TOKENIZER_TEXTS, TOKENIZER_TEXTS[:1], TOKENIZER_TEXTS[4:5]):
        got, want = port(texts, max_length=max_length), ref(texts, max_length=max_length)
        np.testing.assert_array_equal(got.input_ids, want.input_ids)
        np.testing.assert_array_equal(got.attention_mask, want.attention_mask)
        assert got.input_ids.dtype == want.input_ids.dtype == np.int32
        for row in got.input_ids:
            assert port.decode(row) == ref.decode(row)
    assert port.decode([0, 5, 99, 2]) == ref.decode([0, 5, 99, 2])


def test_esm2_vocab_is_esmc_vocab_but_id_31(esm2_checkpoint):
    """ESM-2's HF vocabulary and ``ESMC_VOCAB`` agree id for id except 31
    (``<null_1>`` / ``|``), which no amino-acid text produces: the card
    tokenizes ESM-2 input with ``EsmcSequenceTokenizer``."""
    vocab = (esm2_checkpoint / 'vocab.txt').read_text().split()
    differ = [i for i, (a, b) in enumerate(zip(vocab, esmc.ESMC_VOCAB)) if a != b]
    assert len(vocab) == len(esmc.ESMC_VOCAB) and differ == [31]
