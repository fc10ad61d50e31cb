"""Mixtral in the port against the JAX package.

The same inputs, made from a numpy seed, go through the JAX function and
its counterpart in ``distllm_tpu_torch``:

- ``moe_mlp`` against JAX's and against the JAX test's per-token expert
  loop (fp32: ``atol 1e-5`` against JAX, ``1e-4`` against the loop, as
  the JAX test holds its own), with planted ties (a zero router picks
  experts 0 and 1; three equal router columns pick the lower two), on
  decode's 2-D rows, and in bf16 (``atol 2e-2``: bf16 rounding of two
  matmul chains); ``_top_k`` equal to ``lax.top_k`` index for index.
- ``init``: ``init(quantization=mode)`` equal bit for bit to
  ``quantize_pytree(init(...))`` on the same generator, the tree the
  JAX ``quantize_pytree(init)`` tree's shape; the bridged JAX tree
  (float and int8) through ``apply`` / ``prefill`` / ``logits`` within
  ``atol 1e-5`` / ``rtol 1e-4`` of JAX.
- ``params_from_hf`` against JAX's, bit for bit, on a tiny
  ``transformers.MixtralForCausalLM`` made from a seed and saved to a
  temporary directory, and the port's hidden states against HF's.
- 4-D int8 / nf4 codes and scales bitwise JAX's, quantized one
  ``[in, out]`` slice at a time.
- The paged engine against the JAX ``LLMEngine`` on the same weights:
  greedy tokens identical in fp32, plain, ``draft_k=4``, mixed windows
  with chunked prefill, int8 weights and an int8 KV pool.
- A chat YAML naming ``mixtral`` and the example generate YAML
  (``examples/generate/mixtral8x7b.tpu.tp8.yaml``) at
  ``tensor_parallel_size: 1`` over a tiny seeded checkpoint build the
  JAX config's Mixtral (the example at 8 is refused by both packages);
  the ``auto``
  encoder on the checkpoint against the JAX auto encoder.
"""

import dataclasses
import json
import os
from pathlib import Path

os.environ.setdefault('USE_TF', '0')  # transformers' model classes without TensorFlow

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig
from distllm_tpu.generate.engine import LLMEngine as JaxLLMEngine
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.models import mixtral as jmix
from distllm_tpu.ops import quantization as jq
from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
from distllm_tpu_torch.models import decoder_family, mistral, mixtral
from distllm_tpu_torch.ops import quantization as tq

ATOL, RTOL = 1e-5, 1e-4
EXAMPLE = Path(__file__).resolve().parents[1] / 'examples' / 'generate' / 'mixtral8x7b.tpu.tp8.yaml'
# The JAX tests' tiny Mixtral.
TINY = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=32, num_experts=4, experts_per_token=2, dtype='float32')
# The engines' Mixtral: every projection >= 4096 weights, so int8 puts
# q / k / v / o on the int8 matmul as well as the banks.
ENGINE_MODEL = dict(TINY, hidden_size=64, intermediate_size=64, sliding_window=6)
# The fields both packages' MixtralConfig carry with the same meaning.
SHARED_FIELDS = (
    'vocab_size', 'hidden_size', 'num_layers', 'num_heads', 'num_kv_heads', 'head_dim',
    'head_size', 'intermediate_size', 'num_experts', 'experts_per_token',
    'max_position_embeddings', 'rope_theta', 'rope_scaling', 'rms_norm_eps',
    'sliding_window', 'tie_word_embeddings', 'dtype',
)


def _bank_inputs(seed, *, b=2, s=6, h=16, i=32, e=4, router='random'):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, s, h)).astype(np.float32)
    w = r.standard_normal((h, e)).astype(np.float32) * 0.1
    if router == 'zero':
        w = np.zeros_like(w)
    elif router == 'tied':  # experts 1..e-1 share a column: ties everywhere
        w[:, 2:] = w[:, 1:2]
    gate = r.standard_normal((e, h, i)).astype(np.float32) * 0.1
    up = r.standard_normal((e, h, i)).astype(np.float32) * 0.1
    down = r.standard_normal((e, i, h)).astype(np.float32) * 0.1
    return x, w, gate, up, down


def _expert_loop(x, router, gate, up, down, k):
    """The JAX test's reference: each token through its top-k experts
    (ties to the lower index: a stable sort)."""
    import scipy.special as sp

    h = x.shape[-1]
    flat = x.reshape(-1, h).astype(np.float64)
    probs = sp.softmax(flat @ router, axis=-1)
    out = np.zeros_like(flat)
    for t, row in enumerate(flat):
        idx = np.argsort(-probs[t], kind='stable')[:k]
        w = probs[t, idx] / probs[t, idx].sum()
        for j, ei in enumerate(idx):
            hid = (row @ gate[ei]) * sp.expit(row @ gate[ei]) * (row @ up[ei])
            out[t] += w[j] * (hid @ down[ei])
    return out.reshape(x.shape)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ----------------------------------------------------------- moe_mlp
@pytest.mark.parametrize('router', ['random', 'zero', 'tied'])
def test_moe_mlp_matches_jax_and_the_expert_loop(router):
    x, w, gate, up, down = _bank_inputs(0, router=router)
    got = mixtral.moe_mlp(*_t(x, w, gate, up, down), 2).numpy()
    want = np.asarray(jmix.moe_mlp(x, w, gate, up, down, 2))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _expert_loop(x, w, gate, up, down, 2), atol=1e-4, rtol=1e-4)


def test_planted_ties_pick_the_lower_experts_as_lax_top_k():
    x, w, gate, up, down = _bank_inputs(1, router='zero')
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, 16)) @ torch.from_numpy(w), dim=-1)
    _, idx = mixtral._top_k(probs, 2)
    assert (idx == torch.tensor([0, 1])).all()  # a zero router: every expert 1/E
    # Only experts 0 and 1 reach the output: banks 2 and 3 zeroed change nothing.
    got = mixtral.moe_mlp(*_t(x, w, gate, up, down), 2)
    gate2, up2, down2 = gate.copy(), up.copy(), down.copy()
    gate2[2:], up2[2:], down2[2:] = 0, 0, 0
    assert torch.equal(got, mixtral.moe_mlp(*_t(x, w, gate2, up2, down2), 2))
    rng = np.random.default_rng(2)
    for _ in range(8):  # values drawn from a few levels: ties in every row
        vals = rng.integers(0, 3, size=(5, 8)).astype(np.float32)
        want_v, want_i = jax.lax.top_k(jnp.asarray(vals), 3)
        got_v, got_i = mixtral._top_k(torch.from_numpy(vals), 3)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_moe_mlp_on_decode_rows_and_in_bf16():
    x, w, gate, up, down = _bank_inputs(3, b=5, s=1)
    rows = x[:, 0]  # decode's [B, H]
    got = mixtral.moe_mlp(*_t(rows, w, gate, up, down), 2)
    assert got.shape == (5, 16)
    want = np.asarray(jmix.moe_mlp(x, w, gate, up, down, 2))[:, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    bf = jnp.bfloat16
    want_bf = np.asarray(jmix.moe_mlp(
        jnp.asarray(x, bf), jnp.asarray(w, bf), jnp.asarray(gate, bf),
        jnp.asarray(up, bf), jnp.asarray(down, bf), 2,
    ).astype(jnp.float32))
    got_bf = mixtral.moe_mlp(*(t.bfloat16() for t in _t(x, w, gate, up, down)), 2)
    assert got_bf.dtype == torch.bfloat16
    np.testing.assert_allclose(got_bf.float().numpy(), want_bf, atol=2e-2)


def test_moe_mlp_dequantizes_int8_and_nf4_banks_as_jax():
    x, w, gate, up, down = _bank_inputs(4, h=64, i=64)
    for mode in ('int8', 'nf4'):
        jquant = jq.quantize_int8 if mode == 'int8' else jq.quantize_nf4
        tquant = tq.quantize_int8 if mode == 'int8' else tq.quantize_nf4
        banks = [tquant(torch.from_numpy(a), out_dtype='float32') for a in (gate, up, down)]
        jbanks = [jquant(a, out_dtype='float32') for a in (gate, up, down)]
        got = mixtral.moe_mlp(*_t(x, w), *banks, 2).numpy()
        want = np.asarray(jmix.moe_mlp(x, w, *jbanks, 2))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=mode)


# ----------------------------------------------------- 4-D quantizer
@pytest.mark.parametrize('mode', ['int8', 'nf4'])
def test_expert_bank_codes_equal_jax_bitwise_one_slice_at_a_time(mode, monkeypatch):
    rng = np.random.default_rng(5)
    bank = (rng.standard_normal((3, 4, 32, 48)) * 0.05).astype(np.float32)
    bank[1, 2, :, 7] = 0.0  # a zero channel: scale 1
    bank[2, 0, 5] = 0.0  # (nf4: a block of zeros)
    slices = []
    name = '_int8_slice' if mode == 'int8' else '_nf4_slice'
    inner = getattr(tq, name)

    def spy(w, *args):
        slices.append(tuple(w.shape))
        return inner(w, *args)

    monkeypatch.setattr(tq, name, spy)
    tree = {'layers': {'gate': {'kernel': torch.from_numpy(bank)}}}
    got = tq.quantize_pytree(tree, mode=mode, min_size=1, out_dtype='float32')
    want = jq.quantize_pytree({'layers': {'gate': {'kernel': bank}}}, mode=mode, min_size=1,
                              out_dtype='float32')
    g, w = got['layers']['gate']['kernel'], want['layers']['gate']['kernel']
    assert slices == [(32, 48)] * 12  # one expert's [in, out] at a time
    assert g.shape == tuple(w.shape) and g.q.dtype == getattr(torch, str(w.q.dtype))
    np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
    np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    np.testing.assert_array_equal(g.dequantize().numpy(), np.asarray(w.dequantize()))
    np.testing.assert_array_equal(g[1].dequantize().numpy(), np.asarray(w.dequantize())[1])


# --------------------------------------------------------------- init
def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}/{k}'))
        return out
    return {prefix: tree}


@pytest.mark.parametrize('mode', ['int8', 'nf4'])
def test_init_quantized_layer_by_layer_equals_quantize_pytree_of_init(mode):
    cfg = mixtral.MixtralConfig(**{**ENGINE_MODEL, 'dtype': 'bfloat16'})

    def gen():
        return torch.Generator().manual_seed(3)

    got = _flat(mixtral.init(cfg, gen(), device='cpu', quantization=mode))
    want = _flat(tq.quantize_pytree(mixtral.init(cfg, gen(), device='cpu'), mode=mode))
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        if isinstance(leaf, tq.QTensor):
            g = got[key]
            assert isinstance(g, tq.QTensor), key
            assert (g.kind, g.shape, g.out_dtype, g.block_size) == (
                leaf.kind, leaf.shape, leaf.out_dtype, leaf.block_size), key
            assert torch.equal(g.q, leaf.q) and torch.equal(g.scale, leaf.scale), key
        else:
            assert torch.equal(got[key], leaf), key
    # The JAX tree of the same geometry has the same leaves, quantized alike.
    jcfg = jmix.MixtralConfig(**{**ENGINE_MODEL, 'dtype': 'bfloat16'})
    jtree = _flat(jq.quantize_pytree(jmix.init(jax.random.PRNGKey(0), jcfg), mode=mode))
    assert sorted(jtree) == sorted(got)
    for key, leaf in jtree.items():
        assert isinstance(got[key], tq.QTensor) == isinstance(leaf, jq.QTensor), key
        assert tuple(got[key].shape) == tuple(leaf.shape), key
    assert got['/layers/gate/kernel'].shape == (2, 4, 64, 64)
    assert not isinstance(got['/layers/router/kernel'], tq.QTensor)


def _jax_tree(jcfg, seed=0):
    """The JAX ``init`` tree as numpy, norm scales moved off 1 by a seeded
    draw."""
    tree = jax.tree.map(np.asarray, jmix.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 100)
    for name in ('attn_ln', 'mlp_ln'):
        scale = tree['layers'][name]['scale']
        tree['layers'][name]['scale'] = (scale + rng.normal(scale=0.1, size=scale.shape)
                                         ).astype(np.float32)
    return tree


def _dense_inputs(vocab, b=2, s=10, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 7:] = 0
    return ids, mask


@pytest.mark.parametrize('quantized', [False, True], ids=['float', 'int8'])
def test_bridged_tree_apply_prefill_and_logits_match_jax(quantized):
    jcfg = jmix.MixtralConfig(**ENGINE_MODEL)
    tree = _jax_tree(jcfg)
    if quantized:
        tree = jq.quantize_pytree(tree, mode='int8', out_dtype='float32')
        tree = jax.tree.map(np.asarray, tree)
    tcfg = mixtral.MixtralConfig(**ENGINE_MODEL)
    params = mixtral.params_from_jax(tree, tcfg, device='cpu')
    if quantized:
        bank = params['layers']['gate']['kernel']
        assert isinstance(bank, tq.QTensor) and bank.shape == (2, 4, 64, 64)
        np.testing.assert_array_equal(bank.q.numpy(), np.asarray(tree['layers']['gate']['kernel'].q))
    ids, mask = _dense_inputs(tcfg.vocab_size)
    hidden = mixtral.apply(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    want = np.asarray(jmix.apply(tree, jcfg, ids, mask))
    np.testing.assert_allclose(hidden.numpy(), want, atol=ATOL, rtol=RTOL)
    h2, k, v = mixtral.prefill(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    jh, jk, jv = jmix.prefill(tree, jcfg, ids, mask)
    for got, ref in ((h2, jh), (k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        mixtral.logits(params, tcfg, hidden).numpy(),
        np.asarray(jmix.logits(tree, jcfg, want)), atol=ATOL, rtol=RTOL,
    )


def test_params_from_jax_refuses_a_dense_tree():
    jcfg = jmix.MixtralConfig(**TINY)
    tree = _jax_tree(jcfg)
    del tree['layers']['router']
    with pytest.raises(ValueError, match='router'):
        mixtral.params_from_jax(tree, mixtral.MixtralConfig(**TINY), device='cpu')
    with pytest.raises(ValueError, match='experts_per_token'):
        mixtral.MixtralConfig(**{**TINY, 'experts_per_token': 5})


# ----------------------------------------------------- HF checkpoint
WORDS = [f'w{i}' for i in range(300)]
HF_MIXTRAL = dict(
    vocab_size=303, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, intermediate_size=48, num_local_experts=4, num_experts_per_tok=2,
    max_position_embeddings=128, rope_theta=1e6, sliding_window=None, initializer_range=0.1,
    tie_word_embeddings=False,
)


def _write_tokenizer(root):
    """A word-level fast tokenizer of ``WORDS`` (ids 3..302)."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {'[UNK]': 0, '[PAD]': 1, '</s>': 2}
    vocab.update({w: i + 3 for i, w in enumerate(WORDS)})
    tok = Tokenizer(WordLevel(vocab, unk_token='[UNK]'))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(root / 'tokenizer.json'))
    (root / 'tokenizer_config.json').write_text(json.dumps({
        'tokenizer_class': 'PreTrainedTokenizerFast', 'pad_token': '[PAD]',
        'unk_token': '[UNK]', 'model_max_length': 128,
    }))


def _wide_head(state, seed):
    """Embeddings and head drawn wider than the init's 0.1 (as the Mistral
    checkpoint of test_torch_checkpoint_serve.py is): the logits' gaps
    then dwarf bf16 rounding, so greedy streams are the same text in both
    packages although bf16 sums in another order."""
    rng = np.random.default_rng(seed + 1)
    for name in ('model.embed_tokens.weight', 'lm_head.weight'):
        state[name] = rng.normal(scale=0.5, size=state[name].shape).astype(np.float32)
    return state


def write_checkpoint(root, seed=0):
    """A tiny ``MixtralForCausalLM`` made from a seed, saved as safetensors
    with its ``config.json``, and a word-level fast tokenizer of
    ``WORDS``. Returns ``(root, hf_model)``."""
    from safetensors.numpy import save_file
    from transformers import MixtralConfig as HFMixtralConfig
    from transformers import MixtralForCausalLM

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    _write_tokenizer(root)
    torch.manual_seed(seed)
    hf_cfg = HFMixtralConfig(**HF_MIXTRAL)
    model = MixtralForCausalLM(hf_cfg).eval()
    state = _wide_head({k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
                       seed)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    save_file(state, str(root / 'model.safetensors'))
    (root / 'config.json').write_text(json.dumps(hf_cfg.to_dict()))
    return root, model


def write_numpy_checkpoint(root, seed=0):
    """The same layout with the weights drawn by numpy from ``seed``
    (normal, std 0.1; norms 1 + a draw), without importing transformers'
    model classes. Returns ``root``."""
    from safetensors.numpy import save_file

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    _write_tokenizer(root)
    hf = {**HF_MIXTRAL, 'model_type': 'mixtral', 'num_attention_heads': 4}
    rng = np.random.default_rng(seed)
    h, inter = hf['hidden_size'], hf['intermediate_size']
    hd = h // hf['num_attention_heads']
    kv = hf['num_key_value_heads'] * hd

    def w(*shape):
        return rng.normal(scale=0.1, size=shape).astype(np.float32)

    state = {'model.embed_tokens.weight': w(hf['vocab_size'], h),
             'model.norm.weight': 1 + w(h), 'lm_head.weight': w(hf['vocab_size'], h)}
    for li in range(hf['num_hidden_layers']):
        p = f'model.layers.{li}'
        state.update({
            f'{p}.self_attn.q_proj.weight': w(h, h), f'{p}.self_attn.k_proj.weight': w(kv, h),
            f'{p}.self_attn.v_proj.weight': w(kv, h), f'{p}.self_attn.o_proj.weight': w(h, h),
            f'{p}.block_sparse_moe.gate.weight': w(hf['num_local_experts'], h),
            f'{p}.input_layernorm.weight': 1 + w(h),
            f'{p}.post_attention_layernorm.weight': 1 + w(h),
        })
        for e in range(hf['num_local_experts']):
            q = f'{p}.block_sparse_moe.experts.{e}'
            state.update({f'{q}.w1.weight': w(inter, h), f'{q}.w3.weight': w(inter, h),
                          f'{q}.w2.weight': w(h, inter)})
    save_file(_wide_head(state, seed), str(root / 'model.safetensors'))
    (root / 'config.json').write_text(json.dumps(hf))
    return root


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp('mixtral'))


def test_from_hf_config_matches_jax(checkpoint):
    hf = json.loads((checkpoint[0] / 'config.json').read_text())
    got = mixtral.MixtralConfig.from_hf_config(hf)
    want = jmix.MixtralConfig.from_hf_config(hf)
    for field in SHARED_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert (got.num_experts, got.experts_per_token, got.rope_theta) == (4, 2, 1e6)
    default = mixtral.MixtralConfig()
    for field in SHARED_FIELDS:  # Mixtral-8x7B widths by default, as in JAX
        assert getattr(default, field) == getattr(jmix.MixtralConfig(), field), field


def test_params_from_hf_matches_jax_and_the_hf_forward(checkpoint):
    from distllm_tpu_torch.models.loader import read_checkpoint

    root, model = checkpoint
    hf = json.loads((root / 'config.json').read_text())
    jcfg = jmix.MixtralConfig.from_hf_config(hf).model_copy(update={'dtype': 'float32'})
    tcfg = dataclasses.replace(mixtral.MixtralConfig.from_hf_config(hf), dtype='float32')
    state = read_checkpoint(root)
    want = _flat(jmix.params_from_hf({k: v.numpy() for k, v in state.items()}, jcfg))
    got = _flat(mixtral.params_from_hf(state, tcfg, device='cpu'))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    np.testing.assert_array_equal(  # expert 3's w2 of layer 1, transposed
        got['/layers/down/kernel'][1, 3].numpy(),
        state['model.layers.1.block_sparse_moe.experts.3.w2.weight'].numpy().T,
    )
    ids, mask = _dense_inputs(tcfg.vocab_size, seed=4)
    params = mixtral.params_from_hf(state, tcfg, device='cpu')
    hidden = mixtral.apply(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    with torch.no_grad():
        ref = model.model(input_ids=torch.from_numpy(ids).long(),
                          attention_mask=torch.from_numpy(mask).long()).last_hidden_state
    valid = mask.astype(bool)
    np.testing.assert_allclose(hidden.numpy()[valid], ref.numpy()[valid], atol=5e-5, rtol=1e-4)


# ----------------------------------------------------------- engines
ENGINE = {
    'block_size': 4, 'num_blocks': 96, 'max_num_seqs': 2, 'max_model_len': 96,
    'decode_steps': 4, 'max_window_prefill_tokens': 8, 'max_window_prefill_seqs': 2,
}
STAGGER_LENS = (5, 21, 3, 33, 7, 13)
STAGGER_OUT = (3, 17, 9, 5, 12, 8)
ENGINE_ARMS = {
    'plain': {},
    'spec': {'draft_k': 4, 'prefill_chunk_tokens': 4},
    'mixed': {'enable_mixed_batching': True, 'prefill_chunk_tokens': 4},
    'int8_weights': {'quantization': 'int8'},
    'int8_kv': {'kv_cache_dtype': 'int8'},
}


class _Tok:
    eos_id = None


def _stagger_prompts(vocab=64, seed=1):
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(1, vocab, size=n)] for n in STAGGER_LENS]
    shared = [int(t) for t in rng.integers(1, vocab, size=8)]
    prompts[0] = shared + prompts[0]
    prompts[4] = shared + prompts[4]
    return prompts


@pytest.fixture(scope='module')
def engine_tree():
    return _jax_tree(jmix.MixtralConfig(**ENGINE_MODEL), seed=1)


@pytest.mark.parametrize('arm', sorted(ENGINE_ARMS))
def test_engine_greedy_tokens_identical_to_jax_engine(engine_tree, arm):
    from distllm_tpu_torch.ops import quantized_matmul as tqm

    knobs = ENGINE_ARMS[arm]
    prompts = _stagger_prompts()
    jax_engine = JaxLLMEngine(
        jmix.MixtralConfig(**ENGINE_MODEL), engine_tree, _Tok(),
        JaxEngineConfig(attn_backend='xla', prefer_native_allocator=False, **ENGINE, **knobs),
    )
    rids = [
        jax_engine.add_request(p, JaxSamplingParams(temperature=0.0, max_tokens=n))
        for p, n in zip(prompts, STAGGER_OUT)
    ]
    jax_engine._run_to_completion()
    want = [jax_engine._finished.pop(r).output_ids for r in rids]
    jax_engine.shutdown()

    tcfg = mixtral.MixtralConfig(**ENGINE_MODEL)
    engine = LLMEngine(
        tcfg, mixtral.params_from_jax(engine_tree, tcfg, device='cpu'), _Tok(),
        EngineConfig(**ENGINE, **knobs), device='cpu', own_params=True,
    )
    products = tqm.int8_matmul_reference.launches
    got = engine.generate_ids(
        prompts, [SamplingParams(temperature=0.0, max_tokens=n) for n in STAGGER_OUT]
    )
    assert got == want
    tele = engine.telemetry
    if arm == 'spec':
        assert tele['spec_windows'] > 0
    if arm == 'mixed':
        assert tele['mixed_windows'] > 0
    if arm == 'int8_weights':
        bank = engine.params['layers']['gate']['kernel']
        assert isinstance(bank, tq.QTensor) and bank.q.dim() == 4
        # q / k / v / o through the int8 matmul; the banks are dequantized.
        assert tqm.int8_matmul_reference.launches - products == (
            4 * tcfg.num_layers * tele['forward_passes'])
        assert engine.stats['expert_bank_bytes_quantized'] == sum(
            engine.params['layers'][k]['kernel'].nbytes for k in ('gate', 'up', 'down'))
        assert engine.stats['expert_bank_bytes_float'] == 0
    else:
        assert engine.stats['expert_bank_bytes_float'] == 3 * 2 * 4 * 64 * 64 * 4
    if arm == 'int8_kv':
        assert tele['kv_cache_dtype'] == 'int8'
    assert engine.sched.num_free_blocks == ENGINE['num_blocks'] - 1
    engine.shutdown()


def test_the_engine_records_the_expert_banks_in_its_quantize_phase(engine_tree):
    from distllm_tpu_torch.observability.startup import get_compile_watcher

    tcfg = mixtral.MixtralConfig(**ENGINE_MODEL)
    before = len(get_compile_watcher().state()['phases'])
    engine = LLMEngine(tcfg, mixtral.params_from_jax(engine_tree, tcfg, device='cpu'), _Tok(),
                       EngineConfig(**ENGINE, quantization='int8'), device='cpu')
    phase = [p for p in get_compile_watcher().state()['phases'][before:]
             if p['phase'] == 'quantize'][-1]
    q_banks, f_banks = tq.quantized_nbytes(
        {k: engine.params['layers'][k]['kernel'] for k in ('gate', 'up', 'down')})
    assert phase['expert_bank_bytes_quantized'] == q_banks > 0 and f_banks == 0
    assert (phase['weight_bytes_quantized'], phase['weight_bytes_float']) == (
        engine.weight_bytes_quantized, engine.weight_bytes_float)
    engine.shutdown()


# ------------------------------------------- generators and YAML configs
def test_a_chat_yaml_naming_mixtral_builds_the_jax_config(tmp_path):
    from distllm_tpu_torch.chat_server import load_app_config
    from distllm_tpu_torch.generate.generators.torch_backend import TorchGenerator

    model = {'name': 'mixtral', **TINY, 'rope_theta': 5e5}
    raw = {'system_prompt': '', 'generator_config': {
        'name': 'torch', 'temperature': 0.0, 'max_tokens': 4, 'num_blocks': 32,
        'max_num_seqs': 2, 'max_model_len': 64, 'device': 'cpu', 'quantization': 'int8',
        'model': model,
    }}
    path = tmp_path / 'app.yaml'
    path.write_text(yaml.safe_dump(raw))
    config, _ = load_app_config(str(path))
    assert type(config.model) is mixtral.MixtralConfig and config.model.name == 'mixtral'
    want = jmix.MixtralConfig(**{k: v for k, v in model.items()})
    for field in SHARED_FIELDS:
        assert getattr(config.model, field) == getattr(want, field), field
    generator = TorchGenerator(config)
    # The family's own init, quantized as it was drawn (no float bank).
    bank = generator.engine.params['layers']['gate']['kernel']
    assert isinstance(bank, tq.QTensor) and bank.shape == (2, 4, 16, 32)
    direct = mixtral.init(config.model, torch.Generator().manual_seed(0), device='cpu',
                          quantization='int8')
    assert torch.equal(bank.q, direct['layers']['gate']['kernel'].q)
    assert len(generator.generate(['a b c', 'a b'])) == 2
    generator.shutdown()


def _example_generator_config(root, **update):
    raw = yaml.safe_load(EXAMPLE.read_text())['generator_config']
    return {**raw, 'pretrained_model_name_or_path': str(root), 'tensor_parallel_size': 1,
            'max_model_len': 128, 'max_num_seqs': 4, 'num_blocks': 128, **update}


def test_the_example_generate_yaml_serves_the_checkpoint_as_jax(checkpoint):
    from distllm_tpu.generate.generators.tpu_backend import TpuGenerator, TpuGeneratorConfig
    from distllm_tpu_torch.generate import get_generator

    root, _ = checkpoint
    kw = _example_generator_config(root, temperature=0.0, max_tokens=8)
    assert kw['name'] == 'tpu' and kw['quantization'] == 'int8'
    port = get_generator(kw, device='cpu')
    ref = TpuGenerator(TpuGeneratorConfig(**{k: v for k, v in kw.items() if k != 'name'},
                                          attn_backend='xla'))
    assert type(port.model_cfg) is mixtral.MixtralConfig
    for field in SHARED_FIELDS:
        assert getattr(port.model_cfg, field) == getattr(ref.engine.model_cfg, field), field
    assert isinstance(port.engine.params['layers']['gate']['kernel'], tq.QTensor)
    prompts = ['w1 w2 w3 w4 w5', 'w9 w10 w11', 'w20 w21 w22 w23 w24 w25 w26', 'w7']
    assert port.generate(prompts) == ref.generate(prompts)
    port.shutdown()
    ref.engine.shutdown()


def test_the_example_at_eight_chips_raises_naming_a10b(checkpoint):
    # Tensor parallelism is ported (ROADMAP A10b): at 8 ranks the tiny
    # checkpoint does not split, which both packages refuse with a
    # ValueError (the port on its 2 KV heads, before it starts any rank;
    # JAX on the vocab of 303, which it shards first).
    from distllm_tpu.generate.generators.tpu_backend import TpuGenerator, TpuGeneratorConfig
    from distllm_tpu_torch.generate import get_generator

    kw = _example_generator_config(checkpoint[0], tensor_parallel_size=8)
    with pytest.raises(ValueError, match='num_kv_heads'):
        get_generator(kw, device='cpu')
    with pytest.raises(ValueError, match='divisible by 8'):
        TpuGenerator(TpuGeneratorConfig(**{k: v for k, v in kw.items() if k != 'name'},
                                        attn_backend='xla'))


def test_decoder_family_serves_mixtral():
    assert decoder_family('mixtral') == (mixtral.MixtralConfig, mixtral)
    assert mixtral.apply is mistral.apply and mixtral.decode_step is mistral.decode_step


# ------------------------------------------------------- auto encoder
def test_auto_encoder_on_a_mixtral_checkpoint_matches_jax(checkpoint):
    from distllm_tpu.embed.encoders.auto import AutoEncoder as JaxAutoEncoder
    from distllm_tpu.embed.encoders.auto import AutoEncoderConfig as JaxAutoConfig
    from distllm_tpu.embed.poolers.last_token import LastTokenPooler as JaxPooler
    from distllm_tpu.embed.poolers.last_token import LastTokenPoolerConfig as JaxPoolerConfig
    from distllm_tpu_torch.embed.encoders.auto import AutoEncoder, AutoEncoderConfig
    from distllm_tpu_torch.embed.poolers.last_token import LastTokenPooler, LastTokenPoolerConfig

    root, _ = checkpoint
    for quantization in (False, 'int8'):
        kw = dict(pretrained_model_name_or_path=str(root), half_precision=False,
                  quantization=quantization)
        jax_enc = JaxAutoEncoder(JaxAutoConfig(**kw))
        port_enc = AutoEncoder(AutoEncoderConfig(**kw), device='cpu')
        assert type(port_enc.model_cfg) is mixtral.MixtralConfig
        texts = ['w1 w2 w3 w4 w5 w6 w7 w8', 'w9 w10', 'w11 w12 w13 w14 w15 w16 w17 w18 w19']
        batch, jbatch = port_enc.tokenizer(texts), jax_enc.tokenizer(texts)
        np.testing.assert_array_equal(batch.input_ids, jbatch.input_ids)
        got = port_enc.pooled_forward(LastTokenPooler(LastTokenPoolerConfig()))(batch)
        want = np.asarray(jax_enc.pooled_forward(JaxPooler(JaxPoolerConfig()))(jbatch))
        assert got.shape == (3, 32)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=str(quantization))
