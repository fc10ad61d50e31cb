"""The decoder families in the port against the JAX package: the Gemma
knobs of the shared forward, ``GemmaConfig``, ``from_hf_config`` and
``params_from_hf`` of every family, the dense forward, ``decoder_family``,
the ``auto`` encoder over decoders, and K1's plain version at head dim 256.

Weights come from the JAX ``init`` (norm scales then perturbed from a seed,
so Gemma's ``(1 + w)`` norms differ from the others') and cross the
bridge (``params_from_jax``) as numpy arrays; checkpoints are written from
a seed in the HF layout. Tolerances: fp32 logits, hidden states and K/V
within ``atol 1e-5`` / ``rtol 1e-4`` (the same math, PyTorch vs XLA
summation order); greedy tokens identical; parameter trees equal bit for
bit (both sides transpose and stack the same fp32 arrays).

- The common ops (``softcap``, ``repeat_kv``, ``causal_mask``, the
  ``plus_one`` RMSNorm) against ``distllm_tpu.models.common``.
- ``from_hf_config`` against JAX on HF-style dicts: mistral, qwen2 with
  ``use_sliding_window: false``, llama-3 ``rope_scaling``, gemma, gemma2.
- ``params_from_hf`` trees against JAX's, on tiny checkpoints of the five
  families (gemma2 maps ``post_attention_layernorm`` to a true post-norm).
- ``apply`` / ``prefill`` / ``logits`` against JAX for the five families;
  gemma2 on a sequence longer than its window, where an all-global model
  diverges from it.
- ``prefill_paged`` / ``decode_step`` of gemma2 against JAX's.
- The plain K1 at head dim 256 against the Pallas kernel in interpret mode
  (softcap, scale, a traced window, an int8 pool).
- The paged engine on gemma and gemma2 against the JAX engine: prefill and
  decode, mixed windows, ``draft_k=4`` (the twins of the JAX tests
  ``test_engine_greedy_gemma2_matches_dense_forward``,
  ``test_mixed_windows_token_identity_gemma2`` and
  ``test_spec_token_identity_gemma2``).
- ``decoder_family`` dispatch and its errors; the engine's attention
  backend resolution.
- The ``auto`` encoder's ``last_token`` embeddings against the JAX auto
  encoder on a tiny Mistral and a tiny Gemma-2 checkpoint.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig
from distllm_tpu.generate.engine import LLMEngine as JaxLLMEngine
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.models import common as jax_common
from distllm_tpu.models import decoder_family as jax_decoder_family
from distllm_tpu.models import gemma as jax_gemma
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu.ops import paged_attention as jpa
from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
from distllm_tpu_torch.models import (
    common,
    decoder_families,
    decoder_family,
    gemma,
    mistral,
    mixtral,
)
from distllm_tpu_torch.ops import paged_attention as tpa

ATOL, RTOL = 1e-5, 1e-4

# HF config.json dicts of the five families at tiny widths.
HF_CONFIGS = {
    'mistral': {
        'model_type': 'mistral', 'vocab_size': 320, 'hidden_size': 32,
        'num_hidden_layers': 2, 'num_attention_heads': 4, 'num_key_value_heads': 2,
        'intermediate_size': 64, 'max_position_embeddings': 128,
        'rms_norm_eps': 1e-5, 'sliding_window': 5, 'tie_word_embeddings': False,
    },
    'qwen2': {
        'model_type': 'qwen2', 'vocab_size': 320, 'hidden_size': 32,
        'num_hidden_layers': 2, 'num_attention_heads': 4, 'num_key_value_heads': 2,
        'intermediate_size': 64, 'max_position_embeddings': 128, 'rope_theta': 1e6,
        'rms_norm_eps': 1e-6, 'sliding_window': 4, 'use_sliding_window': False,
        'tie_word_embeddings': True,
    },
    'llama': {
        'model_type': 'llama', 'vocab_size': 320, 'hidden_size': 32,
        'num_hidden_layers': 2, 'num_attention_heads': 4, 'num_key_value_heads': 1,
        'intermediate_size': 64, 'max_position_embeddings': 128, 'rope_theta': 5e5,
        'rope_scaling': {
            'rope_type': 'llama3', 'factor': 8.0, 'low_freq_factor': 1.0,
            'high_freq_factor': 4.0, 'original_max_position_embeddings': 16,
        },
    },
    'gemma': {
        'model_type': 'gemma', 'vocab_size': 320, 'hidden_size': 32,
        'num_hidden_layers': 2, 'num_attention_heads': 4, 'num_key_value_heads': 1,
        'head_dim': 16, 'intermediate_size': 64, 'max_position_embeddings': 128,
        'hidden_act': 'gelu', 'rms_norm_eps': 1e-6,
    },
    'gemma2': {
        'model_type': 'gemma2', 'vocab_size': 320, 'hidden_size': 32,
        'num_hidden_layers': 4, 'num_attention_heads': 4, 'num_key_value_heads': 2,
        'head_dim': 16, 'intermediate_size': 64, 'max_position_embeddings': 128,
        'hidden_activation': 'gelu_pytorch_tanh', 'query_pre_attn_scalar': 16,
        'attn_logit_softcapping': 50.0, 'final_logit_softcapping': 30.0,
        'sliding_window': 6, 'rms_norm_eps': 1e-6,
    },
}
FAMILIES = sorted(HF_CONFIGS)


def _configs(family, dtype='float32'):
    hf = HF_CONFIGS[family]
    jcls, _ = jax_decoder_family(family)
    tcls, _ = decoder_family(family)
    jcfg = jcls.from_hf_config(hf).model_copy(update={'dtype': dtype})
    tcfg = dataclasses.replace(tcls.from_hf_config(hf), dtype=dtype)
    return jcfg, tcfg


def _perturbed_tree(jcfg, seed=0):
    """The JAX ``init`` tree as numpy, every norm scale moved off its
    identity by a seeded draw (so ``(1 + w)`` is exercised)."""
    tree = jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 100)

    def walk(node, name=''):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name == 'scale':
            return (node + rng.normal(scale=0.1, size=node.shape)).astype(np.float32)
        return node

    return walk(tree)


@pytest.fixture(scope='module', params=FAMILIES)
def family_models(request):
    jcfg, tcfg = _configs(request.param)
    tree = _perturbed_tree(jcfg)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    return request.param, jcfg, tree, tcfg, params


def _close(torch_value, jax_value):
    np.testing.assert_allclose(
        torch_value.detach().numpy(), np.asarray(jax_value), atol=ATOL, rtol=RTOL
    )


# ---------------------------------------------------------- common ops
@pytest.mark.parametrize('op', ['softcap', 'repeat_kv', 'causal_mask', 'rms_norm_plus_one'])
def test_common_ops_match_jax(op):
    rng = np.random.default_rng(0)
    x = rng.normal(scale=40.0, size=(2, 5, 3, 8)).astype(np.float32)
    if op == 'softcap':
        _close(common.softcap(torch.from_numpy(x), 30.0), jax_common.softcap(jnp.asarray(x), 30.0))
    elif op == 'repeat_kv':
        for n_rep in (1, 3):
            got = common.repeat_kv(torch.from_numpy(x), n_rep)
            want = jax_common.repeat_kv(jnp.asarray(x), n_rep)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif op == 'causal_mask':
        for q_len, kv_len, offset in ((4, 4, 0), (3, 7, 4), (5, 2, -1)):
            got = common.causal_mask(q_len, kv_len, offset)
            want = jax_common.causal_mask(q_len, kv_len, offset)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        scale = rng.normal(scale=0.3, size=(8,)).astype(np.float32)
        for plus_one in (False, True):
            got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6, plus_one)
            want = jax_common.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6, plus_one)
            _close(got, want)


# ------------------------------------------------------ from_hf_config
@pytest.mark.parametrize('family', FAMILIES)
def test_from_hf_config_matches_jax(family):
    jcls, _ = jax_decoder_family(family)
    jcfg = jcls.from_hf_config(HF_CONFIGS[family])
    tcls, _ = decoder_family(family)
    tcfg = tcls.from_hf_config(HF_CONFIGS[family])
    fields = [f.name for f in dataclasses.fields(tcfg) if f.name != 'qmm_backend']
    assert {'qmm_backend', *fields} == set(type(jcfg).model_fields)
    assert {f: getattr(tcfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    assert tcfg.head_size == jcfg.head_size
    if family == 'qwen2':
        assert tcfg.sliding_window is None and tcfg.attention_bias
    if family == 'gemma2':
        assert tcfg.sliding_window_pattern == 'alternating' and tcfg.post_norms
        assert tcfg.query_scale == 16 ** -0.5


# ------------------------------------------------------- params_from_hf
def _hf_state(family, seed=0):
    """A tiny HF state dict of ``family`` from a seed (numpy, fp32)."""
    hf = HF_CONFIGS[family]
    rng = np.random.default_rng(seed)
    h, inter, n = hf['hidden_size'], hf['intermediate_size'], hf['num_hidden_layers']
    hd = hf.get('head_dim') or h // hf['num_attention_heads']
    q_out = hf['num_attention_heads'] * hd
    kv_out = hf['num_key_value_heads'] * hd

    def w(*shape):
        return rng.normal(scale=0.05, size=shape).astype(np.float32)

    state = {'model.embed_tokens.weight': w(hf['vocab_size'], h), 'model.norm.weight': w(h)}
    for i in range(n):
        p = f'model.layers.{i}'
        state.update({
            f'{p}.self_attn.q_proj.weight': w(q_out, h),
            f'{p}.self_attn.k_proj.weight': w(kv_out, h),
            f'{p}.self_attn.v_proj.weight': w(kv_out, h),
            f'{p}.self_attn.o_proj.weight': w(h, q_out),
            f'{p}.mlp.gate_proj.weight': w(inter, h),
            f'{p}.mlp.up_proj.weight': w(inter, h),
            f'{p}.mlp.down_proj.weight': w(h, inter),
            f'{p}.input_layernorm.weight': w(h),
            f'{p}.post_attention_layernorm.weight': w(h),
        })
        if family == 'qwen2':
            state.update({
                f'{p}.self_attn.q_proj.bias': w(q_out),
                f'{p}.self_attn.k_proj.bias': w(kv_out),
                f'{p}.self_attn.v_proj.bias': w(kv_out),
            })
        if family == 'gemma2':
            state.update({
                f'{p}.pre_feedforward_layernorm.weight': w(h),
                f'{p}.post_feedforward_layernorm.weight': w(h),
            })
    if not HF_CONFIGS[family].get('tie_word_embeddings', family.startswith('gemma')):
        state['lm_head.weight'] = w(hf['vocab_size'], h)
    return state


def _flatten(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f'{prefix}/{k}'))
        return out
    return {prefix: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


@pytest.mark.parametrize('family', FAMILIES)
def test_params_from_hf_matches_jax(family):
    jcfg, tcfg = _configs(family)
    state = _hf_state(family)
    _, jmodule = jax_decoder_family(family)
    _, tmodule = decoder_family(family)
    want = _flatten(jmodule.params_from_hf(dict(state), jcfg))
    got = _flatten(tmodule.params_from_hf(
        {k: torch.from_numpy(v) for k, v in state.items()}, tcfg, device='cpu'
    ))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    if family == 'gemma2':  # the trap: a true post-norm, not the pre-MLP norm
        np.testing.assert_array_equal(
            got['/layers/post_attn_ln/scale'][1],
            state['model.layers.1.post_attention_layernorm.weight'],
        )
        np.testing.assert_array_equal(
            got['/layers/mlp_ln/scale'][1],
            state['model.layers.1.pre_feedforward_layernorm.weight'],
        )


def test_params_from_hf_refuses_a_bias_the_forward_drops():
    _, tcfg = _configs('mistral')
    state = _hf_state('mistral')
    state['model.layers.0.self_attn.o_proj.bias'] = np.zeros(32, np.float32)
    with pytest.raises(ValueError, match='o_proj.bias'):
        mistral.params_from_hf(state, tcfg, device='cpu')


# -------------------------------------------------------- dense forward
def _dense_inputs(vocab, b=2, s=12, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 9:] = 0  # a right-padded row
    return ids, mask


def test_dense_apply_prefill_and_logits_match_jax(family_models):
    family, jcfg, tree, tcfg, params = family_models
    ids, mask = _dense_inputs(jcfg.vocab_size)
    jh = jax_mistral.apply(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    th = mistral.apply(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    _close(th, jh)
    jh2, jk, jv = jax_mistral.prefill(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    th2, tk, tv = mistral.prefill(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert tk.shape == (tcfg.num_layers, 2, 12, tcfg.num_kv_heads, tcfg.head_size)
    for t_val, j_val in ((th2, jh2), (tk, jk), (tv, jv)):
        _close(t_val, j_val)
    _close(mistral.logits(params, tcfg, th), jax_mistral.logits(tree, jcfg, jh))


def test_gemma2_window_cuts_and_all_global_diverges():
    """12 tokens over a window of 6: the even layers' window cuts the
    sequence, so the same weights served all-global give other logits."""
    jcfg, tcfg = _configs('gemma2')
    tree = _perturbed_tree(jcfg)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    ids, mask = _dense_inputs(jcfg.vocab_size)
    want = jax_mistral.logits(tree, jcfg, jax_mistral.apply(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    got = mistral.logits(params, tcfg, mistral.apply(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask)))
    _close(got, want)
    global_cfg = dataclasses.replace(tcfg, sliding_window=None)
    diverged = mistral.logits(params, global_cfg, mistral.apply(
        params, global_cfg, torch.from_numpy(ids), torch.from_numpy(mask)))
    # Positions inside the window agree; those past it do not.
    np.testing.assert_allclose(diverged[:, :6].numpy(), np.asarray(want)[:, :6], atol=ATOL, rtol=RTOL)
    assert np.abs(diverged[0, 6:].numpy() - np.asarray(want)[0, 6:]).max() > 1e-3


def test_dense_forward_refuses_sequence_parallelism():
    _, tcfg = _configs('mistral')
    with pytest.raises(NotImplementedError, match='A10'):
        mistral.apply({}, tcfg, torch.zeros(1, 2, dtype=torch.int32),
                      torch.ones(1, 2), seq_parallel='ring')


# ------------------------------------------------------- paged programs
def test_gemma2_paged_prefill_and_decode_match_jax():
    jcfg, tcfg = _configs('gemma2')
    tree = _perturbed_tree(jcfg, seed=1)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    rng = np.random.default_rng(4)
    shape = (tcfg.num_layers, 24, 4, tcfg.num_kv_heads, tcfg.head_size)
    jpools = [jnp.zeros(shape, jnp.float32)] * 2
    tpools = [torch.zeros(shape), torch.zeros(shape)]
    bt = np.stack([rng.permutation(np.arange(1, 24))[:8] for _ in range(2)]).astype(np.int32)
    ids = rng.integers(1, 320, size=(2, 11)).astype(np.int32)
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))
    tails = np.asarray([11, 8], np.int32)
    jl, jk, jv = jax_mistral.prefill_paged(
        tree, jcfg, jnp.asarray(ids), jnp.asarray(pos), *jpools, jnp.asarray(bt),
        jnp.asarray(tails), jnp.asarray(tails), max_table_positions=64,
    )
    t = torch.from_numpy
    tl, _, _ = mistral.prefill_paged(
        params, tcfg, t(ids), t(pos), *tpools, t(bt), t(tails), t(tails),
        max_table_positions=64,
    )
    _close(tl, jl)
    for step in range(3):  # decode past the window on the even layers
        new = rng.integers(1, 320, size=2).astype(np.int32)
        dpos = tails + step
        jl, jk, jv = jax_mistral.decode_step(
            tree, jcfg, jnp.asarray(new), jnp.asarray(dpos), jk, jv, jnp.asarray(bt),
            jnp.asarray(dpos + 1),
        )
        tl, _, _ = mistral.decode_step(
            params, tcfg, t(new), t(dpos), *tpools, t(bt), t(dpos + 1),
        )
        _close(tl, jl)
    for tp, jp in zip(tpools, (jk, jv), strict=True):
        _close(tp[:, 1:], jp[:, 1:])


# ----------------------------------------------- K1's plain op at 256
def _k1_inputs(seed, *, int8=False, nh=16, nkv=8, hd=256, b=3, s=5, nb=12, bs=16):
    rng = np.random.default_rng(seed)
    ctx = np.asarray([70, s, 40], np.int32)
    q_lens = np.asarray([s, s, 1], np.int32)
    pos = (ctx - q_lens)[:, None] + np.arange(s, dtype=np.int32)[None, :]
    bt = np.stack([rng.permutation(np.arange(1, nb))[:5] for _ in range(b)]).astype(np.int32)
    q = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    if int8:
        pools = [
            tpa.QuantizedKV(
                torch.from_numpy(rng.integers(-127, 128, size=(nb, bs, nkv, hd)).astype(np.int8)),
                torch.from_numpy(rng.uniform(0.01, 0.1, size=(nb, nkv)).astype(np.float32)),
            )
            for _ in range(2)
        ]
    else:
        pools = [torch.from_numpy(rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32))
                 for _ in range(2)]
    return q, pools, bt, ctx, pos, q_lens


def _as_jax_pool(pool):
    if isinstance(pool, tpa.QuantizedKV):
        return jpa.QuantizedKV(jnp.asarray(pool.data.numpy()), jnp.asarray(pool.scale.numpy()))
    return jnp.asarray(pool.numpy())


@pytest.mark.parametrize('int8', [False, True], ids=['fp32_pool', 'int8_pool'])
def test_plain_k1_at_head_dim_256_matches_the_pallas_kernel(int8):
    """Gemma-2-9B's attention geometry (16 / 8 heads, head dim 256, block
    16) with its softcap and query scale, a window of 24 across the rows'
    keys (traced on the JAX side, as the JAX model passes a per-layer
    window), against the Pallas kernel in interpret mode, valid rows."""
    q, (k, v), bt, ctx, pos, q_lens = _k1_inputs(5, int8=int8)
    kw = {'scale': 256 ** -0.5, 'logit_softcap': 50.0}
    want = np.asarray(jpa.ragged_paged_attention_pallas(
        jnp.asarray(q), _as_jax_pool(k), _as_jax_pool(v), jnp.asarray(bt),
        jnp.asarray(ctx), jnp.asarray(pos), q_lens=jnp.asarray(q_lens),
        sliding_window=jnp.int32(24), interpret=True, **kw,
    ))
    args = (torch.from_numpy(q), k, v, torch.from_numpy(bt), torch.from_numpy(ctx),
            torch.from_numpy(pos))
    kw.update(q_lens=torch.from_numpy(q_lens), sliding_window=24)
    out = tpa.ragged_paged_attention(*args, **kw)
    got = out.numpy()
    valid = np.arange(q.shape[1])[None, :] < q_lens[:, None]
    if int8:
        # Over an int8 pool the two sides scale the score in another order
        # (the plain op dequantizes K first, the kernel scales q . c after):
        # the fp32 bound with the INT8 term, as for the kernel's own route.
        tol = tpa.comparison_tolerance(out, *args, route='cuda_cores', **kw).numpy()
        assert (np.abs(got - want)[valid] <= tol[valid]).all()
    else:
        np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=RTOL)
    assert 256 in tpa.KERNEL_HEAD_DIMS


def test_split_plan_takes_one_block_an_sm_at_head_dim_256():
    assert tpa.split_blocks_per_sm(128) == tpa.SPLIT_BLOCKS_PER_SM == 2
    assert tpa.split_blocks_per_sm(256) == 1
    # 8 rows x 8 KV heads on 132 SMs: 5 splits at 128, 3 at 256.
    assert tpa.split_plan(8192, 8, 8, 132, 16, 128) == (5, 1664)
    assert tpa.split_plan(8192, 8, 8, 132, 16, 256) == (3, 2752)


# ------------------------------------------------------------ engines
GEMMA_TINY = {
    'gemma': dict(
        name='gemma', vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
        num_kv_heads=1, head_dim=16, intermediate_size=64, max_position_embeddings=128,
        dtype='float32', activation='gelu_new', embedding_multiplier=32 ** 0.5,
        norm_plus_one=True, tie_word_embeddings=True, rms_norm_eps=1e-6,
    ),
    'gemma2': dict(
        name='gemma2', vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
        num_kv_heads=2, head_dim=16, intermediate_size=64, max_position_embeddings=128,
        dtype='float32', activation='gelu_new', embedding_multiplier=32 ** 0.5,
        norm_plus_one=True, post_norms=True, query_scale=16 ** -0.5,
        attn_logit_softcap=50.0, final_logit_softcap=30.0, sliding_window=6,
        sliding_window_pattern='alternating', tie_word_embeddings=True, rms_norm_eps=1e-6,
    ),
}
ENGINE = {
    'block_size': 4, 'num_blocks': 96, 'max_num_seqs': 2, 'max_model_len': 96,
    'decode_steps': 4, 'max_window_prefill_tokens': 8, 'max_window_prefill_seqs': 2,
}
# The JAX engine tests' staggered workload: more prompts than slots, two
# behind a shared prefix, prompts and outputs that cross the window of 6.
STAGGER_LENS = (5, 21, 3, 33, 7, 13)
STAGGER_OUT = (3, 17, 9, 5, 12, 8)
ENGINE_ARMS = {
    'plain': {},
    'mixed': {'enable_mixed_batching': True, 'prefill_chunk_tokens': 4},
    'spec': {'draft_k': 4, 'prefill_chunk_tokens': 4},
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


@pytest.fixture(scope='module', params=sorted(GEMMA_TINY))
def gemma_weights(request):
    jcfg = jax_gemma.GemmaConfig(**GEMMA_TINY[request.param])
    return request.param, jcfg, _perturbed_tree(jcfg, seed=1)


@pytest.mark.parametrize('arm', sorted(ENGINE_ARMS))
def test_engine_greedy_tokens_identical_to_jax_engine(gemma_weights, arm):
    family, jcfg, tree = gemma_weights
    knobs = ENGINE_ARMS[arm]
    prompts = _stagger_prompts()
    jax_engine = JaxLLMEngine(
        jcfg, tree, _Tok(),
        JaxEngineConfig(attn_backend='xla', prefer_native_allocator=False, **ENGINE, **knobs),
    )
    rids = [
        jax_engine.add_request(p, JaxSamplingParams(temperature=0.0, max_tokens=n))
        for p, n in zip(prompts, STAGGER_OUT)
    ]
    jax_engine._run_to_completion()
    want = [jax_engine._finished.pop(r).output_ids for r in rids]
    jax_engine.shutdown()

    tcfg = gemma.GemmaConfig(**GEMMA_TINY[family])
    engine = LLMEngine(
        tcfg, gemma.params_from_jax(tree, tcfg, device='cpu'), _Tok(),
        EngineConfig(**ENGINE, **knobs), device='cpu',
    )
    got = engine.generate_ids(
        prompts, [SamplingParams(temperature=0.0, max_tokens=n) for n in STAGGER_OUT]
    )
    assert got == want
    assert engine.attn_backend == 'reference'  # 'auto' on the CPU
    if arm == 'mixed':
        assert engine.stats['mixed_windows'] > 0
    if arm == 'spec':
        assert engine.stats['spec_windows'] > 0
    assert engine.sched.num_free_blocks == ENGINE['num_blocks'] - 1


def test_attn_backend_resolves_once_by_head_dim():
    gcfg = gemma.GemmaConfig(**GEMMA_TINY['gemma2'])  # head dim 16: not K1's
    big = dataclasses.replace(gcfg, head_dim=256)
    cpu, cuda = torch.device('cpu'), torch.device('cuda')
    assert tpa.supports_model(big) and not tpa.supports_model(gcfg)
    assert tpa.resolve_attn_backend('auto', big, cuda) == 'auto'
    assert tpa.resolve_attn_backend('auto', big, cpu) == 'reference'
    assert tpa.resolve_attn_backend('auto', gcfg, cpu) == 'reference'
    assert tpa.resolve_attn_backend('reference', big, cuda) == 'reference'
    assert tpa.resolve_attn_backend('reference', gcfg, cuda) == 'reference'
    # On the card a head dim K1 lacks is refused, never served plain.
    with pytest.raises(ValueError, match='no head dim 16'):
        tpa.resolve_attn_backend('auto', gcfg, cuda)
    for name in ('kernel', 'pallas'):
        with pytest.raises(ValueError, match='attn_backend'):
            tpa.resolve_attn_backend(name, big, cuda)


# -------------------------------------------------- decoder dispatch
def test_decoder_family_dispatch_and_errors():
    families = decoder_families()
    assert sorted(families) == ['gemma', 'gemma2', 'llama', 'mistral', 'mixtral', 'qwen2']
    assert families['gemma2'] == (gemma.GemmaConfig, gemma)
    assert decoder_family('llama') == (mistral.MistralConfig, mistral)
    # Mixtral (ROADMAP A10a): the JAX family's config, field for field.
    cfg_cls, module = decoder_family('mixtral')
    assert (cfg_cls, module) == (mixtral.MixtralConfig, mixtral)
    hf = {'model_type': 'mixtral', 'vocab_size': 320, 'hidden_size': 32,
          'num_hidden_layers': 2, 'num_attention_heads': 4, 'num_key_value_heads': 2,
          'intermediate_size': 48, 'num_local_experts': 4, 'num_experts_per_tok': 2,
          'rope_theta': 5e5, 'sliding_window': 8}
    jax_cls, _ = jax_decoder_family('mixtral')
    got, want = cfg_cls.from_hf_config(hf), jax_cls.from_hf_config(hf)
    for field in ('vocab_size', 'hidden_size', 'num_layers', 'num_heads', 'num_kv_heads',
                  'head_size', 'intermediate_size', 'num_experts', 'experts_per_token',
                  'rope_theta', 'sliding_window', 'tie_word_embeddings', 'dtype'):
        assert getattr(got, field) == getattr(want, field), field
    for encoder_type in ('bert', 'esm', 'modernbert', 'nonsense'):
        with pytest.raises(ValueError, match='Unsupported decoder'):
            decoder_family(encoder_type)
        with pytest.raises(ValueError):
            jax_decoder_family(encoder_type)
    with pytest.raises(ValueError, match='name'):
        gemma.GemmaConfig(name='mistral')
    with pytest.raises(ValueError, match='name'):
        mistral.MistralConfig(name='gemma2')


# ------------------------------------------------------- auto encoder
def _write_checkpoint(root, family):
    """A tiny HF checkpoint of ``family`` and a BertTokenizerFast (any
    tokenizer whose ids fit the vocabulary serves the test)."""
    from transformers import BertTokenizerFast

    words = [f'w{i}' for i in range(300)]
    vocab = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]'] + words
    (root / 'vocab.txt').write_text('\n'.join(vocab) + '\n')
    BertTokenizerFast(vocab_file=str(root / 'vocab.txt')).save_pretrained(root)
    (root / 'config.json').write_text(json.dumps(HF_CONFIGS[family]))
    state = {k: torch.from_numpy(v) for k, v in _hf_state(family, seed=7).items()}
    torch.save(state, root / 'pytorch_model.bin')
    return root


@pytest.mark.parametrize('family', ['mistral', 'gemma2'])
def test_auto_encoder_last_token_embeddings_match_jax(tmp_path, family):
    from distllm_tpu.embed.encoders.auto import AutoEncoder as JaxAutoEncoder
    from distllm_tpu.embed.encoders.auto import AutoEncoderConfig as JaxAutoConfig
    from distllm_tpu.embed.poolers.last_token import LastTokenPooler as JaxPooler
    from distllm_tpu.embed.poolers.last_token import LastTokenPoolerConfig as JaxPoolerConfig
    from distllm_tpu_torch.embed.encoders.auto import AutoEncoder, AutoEncoderConfig
    from distllm_tpu_torch.embed.poolers.last_token import LastTokenPooler, LastTokenPoolerConfig

    root = _write_checkpoint(tmp_path, family)
    kw = dict(pretrained_model_name_or_path=str(root), half_precision=False)
    jax_enc = JaxAutoEncoder(JaxAutoConfig(**kw))
    port_enc = AutoEncoder(AutoEncoderConfig(**kw), device='cpu')
    assert type(port_enc.model_cfg) is decoder_family(family)[0]
    texts = ['w1 w2 w3 w4 w5 w6 w7 w8', 'w9 w10', 'w11 w12 w13 w14 w15 w16 w17 w18 w19 w20 w21']
    batch = port_enc.tokenizer(texts)
    jbatch = jax_enc.tokenizer(texts)
    np.testing.assert_array_equal(batch.input_ids, jbatch.input_ids)
    got = port_enc.pooled_forward(LastTokenPooler(LastTokenPoolerConfig()))(batch)
    jax_fn = jax_enc.pooled_forward(JaxPooler(JaxPoolerConfig()))
    want = np.asarray(jax_fn(jbatch))
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_auto_encoder_refuses_unported_families(tmp_path):
    from distllm_tpu.embed.encoders.auto import AutoEncoder as JaxAutoEncoder
    from distllm_tpu.embed.encoders.auto import AutoEncoderConfig as JaxAutoConfig
    from distllm_tpu.embed.poolers.last_token import LastTokenPooler as JaxPooler
    from distllm_tpu.embed.poolers.last_token import LastTokenPoolerConfig as JaxPoolerConfig
    from distllm_tpu_torch.embed.encoders.auto import AutoEncoder, AutoEncoderConfig
    from distllm_tpu_torch.embed.poolers.last_token import LastTokenPooler, LastTokenPoolerConfig
    from tests.test_torch_mixtral import write_numpy_checkpoint

    # ESM-2 and ModernBERT checkpoints are served since the protein slice
    # (tests/test_torch_embed_strategies.py holds them against JAX), and
    # Mixtral since its slice (A10a): its last-token embeddings are JAX's.
    root = write_numpy_checkpoint(tmp_path / 'mixtral', seed=3)
    kw = dict(pretrained_model_name_or_path=str(root), half_precision=False)
    port_enc = AutoEncoder(AutoEncoderConfig(**kw), device='cpu')
    jax_enc = JaxAutoEncoder(JaxAutoConfig(**kw))
    assert type(port_enc.model_cfg) is mixtral.MixtralConfig
    texts = ['w1 w2 w3 w4 w5', 'w6 w7', 'w8 w9 w10 w11 w12 w13 w14']
    got = port_enc.pooled_forward(LastTokenPooler(LastTokenPoolerConfig()))(
        port_enc.tokenizer(texts))
    want = jax_enc.pooled_forward(JaxPooler(JaxPoolerConfig()))(jax_enc.tokenizer(texts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    for model_type, err, match in (
        ('nonsense', ValueError, 'Unsupported decoder model_type'),
    ):
        (tmp_path / 'config.json').write_text(json.dumps({'model_type': model_type}))
        with pytest.raises(err, match=match):
            AutoEncoder(AutoEncoderConfig(pretrained_model_name_or_path=str(tmp_path)),
                        device='cpu')
