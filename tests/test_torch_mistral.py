"""The port's Mistral serving paths against the JAX package's.

Weights come from ``distllm_tpu.models.mistral.init(PRNGKey(0), cfg)`` at
the tiny fp32 config of ``tests/test_ragged_attention.py`` (vocab 128,
hidden 32, 2 layers, 4/2 heads, intermediate 64) and cross the weight
bridge (``params_from_jax``) as numpy arrays. ``prefill_paged`` logits
and pools, ``decode_step`` logits and pools are allclose (fp32, ``atol
1e-5``: same math, PyTorch vs XLA summation order); ``decode_loop``
greedy tokens are identical. Pools are compared outside the trash block
0, whose pad writes race on duplicate indices on both sides. Every check
runs twice: on the plain config, and with Q/K/V biases, tied embeddings,
a sliding window of 4 and linear RoPE scaling switched on together.

int8 weights: a JAX tree quantized by ``distllm_tpu.ops.quantization``
crosses the bridge with its codes and scales as they are, and the port's
``prefill_paged`` / ``decode_step`` logits match the JAX forward with
``qmm_backend='xla'`` and ``'interpret'`` (the Pallas kernel) within the
same fp32 tolerance, at widths where every projection is quantized and
K, N are multiples of 128 (the Pallas tier's tile contract).

int8 KV: ``QuantizedKV`` pools through ``prefill_paged`` and
``decode_step`` give the JAX logits and the JAX pools' codes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu.ops import paged_attention as jpa
from distllm_tpu.ops import quantization as jq
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.ops import paged_attention as tpa
from distllm_tpu_torch.ops import quantization as tq
from distllm_tpu_torch.ops import quantized_matmul as tqm

ATOL = 1e-5
RTOL = 1e-4
NUM_BLOCKS, BLOCK_SIZE, MAX_BLOCKS = 24, 4, 8


TINY = {
    'vocab_size': 128, 'hidden_size': 32, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 64, 'dtype': 'float32',
}
VARIANT = {
    'attention_bias': True, 'tie_word_embeddings': True, 'sliding_window': 4,
    'rope_scaling': {'rope_type': 'linear', 'factor': 2.0},
}


@pytest.fixture(scope='module', params=['plain', 'variant'])
def models(request):
    extra = VARIANT if request.param == 'variant' else {}
    jcfg = jax_mistral.MistralConfig(**TINY, **extra)
    tree = jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(0), jcfg))
    tcfg = mistral.MistralConfig(**TINY, **extra)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    return jcfg, tree, tcfg, params


def _pools(cfg=None):
    nkv, hd = (2, 8) if cfg is None else (cfg.num_kv_heads, cfg.head_size)
    shape = (2, NUM_BLOCKS, BLOCK_SIZE, nkv, hd)
    return (
        (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)),
        (torch.zeros(shape), torch.zeros(shape)),
    )


def _close(torch_value, jax_value):
    np.testing.assert_allclose(
        torch_value.numpy(), np.asarray(jax_value), atol=ATOL, rtol=RTOL
    )


def _tables():
    rng = np.random.default_rng(0)
    rows = [rng.permutation(np.arange(1, NUM_BLOCKS))[:MAX_BLOCKS] for _ in range(2)]
    return np.stack(rows).astype(np.int32)


def _prefill(models, jpools, tpools, ids, pos, bt, ctx, tails):
    jcfg, tree, tcfg, params = models
    jl, jk, jv = jax_mistral.prefill_paged(
        tree, jcfg, jnp.asarray(ids), jnp.asarray(pos), *jpools,
        jnp.asarray(bt), jnp.asarray(ctx), jnp.asarray(tails),
        max_table_positions=64,
    )
    tl, tk, tv = mistral.prefill_paged(
        params, tcfg, *(torch.from_numpy(x) for x in (ids, pos)), *tpools,
        *(torch.from_numpy(x) for x in (bt, ctx, tails)),
        max_table_positions=64,
    )
    return (jl, (jk, jv)), (tl, (tk, tv))


def _prefill_two_chunks(models):
    """Row 0 prefills 9 tokens in two chunks (5 then 4 over the cached
    prefix); row 1 prefills 3 then 6 — the ragged span path both times."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(4, 128, size=(2, 9)).astype(np.int32)
    bt = _tables()
    jpools, tpools = _pools(models[2])
    outs = []
    for starts, lens in (([0, 0], [5, 3]), ([5, 3], [4, 6])):
        starts, lens = np.asarray(starts), np.asarray(lens)
        width = int(lens.max())
        ids = np.zeros((2, width), np.int32)
        pos = np.zeros((2, width), np.int32)
        for r in range(2):
            ids[r, :lens[r]] = tokens[r, starts[r]:starts[r] + lens[r]]
            pos[r] = np.minimum(starts[r] + np.arange(width), 63)
        ctx = (starts + lens).astype(np.int32)
        (jl, jpools), (tl, tpools) = _prefill(
            models, jpools, tpools, ids, pos, bt, ctx, lens.astype(np.int32)
        )
        outs.append((jl, tl))
    return tokens, bt, jpools, tpools, outs


def test_prefill_paged_logits_and_pools(models):
    _, _, jpools, tpools, outs = _prefill_two_chunks(models)
    for jl, tl in outs:
        _close(tl, jl)
    for tp, jp in zip(tpools, jpools, strict=True):
        _close(tp[:, 1:], jp[:, 1:])


def test_decode_step_logits_and_pools(models):
    jcfg, tree, tcfg, params = models
    _, bt, jpools, tpools, _ = _prefill_two_chunks(models)
    ids = np.asarray([17, 42], np.int32)
    pos = np.asarray([9, 9], np.int32)
    ctx = pos + 1
    jl, jk, jv = jax_mistral.decode_step(
        tree, jcfg, jnp.asarray(ids), jnp.asarray(pos), *jpools,
        jnp.asarray(bt), jnp.asarray(ctx),
    )
    tl, tk, tv = mistral.decode_step(
        params, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), *tpools,
        torch.from_numpy(bt), torch.from_numpy(ctx),
    )
    _close(tl, jl)
    _close(tk[:, 1:], jk[:, 1:])
    _close(tv[:, 1:], jv[:, 1:])


def test_decode_loop_greedy_tokens_identical(models):
    """Greedy decode windows give identical tokens, with one row running
    out of budget mid-window (its writes route to the trash block)."""
    jcfg, tree, tcfg, params = models
    tokens, bt, jpools, tpools, _ = _prefill_two_chunks(models)
    ids = tokens[:, -1].copy()
    pos = np.asarray([8, 8], np.int32)
    ctx = pos + 1
    steps_left = np.asarray([6, 3], np.int32)
    zeros_f, ones_f = np.zeros(2, np.float32), np.ones(2, np.float32)
    zeros_i = np.zeros(2, np.int32)
    seeds = np.asarray([11, 12], np.uint32)
    jt, *_ = jax_mistral.decode_loop(
        tree, jcfg, jnp.asarray(ids), jnp.asarray(pos), *jpools,
        jnp.asarray(bt), jnp.asarray(ctx), jnp.asarray(steps_left),
        jnp.asarray(zeros_f), jnp.asarray(ones_f), jnp.asarray(zeros_f),
        jnp.asarray(zeros_i), jnp.asarray(seeds), num_steps=6,
        max_table_positions=64,
    )
    tt, *_ = mistral.decode_loop(
        params, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), *tpools,
        torch.from_numpy(bt), torch.from_numpy(ctx),
        torch.from_numpy(steps_left), torch.from_numpy(zeros_f),
        torch.from_numpy(ones_f), torch.from_numpy(zeros_f),
        torch.from_numpy(zeros_i), torch.from_numpy(seeds.astype(np.int64)),
        num_steps=6, max_table_positions=64,
    )
    jt = np.asarray(jt)
    tt = tt.numpy()
    assert tt.shape == jt.shape == (6, 2)
    # Live steps only: row 1's tokens past its 3-step budget are garbage
    # on both sides.
    for row, steps in enumerate(steps_left):
        np.testing.assert_array_equal(tt[:steps, row], jt[:steps, row])


@pytest.mark.parametrize('scaling', [
    None,
    {'rope_type': 'linear', 'factor': 4.0},
    {'rope_type': 'llama3', 'factor': 8.0, 'low_freq_factor': 1.0,
     'high_freq_factor': 4.0, 'original_max_position_embeddings': 64},
])
def test_rope_tables_match_jax(scaling):
    from distllm_tpu.models import common as jax_common
    from distllm_tpu_torch.models import common

    for ours, ref in zip(
        common.rope_frequencies(16, 300, 10000.0, scaling),
        jax_common.rope_frequencies(16, 300, 10000.0, scaling),
        strict=True,
    ):
        np.testing.assert_array_equal(ours, ref)


def test_bridge_rejects_a_mismatched_tree(models):
    _, tree, tcfg, _ = models
    with pytest.raises(ValueError, match='does not match'):
        mistral.params_from_jax(
            tree, dataclasses.replace(tcfg, hidden_size=64, intermediate_size=64),
            device='cpu',
        )
    with pytest.raises(ValueError, match='missing'):
        mistral.params_from_jax({'embed': tree['embed']}, tcfg, device='cpu')


def test_init_is_seeded_and_full_shape():
    cfg = mistral.MistralConfig(
        vocab_size=64, hidden_size=16, num_layers=3, num_heads=4,
        num_kv_heads=2, intermediate_size=24, dtype='float32',
        attention_bias=True,
    )
    a = mistral.init(cfg, torch.Generator().manual_seed(5), device='cpu')
    b = mistral.init(cfg, torch.Generator().manual_seed(5), device='cpu')
    assert a['layers']['gate']['kernel'].shape == (3, 16, 24)
    assert a['layers']['k']['kernel'].shape == (3, 16, 8)
    assert a['lm_head'].shape == (16, 64)
    assert a['layers']['v']['bias'].shape == (3, 8)
    torch.testing.assert_close(a['layers']['q']['kernel'], b['layers']['q']['kernel'])


# ------------------------------------------------------------ int8 weights
QUANT = {
    'vocab_size': 128, 'hidden_size': 128, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 4, 'intermediate_size': 256, 'dtype': 'float32',
}


@pytest.fixture(scope='module', params=['xla', 'interpret'])
def quantized_models(request):
    """An int8 JAX tree (every projection quantized) served by JAX with
    the given quantized-matmul tier, and its bridge to the port."""
    jcfg = jax_mistral.MistralConfig(**QUANT, qmm_backend=request.param)
    jtree = jq.quantize_pytree(
        jax_mistral.init(jax.random.PRNGKey(2), jcfg), mode='int8', out_dtype='float32'
    )
    tcfg = mistral.MistralConfig(**QUANT)
    params = mistral.params_from_jax(jax.tree.map(np.asarray, jtree), tcfg, device='cpu')
    return jcfg, jtree, tcfg, params


def test_bridge_keeps_int8_codes_and_fp32_scales(quantized_models):
    _, jtree, _, params = quantized_models
    for name in ('q', 'k', 'v', 'o', 'gate', 'up', 'down'):
        leaf, ref = params['layers'][name]['kernel'], jtree['layers'][name]['kernel']
        assert isinstance(leaf, tq.QTensor) and leaf.kind == 'int8'
        assert leaf.q.dtype == torch.int8 and leaf.scale.dtype == torch.float32
        np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(ref.q))
        np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(ref.scale))
    assert params['embed'].dtype == torch.float32  # exempt leaves stay float


def test_int8_prefill_and_decode_logits_match_jax(quantized_models):
    jcfg, jtree, tcfg, params = quantized_models
    plain = tqm.int8_matmul_reference.launches
    _, bt, jpools, tpools, outs = _prefill_two_chunks((jcfg, jtree, tcfg, params))
    for jl, tl in outs:
        _close(tl, jl)
    ids = np.asarray([17, 42], np.int32)
    pos = np.asarray([9, 9], np.int32)
    jl, *_ = jax_mistral.decode_step(
        jtree, jcfg, jnp.asarray(ids), jnp.asarray(pos), *jpools,
        jnp.asarray(bt), jnp.asarray(pos + 1),
    )
    tl, *_ = mistral.decode_step(
        params, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), *tpools,
        torch.from_numpy(bt), torch.from_numpy(pos + 1),
    )
    _close(tl, jl)
    # 7 int8 products per layer per forward pass (lm_head stays float):
    # two prefill chunks and one decode step, all on the CPU plain version.
    assert tqm.int8_matmul_reference.launches - plain == 7 * QUANT['num_layers'] * 3


def _int8_pools(cfg):
    shape = (2, NUM_BLOCKS, BLOCK_SIZE, cfg.num_kv_heads, cfg.head_size)
    scale_shape = shape[:2] + shape[3:4]

    def jax_pool():
        return jpa.QuantizedKV(
            jnp.zeros(shape, jnp.int8), jnp.zeros(scale_shape, jnp.float32)
        )

    def port_pool():
        return tpa.QuantizedKV(
            torch.zeros(shape, dtype=torch.int8), torch.zeros(scale_shape)
        )

    return (jax_pool(), jax_pool()), (port_pool(), port_pool())


def test_int8_pools_through_prefill_and_decode(models):
    """int8 KV pools (``QuantizedKV`` with a leading layer axis) through
    two ragged prefill chunks (fresh spans, then spans landing mid-block)
    and a decode step: each layer's slice carries its data and scales
    together (``_kv_layer``), logits match the JAX paths within the fp32
    tolerance. The codes equal the JAX pools' bitwise; the scales are
    absmax / 127 of fp32 K/V that the two frameworks compute in different
    summation orders, so they agree to the fp32 tolerance (bitwise on the
    same fp32 inputs: tests/test_torch_kv_quant.py)."""
    jcfg, tree, tcfg, params = models
    rng = np.random.default_rng(1)
    tokens = rng.integers(4, 128, size=(2, 9)).astype(np.int32)
    bt = _tables()
    jpools, tpools = _int8_pools(tcfg)
    for starts, lens in (([0, 0], [5, 3]), ([5, 3], [4, 6])):
        starts, lens = np.asarray(starts), np.asarray(lens)
        width = int(lens.max())
        ids = np.zeros((2, width), np.int32)
        pos = np.zeros((2, width), np.int32)
        for r in range(2):
            ids[r, :lens[r]] = tokens[r, starts[r]:starts[r] + lens[r]]
            pos[r] = np.minimum(starts[r] + np.arange(width), 63)
        ctx = (starts + lens).astype(np.int32)
        (jl, jpools), (tl, tpools) = _prefill(
            models, jpools, tpools, ids, pos, bt, ctx, lens.astype(np.int32)
        )
        _close(tl, jl)
    ids = np.asarray([17, 42], np.int32)
    pos = np.asarray([9, 9], np.int32)
    jl, jk, jv = jax_mistral.decode_step(
        tree, jcfg, jnp.asarray(ids), jnp.asarray(pos), *jpools,
        jnp.asarray(bt), jnp.asarray(pos + 1),
    )
    tl, tk, tv = mistral.decode_step(
        params, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), *tpools,
        torch.from_numpy(bt), torch.from_numpy(pos + 1),
    )
    _close(tl, jl)
    for port, jax_pool in ((tk, jk), (tv, jv)):
        assert port is tpools[0] or port is tpools[1]  # written in place
        np.testing.assert_array_equal(
            port.data.numpy()[:, 1:], np.asarray(jax_pool.data)[:, 1:]
        )
        np.testing.assert_allclose(
            port.scale.numpy()[:, 1:], np.asarray(jax_pool.scale)[:, 1:], rtol=RTOL
        )
