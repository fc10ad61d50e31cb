"""The port's weight-only quantizers against the JAX package's.

Weights are made with numpy from a seed and handed to both sides. The
int8 and nf4 codes and scales must be bitwise equal
(``distllm_tpu.ops.quantization`` quantizes in numpy, the port in PyTorch
with the same fp32 arithmetic), and so must ``dequantize``. The
quantize-or-pass-through policy must pick the same leaves of a Mistral and
a BERT tree, at widths where every projection is large enough to be
quantized.
"""

import jax
import numpy as np
import pytest
import torch

from distllm_tpu.models import bert as jax_bert
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu.ops import quantization as jq
from distllm_tpu_torch.models import bert, mistral
from distllm_tpu_torch.ops import quantization as tq

MISTRAL_Q = {
    'vocab_size': 128, 'hidden_size': 64, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 128, 'dtype': 'float32',
}
BERT_Q = dict(
    vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128, max_position_embeddings=64, dtype='float32',
)


def _weights(seed, shape, zero_column=False):
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if zero_column:
        w[..., 5] = 0.0  # an all-zero output channel: scale 1, codes 0
    return w


def _same(port: tq.QTensor, ref: jq.QTensor):
    assert port.kind == ref.kind and port.shape == tuple(ref.shape)
    assert port.block_size == ref.block_size
    q, s = np.asarray(ref.q), np.asarray(ref.scale)
    assert port.q.dtype == {np.int8: torch.int8, np.uint8: torch.uint8}[q.dtype.type]
    assert port.scale.dtype == torch.float32
    np.testing.assert_array_equal(port.q.numpy(), q)
    np.testing.assert_array_equal(port.scale.numpy(), s)


INT8_CASES = [
    ('2d', (96, 80), False),
    ('stacked', (3, 64, 48), False),
    ('zero_column', (64, 32), True),
    ('stacked_zero_column', (2, 32, 16), True),
]


@pytest.mark.parametrize('name,shape,zero', INT8_CASES, ids=[c[0] for c in INT8_CASES])
def test_int8_codes_and_scales_bitwise_equal_to_jax(name, shape, zero):
    w = _weights(1, shape, zero)
    ref = jq.quantize_int8(w, 'float32')
    port = tq.quantize_int8(torch.from_numpy(w), 'float32')
    _same(port, ref)
    if zero:
        assert (port.scale[..., 5] == 1.0).all() and (port.q[..., 5] == 0).all()
    np.testing.assert_array_equal(port.dequantize().numpy(), np.asarray(ref.dequantize()))


def test_int8_of_bf16_weights_equals_jax_on_the_widened_values():
    """The card quantizes bf16 weights: the codes are those of their exact
    fp32 values."""
    w = torch.from_numpy(_weights(2, (2, 64, 32))).bfloat16()
    ref = jq.quantize_int8(w.float().numpy(), 'bfloat16')
    port = tq.quantize_int8(w, 'bfloat16')
    _same(port, ref)
    np.testing.assert_array_equal(
        port.dequantize().float().numpy(),
        np.asarray(ref.dequantize()).astype(np.float32),
    )


NF4_CASES = [
    ('2d', (32, 64), 64),
    ('stacked', (3, 16, 32), 64),
    ('partial_tail_block', (10, 7), 64),  # 70 weights: one full, one 6-wide block
    ('stacked_partial', (2, 9, 5), 16),
    ('zero_column', (16, 8), 32),
]


@pytest.mark.parametrize('name,shape,block', NF4_CASES, ids=[c[0] for c in NF4_CASES])
@pytest.mark.parametrize('out_dtype', ['float32', 'bfloat16'])
def test_nf4_codes_scales_and_dequantize_bitwise_equal_to_jax(name, shape, block, out_dtype):
    w = _weights(3, shape, zero_column=name == 'zero_column')
    ref = jq.quantize_nf4(w, block, out_dtype)
    port = tq.quantize_nf4(torch.from_numpy(w), block, out_dtype)
    _same(port, ref)
    got = port.dequantize()
    assert got.shape == shape and got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(ref.dequantize()).astype(np.float32)
    )


def test_nf4_zero_weights_restore_exactly():
    port = tq.quantize_nf4(torch.zeros((8, 8)), 64, 'float32')
    assert (port.dequantize() == 0).all()


@pytest.mark.parametrize('mode', ['int8', 'nf4'])
def test_layer_index_slices_codes_and_scales_together(mode):
    """``qt[li]`` is the port's counterpart of a scan slicing a stacked
    leaf: it dequantizes to layer ``li`` of the whole leaf."""
    w = torch.from_numpy(_weights(4, (3, 32, 48)))
    qt = tq.quantize_int8(w, 'float32') if mode == 'int8' else tq.quantize_nf4(w, 64, 'float32')
    whole = qt.dequantize()
    for li in range(3):
        layer = qt[li]
        assert layer.shape == (32, 48)
        if mode == 'int8':
            assert layer.q.shape == (32, 48) and layer.scale.shape == (1, 48)
        torch.testing.assert_close(layer.dequantize(), whole[li], rtol=0, atol=0)
    with pytest.raises(IndexError):
        qt[0][0]


def _jax_tree_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jq.QTensor)
    )
    return {
        '/'.join(str(getattr(k, 'key', k)) for k in path): leaf for path, leaf in flat
    }


def _port_tree_paths(tree, prefix=''):
    out = {}
    for key, value in tree.items():
        path = f'{prefix}/{key}' if prefix else key
        if isinstance(value, dict):
            out.update(_port_tree_paths(value, path))
        else:
            out[path] = value
    return out


def _trees(family):
    if family == 'mistral':
        jcfg = jax_mistral.MistralConfig(**MISTRAL_Q)
        tree = jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(0), jcfg))
        params = mistral.params_from_jax(tree, mistral.MistralConfig(**MISTRAL_Q), device='cpu')
        expected = {f'layers/{n}/kernel' for n in ('q', 'k', 'v', 'o', 'gate', 'up', 'down')}
    else:
        jcfg = jax_bert.BertConfig(**BERT_Q)
        tree = jax.tree.map(np.asarray, jax_bert.init(jax.random.PRNGKey(1), jcfg))
        params = bert.params_from_jax(tree, bert.BertConfig(**BERT_Q), device='cpu')
        expected = {f'layers/{n}/kernel' for n in ('q', 'k', 'v', 'o', 'up', 'down')}
    return tree, params, expected


@pytest.mark.parametrize('family', ['mistral', 'bert'])
@pytest.mark.parametrize('mode', ['int8', 'nf4'])
def test_quantize_pytree_picks_the_same_leaves_and_codes(family, mode):
    tree, params, expected = _trees(family)
    ref = _jax_tree_paths(jq.quantize_pytree(tree, mode=mode, out_dtype='float32'))
    port = _port_tree_paths(tq.quantize_pytree(params, mode=mode, out_dtype='float32'))
    assert set(port) == set(ref)
    quantized = {p for p, leaf in port.items() if isinstance(leaf, tq.QTensor)}
    assert quantized == {p for p, leaf in ref.items() if isinstance(leaf, jq.QTensor)}
    assert quantized == expected
    for path in quantized:
        _same(port[path], ref[path])
    # Embeddings, norms, biases and the head stay float, untouched.
    for path in set(port) - quantized:
        np.testing.assert_array_equal(port[path].numpy(), np.asarray(ref[path]))
    assert tq.quantized_nbytes(tq.quantize_pytree(params, mode=mode)) == jq.quantized_nbytes(
        jq.quantize_pytree(tree, mode=mode)
    )


def test_quantized_nbytes_and_dequantize_pytree():
    tree, params, _ = _trees('mistral')
    qparams = tq.quantize_pytree(params, mode='int8', out_dtype='float32')
    q_bytes, f_bytes = tq.quantized_nbytes(qparams)
    assert (q_bytes, f_bytes) == jq.quantized_nbytes(
        jq.quantize_pytree(tree, mode='int8', out_dtype='float32')
    )
    # int8 codes (1 byte) + one fp32 scale per (layer, channel).
    L, h, i = 2, 64, 128
    kv = 2 * 16
    weights = L * (h * h * 2 + h * kv * 2 + 3 * h * i)
    scales = L * (h + kv + kv + h + i + i + h) * 4
    assert q_bytes == weights + scales
    assert tq.quantized_nbytes(params) == (0, sum(
        t.numel() * 4 for t in _port_tree_paths(params).values()
    ))
    restored = tq.dequantize_pytree(qparams)
    for path, leaf in _port_tree_paths(restored).items():
        assert isinstance(leaf, torch.Tensor)
        assert leaf.shape == _port_tree_paths(params)[path].shape


def test_delete_source_drops_the_callers_float_leaves():
    _, params, expected = _trees('mistral')
    out = tq.quantize_pytree(params, mode='int8', delete_source=True)
    flat = _port_tree_paths(params)
    assert {p for p, leaf in flat.items() if leaf is None} == expected
    assert all(isinstance(_port_tree_paths(out)[p], tq.QTensor) for p in expected)
    # Already quantized leaves pass through a second quantization.
    again = tq.quantize_pytree(out, mode='nf4')
    assert all(_port_tree_paths(again)[p] is _port_tree_paths(out)[p] for p in expected)


def test_normalize_mode():
    for value in (True, False, None, '', 'int8', 'nf4'):
        assert tq.normalize_mode(value) == jq.normalize_mode(value)
    with pytest.raises(ValueError, match='unknown quantization mode'):
        tq.normalize_mode('int4')
    with pytest.raises(ValueError, match='unknown quantization mode'):
        tq.quantize_pytree({}, mode='fp8')


def test_should_quantize_matches_the_jax_gate():
    cases = [
        (('layers', 'q', 'kernel'), (2, 64, 64)),
        (('layers', 'q', 'bias'), (2, 4096)),
        (('embed',), (128, 64)),
        (('lm_head',), (64, 128)),
        (('layers', 'attn_ln', 'scale'), (2, 4096)),
        (('layers', 'up', 'kernel'), (2, 16, 16)),  # below min_size
        (('w',), (4096,)),  # 1-D
        (('moe', 'router'), (64, 128)),
    ]
    for path, shape in cases:
        leaf = np.zeros(shape, np.float32)
        jpath = tuple(jax.tree_util.DictKey(k) for k in path)
        assert tq.should_quantize(path, torch.from_numpy(leaf), 4096) == jq._should_quantize(
            jpath, leaf, 4096
        ), path
    assert not tq.should_quantize(('w',), torch.zeros((64, 64), dtype=torch.int32), 16)
