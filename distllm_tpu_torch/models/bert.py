"""BERT-family encoder (PubMedBERT / S-PubMedBert-MS-MARCO class models),
the PyTorch counterpart of ``distllm_tpu.models.bert``.

Parameters are a plain dict shaped like the JAX pytree: per-layer weights
stacked on a leading ``L`` axis, kernels laid out ``[in, out]``::

    {'embeddings': {'word': [V, H], 'position': [P, H], 'token_type': [T, H],
                    'ln': {'scale': [H], 'bias': [H]}},
     'layers': {'q'|'k'|'v'|'o'|'up'|'down': {'kernel': [L, in, out],
                                              'bias': [L, out]},
                'attn_ln'|'mlp_ln': {'scale': [L, H], 'bias': [L, H]}}}

Embeddings and LayerNorm parameters stay fp32, as the JAX forward reads
them; the dense kernels and biases are held in the model dtype. The JAX
code casts its fp32 weights to the activation dtype at each use; casting
once at load gives the same values. Dense products are ``torch.matmul``
(the JAX package leaves them to XLA); attention goes through
``common.encoder_attend`` (``attn_impl``: ``'auto'``, ``'reference'``,
``'xla'``) to ``ops.encoder_attention`` — the CUDA kernel for CUDA
tensors, its plain version for CPU tensors. A dense kernel may be an
int8-quantized ``QTensor`` (``TorchEncoder(quantization='int8')``);
``common.dense`` then sends it through kernel K2
(``ops.quantized_matmul``).
"""

from __future__ import annotations

import dataclasses

import torch

from distllm_tpu_torch.models import common
from distllm_tpu_torch.parallel.sharding import P
from distllm_tpu_torch.utils import BaseConfig, torch_dtype

_DENSE = ('q', 'k', 'v', 'o', 'up', 'down')
_NORMS = ('attn_ln', 'mlp_ln')


@dataclasses.dataclass
class BertConfig(BaseConfig):
    """Encoder geometry; the defaults are BERT-base (PubMedBERT widths),
    as in the JAX ``BertConfig``."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = 'gelu'
    dtype: str = 'bfloat16'

    # Not a field: the rank's tensor-parallel collectives on a copy bound
    # to a mesh (``parallel.comm.bind``, ``TorchEncoder.shard``); None runs
    # the whole model.
    tp = None

    def validate(self) -> None:
        if self.hidden_size % self.num_heads:
            raise ValueError('hidden_size must be a multiple of num_heads')
        if self.hidden_act not in common.ACTIVATIONS:
            raise ValueError(
                f'hidden_act must be one of {sorted(common.ACTIVATIONS)}, '
                f'got {self.hidden_act!r}'
            )
        torch_dtype(self.dtype)

    @classmethod
    def from_hf_config(cls, hf: dict) -> 'BertConfig':
        return cls(
            vocab_size=hf['vocab_size'],
            hidden_size=hf['hidden_size'],
            num_layers=hf['num_hidden_layers'],
            num_heads=hf['num_attention_heads'],
            intermediate_size=hf['intermediate_size'],
            max_position_embeddings=hf.get('max_position_embeddings', 512),
            type_vocab_size=hf.get('type_vocab_size', 2),
            layer_norm_eps=hf.get('layer_norm_eps', 1e-12),
            hidden_act=hf.get('hidden_act', 'gelu'),
        )


def _shapes(cfg: BertConfig) -> dict:
    """The parameter tree's shapes for ``cfg``."""
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    dense = {
        'q': (h, h), 'k': (h, h), 'v': (h, h), 'o': (h, h),
        'up': (h, i), 'down': (i, h),
    }
    layers = {
        name: {'kernel': (L, *shape), 'bias': (L, shape[1])}
        for name, shape in dense.items()
    }
    for name in _NORMS:
        layers[name] = {'scale': (L, h), 'bias': (L, h)}
    return {
        'embeddings': {
            'word': (cfg.vocab_size, h),
            'position': (cfg.max_position_embeddings, h),
            'token_type': (cfg.type_vocab_size, h),
            'ln': {'scale': (h,), 'bias': (h,)},
        },
        'layers': layers,
    }


def _in_model_dtype(path: tuple) -> bool:
    """Dense kernels and biases are held in the model dtype."""
    return path[0] == 'layers' and path[1] in _DENSE


def init(
    cfg: BertConfig,
    generator: 'torch.Generator | None' = None,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """Random weights made on ``device`` (``None`` = CUDA; raises without
    it): normal with std 0.02 for embeddings and kernels, zero biases,
    LayerNorm scales at 1 — the JAX ``init``'s distribution, not its
    numbers. ``generator`` must live on ``device``; ``None`` seeds a fresh
    one with 0."""
    return common.init_tree(
        _shapes(cfg), _in_model_dtype, generator, device, dtype or cfg.dtype
    )


def params_from_jax(
    tree: dict,
    cfg: BertConfig,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """The weight bridge: a ``distllm_tpu.models.bert`` param tree (stacked
    layers) whose leaves the caller turned into numpy arrays, as the port's
    parameters on ``device`` (``None`` = CUDA). A quantized JAX leaf keeps
    its codes and fp32 scales. Raises ``ValueError`` when the tree does not
    match ``cfg``."""
    return common.place_tree(
        tree, _shapes(cfg), _in_model_dtype, device, dtype or cfg.dtype, 'bert'
    )


def param_specs(cfg: BertConfig, params: dict | None = None) -> dict:
    """Megatron-style tensor parallelism over the ``model`` axis, leaf for
    leaf the JAX ``param_specs``: ``q``/``k``/``v`` and ``up``
    column-parallel with their biases, ``o`` and ``down`` row-parallel
    (their biases replicated, added after the sum), the embeddings and
    norms replicated; the layer-stack axis unsharded."""
    col = {'kernel': P(None, None, 'model'), 'bias': P(None, 'model')}
    row = {'kernel': P(None, 'model', None), 'bias': P(None)}
    ln = {'scale': P(None), 'bias': P(None)}
    return {
        'embeddings': {
            'word': P(None, None),
            'position': P(None, None),
            'token_type': P(None, None),
            'ln': {'scale': P(), 'bias': P()},
        },
        'layers': {
            'q': dict(col),
            'k': dict(col),
            'v': dict(col),
            'o': dict(row),
            'attn_ln': dict(ln),
            'up': dict(col),
            'down': dict(row),
            'mlp_ln': dict(ln),
        },
    }


def params_from_hf(
    state: dict,
    cfg: BertConfig,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """Convert an HF ``BertModel`` state dict (tensors or numpy arrays;
    an optional ``bert.`` prefix) to the port's parameters, with the JAX
    ``params_from_hf`` mapping: Linear ``[out, in]`` weights transposed to
    ``[in, out]``, per-layer weights stacked."""
    sd = {
        key.removeprefix('bert.'): torch.as_tensor(value).float()
        for key, value in state.items()
    }
    hf_names = {
        'q': 'attention.self.query',
        'k': 'attention.self.key',
        'v': 'attention.self.value',
        'o': 'attention.output.dense',
        'up': 'intermediate.dense',
        'down': 'output.dense',
        'attn_ln': 'attention.output.LayerNorm',
        'mlp_ln': 'output.LayerNorm',
    }

    def stacked(name, leaf):
        per_layer = []
        for li in range(cfg.num_layers):
            value = sd[f'encoder.layer.{li}.{hf_names[name]}.{leaf}']
            per_layer.append(value.T if leaf == 'weight' and name in _DENSE else value)
        return torch.stack(per_layer)

    layers = {}
    for name in _DENSE:
        layers[name] = {'kernel': stacked(name, 'weight'), 'bias': stacked(name, 'bias')}
    for name in _NORMS:
        layers[name] = {'scale': stacked(name, 'weight'), 'bias': stacked(name, 'bias')}
    tree = {
        'embeddings': {
            'word': sd['embeddings.word_embeddings.weight'],
            'position': sd['embeddings.position_embeddings.weight'],
            'token_type': sd['embeddings.token_type_embeddings.weight'],
            'ln': {
                'scale': sd['embeddings.LayerNorm.weight'],
                'bias': sd['embeddings.LayerNorm.bias'],
            },
        },
        'layers': layers,
    }
    return common.place_tree(
        tree, _shapes(cfg), _in_model_dtype, device, dtype or cfg.dtype, 'bert'
    )


def apply(
    params: dict,
    cfg: BertConfig,
    input_ids: torch.Tensor,  # [B, S] int
    attention_mask: torch.Tensor,  # [B, S] int, nonzero = valid
    attn_impl: str = 'auto',
) -> torch.Tensor:
    """Forward pass: ``[B, S]`` ids/mask -> ``[B, S, H]`` last hidden
    states in the model dtype, with the JAX ``bert.apply`` numerics:
    word + position + token_type[0] embeddings and their LayerNorm in
    fp32, then a cast; post-LN residuals, each LayerNorm's statistics in
    fp32; exact-erf GELU (``hidden_act='gelu'``). Under a config bound to
    a mesh (``TorchEncoder.shard``) the rank's slices run its heads and
    width, and ``o`` / ``down`` sum over the ``model`` group."""
    common.check_attn_impl(attn_impl)
    dtype = torch_dtype(cfg.dtype)
    act = common.ACTIVATIONS[cfg.hidden_act]
    emb = params['embeddings']
    layers = params['layers']
    seq_len = input_ids.shape[1]
    eps = cfg.layer_norm_eps

    x = (
        emb['word'][input_ids.long()]
        + emb['position'][None, :seq_len]
        + emb['token_type'][0][None, None, :]
    )
    x = common.layer_norm(x, emb['ln']['scale'], emb['ln']['bias'], eps).to(dtype)

    def dense(h, name, li):
        return common.dense(h, layers[name]['kernel'][li], layers[name]['bias'][li])

    def row(h, name, li):
        return common.row_dense(h, layers[name]['kernel'][li], layers[name]['bias'][li], cfg.tp)

    def norm(h, name, li):
        ln = layers[name]
        return common.layer_norm(h, ln['scale'][li], ln['bias'][li], eps).to(dtype)

    heads = common.rank_heads(cfg)
    for li in range(cfg.num_layers):
        q, k, v = dense(x, 'q', li), dense(x, 'k', li), dense(x, 'v', li)
        # Heads stay packed in the last dim: no transpose materialises.
        attn = common.encoder_attend(q, k, v, attention_mask, heads, attn_impl)
        attn = row(attn, 'o', li)
        # Post-LN residual (BERT): LN(x + sublayer(x)), statistics in fp32.
        x = norm((x + attn).float(), 'attn_ln', li)
        mlp = row(act(dense(x, 'up', li)), 'down', li)
        x = norm((x + mlp).float(), 'mlp_ln', li)
    return x
