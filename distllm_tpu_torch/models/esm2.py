"""ESM-2 protein language model, the PyTorch counterpart of
``distllm_tpu.models.esm2``: rotary position embeddings, pre-LN residual
blocks and the ESM token-dropout embedding rescale, with HF ``EsmModel``
numerics.

Parameters are a plain dict shaped like the JAX pytree (per-layer weights
stacked on a leading ``L`` axis, kernels ``[in, out]``)::

    {'embed': [V, H],
     'layers': {'q'|'k'|'v'|'o'|'up'|'down': {'kernel': [L, in, out],
                                              'bias': [L, out]},
                'attn_ln'|'mlp_ln': {'scale': [L, H], 'bias': [L, H]}},
     'final_ln': {'scale': [H], 'bias': [H]}}

The embedding table and the norms stay fp32, as the JAX forward reads
them (the token-dropout rescale happens in the table's dtype, before the
cast to the model dtype); dense kernels and biases are held in the model
dtype. Attention goes through ``common.encoder_attend`` — kernel K3 on
CUDA tensors. The output is the final LayerNorm in fp32.
"""

from __future__ import annotations

import dataclasses

import torch

from distllm_tpu_torch.models import common
from distllm_tpu_torch.parallel.sharding import P
from distllm_tpu_torch.utils import BaseConfig, torch_dtype

_DENSE = ('q', 'k', 'v', 'o', 'up', 'down')
_NORMS = ('attn_ln', 'mlp_ln')
# ESM pretraining mask rate x mask fraction (HF EsmEmbeddings).
_MASK_RATIO_TRAIN = 0.15 * 0.8
ROPE_THETA = 10000.0


@dataclasses.dataclass
class Esm2Config(BaseConfig):
    """ESM-2 geometry; the defaults are the JAX ``Esm2Config``'s (8M)."""

    vocab_size: int = 33
    hidden_size: int = 320
    num_layers: int = 6
    num_heads: int = 20
    intermediate_size: int = 1280
    layer_norm_eps: float = 1e-5
    token_dropout: bool = True
    mask_token_id: int = 32
    pad_token_id: int = 1
    dtype: str = 'bfloat16'

    # Not a field: the rank's tensor-parallel collectives on a copy bound
    # to a mesh (``parallel.comm.bind``); None runs the whole model.
    tp = None

    def validate(self) -> None:
        if self.hidden_size % self.num_heads:
            raise ValueError('hidden_size must be a multiple of num_heads')
        torch_dtype(self.dtype)

    @classmethod
    def from_hf_config(cls, hf: dict) -> 'Esm2Config':
        return cls(
            vocab_size=hf['vocab_size'],
            hidden_size=hf['hidden_size'],
            num_layers=hf['num_hidden_layers'],
            num_heads=hf['num_attention_heads'],
            intermediate_size=hf['intermediate_size'],
            layer_norm_eps=hf.get('layer_norm_eps', 1e-5),
            token_dropout=hf.get('token_dropout', True),
            mask_token_id=hf.get('mask_token_id', 32),
            pad_token_id=hf.get('pad_token_id', 1),
        )


def _shapes(cfg: Esm2Config) -> dict:
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    dense = {
        'q': (h, h), 'k': (h, h), 'v': (h, h), 'o': (h, h),
        'up': (h, i), 'down': (i, h),
    }
    layers = {}
    for name in ('q', 'k', 'v', 'o'):
        layers[name] = {'kernel': (L, *dense[name]), 'bias': (L, h)}
    layers['attn_ln'] = {'scale': (L, h), 'bias': (L, h)}
    layers['up'] = {'kernel': (L, h, i), 'bias': (L, i)}
    layers['down'] = {'kernel': (L, i, h), 'bias': (L, h)}
    layers['mlp_ln'] = {'scale': (L, h), 'bias': (L, h)}
    return {
        'embed': (cfg.vocab_size, h),
        'layers': layers,
        'final_ln': {'scale': (h,), 'bias': (h,)},
    }


def _in_model_dtype(path: tuple) -> bool:
    return path[0] == 'layers' and path[1] in _DENSE


def init(
    cfg: Esm2Config,
    generator: 'torch.Generator | None' = None,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """Random weights made on ``device`` (``None`` = CUDA; raises without
    it) with the JAX ``init``'s distribution (normal, std 0.02; zero
    biases; norm scales at 1), not its numbers. ``generator`` must live on
    ``device``; ``None`` seeds a fresh one with 0."""
    return common.init_tree(
        _shapes(cfg), _in_model_dtype, generator, device, dtype or cfg.dtype
    )


def params_from_jax(
    tree: dict,
    cfg: Esm2Config,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """The weight bridge: a ``distllm_tpu.models.esm2`` tree whose leaves
    the caller turned into numpy arrays (a quantized leaf keeps its codes
    and fp32 scales), as the port's parameters on ``device``. Raises
    ``ValueError`` when the tree does not match ``cfg``."""
    return common.place_tree(
        tree, _shapes(cfg), _in_model_dtype, device, dtype or cfg.dtype, 'esm2'
    )


def params_from_hf(
    state: dict,
    cfg: Esm2Config,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """Convert HF ``EsmModel`` / ``EsmForMaskedLM`` weights (tensors or
    numpy arrays) with the JAX mapping: the ``esm.`` prefix dropped, the
    contact head and LM head ignored, Linear ``[out, in]`` weights
    transposed, layers stacked."""
    sd = {
        key.removeprefix('esm.'): torch.as_tensor(value).float()
        for key, value in state.items()
    }

    def lin(key):
        return {'kernel': sd[f'{key}.weight'].T, 'bias': sd[f'{key}.bias']}

    def ln(key):
        return {'scale': sd[f'{key}.weight'], 'bias': sd[f'{key}.bias']}

    hf_names = {
        'q': 'attention.self.query', 'k': 'attention.self.key',
        'v': 'attention.self.value', 'o': 'attention.output.dense',
        'attn_ln': 'attention.LayerNorm', 'up': 'intermediate.dense',
        'down': 'output.dense', 'mlp_ln': 'LayerNorm',
    }
    layers = {}
    for name, hf_name in hf_names.items():
        make = ln if name in _NORMS else lin
        per_layer = [make(f'encoder.layer.{li}.{hf_name}') for li in range(cfg.num_layers)]
        layers[name] = {
            leaf: torch.stack([p[leaf] for p in per_layer]) for leaf in per_layer[0]
        }
    tree = {
        'embed': sd['embeddings.word_embeddings.weight'],
        'layers': layers,
        'final_ln': ln('encoder.emb_layer_norm_after'),
    }
    return common.place_tree(
        tree, _shapes(cfg), _in_model_dtype, device, dtype or cfg.dtype, 'esm2'
    )


def param_specs(cfg: Esm2Config, params: dict | None = None) -> dict:
    """Megatron-style tensor parallelism over ``model``, leaf for leaf the
    JAX ``param_specs``: ``q``/``k``/``v``/``up`` column-parallel with
    their biases, ``o``/``down`` row-parallel, the embedding table and the
    norms replicated."""
    col = {'kernel': P(None, None, 'model'), 'bias': P(None, 'model')}
    row = {'kernel': P(None, 'model', None), 'bias': P(None)}
    ln = {'scale': P(None), 'bias': P(None)}
    return {
        'embed': P(None, None),
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
        'final_ln': {'scale': P(), 'bias': P()},
    }


def embed_tokens(
    params: dict, cfg: Esm2Config, input_ids: torch.Tensor, attention_mask: torch.Tensor
) -> torch.Tensor:
    """The embedding table's rows with the token-dropout rescale (HF
    ``EsmEmbeddings``): ``<mask>`` rows zeroed, every row scaled by
    ``(1 - 0.12) / (1 - observed mask share)``, padding rows zeroed; all
    in the table's dtype (fp32), returned in the model dtype."""
    ids = input_ids.long()
    x = params['embed'][ids]
    if cfg.token_dropout:
        is_mask = ids == cfg.mask_token_id
        x = torch.where(is_mask[..., None], 0.0, x)
        lengths = attention_mask.sum(dim=1).float()
        n_masked = (is_mask & (attention_mask != 0)).sum(dim=1).float()
        observed = n_masked / lengths.clamp(min=1.0)
        # A tensor numerator: a Python scalar over a tensor is computed as
        # the scalar times the reciprocal, one rounding more than JAX's.
        keep = torch.full_like(observed, 1.0 - _MASK_RATIO_TRAIN)
        x = x * (keep / (1.0 - observed))[:, None, None]
    x = x * attention_mask[..., None].to(x.dtype)
    return x.to(torch_dtype(cfg.dtype))


def apply(
    params: dict,
    cfg: Esm2Config,
    input_ids: torch.Tensor,  # [B, S] int
    attention_mask: torch.Tensor,  # [B, S] int, nonzero = valid
    attn_impl: str = 'auto',
) -> torch.Tensor:
    """Forward: ``[B, S]`` ids/mask -> ``[B, S, H]`` last hidden states,
    the final LayerNorm in fp32, with the JAX ``esm2.apply`` numerics:
    pre-LN blocks with fp32 norm statistics cast back to the model dtype,
    RoPE (theta 10000, rotate-half) on q and k, exact-erf GELU. Under a
    config bound to a mesh the rank runs its heads and width, and ``o`` /
    ``down`` sum over the ``model`` group."""
    common.check_attn_impl(attn_impl)
    dtype = torch_dtype(cfg.dtype)
    layers = params['layers']
    eps = cfg.layer_norm_eps
    heads = common.rank_heads(cfg)
    cos, sin = common.rope_tables(
        cfg.hidden_size // cfg.num_heads, input_ids.shape[1], ROPE_THETA, input_ids.device
    )

    def dense(h, name, li):
        return common.dense(h, layers[name]['kernel'][li], layers[name]['bias'][li])

    def row(h, name, li):
        return common.row_dense(h, layers[name]['kernel'][li], layers[name]['bias'][li], cfg.tp)

    def norm(h, name, li):
        p = layers[name]
        return common.layer_norm(h.float(), p['scale'][li], p['bias'][li], eps).to(dtype)

    def rope(h):
        return common.merge_heads(common.apply_rope(common.split_heads(h, heads), cos, sin))

    x = embed_tokens(params, cfg, input_ids, attention_mask)
    for li in range(cfg.num_layers):
        normed = norm(x, 'attn_ln', li)
        q, k = rope(dense(normed, 'q', li)), rope(dense(normed, 'k', li))
        attn = common.encoder_attend(
            q, k, dense(normed, 'v', li), attention_mask, heads, attn_impl
        )
        x = x + row(attn, 'o', li)
        x = x + row(common.gelu(dense(norm(x, 'mlp_ln', li), 'up', li)), 'down', li)
    final = params['final_ln']
    return common.layer_norm(x.float(), final['scale'], final['bias'], eps)
