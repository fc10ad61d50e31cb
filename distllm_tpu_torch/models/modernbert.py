"""ModernBERT encoder (answerdotai/ModernBERT class models), the PyTorch
counterpart of ``distllm_tpu.models.modernbert``, with HF
``ModernBertModel`` numerics: pre-LN residuals, a bias-free GeGLU MLP
(``act(input) * gate``), RoPE (rotate-half) and LayerNorms with an
optional bias, a final norm on the output in fp32.

The architecture's per-layer differences are Python branches of the layer
loop (the JAX module carries them as traced flag vectors):

- layer 0's attention pre-norm is the identity;
- layer ``li`` attends globally when ``li % global_attn_every_n_layers ==
  0`` (RoPE theta ``global_rope_theta``), and otherwise within ``|i - j|
  <= local_attention // 2`` (theta ``local_rope_theta``).

Both layer kinds run kernel K3 (``common.encoder_attend``). A local layer
passes the window as the JAX kernel receives it: an fp32 ``[S, S]`` bias
of 0 / -1e9, built once per forward and added to the key mask's -1e9. A
global layer passes no bias where JAX passes a zero one: the kernel adds
the bias to each score's key bias, and adding 0.0 is exact, so the result
is the same bit for bit while the kernel reads no ``[S, S]`` term.

Parameters mirror the JAX tree without its flag vectors (kernels
``[in, out]``, layers stacked; ``Wqkv`` and ``Wi`` split at load)::

    {'embed': [V, H], 'embed_norm'|'final_norm': {'scale': [H], 'bias': [H]},
     'layers': {'attn_norm'|'mlp_norm': {'scale': [L, H], 'bias': [L, H]},
                'q'|'k'|'v'|'o'|'wi_in'|'wi_gate'|'wo':
                    {'kernel': [L, in, out] (, 'bias': [L, out])}}}
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distllm_tpu_torch.models import common
from distllm_tpu_torch.ops.encoder_attention import NEG_BIG
from distllm_tpu_torch.parallel.sharding import P
from distllm_tpu_torch.utils import BaseConfig, torch_dtype

_ATTN = ('q', 'k', 'v', 'o')
_MLP = ('wi_in', 'wi_gate', 'wo')


@dataclasses.dataclass
class ModernBertConfig(BaseConfig):
    """ModernBERT geometry; the defaults are ModernBERT-base's."""

    vocab_size: int = 50368
    hidden_size: int = 768
    num_layers: int = 22
    num_heads: int = 12
    intermediate_size: int = 1152
    norm_eps: float = 1e-5
    norm_bias: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    global_attn_every_n_layers: int = 3
    local_attention: int = 128
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    hidden_act: str = 'gelu'
    max_position_embeddings: int = 8192
    dtype: str = 'bfloat16'

    # Not a field: the rank's tensor-parallel collectives on a copy bound
    # to a mesh (``parallel.comm.bind``); None runs the whole model.
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

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def is_global(self, li: int) -> bool:
        """Whether layer ``li`` attends globally (every n-th from 0)."""
        return li % self.global_attn_every_n_layers == 0

    @classmethod
    def from_hf_config(cls, hf: dict) -> 'ModernBertConfig':
        return cls(
            vocab_size=hf['vocab_size'],
            hidden_size=hf['hidden_size'],
            num_layers=hf['num_hidden_layers'],
            num_heads=hf['num_attention_heads'],
            intermediate_size=hf['intermediate_size'],
            norm_eps=hf.get('norm_eps', 1e-5),
            norm_bias=hf.get('norm_bias', False),
            attention_bias=hf.get('attention_bias', False),
            mlp_bias=hf.get('mlp_bias', False),
            global_attn_every_n_layers=hf.get('global_attn_every_n_layers', 3),
            local_attention=hf.get('local_attention', 128),
            global_rope_theta=hf.get('global_rope_theta', 160000.0),
            local_rope_theta=hf.get('local_rope_theta', 10000.0),
            hidden_act=hf.get('hidden_activation', 'gelu'),
            max_position_embeddings=hf.get('max_position_embeddings', 8192),
        )


def _shapes(cfg: ModernBertConfig) -> dict:
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def lin(name, shape):
        out = {'kernel': (L, *shape)}
        if cfg.attention_bias if name in _ATTN else cfg.mlp_bias:
            out['bias'] = (L, shape[1])
        return out

    return {
        'embed': (cfg.vocab_size, h),
        'embed_norm': {'scale': (h,), 'bias': (h,)},
        'final_norm': {'scale': (h,), 'bias': (h,)},
        'layers': {
            'attn_norm': {'scale': (L, h), 'bias': (L, h)},
            'q': lin('q', (h, h)),
            'k': lin('k', (h, h)),
            'v': lin('v', (h, h)),
            'o': lin('o', (h, h)),
            'mlp_norm': {'scale': (L, h), 'bias': (L, h)},
            'wi_in': lin('wi_in', (h, i)),
            'wi_gate': lin('wi_gate', (h, i)),
            'wo': lin('wo', (i, h)),
        },
    }


def _in_model_dtype(path: tuple) -> bool:
    return path[0] == 'layers' and path[1] in (*_ATTN, *_MLP)


def init(
    cfg: ModernBertConfig,
    generator: 'torch.Generator | None' = None,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """Random weights made on ``device`` (``None`` = CUDA; raises without
    it) with the JAX ``init``'s distribution, not its numbers."""
    return common.init_tree(
        _shapes(cfg), _in_model_dtype, generator, device, dtype or cfg.dtype
    )


def param_specs(cfg: ModernBertConfig, params: dict | None = None) -> dict:
    """Megatron-style tensor parallelism over ``model`` (``q``/``k``/``v``
    and ``Wi``'s two halves column-parallel, ``o`` and ``wo``
    row-parallel, the embedding table and norms replicated): the JAX
    ``param_specs`` leaf for leaf, without its flag vectors, which the
    port's tree does not carry. Like JAX's, it names no dense bias: a
    checkpoint with ``attention_bias`` or ``mlp_bias`` has leaves without
    a spec, which ``shard_pytree`` refuses as JAX's does."""
    ln = {'scale': P(None), 'bias': P(None)}
    return {
        'embed': P(None, None),
        'embed_norm': dict(ln),
        'final_norm': dict(ln),
        'layers': {
            'attn_norm': dict(ln),
            'q': {'kernel': P(None, None, 'model')},
            'k': {'kernel': P(None, None, 'model')},
            'v': {'kernel': P(None, None, 'model')},
            'o': {'kernel': P(None, 'model', None)},
            'mlp_norm': dict(ln),
            'wi_in': {'kernel': P(None, None, 'model')},
            'wi_gate': {'kernel': P(None, None, 'model')},
            'wo': {'kernel': P(None, 'model', None)},
        },
    }


def _flags(cfg: ModernBertConfig) -> dict[str, np.ndarray]:
    """The JAX tree's flag vectors for ``cfg`` (``[L, 1]`` fp32)."""
    attn_norm = np.ones((cfg.num_layers, 1), np.float32)
    attn_norm[0] = 0.0
    is_global = [[float(cfg.is_global(li))] for li in range(cfg.num_layers)]
    return {'attn_norm_flag': attn_norm, 'global_flag': np.asarray(is_global, np.float32)}


def params_from_jax(
    tree: dict,
    cfg: ModernBertConfig,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """The weight bridge from a ``distllm_tpu.models.modernbert`` tree of
    numpy arrays. Its flag vectors must be the ones ``cfg`` implies (the
    port reads the layer kinds from ``cfg``) and are dropped; raises
    ``ValueError`` otherwise, or when the tree does not match ``cfg``."""
    tree = dict(tree)
    for name, want in _flags(cfg).items():
        got = tree.pop(name, None)
        if got is None or not np.array_equal(np.asarray(got), want):
            raise ValueError(f'{name} of the tree does not match the config')
    return common.place_tree(
        tree, _shapes(cfg), _in_model_dtype, device, dtype or cfg.dtype, 'modernbert'
    )


def params_from_hf(
    state: dict,
    cfg: ModernBertConfig,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """Convert an HF ``ModernBertModel`` state dict (the bare ``layers.N``
    layout or the task model's ``model.layers.N``) with the JAX mapping:
    ``Wqkv`` split in three and ``Wi`` in two (input half first), Linear
    weights transposed; layer 0's identity attention norm and every
    missing norm bias become the identity's parameters."""
    sd = {
        key.removeprefix('model.'): torch.as_tensor(value).float()
        for key, value in state.items()
    }
    h = cfg.hidden_size

    def lin(prefix, parts=1):
        out = [{'kernel': kk} for kk in sd[f'{prefix}.weight'].T.chunk(parts, dim=1)]
        if f'{prefix}.bias' in sd:
            for part, bias in zip(out, sd[f'{prefix}.bias'].chunk(parts)):
                part['bias'] = bias
        return out

    def ln(prefix):
        if f'{prefix}.weight' not in sd:  # layer 0's identity attn_norm
            return {'scale': torch.ones(h), 'bias': torch.zeros(h)}
        scale = sd[f'{prefix}.weight']
        return {'scale': scale, 'bias': sd.get(f'{prefix}.bias', torch.zeros_like(scale))}

    blocks = []
    for li in range(cfg.num_layers):
        p = f'layers.{li}'
        q, k, v = lin(f'{p}.attn.Wqkv', 3)
        wi_in, wi_gate = lin(f'{p}.mlp.Wi', 2)
        blocks.append({
            'attn_norm': ln(f'{p}.attn_norm'), 'q': q, 'k': k, 'v': v,
            'o': lin(f'{p}.attn.Wo')[0], 'mlp_norm': ln(f'{p}.mlp_norm'),
            'wi_in': wi_in, 'wi_gate': wi_gate, 'wo': lin(f'{p}.mlp.Wo')[0],
        })
    layers = {
        name: {leaf: torch.stack([b[name][leaf] for b in blocks]) for leaf in leaves}
        for name, leaves in blocks[0].items()
    }
    tree = {
        'embed': sd['embeddings.tok_embeddings.weight'],
        'embed_norm': ln('embeddings.norm'),
        'final_norm': ln('final_norm'),
        'layers': layers,
    }
    return common.place_tree(
        tree, _shapes(cfg), _in_model_dtype, device, dtype or cfg.dtype, 'modernbert'
    )


def window_bias(cfg: ModernBertConfig, seq_len: int, device) -> torch.Tensor:
    """The local layers' ``[S, S]`` fp32 score bias: 0 where ``|i - j| <=
    local_attention // 2``, -1e9 elsewhere (the JAX ``window_bias``)."""
    pos = torch.arange(seq_len, device=device)
    inside = (pos[:, None] - pos[None, :]).abs() <= cfg.local_attention // 2
    return torch.where(inside, 0.0, NEG_BIG).to(torch.float32)


def apply(
    params: dict,
    cfg: ModernBertConfig,
    input_ids: torch.Tensor,  # [B, S]
    attention_mask: torch.Tensor,  # [B, S]
    attn_impl: str = 'auto',
) -> torch.Tensor:
    """Forward: ``[B, S]`` ids/mask -> ``[B, S, H]`` final hidden states in
    fp32, with the JAX ``modernbert.apply`` numerics (norm statistics in
    fp32 cast back to the model dtype). Under a config bound to a mesh the
    rank runs its heads and width, ``o`` / ``wo`` sum over the ``model``
    group, and the window bias stays whole."""
    common.check_attn_impl(attn_impl)
    dtype = torch_dtype(cfg.dtype)
    act = common.ACTIVATIONS[cfg.hidden_act]
    layers = params['layers']
    eps = cfg.norm_eps
    heads = common.rank_heads(cfg)
    seq, device = input_ids.shape[1], input_ids.device
    tables = {
        True: common.rope_tables(cfg.head_dim, seq, cfg.global_rope_theta, device),
        False: common.rope_tables(cfg.head_dim, seq, cfg.local_rope_theta, device),
    }
    local_bias = window_bias(cfg, seq, device)

    def norm(h, p, li=None):
        scale, bias = (p['scale'], p['bias']) if li is None else (p['scale'][li], p['bias'][li])
        return common.layer_norm(h.float(), scale, bias, eps).to(dtype)

    def dense(h, name, li):
        p = layers[name]
        return common.dense(h, p['kernel'][li], p['bias'][li] if 'bias' in p else None)

    def row(h, name, li):
        p = layers[name]
        return common.row_dense(
            h, p['kernel'][li], p['bias'][li] if 'bias' in p else None, cfg.tp,
        )

    x = norm(params['embed'][input_ids.long()], params['embed_norm'])
    for li in range(cfg.num_layers):
        is_global = cfg.is_global(li)
        cos, sin = tables[is_global]
        # Layer 0: HF's attention pre-norm is the identity.
        normed = x if li == 0 else norm(x, layers['attn_norm'], li)

        def rope(h):
            return common.merge_heads(
                common.apply_rope(common.split_heads(h, heads), cos, sin)
            )

        attn = common.encoder_attend(
            rope(dense(normed, 'q', li)), rope(dense(normed, 'k', li)),
            dense(normed, 'v', li), attention_mask, heads, attn_impl,
            bias=None if is_global else local_bias,
        )
        x = x + row(attn, 'o', li)
        normed2 = norm(x, layers['mlp_norm'], li)
        x = x + row(act(dense(normed2, 'wi_in', li)) * dense(normed2, 'wi_gate', li), 'wo', li)
    return common.layer_norm(
        x.float(), params['final_norm']['scale'], params['final_norm']['bias'], eps
    )
