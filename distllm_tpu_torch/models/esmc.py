"""ESM-Cambrian (ESM-C) protein language model, the PyTorch counterpart of
``distllm_tpu.models.esmc``:

- fused pre-norm QKV: LayerNorm, then one bias-free ``d -> 3d`` linear;
- QK LayerNorm (scale only) on the full q and k before the head split;
- rotary position embeddings (rotate-half, theta 10000);
- bidirectional attention masked on key validity, through kernel K3;
- a SwiGLU FFN (gate first) with hidden ``ceil(8/3 d / 256) * 256``;
- residual branches multiplied by ``1 / sqrt(num_layers / 36)``, a scalar
  in the model dtype;
- a bias-free final LayerNorm returning the model dtype.

Parameters mirror the JAX tree (kernels ``[in, out]``, layers stacked)::

    {'embed': [V, H],
     'layers': {'qkv_ln'|'ffn_ln': {'scale': [L, H], 'bias': [L, H]},
                'q_ln'|'k_ln': {'scale': [L, H]},
                'qkv': {'kernel': [L, H, 3H]}, 'out': {'kernel': [L, H, H]},
                'ffn_in': {'kernel': [L, H, 2F]}, 'ffn_out': {'kernel': [L, F, H]}},
     'final_ln': {'scale': [H]}}

Dense kernels are held in the model dtype, the table and norms in fp32.
:class:`EsmcSequenceTokenizer` is the fixed 33-symbol protein tokenizer
(cls + sequence + eos framing) with the port's bucketed padding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from distllm_tpu_torch.models import common
from distllm_tpu_torch.models.tokenizer import TokenBatch, _BucketingMixin, bucket_ladder
from distllm_tpu_torch.utils import BaseConfig, torch_dtype

# EsmSequenceTokenizer's vocabulary (fixed, public). ESM-2's is the same,
# id for id, but for id 31 ('<null_1>' there), which no sequence produces.
ESMC_VOCAB = (
    ['<cls>', '<pad>', '<eos>', '<unk>']
    + list('LAGVSERTIDPKQNFYMHWCXBUZO')
    + ['.', '-', '|', '<mask>']
)

# The released sizes: hidden -> (layers, heads) for 300M and 600M.
_SIZES = {960: (30, 15), 1152: (36, 18)}
_DENSE = ('qkv', 'out', 'ffn_in', 'ffn_out')


@dataclasses.dataclass
class EsmcConfig(BaseConfig):
    vocab_size: int = 64  # embedding rows are padded past the 33 used ids
    hidden_size: int = 960
    num_layers: int = 30
    num_heads: int = 15
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: str = 'bfloat16'

    def validate(self) -> None:
        if self.hidden_size % self.num_heads:
            raise ValueError('hidden_size must be a multiple of num_heads')
        torch_dtype(self.dtype)

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_hidden(self) -> int:
        # swiglu_correction_fn: 8/3 expansion rounded up to a multiple of 256.
        return int(-(-(self.hidden_size * 8 // 3) // 256) * 256)

    @property
    def residue_scale(self) -> float:
        return math.sqrt(self.num_layers / 36.0)

    @classmethod
    def from_hidden_size(cls, hidden_size: int, **kwargs) -> 'EsmcConfig':
        if hidden_size not in _SIZES:
            raise ValueError(
                f'ESM-C hidden size must be one of {sorted(_SIZES)} '
                f'(300M/600M releases), got {hidden_size}'
            )
        layers, heads = _SIZES[hidden_size]
        return cls(hidden_size=hidden_size, num_layers=layers, num_heads=heads, **kwargs)


def _shapes(cfg: EsmcConfig) -> dict:
    h, f, L = cfg.hidden_size, cfg.ffn_hidden, cfg.num_layers
    norm = {'scale': (L, h), 'bias': (L, h)}
    return {
        'embed': (cfg.vocab_size, h),
        'layers': {
            'qkv_ln': dict(norm),
            'qkv': {'kernel': (L, h, 3 * h)},
            'q_ln': {'scale': (L, h)},
            'k_ln': {'scale': (L, h)},
            'out': {'kernel': (L, h, h)},
            'ffn_ln': dict(norm),
            'ffn_in': {'kernel': (L, h, 2 * f)},
            'ffn_out': {'kernel': (L, f, h)},
        },
        'final_ln': {'scale': (h,)},
    }


def _in_model_dtype(path: tuple) -> bool:
    return path[0] == 'layers' and path[1] in _DENSE


def init(
    cfg: EsmcConfig,
    generator: 'torch.Generator | None' = None,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """Random weights made on ``device`` (``None`` = CUDA; raises without
    it) with the JAX ``init``'s distribution, not its numbers."""
    return common.init_tree(
        _shapes(cfg), _in_model_dtype, generator, device, dtype or cfg.dtype
    )


def params_from_jax(
    tree: dict,
    cfg: EsmcConfig,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """The weight bridge from a ``distllm_tpu.models.esmc`` tree of numpy
    arrays; raises ``ValueError`` when it does not match ``cfg``."""
    return common.place_tree(
        tree, _shapes(cfg), _in_model_dtype, device, dtype or cfg.dtype, 'esmc'
    )


def params_from_esm(
    state: dict,
    cfg: EsmcConfig,
    device: 'str | torch.device | None' = None,
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """Convert an ``esm``-package ESMC state dict (the ``.pth`` layout,
    ``transformer.blocks.N...``) with the JAX mapping; a LayerNorm that
    ships no bias gets zeros."""
    sd = {key: torch.as_tensor(value).float() for key, value in state.items()}

    def lin(key):
        return {'kernel': sd[key].T}

    def ln(prefix, with_bias=True):
        out = {'scale': sd[f'{prefix}.weight']}
        if with_bias:
            out['bias'] = sd.get(f'{prefix}.bias', torch.zeros_like(out['scale']))
        return out

    def block(i):
        p = f'transformer.blocks.{i}'
        return {
            'qkv_ln': ln(f'{p}.attn.layernorm_qkv.0'),
            'qkv': lin(f'{p}.attn.layernorm_qkv.1.weight'),
            'q_ln': ln(f'{p}.attn.q_ln', with_bias=False),
            'k_ln': ln(f'{p}.attn.k_ln', with_bias=False),
            'out': lin(f'{p}.attn.out_proj.weight'),
            'ffn_ln': ln(f'{p}.ffn.0'),
            'ffn_in': lin(f'{p}.ffn.1.weight'),
            'ffn_out': lin(f'{p}.ffn.3.weight'),
        }

    blocks = [block(i) for i in range(cfg.num_layers)]
    layers = {
        name: {leaf: torch.stack([b[name][leaf] for b in blocks]) for leaf in leaves}
        for name, leaves in blocks[0].items()
    }
    tree = {
        'embed': sd['embed.weight'],
        'layers': layers,
        'final_ln': ln('transformer.norm', with_bias=False),
    }
    return common.place_tree(
        tree, _shapes(cfg), _in_model_dtype, device, dtype or cfg.dtype, 'esmc'
    )


def apply(
    params: dict,
    cfg: EsmcConfig,
    input_ids: torch.Tensor,  # [B, S]
    attention_mask: torch.Tensor,  # [B, S]
    attn_impl: str = 'auto',
) -> torch.Tensor:
    """Forward -> ``[B, S, H]`` hidden states after the final norm, in the
    model dtype (what the reference's ``encode`` returns), with the JAX
    ``esmc.apply`` numerics. As there, the depth is the tree's and the
    residual scale the config's ``num_layers``."""
    common.check_attn_impl(attn_impl)
    dtype = torch_dtype(cfg.dtype)
    layers = params['layers']
    eps = cfg.layer_norm_eps
    heads = cfg.num_heads
    cos, sin = common.rope_tables(
        cfg.head_size, input_ids.shape[1], cfg.rope_theta, input_ids.device
    )
    # Multiplied into both residual branches in the model dtype, as JAX
    # does: a division, or an fp32 multiplier, rounds otherwise in bf16.
    inv_scale = torch.tensor(1.0 / cfg.residue_scale, dtype=dtype, device=input_ids.device)

    def norm(h, p, li=None):
        scale = p['scale'] if li is None else p['scale'][li]
        bias = p.get('bias')
        if bias is not None and li is not None:
            bias = bias[li]
        # Norm statistics in fp32, cast back to the model dtype.
        return common.layer_norm(h.float(), scale, bias, eps).to(dtype)

    def rope(h):
        return common.merge_heads(common.apply_rope(common.split_heads(h, heads), cos, sin))

    x = params['embed'][input_ids.long()].to(dtype)
    for li in range(layers['qkv']['kernel'].shape[0]):
        qkv = common.dense(norm(x, layers['qkv_ln'], li), layers['qkv']['kernel'][li])
        q, k, v = qkv.chunk(3, dim=-1)
        # QK LayerNorm on the full vectors (scale only), before the split.
        q = rope(norm(q, layers['q_ln'], li))
        k = rope(norm(k, layers['k_ln'], li))
        attn = common.encoder_attend(q, k, v, attention_mask, heads, attn_impl)
        x = x + common.dense(attn, layers['out']['kernel'][li]) * inv_scale
        gate, up = common.dense(
            norm(x, layers['ffn_ln'], li), layers['ffn_in']['kernel'][li]
        ).chunk(2, dim=-1)
        ffn = common.dense(common.silu(gate) * up, layers['ffn_out']['kernel'][li])
        x = x + ffn * inv_scale
    return norm(x, params['final_ln'])


class EsmcSequenceTokenizer(_BucketingMixin):
    """``EsmSequenceTokenizer``'s equivalent (a copy of the JAX one): the
    fixed protein vocabulary, cls + sequence + eos framing (the body cut at
    ``max_length - 2``), sequences uppercased and stripped, unknown letters
    as ``<unk>``, bucketed fixed-shape padding."""

    def __init__(self, model_max_length: int = 2048, min_bucket: int = 16) -> None:
        self.vocab = list(ESMC_VOCAB)
        self.vocab_size = len(self.vocab)
        self._ids = {tok: i for i, tok in enumerate(self.vocab)}
        self.pad_id = self._ids['<pad>']
        self.cls_id = self._ids['<cls>']
        self.eos_id = self._ids['<eos>']
        self.unk_id = self._ids['<unk>']
        self.model_max_length = model_max_length
        self.buckets = bucket_ladder(model_max_length, min_bucket)

    def __call__(
        self, texts: Sequence[str], *, max_length: int | None = None
    ) -> TokenBatch:
        max_length = max_length or self.model_max_length
        body_limit = max(0, max_length - 2)
        rows = []
        for seq in texts:
            body = [self._ids.get(ch, self.unk_id) for ch in seq.upper().strip()]
            rows.append([self.cls_id] + body[:body_limit] + [self.eos_id])
        return self._pad_to_bucket(rows, self.pad_id, max_length)

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for tid in ids:
            tok = self.vocab[int(tid)] if 0 <= int(tid) < self.vocab_size else '<unk>'
            if not tok.startswith('<'):
                out.append(tok)
        return ''.join(out)
