"""Mixtral-family sparse-MoE decoder (the PyTorch counterpart of
``distllm_tpu.models.mixtral``).

The Mistral backbone (GQA, RoPE, RMSNorm) with the SwiGLU MLP replaced
by a top-k routed bank of expert MLPs, HF ``MixtralSparseMoeBlock``
semantics: router logits, a softmax over every expert, the top k kept
and renormalised. A layer carries it as a ``router`` leaf ``[L, H, E]``
and expert banks ``gate`` / ``up`` ``[L, E, H, I]`` and ``down``
``[L, E, I, H]``; ``models/mistral._mlp_block`` sees the router and calls
:func:`moe_mlp`, so every serving program of the shared forward (paged
prefill, chunk rows, decode and verify windows, the dense ``apply``)
serves Mixtral, as in JAX.

Routed experts are computed as in the JAX module: dense products over
every expert with the combine weights of the unselected ones zero, and
int8 / nf4 banks dequantized at the point of use, one layer at a time.
The products are ``torch.matmul`` over the expert axis (the activations
broadcast, the bank read in place), so no permuted copy of a bank is
made. Attention projections of an int8 tree run through kernel K2 as
Mistral's do; the banks are never handed to K2.

At Mixtral-8x7B widths the bf16 weights (93 GB) do not fit one 80 GB
card: :func:`init` with a quantization mode draws one layer's leaves at
a time and quantizes them before drawing the next, so no float copy of
the whole tree ever exists.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.models.mistral import MistralConfig
from distllm_tpu_torch.ops.quantization import (
    QTensor,
    normalize_mode,
    quantize_int8,
    quantize_nf4,
    should_quantize,
)
from distllm_tpu_torch.parallel.sharding import P
from distllm_tpu_torch.utils import torch_dtype


@dataclasses.dataclass
class MixtralConfig(MistralConfig):
    """Mixtral geometry; the defaults are Mixtral-8x7B's widths, as in the
    JAX ``MixtralConfig`` (rope theta 1e6, 8 experts, top 2)."""

    name: str = 'mixtral'
    rope_theta: float = 1e6
    num_experts: int = 8
    experts_per_token: int = 2

    NAMES = ('mixtral',)

    def validate(self) -> None:
        super().validate()
        if not 1 <= self.experts_per_token <= self.num_experts:
            raise ValueError(
                f'experts_per_token must be in [1, num_experts={self.num_experts}], '
                f'got {self.experts_per_token}'
            )

    @classmethod
    def from_hf_config(cls, hf: dict) -> 'MixtralConfig':
        """Map an HF ``MixtralConfig`` dict (the JAX mapping):
        ``num_local_experts`` and ``num_experts_per_tok``."""
        return cls(
            vocab_size=hf['vocab_size'],
            hidden_size=hf['hidden_size'],
            num_layers=hf['num_hidden_layers'],
            num_heads=hf['num_attention_heads'],
            num_kv_heads=hf.get('num_key_value_heads', hf['num_attention_heads']),
            intermediate_size=hf['intermediate_size'],
            num_experts=hf.get('num_local_experts', 8),
            experts_per_token=hf.get('num_experts_per_tok', 2),
            max_position_embeddings=hf.get('max_position_embeddings', 32768),
            rope_theta=hf.get('rope_theta', 1e6),
            rope_scaling=hf.get('rope_scaling'),
            rms_norm_eps=hf.get('rms_norm_eps', 1e-5),
            sliding_window=hf.get('sliding_window'),
            tie_word_embeddings=hf.get('tie_word_embeddings', False),
        )


def _quantizer(mode: str | None):
    if mode == 'int8':
        return quantize_int8
    if mode == 'nf4':
        return quantize_nf4
    return None


def init(
    cfg: MixtralConfig,
    generator: 'torch.Generator | None' = None,
    device: 'str | torch.device' = 'cuda',
    dtype: 'str | torch.dtype | None' = None,
    quantization: 'bool | str | None' = None,
    leaf_fn=None,
) -> dict:
    """Random weights (normal, std 0.02; norm scales 1) drawn on
    ``device`` in ``dtype`` (default ``cfg.dtype``), one layer's leaves at
    a time in a fixed order (``embed``; per layer ``q``, ``k``, ``v``,
    ``o``, ``router``, ``gate``, ``up``, ``down``; ``lm_head``) into
    stacked leaves. With ``quantization`` ('int8' / 'nf4'; ``True`` means
    nf4) every leaf ``quantize_pytree`` would quantize is quantized layer
    by layer into preallocated codes and scales as it is drawn: the
    float transient is one layer's leaf, and the tree equals
    ``quantize_pytree(init(...), mode)`` on the same generator bit for
    bit. ``generator`` must live on ``device``; ``None`` seeds a fresh
    one with 0.

    ``leaf_fn(path, leaf, stacked=...)`` (tensor and expert parallelism:
    ``parallel.sharding.leaf_sharder``) takes each layer's leaf as soon as
    it is drawn and quantized (``stacked=False``: no layer axis) and the
    unstacked leaves, and what it returns is kept: a rank's slices, each
    the unsharded tree's bit for bit."""
    device = torch.device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    quantize = _quantizer(normalize_mode(quantization))
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    h, hd, i, e, L = (cfg.hidden_size, cfg.head_size, cfg.intermediate_size,
                      cfg.num_experts, cfg.num_layers)
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dt).mul_(0.02)

    def norm(*shape):
        return torch.ones(shape, device=device, dtype=dt)

    shapes = {
        'q': (h, q_out), 'k': (h, kv_out), 'v': (h, kv_out), 'o': (q_out, h),
        'router': (h, e), 'gate': (e, h, i), 'up': (e, h, i), 'down': (e, i, h),
    }
    quantized = {
        name: quantize is not None and should_quantize(
            ('layers', name, 'kernel'), torch.empty((L, *shape), device='meta'), 4096)
        for name, shape in shapes.items()
    }
    def keep(path, leaf, stacked=True):
        return leaf if leaf_fn is None else leaf_fn(path, leaf, stacked=stacked)

    params = {'embed': keep(('embed',), normal(cfg.vocab_size, h))}
    layers: dict = {}
    for li in range(L):
        for name, shape in shapes.items():
            w = normal(*shape)
            if quantized[name]:
                w = quantize(w, out_dtype=dt)
            w = keep(('layers', name, 'kernel'), w, stacked=False)
            if name not in layers:  # the stacked leaf, preallocated at layer 0
                view = getattr(w, 'view', None)
                layers[name] = {'kernel': w.new_empty((L, *w.shape)) if not quantized[name]
                                else QTensor(w.q.new_empty((L, *w.q.shape)),
                                             w.scale.new_empty((L, *w.scale.shape)),
                                             w.kind, (L, *w.shape), dt, w.block_size,
                                             None if view is None else
                                             ((L, *view[0]), (None, *view[1])))}
            kernel = layers[name]['kernel']
            if quantized[name]:
                kernel.q[li], kernel.scale[li] = w.q, w.scale
            else:
                kernel[li] = w
            del w
    layers['attn_ln'] = {'scale': norm(L, h)}
    layers['mlp_ln'] = {'scale': norm(L, h)}
    params['layers'] = layers
    params['final_ln'] = {'scale': norm(h)}
    if not cfg.tie_word_embeddings:
        params['lm_head'] = keep(('lm_head',), normal(h, cfg.vocab_size))
    return params


def param_specs(cfg: MixtralConfig, params: dict | None = None) -> dict:
    """EP x TP sharding, the JAX ``param_specs``: the expert banks ``[L, E,
    H, I]`` over ``expert``, their widths over ``model``; attention as
    Mistral's; the router replicated; an untied ``lm_head`` split on the
    vocab."""
    col = {'kernel': P(None, None, 'model')}
    row = {'kernel': P(None, 'model', None)}
    specs = {
        'embed': P(None, None),
        'layers': {
            'q': dict(col),
            'k': dict(col),
            'v': dict(col),
            'o': dict(row),
            'attn_ln': {'scale': P(None)},
            'router': {'kernel': P(None, None, None)},
            # [L, E, H, I]: experts over 'expert', MLP width over 'model'.
            'gate': {'kernel': P(None, 'expert', None, 'model')},
            'up': {'kernel': P(None, 'expert', None, 'model')},
            'down': {'kernel': P(None, 'expert', 'model', None)},
            'mlp_ln': {'scale': P(None)},
        },
        'final_ln': {'scale': P()},
    }
    has_lm_head = (
        'lm_head' in params if params is not None else not cfg.tie_word_embeddings
    )
    if has_lm_head:
        specs['lm_head'] = P(None, 'model')
    return specs


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, equal
    values ordered by the lower index first. ``torch.topk`` promises no
    order among ties; a stable descending sort keeps the index order."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def moe_mlp(
    x: torch.Tensor,  # [..., H]
    router_kernel: torch.Tensor,  # [H, E]
    gate: 'torch.Tensor | QTensor',  # [E, H, I]
    up: 'torch.Tensor | QTensor',  # [E, H, I]
    down: 'torch.Tensor | QTensor',  # [E, I, H]
    experts_per_token: int,
    tp=None,
) -> torch.Tensor:
    """Top-k routed SwiGLU expert bank, the JAX ``moe_mlp``: router
    logits and a softmax over ALL experts in fp32, the top
    ``experts_per_token`` kept (ties to the lower index) and renormalised
    (the sum clipped at 1e-9), scattered to a dense ``[..., E]`` combine
    in fp32 and cast to the model dtype; every expert's SwiGLU computed
    as dense products and combined. A quantized bank is dequantized here,
    at the point of use. Any leading shape (decode's ``[B, H]``, prefill's
    ``[B, S, H]``).

    Under expert and tensor parallelism (``tp``, a
    ``parallel.comm.TensorParallel``) the banks hold the rank's experts
    and its slice of their width; the router is replicated, so every rank
    computes the whole combine, takes its experts' columns, and the
    ranks' partial outputs are summed over the ``expert`` x ``model``
    group."""
    dtype = x.dtype

    def deq(w):
        return (w.dequantize() if isinstance(w, QTensor) else w).to(dtype)

    lead, h = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, h)  # [N, H]
    probs = torch.softmax(flat.float() @ router_kernel.float(), dim=-1)  # [N, E]
    top_w, top_idx = _top_k(probs, experts_per_token)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)
    # JAX sums one-hot rows times the weights; with distinct indices that
    # is each kept weight at its expert and 0 elsewhere, which a scatter
    # writes exactly (and without the host check one_hot may make).
    combine = torch.zeros_like(probs).scatter_(-1, top_idx, top_w)  # [N, E]
    if tp is not None:  # this rank's experts
        n_local = gate.shape[0]
        combine = combine[:, tp.expert_rank * n_local:(tp.expert_rank + 1) * n_local]
    hidden = F.silu(torch.matmul(flat, deq(gate))) * torch.matmul(flat, deq(up))
    expert_out = torch.matmul(hidden, deq(down))  # [E, N, H]
    out = torch.einsum('enh,ne->nh', expert_out, combine.to(dtype))
    if tp is not None:
        out = tp.reduce_moe(out)
    return out.reshape(*lead, h)


def params_from_jax(
    tree: dict,
    cfg: MixtralConfig,
    device: 'str | torch.device' = 'cuda',
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """The weight bridge for a ``distllm_tpu.models.mixtral.init`` tree,
    or its ``quantize_pytree`` tree, whose leaves the caller turned into
    numpy arrays (``mistral.params_from_jax``): float leaves in ``dtype``,
    quantized ones (the 4-D expert banks among them) as the port's
    ``QTensor`` with their codes and fp32 scales as they are."""
    layers = tree.get('layers', {})
    if 'router' not in layers:
        raise ValueError('not a mixtral param tree: the layers have no router')
    params = mistral.params_from_jax(tree, cfg, device=device, dtype=dtype)
    want = (cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size)
    gate = params['layers']['gate']['kernel']
    if tuple(gate.shape) != want:
        raise ValueError(f'gate bank {tuple(gate.shape)} does not match the config {want}')
    return params


def params_from_hf(
    state: dict,
    cfg: MixtralConfig,
    device: 'str | torch.device' = 'cuda',
    dtype: 'str | torch.dtype | None' = None,
    leaf_fn=None,
) -> dict:
    """Convert HF ``MixtralForCausalLM`` / ``MixtralModel`` weights with
    the JAX mapping: Linear ``[out, in]`` weights transposed to ``[in,
    out]``, ``block_sparse_moe.gate`` the router, each layer's
    ``block_sparse_moe.experts.{e}.w1`` / ``w3`` / ``w2`` stacked on E as
    ``gate`` / ``up`` / ``down``, layers stacked; ``lm_head`` kept when
    the embeddings are untied and the checkpoint has one. The tensors
    land on ``device`` in ``dtype`` (default ``cfg.dtype``), each leaf
    through ``leaf_fn`` when given (``mistral._to_torch``)."""
    sd = mistral.hf_state_dict(state)

    def lin(key):
        return {'kernel': np.ascontiguousarray(sd[key].T)}

    def expert_stack(layer: int, proj: str) -> np.ndarray:
        return np.stack([
            np.ascontiguousarray(
                sd[f'layers.{layer}.block_sparse_moe.experts.{e}.{proj}.weight'].T
            )
            for e in range(cfg.num_experts)
        ])

    layers = []
    for li in range(cfg.num_layers):
        p = f'layers.{li}'
        layers.append({
            'q': lin(f'{p}.self_attn.q_proj.weight'),
            'k': lin(f'{p}.self_attn.k_proj.weight'),
            'v': lin(f'{p}.self_attn.v_proj.weight'),
            'o': lin(f'{p}.self_attn.o_proj.weight'),
            'attn_ln': {'scale': sd[f'{p}.input_layernorm.weight']},
            'router': lin(f'{p}.block_sparse_moe.gate.weight'),
            'gate': {'kernel': expert_stack(li, 'w1')},
            'up': {'kernel': expert_stack(li, 'w3')},
            'down': {'kernel': expert_stack(li, 'w2')},
            'mlp_ln': {'scale': sd[f'{p}.post_attention_layernorm.weight']},
        })
    tree = {
        'embed': sd['embed_tokens.weight'],
        'layers': mistral.stack_layers(layers),
        'final_ln': {'scale': sd['norm.weight']},
    }
    if 'lm_head.weight' in sd and not cfg.tie_word_embeddings:
        tree['lm_head'] = np.ascontiguousarray(sd['lm_head.weight'].T)
    return mistral._to_torch(tree, device, dtype or cfg.dtype, leaf_fn)


# The engine, the generators and the embed pipeline drive the family
# through these; the router branch of ``mistral._mlp_block`` is what makes
# them Mixtral's.
apply = mistral.apply
prefill = mistral.prefill
logits = mistral.logits
prefill_paged = mistral.prefill_paged
decode_step = mistral.decode_step
decode_loop = mistral.decode_loop
