"""Gemma / Gemma-2 decoders over the shared Mistral-family forward (the
PyTorch counterpart of ``distllm_tpu.models.gemma``).

One forward serves every decoder family (``models/mistral.py``); Gemma
is a set of config knobs there:

- a GeGLU MLP (``activation='gelu_new'``, HF ``gelu_pytorch_tanh``);
- embeddings scaled by sqrt(hidden), rounded to the compute dtype;
- ``(1 + w)`` RMSNorm weights (checkpoints stay byte-identical to HF);
- Gemma-2 also: sandwich norms around attention and the MLP
  (``post_norms``), attention and final logit soft-capping, the
  ``query_pre_attn_scalar`` score scale, and the alternating local /
  global sliding window (even layers windowed).

Kernel K1 (``ops.paged_attention``) takes the softcap, the scale and a
per-layer window natively, and head dim 256 (Gemma-7B, Gemma-2 2B and
9B) on every route, so the paged engine serves these families through
it as it serves Mistral.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.models.mistral import MistralConfig


@dataclasses.dataclass
class GemmaConfig(MistralConfig):
    name: str = 'gemma'

    NAMES = ('gemma', 'gemma2')

    @classmethod
    def from_hf_config(cls, hf: dict) -> 'GemmaConfig':
        """Map an HF ``GemmaConfig`` / ``Gemma2Config`` dict (the JAX
        mapping): ``hidden_activation`` (gemma2) or ``hidden_act``
        (gemma), both ``gelu_pytorch_tanh``; an explicit ``head_dim``;
        tied embeddings."""
        model_type = hf.get('model_type', 'gemma')
        is_v2 = model_type == 'gemma2'
        act = hf.get('hidden_activation') or hf.get('hidden_act', 'gelu_pytorch_tanh')
        query_pre_attn = hf.get('query_pre_attn_scalar')
        return cls(
            name=model_type,
            vocab_size=hf['vocab_size'],
            hidden_size=hf['hidden_size'],
            num_layers=hf['num_hidden_layers'],
            num_heads=hf['num_attention_heads'],
            num_kv_heads=hf.get('num_key_value_heads', hf['num_attention_heads']),
            head_dim=hf.get('head_dim'),
            intermediate_size=hf['intermediate_size'],
            max_position_embeddings=hf.get('max_position_embeddings', 8192),
            rope_theta=hf.get('rope_theta', 10000.0),
            rms_norm_eps=hf.get('rms_norm_eps', 1e-6),
            tie_word_embeddings=hf.get('tie_word_embeddings', True),
            activation={
                'gelu_pytorch_tanh': 'gelu_new',
                'gelu': 'gelu_new',  # HF Gemma aliases plain gelu to tanh
            }.get(act, act),
            embedding_multiplier=hf['hidden_size'] ** 0.5,
            norm_plus_one=True,
            post_norms=is_v2,
            query_scale=query_pre_attn ** -0.5 if is_v2 and query_pre_attn else None,
            attn_logit_softcap=hf.get('attn_logit_softcapping') if is_v2 else None,
            final_logit_softcap=hf.get('final_logit_softcapping') if is_v2 else None,
            sliding_window=hf.get('sliding_window') if is_v2 else None,
            sliding_window_pattern='alternating' if is_v2 else 'all',
        )


# The engine and the embed pipeline drive the family through these;
# Gemma's differences live in the config knobs above.
init = mistral.init
params_from_jax = mistral.params_from_jax
apply = mistral.apply
prefill = mistral.prefill
logits = mistral.logits
prefill_paged = mistral.prefill_paged
decode_step = mistral.decode_step
decode_loop = mistral.decode_loop
# The post norms are replicated and the softcaps act on whole scores and
# logits, so the Mistral specs serve Gemma under tensor parallelism.
param_specs = mistral.param_specs


def params_from_hf(
    state: dict,
    cfg: GemmaConfig,
    device: 'str | torch.device' = 'cuda',
    dtype: 'str | torch.dtype | None' = None,
    leaf_fn=None,
) -> dict:
    """Convert HF ``GemmaForCausalLM`` / ``Gemma2ForCausalLM`` weights,
    on ``device`` in ``dtype`` (default ``cfg.dtype``), each leaf through
    ``leaf_fn`` when given (``mistral._to_torch``). The trap is
    ``post_attention_layernorm``:

    - gemma: ``input_layernorm`` -> ``attn_ln``,
      ``post_attention_layernorm`` -> ``mlp_ln`` (Llama's pre-MLP norm);
    - gemma2: ``input_layernorm`` -> ``attn_ln``,
      ``post_attention_layernorm`` -> ``post_attn_ln`` (a true post-norm),
      ``pre_feedforward_layernorm`` -> ``mlp_ln``,
      ``post_feedforward_layernorm`` -> ``post_mlp_ln``.
    """
    sd = mistral.hf_state_dict(state)

    def lin(key):
        return {'kernel': np.ascontiguousarray(sd[key].T)}

    layers = []
    for i in range(cfg.num_layers):
        p = f'layers.{i}'
        lp = {
            'q': lin(f'{p}.self_attn.q_proj.weight'),
            'k': lin(f'{p}.self_attn.k_proj.weight'),
            'v': lin(f'{p}.self_attn.v_proj.weight'),
            'o': lin(f'{p}.self_attn.o_proj.weight'),
            'attn_ln': {'scale': sd[f'{p}.input_layernorm.weight']},
            'gate': lin(f'{p}.mlp.gate_proj.weight'),
            'up': lin(f'{p}.mlp.up_proj.weight'),
            'down': lin(f'{p}.mlp.down_proj.weight'),
        }
        if cfg.post_norms:
            lp['post_attn_ln'] = {'scale': sd[f'{p}.post_attention_layernorm.weight']}
            lp['mlp_ln'] = {'scale': sd[f'{p}.pre_feedforward_layernorm.weight']}
            lp['post_mlp_ln'] = {'scale': sd[f'{p}.post_feedforward_layernorm.weight']}
        else:
            lp['mlp_ln'] = {'scale': sd[f'{p}.post_attention_layernorm.weight']}
        layers.append(lp)
    tree = {
        'embed': sd['embed_tokens.weight'],
        'layers': mistral.stack_layers(layers),
        'final_ln': {'scale': sd['norm.weight']},
    }
    return mistral._to_torch(tree, device, dtype or cfg.dtype, leaf_fn)
