"""Mistral/Llama/Qwen2-family decoder, and through its Gemma knobs the
Gemma families (``models/gemma.py``), over the paged KV cache and as a
dense forward (PyTorch counterpart of ``distllm_tpu.models.mistral``).

Parameters are a plain dict shaped like the JAX pytree: per-layer weights
stacked on a leading ``L`` axis, kernels laid out ``[in, out]``::

    {'embed': [V, H],
     'layers': {'q'|'k'|'v'|'o'|'gate'|'up'|'down': {'kernel': [L, in, out]
                                                      (+ 'bias': [L, out])},
                'attn_ln'|'mlp_ln': {'scale': [L, H]}},
     'final_ln': {'scale': [H]},
     'lm_head': [H, V]}            # absent when embeddings are tied

so :func:`params_from_jax` copies a bridged JAX tree over unchanged, and
the layer loop indexes ``[li]`` where the JAX code scans. A kernel may be
a quantized ``QTensor`` (``ops.quantization``); indexing it slices codes
and scales together, and ``common.dense`` sends a 2-D int8 one through
kernel K2 with the tier ``MistralConfig.qmm_backend``.

Serving paths: :func:`prefill_paged` (a prompt tail written into the pool,
then attended through the paged cache; with ``all_logits`` every span
position's logits), :func:`decode_step`, :func:`decode_window_step` (one
decode+sample step writing its carry in place, the unit a CUDA graph
captures), the fused :func:`decode_loop` (``num_steps`` such steps with
the sampled tokens kept on the device), :func:`mixed_window` (prefill
chunk rows, then the decode loop) and :func:`spec_window` (optional chunk
rows, then one verify pass over draft spans; :func:`verify_window_step`
is its verify half writing into a caller's buffer, the unit the verify
graph captures).
Every one of them reaches attention through ``ops.paged_attention`` —
the CUDA kernel for CUDA tensors, the plain op for CPU tensors;
``attn_backend='reference'`` pins the plain op on any device (the
card-side identity check). The Gemma knobs of :class:`MistralConfig`
(the JAX config's eight, with its defaults) act in every one of them: the
activation, the embedding multiplier, ``(1 + w)`` norms, gemma2's
sandwich norms, the query scale and attention softcap handed to the
attention op, the final-logit softcap, and the per-layer window
(:func:`_layer_window`: a Python value per layer, so a captured graph
holds it as a constant).

Dense forward: :func:`apply` / :func:`prefill` (whole sequences through
``common.sdpa``, the embedding path of the ``auto`` encoder); weights
from an HF checkpoint with :func:`params_from_hf`.

The pool planes ``[L, num_blocks, block_size, N_kv, Hd]`` are written IN
PLACE (the JAX functions are pure and return new caches); the functions
return them anyway so call sites read like the JAX ones. A pool is a bare
tensor or an int8 ``QuantizedKV`` (data plus ``[L, num_blocks, N_kv]``
scales); :func:`_kv_layer` slices either into per-layer views.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distllm_tpu_torch.models import common
from distllm_tpu_torch.ops.paged_attention import (
    ATTN_BACKENDS,
    QuantizedKV,
    ragged_paged_attention,
    ragged_paged_attention_reference,
    write_chunk_kv,
    write_token_kv,
)
from distllm_tpu_torch.ops.quantization import (
    is_jax_qtensor,
    normalize_mode,
    qtensor_from_jax,
    quantize_int8,
    quantize_nf4,
    quantize_pytree,
    should_quantize,
)
from distllm_tpu_torch.parallel.comm import local_heads
from distllm_tpu_torch.parallel.sharding import P
from distllm_tpu_torch.ops.quantized_matmul import QMM_BACKENDS
from distllm_tpu_torch.ops.sampling import fold_row_keys, sample_tokens, verify_spans
from distllm_tpu_torch.utils import BaseConfig, torch_dtype


# MistralConfig's float fields: a YAML float without a dot ('1e-6') loads
# as a string.
_FLOAT_FIELDS = (
    'rope_theta', 'rms_norm_eps', 'embedding_multiplier', 'query_scale',
    'attn_logit_softcap', 'final_logit_softcap',
)


@dataclasses.dataclass
class MistralConfig(BaseConfig):
    """Decoder geometry; the defaults are Mistral-7B
    (``mistralai/Mistral-7B-Instruct-v0.2`` widths), as in the JAX
    ``MistralConfig``. The same forward serves Llama and Qwen2 (Q/K/V
    biases) and, through the Gemma knobs that ``models.gemma`` sets, the
    Gemma families; their defaults keep every other family as it was."""

    name: str = 'mistral'
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int | None = None
    intermediate_size: int = 14336
    max_position_embeddings: int = 32768
    rope_theta: float = 10000.0
    rope_scaling: dict | None = None
    rms_norm_eps: float = 1e-5
    sliding_window: int | None = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    # --- Gemma-family knobs (the JAX config's, with its defaults) ---
    activation: str = 'silu'  # MLP gate activation (gemma: 'gelu_new')
    embedding_multiplier: float | None = None  # gemma: sqrt(hidden_size)
    norm_plus_one: bool = False  # gemma RMSNorm computes (1 + w)
    post_norms: bool = False  # gemma2 sandwich norms around attention and MLP
    query_scale: float | None = None  # gemma2 query_pre_attn_scalar ** -0.5
    attn_logit_softcap: float | None = None  # gemma2 tanh cap on scores
    final_logit_softcap: float | None = None  # gemma2 tanh cap on logits
    # 'all': every layer uses sliding_window (Mistral); 'alternating':
    # gemma2's even layers local, odd layers global.
    sliding_window_pattern: str = 'all'
    # Quantized-matmul tier of every projection over an int8 weight
    # (``ops.quantized_matmul``): 'auto' = kernel K2 on CUDA, the plain
    # version on the CPU; 'reference' = the plain version anywhere. The
    # engine pins the value it resolved at construction.
    qmm_backend: str = 'auto'
    dtype: str = 'bfloat16'

    # The values ``name`` may take in this class.
    NAMES = ('mistral',)
    # Not a field: the rank's tensor-parallel collectives
    # (``parallel.comm.TensorParallel``) on a copy bound to a mesh by
    # ``parallel.comm.bind``; None runs the whole model. (A
    # ``dataclasses.replace`` of a bound copy drops it.)
    tp = None

    def validate(self) -> None:
        # Take a number in a string as the JAX config's pydantic fields do.
        for name in _FLOAT_FIELDS:
            if isinstance(getattr(self, name), str):
                setattr(self, name, float(getattr(self, name)))
        if self.name not in self.NAMES:
            raise ValueError(
                f'{type(self).__name__}.name must be one of {self.NAMES}, '
                f'got {self.name!r}'
            )
        if self.num_heads % self.num_kv_heads:
            raise ValueError('num_heads must be a multiple of num_kv_heads')
        if self.qmm_backend not in QMM_BACKENDS:
            raise ValueError(
                f'qmm_backend must be one of {QMM_BACKENDS}, got {self.qmm_backend!r}'
            )
        if self.activation not in common.ACTIVATIONS:
            raise ValueError(
                f'activation must be one of {sorted(common.ACTIVATIONS)}, '
                f'got {self.activation!r}'
            )
        if self.sliding_window_pattern not in ('all', 'alternating'):
            raise ValueError(
                "sliding_window_pattern must be 'all' or 'alternating', got "
                f'{self.sliding_window_pattern!r}'
            )
        torch_dtype(self.dtype)

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def from_hf_config(cls, hf: dict) -> 'MistralConfig':
        """Map an HF ``config.json`` dict of the mistral, llama or qwen2
        family (the JAX mapping)."""
        return cls(
            vocab_size=hf['vocab_size'],
            hidden_size=hf['hidden_size'],
            num_layers=hf['num_hidden_layers'],
            num_heads=hf['num_attention_heads'],
            num_kv_heads=hf.get('num_key_value_heads', hf['num_attention_heads']),
            head_dim=hf.get('head_dim'),
            intermediate_size=hf['intermediate_size'],
            max_position_embeddings=hf.get('max_position_embeddings', 32768),
            rope_theta=hf.get('rope_theta', 10000.0),
            rope_scaling=hf.get('rope_scaling'),
            rms_norm_eps=hf.get('rms_norm_eps', 1e-5),
            # Qwen2 configs carry sliding_window even when
            # use_sliding_window is false: honour the switch (Mistral
            # configs have none; absent means enabled if set).
            sliding_window=(
                hf.get('sliding_window')
                if hf.get('use_sliding_window', True) else None
            ),
            tie_word_embeddings=hf.get('tie_word_embeddings', False),
            attention_bias=hf.get('attention_bias', hf.get('model_type') == 'qwen2'),
        )


def init(
    cfg: MistralConfig,
    generator: 'torch.Generator | None' = None,
    device: 'str | torch.device' = 'cuda',
    dtype: 'str | torch.dtype | None' = None,
    quantization: 'bool | str | None' = None,
    leaf_fn=None,
) -> dict:
    """Random weights (normal, std 0.02; norms at their identity: 1, or 0
    under ``norm_plus_one``) created directly on ``device`` in ``dtype``
    (default ``cfg.dtype``) at full width — the ``init_on_device``
    counterpart: one draw per parameter kind with its leading ``L`` axis,
    never a host copy. ``generator`` must live on ``device``; ``None``
    seeds a fresh one with 0. With ``quantization`` ('int8' / 'nf4';
    ``True`` means nf4) the tree is ``quantize_pytree``'s of those
    weights, each float leaf dropped as its codes appear (the engine's
    own quantization, done here; ``mixtral.init`` takes the same
    argument and quantizes layer by layer).

    ``leaf_fn(path, leaf)`` (tensor parallelism:
    ``parallel.sharding.leaf_sharder``) takes each leaf as soon as it is
    drawn and quantized, and what it returns is kept: a rank keeps its
    slice and never holds more than one whole leaf. The draws are the
    unsharded ones, in the same order, so every slice is the unsharded
    tree's bit for bit."""
    device = torch.device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    h, hd, i, L = cfg.hidden_size, cfg.head_size, cfg.intermediate_size, cfg.num_layers
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd
    mode = normalize_mode(quantization)

    def keep(path, leaf):
        # With leaf_fn the leaf at ``path`` is quantized and handed over
        # here; without, the whole tree is quantized below.
        if leaf_fn is None:
            return leaf
        if mode and should_quantize(path, leaf, 4096):
            quantize = quantize_int8 if mode == 'int8' else quantize_nf4
            leaf = quantize(leaf, out_dtype=dt)
        return leaf_fn(path, leaf)

    def normal(*shape):
        out = torch.randn(shape, generator=generator, device=device, dtype=dt)
        return out.mul_(0.02)

    def proj(name, shape):
        out = {'kernel': keep(('layers', name, 'kernel'), normal(L, *shape))}
        if cfg.attention_bias:
            out['bias'] = keep(('layers', name, 'bias'), normal(L, shape[-1]))
        return out

    def norm(*shape):
        return torch.full(shape, 0.0 if cfg.norm_plus_one else 1.0, device=device, dtype=dt)

    def kernel(name, shape):
        return {'kernel': keep(('layers', name, 'kernel'), normal(L, *shape))}

    params = {'embed': keep(('embed',), normal(cfg.vocab_size, h))}
    params['layers'] = {
        'q': proj('q', (h, q_out)),
        'k': proj('k', (h, kv_out)),
        'v': proj('v', (h, kv_out)),
        'o': kernel('o', (q_out, h)),
        'attn_ln': {'scale': norm(L, h)},
        'gate': kernel('gate', (h, i)),
        'up': kernel('up', (h, i)),
        'down': kernel('down', (i, h)),
        'mlp_ln': {'scale': norm(L, h)},
    }
    params['final_ln'] = {'scale': norm(h)}
    if cfg.post_norms:
        params['layers']['post_attn_ln'] = {'scale': norm(L, h)}
        params['layers']['post_mlp_ln'] = {'scale': norm(L, h)}
    if not cfg.tie_word_embeddings:
        params['lm_head'] = keep(('lm_head',), normal(h, cfg.vocab_size))
    if mode and leaf_fn is None:
        params = quantize_pytree(params, mode=mode, out_dtype=dt, delete_source=True)
    return params


def param_specs(cfg: MistralConfig, params: dict | None = None) -> dict:
    """Sharding specs structurally matching ``params`` (the JAX
    ``param_specs``): ``q``/``k``/``v``, ``gate``, ``up`` column-parallel
    over ``model`` (Qwen2's stacked ``[L, out]`` biases with their
    kernels), ``o`` and ``down`` row-parallel, an untied ``lm_head``
    split on the vocab, everything else replicated.

    Encoder-only checkpoints (SFR-Embedding-Mistral) have no ``lm_head``
    even with untied embeddings, so the spec tree mirrors the actual
    params when they are provided."""
    col = {'kernel': P(None, None, 'model')}
    row = {'kernel': P(None, 'model', None)}
    if cfg.attention_bias:
        # Stacked [L, out] biases shard with their column-parallel kernels.
        qkv = {'kernel': P(None, None, 'model'), 'bias': P(None, 'model')}
    else:
        qkv = col
    specs = {
        'embed': P(None, None),
        'layers': {
            'q': dict(qkv),
            'k': dict(qkv),
            'v': dict(qkv),
            'o': dict(row),
            'attn_ln': {'scale': P(None)},
            'gate': dict(col),
            'up': dict(col),
            'down': dict(row),
            'mlp_ln': {'scale': P(None)},
        },
        'final_ln': {'scale': P()},
    }
    if getattr(cfg, 'post_norms', False):
        specs['layers']['post_attn_ln'] = {'scale': P(None)}
        specs['layers']['post_mlp_ln'] = {'scale': P(None)}
    has_lm_head = (
        'lm_head' in params if params is not None else not cfg.tie_word_embeddings
    )
    if has_lm_head:
        specs['lm_head'] = P(None, 'model')
    return specs


def _to_torch(tree: dict, device, dtype, leaf_fn=None) -> dict:
    """A parameter tree of numpy arrays (quantized JAX leaves kept as
    codes and fp32 scales) as torch tensors on ``device`` in ``dtype``;
    each leaf, once on the device, goes through ``leaf_fn(path, leaf)``
    when one is given (a rank's slice under tensor parallelism), so the
    device holds one whole leaf at a time."""
    dt = torch_dtype(dtype)
    device = torch.device(device)

    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        if is_jax_qtensor(node):
            leaf = qtensor_from_jax(node, device)
        else:
            leaf = torch.tensor(np.asarray(node, np.float32), dtype=dt, device=device)
        return leaf if leaf_fn is None else leaf_fn(path, leaf)

    return convert(tree, ())


def params_from_jax(
    tree: dict,
    cfg: MistralConfig,
    device: 'str | torch.device' = 'cuda',
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """The weight bridge: a ``distllm_tpu.models.mistral.init`` pytree (or
    a Gemma one, post-norm leaves included) whose leaves the caller
    already turned into numpy arrays, as torch tensors on ``device`` in
    ``dtype`` (default ``cfg.dtype``). The layout is unchanged, so the
    port computes with exactly the JAX weights. A quantized JAX leaf (a
    ``QTensor`` with numpy ``q``/``scale``) becomes the port's
    :class:`QTensor` with its codes and fp32 scales as they are, never
    cast to ``dtype``."""
    required = {'embed', 'layers', 'final_ln'}
    if not required <= set(tree):
        raise ValueError(f'not a mistral param tree: missing {required - set(tree)}')
    if not cfg.tie_word_embeddings and 'lm_head' not in tree:
        raise ValueError('untied config but the tree has no lm_head')
    if cfg.post_norms and not {'post_attn_ln', 'post_mlp_ln'} <= set(tree['layers']):
        raise ValueError('post_norms config but the tree has no post-norm leaves')
    params = _to_torch(tree, device, dtype or cfg.dtype)
    layers = params['layers']
    if layers['q']['kernel'].shape != (
        cfg.num_layers, cfg.hidden_size, cfg.num_heads * cfg.head_size
    ):
        raise ValueError(
            f"q kernel {tuple(layers['q']['kernel'].shape)} does not match "
            'the config'
        )
    return params


def hf_state_dict(state: dict) -> dict[str, np.ndarray]:
    """An HF state dict (torch tensors or numpy arrays) as fp32 numpy
    arrays, keys without the ``model.`` prefix."""
    return {
        key.removeprefix('model.'): np.asarray(torch.as_tensor(value).float())
        for key, value in state.items()
    }


def stack_layers(per_layer: list[dict]) -> dict:
    """Per-layer parameter dicts stacked into one tree with a leading
    ``L`` axis (the JAX ``common.stack_layers``)."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: stack_layers([layer[k] for layer in per_layer]) for k in first}
    return np.stack(per_layer)


def params_from_hf(
    state: dict,
    cfg: MistralConfig,
    device: 'str | torch.device' = 'cuda',
    dtype: 'str | torch.dtype | None' = None,
    leaf_fn=None,
) -> dict:
    """Convert HF ``MistralForCausalLM`` / ``MistralModel`` weights (and
    the Llama and Qwen2 ones) with the JAX mapping: Linear ``[out, in]``
    weights transposed to ``[in, out]``, layers stacked; Q/K/V biases
    kept, a bias on any other projection refused; ``lm_head`` kept when
    the embeddings are untied and the checkpoint has one (an embedding
    model such as SFR-Embedding-Mistral has none). The tensors land on
    ``device`` in ``dtype`` (default ``cfg.dtype``), each through
    ``leaf_fn`` when given (``_to_torch``)."""
    sd = hf_state_dict(state)

    def lin(key, bias_ok=False):
        out = {'kernel': np.ascontiguousarray(sd[key].T)}
        bias_key = key.removesuffix('.weight') + '.bias'
        if bias_key in sd:
            if not bias_ok:
                # Only Q/K/V biases reach the forward: a checkpoint with
                # another bias must fail, not drop the weight.
                raise ValueError(f'{bias_key}: bias unsupported on this projection')
            out['bias'] = sd[bias_key]
        return out

    layers = []
    for i in range(cfg.num_layers):
        p = f'layers.{i}'
        layers.append({
            'q': lin(f'{p}.self_attn.q_proj.weight', bias_ok=True),
            'k': lin(f'{p}.self_attn.k_proj.weight', bias_ok=True),
            'v': lin(f'{p}.self_attn.v_proj.weight', bias_ok=True),
            'o': lin(f'{p}.self_attn.o_proj.weight'),
            'attn_ln': {'scale': sd[f'{p}.input_layernorm.weight']},
            'gate': lin(f'{p}.mlp.gate_proj.weight'),
            'up': lin(f'{p}.mlp.up_proj.weight'),
            'down': lin(f'{p}.mlp.down_proj.weight'),
            'mlp_ln': {'scale': sd[f'{p}.post_attention_layernorm.weight']},
        })
    tree = {
        'embed': sd['embed_tokens.weight'],
        'layers': stack_layers(layers),
        'final_ln': {'scale': sd['norm.weight']},
    }
    if 'lm_head.weight' in sd and not cfg.tie_word_embeddings:
        tree['lm_head'] = np.ascontiguousarray(sd['lm_head.weight'].T)
    return _to_torch(tree, device, dtype or cfg.dtype, leaf_fn)


_ROPE_CACHE: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _rope_tables(cfg: MistralConfig, max_len: int, device: torch.device):
    """RoPE tables on ``device``, built once per geometry and device."""
    key = (
        cfg.head_size, max_len, cfg.rope_theta, repr(cfg.rope_scaling),
        str(device),
    )
    tables = _ROPE_CACHE.get(key)
    if tables is None:
        cos, sin = common.rope_frequencies(
            cfg.head_size, max_len, cfg.rope_theta, cfg.rope_scaling
        )
        tables = (
            torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)
        )
        _ROPE_CACHE[key] = tables
    return tables


def _norm(x: torch.Tensor, scale: torch.Tensor, cfg: MistralConfig) -> torch.Tensor:
    return common.rms_norm(x, scale, cfg.rms_norm_eps, plus_one=cfg.norm_plus_one)


def _embed_tokens(params: dict, cfg: MistralConfig, input_ids: torch.Tensor):
    dt = torch_dtype(cfg.dtype)
    x = params['embed'][input_ids.long()].to(dt)
    if cfg.embedding_multiplier is not None:
        # Gemma scales the embeddings by sqrt(hidden) rounded to the
        # compute dtype (HF casts the normalizer), as the JAX code does.
        x = x * torch.tensor(cfg.embedding_multiplier, dtype=dt).item()
    return x


def _mlp_block(
    normed: torch.Tensor, lp: dict, li: int, cfg: MistralConfig
) -> torch.Tensor:
    """Per-layer MLP of layer ``li``: the gated MLP (SwiGLU; GeGLU for
    Gemma), or Mixtral's routed expert bank when the layer carries a
    ``router`` (``mixtral.moe_mlp``, the JAX dispatch on the tree's
    structure). Every program of the forward reaches it through
    :func:`_residual_block`, decode's ``[B, H]`` rows included. A router
    without ``cfg.experts_per_token`` raises rather than guess top 2."""
    if 'router' in lp:
        from distllm_tpu_torch.models.mixtral import moe_mlp

        return moe_mlp(
            normed, lp['router']['kernel'][li], lp['gate']['kernel'][li],
            lp['up']['kernel'][li], lp['down']['kernel'][li], cfg.experts_per_token,
            tp=cfg.tp,
        )
    qb = cfg.qmm_backend
    act = common.ACTIVATIONS[cfg.activation]
    gate = common.dense(normed, lp['gate']['kernel'][li], qmm_backend=qb)
    up = common.dense(normed, lp['up']['kernel'][li], qmm_backend=qb)
    out = common.dense(act(gate) * up, lp['down']['kernel'][li], qmm_backend=qb)
    # Row-parallel down: the ranks' partial sums over their width slices.
    return out if cfg.tp is None else cfg.tp.reduce_model(out)


def _layer_window(cfg: MistralConfig, li: int) -> int | None:
    """Layer ``li``'s sliding window as a Python value (``None`` = global),
    so a captured graph holds it as a constant: ``cfg.sliding_window`` on
    every layer, or with the ``'alternating'`` pattern (gemma2) on the even
    layers only — the JAX ``_layer_window_flags``."""
    if cfg.sliding_window_pattern == 'alternating' and li % 2:
        return None
    return cfg.sliding_window


def _residual_block(
    x: torch.Tensor, attn: torch.Tensor, lp: dict, li: int, cfg: MistralConfig
) -> torch.Tensor:
    """The rest of layer ``li`` after attention (``attn`` with its heads
    merged): the output projection, the residual adds, the MLP, and with
    ``post_norms`` (gemma2) the sandwich norms on both branches."""
    attn_out = common.dense(attn, lp['o']['kernel'][li], qmm_backend=cfg.qmm_backend)
    if cfg.tp is not None:  # row-parallel o: the ranks' heads summed
        attn_out = cfg.tp.reduce_model(attn_out)
    if cfg.post_norms:
        attn_out = _norm(attn_out, lp['post_attn_ln']['scale'][li], cfg)
    x = x + attn_out
    mlp = _mlp_block(_norm(x, lp['mlp_ln']['scale'][li], cfg), lp, li, cfg)
    if cfg.post_norms:
        mlp = _norm(mlp, lp['post_mlp_ln']['scale'][li], cfg)
    return x + mlp


def _proj(
    x: torch.Tensor, lp: dict, name: str, li: int, cfg: MistralConfig
) -> torch.Tensor:
    bias = lp[name].get('bias')
    return common.dense(
        x, lp[name]['kernel'][li], None if bias is None else bias[li],
        qmm_backend=cfg.qmm_backend,
    )


def _kv_layer(cache, li: int):
    """Layer ``li``'s slice of a stacked KV pool, as views (the in-place
    writes land in the pool): a bare tensor's ``[li]``, or both members of
    an int8 :class:`QuantizedKV` (data AND its per-block scales) — the JAX
    ``_kv_layer``."""
    if isinstance(cache, QuantizedKV):
        return QuantizedKV(cache.data[li], cache.scale[li])
    return cache[li]


def _attention(attn_backend: str):
    if attn_backend == 'auto':
        return ragged_paged_attention
    if attn_backend == 'reference':
        return ragged_paged_attention_reference
    raise ValueError(
        f'attn_backend must be one of {ATTN_BACKENDS}, got {attn_backend!r}'
    )


def logits(params: dict, cfg: MistralConfig, hidden: torch.Tensor) -> torch.Tensor:
    """LM head: ``[..., H]`` hidden -> fp32 ``[..., V]`` logits (tanh
    soft-capped under ``final_logit_softcap``). Under tensor parallelism
    an untied ``lm_head`` holds the rank's vocab slice, whose logits are
    gathered; the tied embedding is replicated."""
    if cfg.tie_word_embeddings or 'lm_head' not in params:
        kernel = params['embed'].t()
        out = common.dense(hidden, kernel, qmm_backend=cfg.qmm_backend).float()
    else:
        out = common.dense(hidden, params['lm_head'], qmm_backend=cfg.qmm_backend).float()
        if cfg.tp is not None:
            out = cfg.tp.gather_model(out)
    if cfg.final_logit_softcap is not None:
        out = common.softcap(out, cfg.final_logit_softcap)
    return out


def _dense_mask(attention_mask: torch.Tensor, window: int | None) -> torch.Tensor:
    """Causal x key-validity boolean mask ``[B, 1, S, S]``, limited to the
    sliding ``window`` when one is given (the JAX ``_attn_mask``)."""
    seq = attention_mask.shape[1]
    dev = attention_mask.device
    mask = common.causal_mask(seq, seq, device=dev)
    if window is not None:
        pos = torch.arange(seq, device=dev)
        mask = mask & (pos[None, :] > pos[:, None] - window)
    return mask[None, None] & attention_mask.bool()[:, None, None, :]


def _forward(
    params: dict,
    cfg: MistralConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    *,
    collect_kv: bool,
    mesh=None,
    seq_parallel: str | None = None,
):
    """The dense causal forward over whole sequences (positions 0..S-1):
    attention through ``common.sdpa`` with each layer's causal and window
    mask (gemma2: windowed even layers, global odd ones), the query scale
    and the logit softcap. Returns ``(hidden [B, S, H], k, v)`` with the
    per-layer K/V ``[L, B, S, N_kv, Hd]`` when ``collect_kv``, else
    ``None`` for both."""
    if mesh is not None or seq_parallel is not None:
        raise NotImplementedError(
            'sequence parallelism (mesh / seq_parallel: ring attention) is not '
            'ported to distllm_tpu_torch yet (ROADMAP A10c); tensor parallelism '
            'binds the config instead (parallel.comm.bind)'
        )
    b, s = input_ids.shape
    hd = cfg.head_size
    nh, nkv = local_heads(cfg)
    cos, sin = _rope_tables(cfg, s, input_ids.device)
    positions = torch.arange(s, device=input_ids.device)[None].expand(b, s)
    windows = [_layer_window(cfg, li) for li in range(cfg.num_layers)]
    masks = {w: _dense_mask(attention_mask, w) for w in set(windows)}
    x = _embed_tokens(params, cfg, input_ids)
    lp = params['layers']
    ks, vs = [], []
    for li in range(cfg.num_layers):
        normed = _norm(x, lp['attn_ln']['scale'][li], cfg)
        q = _proj(normed, lp, 'q', li, cfg).reshape(b, s, nh, hd)
        k = _proj(normed, lp, 'k', li, cfg).reshape(b, s, nkv, hd)
        v = _proj(normed, lp, 'v', li, cfg).reshape(b, s, nkv, hd)
        q = common.apply_rope(q, cos, sin, positions)
        k = common.apply_rope(k, cos, sin, positions)
        attn = common.sdpa(
            q, k, v, mask=masks[windows[li]], scale=cfg.query_scale,
            logit_softcap=cfg.attn_logit_softcap,
        )
        x = _residual_block(x, common.merge_heads(attn), lp, li, cfg)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    hidden = _norm(x, params['final_ln']['scale'], cfg)
    if collect_kv:
        return hidden, torch.stack(ks), torch.stack(vs)
    return hidden, None, None


def apply(
    params: dict,
    cfg: MistralConfig,
    input_ids: torch.Tensor,  # [B, S]
    attention_mask: torch.Tensor,  # [B, S], nonzero = valid
    *,
    mesh=None,
    seq_parallel: str | None = None,
) -> torch.Tensor:
    """Dense causal forward: ``[B, S]`` -> last hidden states ``[B, S, H]``
    (the embedding path: SFR-Embedding-Mistral with last-token pooling).
    ``mesh`` / ``seq_parallel`` (sequence parallelism) raise: ROADMAP A10c.
    A config bound to a mesh (``parallel.comm.bind``) runs the rank's
    heads and widths, tensor-parallel."""
    hidden, _, _ = _forward(
        params, cfg, input_ids, attention_mask, collect_kv=False,
        mesh=mesh, seq_parallel=seq_parallel,
    )
    return hidden


def prefill(
    params: dict,
    cfg: MistralConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`apply` that also returns the per-layer K/V
    ``[L, B, S, N_kv, Hd]``."""
    return _forward(params, cfg, input_ids, attention_mask, collect_kv=True)


def prefill_paged(
    params: dict,
    cfg: MistralConfig,
    input_ids: torch.Tensor,  # [B, S] uncached tail tokens (padded)
    positions: torch.Tensor,  # [B, S] absolute position of each tail token
    k_cache: torch.Tensor,  # [L, num_blocks, block_size, N_kv, Hd]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks]
    context_lens: torch.Tensor,  # [B] total valid tokens incl. this tail
    tail_lens: torch.Tensor,  # [B] valid tokens in input_ids (0 = pad row)
    max_table_positions: int | None = None,
    attn_backend: str = 'auto',
    all_logits: bool = False,
    rope: 'tuple[torch.Tensor, torch.Tensor] | None' = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill a prompt TAIL against the KV history already in the pool.

    Each layer writes the tail's K/V into its pool plane first, then the
    tail queries attend over the paged cache (cached prefix and own span
    together) with ``q_lens=tail_lens`` — the rows are ragged spans.
    Returns ``(last_logits [B, V] fp32, k_cache, v_cache)`` taken at each
    row's last valid position; with ``all_logits`` (speculative
    verification) the logits of every span position, ``[B, S, V]``, from
    the same forward. Padding positions write to the trash block 0 and
    their logits are garbage the caller discards. ``rope`` passes the
    ``(cos, sin)`` tables in (a captured step's own); by default they
    come from the per-device cache.
    """
    attend = _attention(attn_backend)
    b, s = input_ids.shape
    table_len = max_table_positions or cfg.max_position_embeddings
    cos, sin = rope or _rope_tables(cfg, table_len, input_ids.device)
    valid = (
        torch.arange(s, device=input_ids.device)[None, :] < tail_lens[:, None]
    )
    x = _embed_tokens(params, cfg, input_ids)  # [B, S, H]
    lp = params['layers']
    hd = cfg.head_size
    nh, nkv = local_heads(cfg)
    for li in range(cfg.num_layers):
        normed = _norm(x, lp['attn_ln']['scale'][li], cfg)
        q = _proj(normed, lp, 'q', li, cfg).reshape(b, s, nh, hd)
        k = _proj(normed, lp, 'k', li, cfg).reshape(b, s, nkv, hd)
        v = _proj(normed, lp, 'v', li, cfg).reshape(b, s, nkv, hd)
        q = common.apply_rope(q, cos, sin, positions)
        k = common.apply_rope(k, cos, sin, positions)
        k_layer, v_layer = _kv_layer(k_cache, li), _kv_layer(v_cache, li)
        write_chunk_kv(k_layer, v_layer, k, v, block_tables, positions, valid)
        attn = attend(
            q, k_layer, v_layer, block_tables, context_lens,
            positions, q_lens=tail_lens, sliding_window=_layer_window(cfg, li),
            scale=cfg.query_scale, logit_softcap=cfg.attn_logit_softcap,
        )
        x = _residual_block(x, attn.reshape(b, s, nh * hd), lp, li, cfg)
    hidden = _norm(x, params['final_ln']['scale'], cfg)
    if all_logits:
        return logits(params, cfg, hidden), k_cache, v_cache
    last_idx = torch.clamp(tail_lens.long() - 1, min=0)
    last_hidden = hidden[torch.arange(b, device=hidden.device), last_idx]
    return logits(params, cfg, last_hidden), k_cache, v_cache


def _decode_core(
    params: dict,
    cfg: MistralConfig,
    input_ids: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B]
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks]
    context_lens: torch.Tensor,  # [B]
    cos: torch.Tensor,
    sin: torch.Tensor,
    attn_backend: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step, RoPE tables passed in. A decode row is the
    ragged op's span-1 case: one query at the token's own position over
    the whole context."""
    attend = _attention(attn_backend)
    b = input_ids.shape[0]
    hd = cfg.head_size
    nh, nkv = local_heads(cfg)
    x = _embed_tokens(params, cfg, input_ids)  # [B, H]
    lp = params['layers']
    pos_span = positions[:, None]
    for li in range(cfg.num_layers):
        normed = _norm(x, lp['attn_ln']['scale'][li], cfg)
        q = _proj(normed, lp, 'q', li, cfg).reshape(b, 1, nh, hd)
        k = _proj(normed, lp, 'k', li, cfg).reshape(b, 1, nkv, hd)
        v = _proj(normed, lp, 'v', li, cfg).reshape(b, nkv, hd)
        q = common.apply_rope(q, cos, sin, pos_span)
        k = common.apply_rope(k, cos, sin, pos_span)[:, 0]
        k_layer, v_layer = _kv_layer(k_cache, li), _kv_layer(v_cache, li)
        write_token_kv(k_layer, v_layer, k, v, block_tables, positions)
        attn = attend(
            q, k_layer, v_layer, block_tables, context_lens,
            pos_span, sliding_window=_layer_window(cfg, li),
            scale=cfg.query_scale, logit_softcap=cfg.attn_logit_softcap,
        )
        x = _residual_block(x, attn.reshape(b, nh * hd), lp, li, cfg)
    hidden = _norm(x, params['final_ln']['scale'], cfg)
    return logits(params, cfg, hidden), k_cache, v_cache


def decode_step(
    params: dict,
    cfg: MistralConfig,
    input_ids: torch.Tensor,  # [B] one new token per sequence
    positions: torch.Tensor,  # [B] 0-based index of that token
    k_cache: torch.Tensor,  # [L, num_blocks, block_size, N_kv, Hd]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks]
    context_lens: torch.Tensor,  # [B] valid tokens incl. the new one
    attn_backend: str = 'auto',
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode: ``(logits [B, V] fp32, k_cache, v_cache)`` with
    the new token's K/V written into its block. Inactive slots point their
    table rows at the trash block 0."""
    cos, sin = _rope_tables(cfg, cfg.max_position_embeddings, input_ids.device)
    return _decode_core(
        params, cfg, input_ids, positions, k_cache, v_cache, block_tables,
        context_lens, cos, sin, attn_backend,
    )


def decode_window_step(
    params: dict,
    cfg: MistralConfig,
    k_cache,
    v_cache,
    block_tables: torch.Tensor,  # [B, max_blocks] — covers the window
    ids: torch.Tensor,  # [B] carry: last emitted token per slot
    pos: torch.Tensor,  # [B] carry: 0-based index of that token
    ctx: torch.Tensor,  # [B] carry: valid tokens incl. that token
    live_steps: torch.Tensor,  # [B] carry: tokens this slot may still emit
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    min_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] (0 disables)
    seeds: torch.Tensor,  # [B] per-request sampling seeds
    token_out: torch.Tensor,  # [B] int32: receives this step's token
    cos: torch.Tensor,
    sin: torch.Tensor,
    attn_backend: str = 'auto',
    all_greedy: bool = False,
    sampling_top_window: int = 0,
) -> None:
    """One fused decode+sample step of a window, every result written IN
    PLACE into tensors the caller owns: the carry (``ids``, ``pos``,
    ``ctx``, ``live_steps``) by ``copy_``, the pool by the KV writes, the
    step's token into ``token_out``. Nothing is rebound and nothing read
    back, so the step can be captured once as a CUDA graph and replayed
    over the same buffers (``generate.engine.decode_graph``).

    A slot with ``live_steps <= 0`` routes its KV write to the trash block
    0 and does not advance; its token is garbage the host discards.
    """
    live = live_steps > 0
    # Out-of-budget slots write to the trash block and stop advancing.
    bt_eff = torch.where(live[:, None], block_tables, 0)
    step_logits, _, _ = _decode_core(
        params, cfg, ids, pos, k_cache, v_cache, bt_eff, ctx, cos, sin,
        attn_backend,
    )
    # The token produced this step sits at absolute index pos + 1.
    token = sample_tokens(
        step_logits, temperature, top_p, min_p,
        fold_row_keys(seeds, pos + 1), top_window=sampling_top_window,
        top_k=top_k, all_greedy=all_greedy,
    )
    token_out.copy_(token)
    ids.copy_(torch.where(live, token, ids))
    pos.copy_(torch.where(live, pos + 1, pos))
    ctx.copy_(torch.where(live, ctx + 1, ctx))
    live_steps.sub_(1)


def decode_loop(
    params: dict,
    cfg: MistralConfig,
    input_ids: torch.Tensor,  # [B] last emitted token per slot
    positions: torch.Tensor,  # [B] 0-based index of that token
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_blocks] — covers +num_steps tokens
    context_lens: torch.Tensor,  # [B] valid tokens incl. the input token
    steps_left: torch.Tensor,  # [B] tokens this slot may emit now
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    min_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] (0 disables)
    seeds: torch.Tensor,  # [B] per-request sampling seeds
    num_steps: int,
    attn_backend: str = 'auto',
    max_table_positions: int | None = None,
    all_greedy: bool = False,
    sampling_top_window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``num_steps`` fused decode+sample steps, eagerly: the loop over
    :func:`decode_window_step` on copies of the inputs (which stay as they
    are); each sampled token feeds the next step on the device, and nothing
    is fetched to the host. The engine replays the same step as a CUDA
    graph on the card; this is its eager twin.

    Slots whose ``steps_left`` runs out mid-window route their KV writes
    to the trash block 0 and stop advancing; their later tokens are
    garbage the host discards. ``all_greedy`` is the host's promise that
    every row is greedy (argmax without the sampling filter). Returns
    ``(tokens [num_steps, B] int32, k_cache, v_cache, last_ids)``.
    """
    table_len = max_table_positions or cfg.max_position_embeddings
    cos, sin = _rope_tables(cfg, table_len, input_ids.device)
    ids, pos, ctx, live_steps = (
        x.clone() for x in (input_ids, positions, context_lens, steps_left)
    )
    tokens = torch.empty(
        (num_steps, input_ids.shape[0]), dtype=torch.int32, device=input_ids.device
    )
    for step in range(num_steps):
        decode_window_step(
            params, cfg, k_cache, v_cache, block_tables, ids, pos, ctx,
            live_steps, temperature, top_p, min_p, top_k, seeds, tokens[step],
            cos, sin, attn_backend=attn_backend, all_greedy=all_greedy,
            sampling_top_window=sampling_top_window,
        )
    return tokens, k_cache, v_cache, ids


def prefill_chunk_rows(
    params: dict,
    cfg: MistralConfig,
    k_cache,
    v_cache,
    chunk: tuple,  # (ids, pos, bt, ctx, tails, temp, top_p, min_p, top_k, seeds)
    max_table_positions: int | None = None,
    attn_backend: str = 'auto',
    sampling_top_window: int = 0,
    all_greedy: bool = False,
) -> torch.Tensor:
    """The chunk half of a mixed or speculative window: one
    :func:`prefill_paged` pass over the prefill-chunk rows ``chunk`` (the
    operands of the JAX ``mixed_window``'s chunk half, in its order), then
    a token sampled at each row's last valid position with the key of
    the token it produces, ``fold_row_keys(seeds, ctx)`` (tokens
    ``0..ctx-1`` are prompt), as a standalone prefill samples it. Returns
    ``chunk_tokens [C]`` int32: meaningful only for rows whose tail ends
    here."""
    ids, pos, bt, ctx, tails, temp, top_p, min_p, top_k, seeds = chunk
    chunk_logits, _, _ = prefill_paged(
        params, cfg, ids, pos, k_cache, v_cache, bt, ctx, tails,
        max_table_positions=max_table_positions, attn_backend=attn_backend,
    )
    return sample_tokens(
        chunk_logits, temp, top_p, min_p, fold_row_keys(seeds, ctx),
        top_window=sampling_top_window, top_k=top_k, all_greedy=all_greedy,
    )


def mixed_window(
    params: dict,
    cfg: MistralConfig,
    input_ids: torch.Tensor,  # [B] last emitted token per slot
    positions: torch.Tensor,  # [B]
    k_cache,
    v_cache,
    block_tables: torch.Tensor,  # [B, max_blocks]
    context_lens: torch.Tensor,  # [B]
    steps_left: torch.Tensor,  # [B]
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    min_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] (0 disables)
    seeds: torch.Tensor,  # [B]
    chunk: tuple,  # prefill_chunk_rows's operands, C rows
    num_steps: int,
    attn_backend: str = 'auto',
    max_table_positions: int | None = None,
    sampling_top_window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One mixed serving window, eagerly (the JAX ``mixed_window``): the
    prefill-chunk rows' pass (:func:`prefill_chunk_rows`), then
    :func:`decode_loop` over the decode rows. Chunk rows and decode rows
    own disjoint blocks, so each half computes what its standalone
    dispatch would. The engine runs the chunk half eagerly and the decode
    half as graph replays. Returns ``(tokens [num_steps, B], k_cache,
    v_cache, last_ids, chunk_tokens [C])``."""
    chunk_tokens = prefill_chunk_rows(
        params, cfg, k_cache, v_cache, chunk,
        max_table_positions=max_table_positions, attn_backend=attn_backend,
        sampling_top_window=sampling_top_window,
    )
    tokens, _, _, last_ids = decode_loop(
        params, cfg, input_ids, positions, k_cache, v_cache, block_tables,
        context_lens, steps_left, temperature, top_p, min_p, top_k, seeds,
        num_steps=num_steps, attn_backend=attn_backend,
        max_table_positions=max_table_positions,
        sampling_top_window=sampling_top_window,
    )
    return tokens, k_cache, v_cache, last_ids, chunk_tokens


def _verify(
    params, cfg, span_ids, span_positions, k_cache, v_cache, block_tables,
    context_lens, span_lens, temperature, top_p, min_p, top_k, seeds, *,
    attn_backend, max_table_positions, sampling_top_window, all_greedy,
    rope=None,
) -> torch.Tensor:
    """The verify pass: every span position's logits from one
    :func:`prefill_paged` forward, then :func:`~distllm_tpu_torch.ops
    .sampling.verify_spans`. Returns packed ``[B, S+1]`` int32."""
    span_logits, _, _ = prefill_paged(
        params, cfg, span_ids, span_positions, k_cache, v_cache, block_tables,
        context_lens, span_lens, max_table_positions=max_table_positions,
        attn_backend=attn_backend, all_logits=True, rope=rope,
    )
    return verify_spans(
        span_logits, span_ids, span_lens, span_positions, temperature, top_p,
        min_p, top_k, seeds, top_window=sampling_top_window,
        all_greedy=all_greedy,
    )


def spec_window(
    params: dict,
    cfg: MistralConfig,
    span_ids: torch.Tensor,  # [B, S] last emitted token + draft tokens
    span_positions: torch.Tensor,  # [B, S] absolute positions
    k_cache,
    v_cache,
    block_tables: torch.Tensor,  # [B, max_blocks]
    context_lens: torch.Tensor,  # [B] valid tokens incl. the span
    span_lens: torch.Tensor,  # [B] valid span tokens (0 = inactive slot)
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    min_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] (0 disables)
    seeds: torch.Tensor,  # [B]
    chunk: 'tuple | None' = None,  # prefill_chunk_rows's operands
    max_table_positions: int | None = None,
    sampling_top_window: int = 0,
    attn_backend: str = 'auto',
    all_greedy: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, 'torch.Tensor | None']:
    """One speculative verify window, eagerly (the JAX ``spec_window``):
    the optional chunk half (:func:`prefill_chunk_rows`), then the verify
    pass over each row's ``[last emitted token, d_1..d_m]`` at positions
    ``num_tokens - 1 ..``, through the same write-then-attend forward as
    a paged prefill, and :func:`~distllm_tpu_torch.ops.sampling
    .verify_spans`. Rejected suffixes need no rollback of K/V: their
    writes sit at positions at or past the row's context after
    acceptance, which every later pass overwrites before it attends or
    masks out. The engine replays the verify half as a CUDA graph
    (:func:`verify_window_step`); this is its eager twin. Returns
    ``(packed [B, S+1] int32, k_cache, v_cache, chunk_tokens [C] | None)``.
    """
    chunk_tokens = None
    if chunk is not None:
        chunk_tokens = prefill_chunk_rows(
            params, cfg, k_cache, v_cache, chunk,
            max_table_positions=max_table_positions, attn_backend=attn_backend,
            sampling_top_window=sampling_top_window,
        )
    packed = _verify(
        params, cfg, span_ids, span_positions, k_cache, v_cache, block_tables,
        context_lens, span_lens, temperature, top_p, min_p, top_k, seeds,
        attn_backend=attn_backend, max_table_positions=max_table_positions,
        sampling_top_window=sampling_top_window, all_greedy=all_greedy,
    )
    return packed, k_cache, v_cache, chunk_tokens


def verify_window_step(
    params: dict,
    cfg: MistralConfig,
    k_cache,
    v_cache,
    span_ids: torch.Tensor,  # [B, S]
    span_positions: torch.Tensor,  # [B, S]
    block_tables: torch.Tensor,  # [B, max_blocks]
    context_lens: torch.Tensor,  # [B]
    span_lens: torch.Tensor,  # [B]
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    min_p: torch.Tensor,
    top_k: torch.Tensor,
    seeds: torch.Tensor,
    packed_out: torch.Tensor,  # [B, S+1] int32: receives the packed result
    cos: torch.Tensor,
    sin: torch.Tensor,
    attn_backend: str = 'auto',
    all_greedy: bool = False,
    sampling_top_window: int = 0,
) -> None:
    """The verify half of :func:`spec_window` with its result written IN
    PLACE into ``packed_out`` and the RoPE tables passed in: nothing is
    rebound and nothing read back, so the step is captured once as a CUDA
    graph and replayed over the same buffers
    (``generate.engine.decode_graph.VerifyGraphRunner``)."""
    packed_out.copy_(_verify(
        params, cfg, span_ids, span_positions, k_cache, v_cache, block_tables,
        context_lens, span_lens, temperature, top_p, min_p, top_k, seeds,
        attn_backend=attn_backend, max_table_positions=None,
        sampling_top_window=sampling_top_window, all_greedy=all_greedy,
        rope=(cos, sin),
    ))
