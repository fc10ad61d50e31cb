"""Mistral/Llama-family decoder over the paged KV cache (PyTorch
counterpart of ``distllm_tpu.models.mistral``, the serving half).

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
card-side identity check).

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
    QuantizedKV,
    ragged_paged_attention,
    ragged_paged_attention_reference,
    write_chunk_kv,
    write_token_kv,
)
from distllm_tpu_torch.ops.quantization import is_jax_qtensor, qtensor_from_jax
from distllm_tpu_torch.ops.quantized_matmul import QMM_BACKENDS
from distllm_tpu_torch.ops.sampling import fold_row_keys, sample_tokens, verify_spans
from distllm_tpu_torch.utils import BaseConfig, torch_dtype

ATTN_BACKENDS = ('auto', 'reference')


@dataclasses.dataclass
class MistralConfig(BaseConfig):
    """Decoder geometry; the defaults are Mistral-7B
    (``mistralai/Mistral-7B-Instruct-v0.2`` widths), as in the JAX
    ``MistralConfig``."""

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
    # Quantized-matmul tier of every projection over an int8 weight
    # (``ops.quantized_matmul``): 'auto' = kernel K2 on CUDA, the plain
    # version on the CPU; 'reference' = the plain version anywhere. The
    # engine pins the value it resolved at construction.
    qmm_backend: str = 'auto'
    dtype: str = 'bfloat16'

    def validate(self) -> None:
        if self.num_heads % self.num_kv_heads:
            raise ValueError('num_heads must be a multiple of num_kv_heads')
        if self.qmm_backend not in QMM_BACKENDS:
            raise ValueError(
                f'qmm_backend must be one of {QMM_BACKENDS}, got {self.qmm_backend!r}'
            )
        torch_dtype(self.dtype)

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


def init(
    cfg: MistralConfig,
    generator: 'torch.Generator | None' = None,
    device: 'str | torch.device' = 'cuda',
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """Random weights (normal, std 0.02; norms at 1) created directly on
    ``device`` in ``dtype`` (default ``cfg.dtype``) at full width — the
    ``init_on_device`` counterpart: one draw per parameter kind with its
    leading ``L`` axis, never a host copy. ``generator`` must live on
    ``device``; ``None`` seeds a fresh one with 0."""
    device = torch.device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    h, hd, i, L = cfg.hidden_size, cfg.head_size, cfg.intermediate_size, cfg.num_layers
    q_out, kv_out = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def normal(*shape):
        out = torch.randn(shape, generator=generator, device=device, dtype=dt)
        return out.mul_(0.02)

    def proj(shape):
        out = {'kernel': normal(L, *shape)}
        if cfg.attention_bias:
            out['bias'] = normal(L, shape[-1])
        return out

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dt)

    params = {
        'embed': normal(cfg.vocab_size, h),
        'layers': {
            'q': proj((h, q_out)),
            'k': proj((h, kv_out)),
            'v': proj((h, kv_out)),
            'o': {'kernel': normal(L, q_out, h)},
            'attn_ln': {'scale': ones(L, h)},
            'gate': {'kernel': normal(L, h, i)},
            'up': {'kernel': normal(L, h, i)},
            'down': {'kernel': normal(L, i, h)},
            'mlp_ln': {'scale': ones(L, h)},
        },
        'final_ln': {'scale': ones(h)},
    }
    if not cfg.tie_word_embeddings:
        params['lm_head'] = normal(h, cfg.vocab_size)
    return params


def params_from_jax(
    tree: dict,
    cfg: MistralConfig,
    device: 'str | torch.device' = 'cuda',
    dtype: 'str | torch.dtype | None' = None,
) -> dict:
    """The weight bridge: a ``distllm_tpu.models.mistral.init`` pytree whose
    leaves the caller already turned into numpy arrays, as torch tensors
    on ``device`` in ``dtype`` (default ``cfg.dtype``). The layout is
    unchanged, so the port computes with exactly the JAX weights. A
    quantized JAX leaf (a ``QTensor`` with numpy ``q``/``scale``) becomes
    the port's :class:`QTensor` with its codes and fp32 scales as they
    are, never cast to ``dtype``."""
    dt = torch_dtype(dtype or cfg.dtype)
    device = torch.device(device)
    required = {'embed', 'layers', 'final_ln'}
    if not required <= set(tree):
        raise ValueError(f'not a mistral param tree: missing {required - set(tree)}')
    if not cfg.tie_word_embeddings and 'lm_head' not in tree:
        raise ValueError('untied config but the tree has no lm_head')

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if is_jax_qtensor(node):
            return qtensor_from_jax(node, device)
        return torch.tensor(np.asarray(node, np.float32), dtype=dt, device=device)

    params = convert(tree)
    layers = params['layers']
    if layers['q']['kernel'].shape != (
        cfg.num_layers, cfg.hidden_size, cfg.num_heads * cfg.head_size
    ):
        raise ValueError(
            f"q kernel {tuple(layers['q']['kernel'].shape)} does not match "
            'the config'
        )
    return params


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
    return common.rms_norm(x, scale, cfg.rms_norm_eps)


def _embed_tokens(params: dict, cfg: MistralConfig, input_ids: torch.Tensor):
    return params['embed'][input_ids.long()].to(torch_dtype(cfg.dtype))


def _mlp_block(
    normed: torch.Tensor, lp: dict, li: int, cfg: MistralConfig
) -> torch.Tensor:
    """Per-layer SwiGLU MLP of layer ``li``."""
    qb = cfg.qmm_backend
    gate = common.dense(normed, lp['gate']['kernel'][li], qmm_backend=qb)
    up = common.dense(normed, lp['up']['kernel'][li], qmm_backend=qb)
    return common.dense(
        common.silu(gate) * up, lp['down']['kernel'][li], qmm_backend=qb
    )


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
    """LM head: ``[..., H]`` hidden -> fp32 ``[..., V]`` logits."""
    if cfg.tie_word_embeddings or 'lm_head' not in params:
        kernel = params['embed'].t()
    else:
        kernel = params['lm_head']
    return common.dense(hidden, kernel, qmm_backend=cfg.qmm_backend).float()


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
    for li in range(cfg.num_layers):
        normed = _norm(x, lp['attn_ln']['scale'][li], cfg)
        q = _proj(normed, lp, 'q', li, cfg).reshape(b, s, cfg.num_heads, hd)
        k = _proj(normed, lp, 'k', li, cfg).reshape(b, s, cfg.num_kv_heads, hd)
        v = _proj(normed, lp, 'v', li, cfg).reshape(b, s, cfg.num_kv_heads, hd)
        q = common.apply_rope(q, cos, sin, positions)
        k = common.apply_rope(k, cos, sin, positions)
        k_layer, v_layer = _kv_layer(k_cache, li), _kv_layer(v_cache, li)
        write_chunk_kv(k_layer, v_layer, k, v, block_tables, positions, valid)
        attn = attend(
            q, k_layer, v_layer, block_tables, context_lens,
            positions, q_lens=tail_lens, sliding_window=cfg.sliding_window,
        )
        x = x + common.dense(
            attn.reshape(b, s, cfg.num_heads * hd), lp['o']['kernel'][li],
            qmm_backend=cfg.qmm_backend,
        )
        x = x + _mlp_block(_norm(x, lp['mlp_ln']['scale'][li], cfg), lp, li, cfg)
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
    x = _embed_tokens(params, cfg, input_ids)  # [B, H]
    lp = params['layers']
    pos_span = positions[:, None]
    for li in range(cfg.num_layers):
        normed = _norm(x, lp['attn_ln']['scale'][li], cfg)
        q = _proj(normed, lp, 'q', li, cfg).reshape(b, 1, cfg.num_heads, hd)
        k = _proj(normed, lp, 'k', li, cfg).reshape(b, 1, cfg.num_kv_heads, hd)
        v = _proj(normed, lp, 'v', li, cfg).reshape(b, cfg.num_kv_heads, hd)
        q = common.apply_rope(q, cos, sin, pos_span)
        k = common.apply_rope(k, cos, sin, pos_span)[:, 0]
        k_layer, v_layer = _kv_layer(k_cache, li), _kv_layer(v_cache, li)
        write_token_kv(k_layer, v_layer, k, v, block_tables, positions)
        attn = attend(
            q, k_layer, v_layer, block_tables, context_lens,
            pos_span, sliding_window=cfg.sliding_window,
        )
        x = x + common.dense(
            attn.reshape(b, cfg.num_heads * hd), lp['o']['kernel'][li],
            qmm_backend=cfg.qmm_backend,
        )
        x = x + _mlp_block(_norm(x, lp['mlp_ln']['scale'][li], cfg), lp, li, cfg)
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
