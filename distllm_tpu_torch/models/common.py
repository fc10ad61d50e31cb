"""Shared functional layers (PyTorch counterpart of
``distllm_tpu.models.common``, the parts the decoder serving path and the
encoders use), and the encoders' shared parameter and attention plumbing.

Kernels keep the JAX layout ``[in, out]`` so bridged weights copy over
unchanged, and the plain ``x @ W`` products stay ``torch.matmul`` — the
JAX package leaves them to XLA too. int8-quantized kernels go through
kernel K2 (``ops.quantized_matmul``); the encoders' attention goes
through kernel K3 (``ops.encoder_attention``, :func:`encoder_attend`).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from distllm_tpu_torch.ops import encoder_attention as _ea
from distllm_tpu_torch.ops.quantization import QTensor, is_jax_qtensor, qtensor_from_jax
from distllm_tpu_torch.ops.quantized_matmul import int8_dense
from distllm_tpu_torch.utils import resolve_device, torch_dtype


def rms_norm(
    x: torch.Tensor, scale: torch.Tensor, eps: float, plus_one: bool = False
) -> torch.Tensor:
    """RMSNorm with fp32 statistics, cast back to ``x``'s dtype.
    ``plus_one``: the Gemma ``(1 + w)`` parameterization (HF
    ``GemmaRMSNorm``), so loaded weights stay byte-identical to HF."""
    x32 = x.float()
    normed = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    w = scale.float()
    if plus_one:
        w = 1.0 + w
    return (normed * w).to(x.dtype)


def dense(
    x: torch.Tensor,
    kernel: 'torch.Tensor | QTensor',
    bias: 'torch.Tensor | None' = None,
    qmm_backend: str = 'auto',
) -> torch.Tensor:
    """``x @ kernel (+ bias)`` with ``kernel`` laid out ``[in, out]``.

    ``kernel`` may be a quantized :class:`~distllm_tpu_torch.ops.
    quantization.QTensor`. A 2-D int8 one is never dequantized: it goes
    to :func:`~distllm_tpu_torch.ops.quantized_matmul.int8_dense` (kernel
    K2 on the card) with the tier ``qmm_backend``. Any other (nf4) is
    dequantized here, at the point of use, so a layer loop only ever holds
    one layer's float weight.
    """
    if isinstance(kernel, QTensor):
        if kernel.kind == 'int8' and kernel.q.dim() == 2:
            y = int8_dense(x, kernel.q, kernel.scale, backend=qmm_backend)
            if bias is not None:
                y = y + bias.to(y.dtype)
            return y
        kernel = kernel.dequantize()
    y = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def rank_heads(cfg) -> int:
    """The query heads this rank computes: all of them, or under a config
    bound to a mesh (``parallel.comm.bind``) its ``num_heads / model``."""
    tp = getattr(cfg, 'tp', None)
    return cfg.num_heads if tp is None else tp.local_heads(cfg.num_heads)


def row_dense(
    x: torch.Tensor,
    kernel: 'torch.Tensor | QTensor',
    bias: 'torch.Tensor | None',
    tp,
) -> torch.Tensor:
    """A row-parallel layer (a Megatron ``o`` or ``down``): :func:`dense`
    without ``tp``; under ``tp`` (``parallel.comm.TensorParallel``) the
    rank's partial product over its slice of the input axis summed over
    the ``model`` group, then the replicated bias added once, after the
    sum, as GSPMD places it."""
    if tp is None:
        return dense(x, kernel, bias)
    y = tp.reduce_model(dense(x, kernel))
    return y if bias is None else y + bias.to(y.dtype)


def layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: 'torch.Tensor | None',
    eps: float,
) -> torch.Tensor:
    """LayerNorm over the last dim in ``x``'s dtype (callers pass fp32, as
    the JAX encoders do); ``bias=None`` = scale only. Biased variance,
    ``eps`` inside the root — the JAX function, as one fused kernel."""
    return F.layer_norm(x, x.shape[-1:], scale.to(x.dtype),
                        None if bias is None else bias.to(x.dtype), eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """HF 'gelu': the exact erf form, at every dtype."""
    return F.gelu(x, approximate='none')


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Opt-in tanh-approximated GELU (HF ``gelu_pytorch_tanh``)."""
    return F.gelu(x, approximate='tanh')


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping ``tanh(x / cap) * cap`` (attention
    scores and final logits)."""
    return torch.tanh(x / cap) * cap


ACTIVATIONS = {
    'gelu': gelu,
    'gelu_tanh': gelu_tanh,
    'gelu_new': gelu_tanh,  # HF's historical alias for the tanh form
    'silu': silu,
    'relu': F.relu,
}


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``[B, S, N*H] -> [B, S, N, H]`` (a view)."""
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[B, S, N, H] -> [B, S, N*H]``."""
    b, s, n, h = x.shape
    return x.reshape(b, s, n * h)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: expand ``[B, S, N_kv, H]`` to ``[B, S, N_kv * n_rep, H]``
    (each KV head repeated for its group of query heads)."""
    if n_rep == 1:
        return x
    b, s, n, h = x.shape
    return x[:, :, :, None, :].expand(b, s, n, n_rep, h).reshape(b, s, n * n_rep, h)


def causal_mask(
    q_len: int, kv_len: int, offset: int = 0, device=None
) -> torch.Tensor:
    """Boolean ``[q_len, kv_len]`` causal mask: query i sees keys
    ``<= i + offset``."""
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


# jax.nn.dot_product_attention's mask value: -0.7 x the dtype's max, large
# and finite, so a fully masked query row softmaxes to a uniform average.
_MASK_VALUE_SCALE = -0.7


def sdpa(
    q: torch.Tensor,  # [B, S, N, H]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: 'torch.Tensor | None' = None,  # [B, S_kv] or [B, N, S_q, S_kv]
    scale: float | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention over ``[B, S, N, H]`` tensors with a
    boolean mask — a ``[B, S_kv]`` key mask (the BERT ``'xla'`` branch) or
    a broadcastable ``[B, N, S_q, S_kv]`` one (the decoders' causal and
    window masks) — with ``jax.nn.dot_product_attention``'s XLA
    arithmetic: scores in fp32, masked entries set to ``-0.7 *
    finfo(float32).max``, softmax in fp32, probabilities cast to V's
    dtype, the weighted sum accumulated in fp32 and returned in V's dtype.
    K/V with fewer heads than q (GQA) are repeated per group; a
    ``logit_softcap`` (Gemma-2) caps the scaled scores before the mask,
    as the JAX softcap branch does (which then keeps p in fp32)."""
    if k.shape[2] != q.shape[2]:
        k = repeat_kv(k, q.shape[2] // k.shape[2])
        v = repeat_kv(v, q.shape[2] // v.shape[2])
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.einsum('bqnh,bknh->bnqk', q.float(), k.float()) * scale
    if logit_softcap is not None:
        scores = softcap(scores, logit_softcap)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[:, None, None, :]
        fill = _MASK_VALUE_SCALE * torch.finfo(torch.float32).max
        scores = scores.masked_fill(~mask.bool(), fill)
    probs = torch.softmax(scores, dim=-1)
    if logit_softcap is None:
        # The fused path rounds p to V's dtype; the JAX softcap branch
        # weighs V by the fp32 probabilities.
        probs = probs.to(v.dtype)
    out = torch.einsum('bnqk,bknh->bqnh', probs.float(), v.float())
    return out.to(v.dtype)


def rope_frequencies(
    head_dim: int,
    max_len: int,
    theta: float,
    rope_scaling: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """RoPE cos/sin tables ``[max_len, head_dim//2]`` computed on the host
    in float64 and returned as float32 (the JAX function, verbatim)."""
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    if rope_scaling:
        kind = rope_scaling.get('rope_type', rope_scaling.get('type'))
        if kind in (None, 'default'):
            pass
        elif kind == 'linear':
            inv_freq = inv_freq / float(rope_scaling['factor'])
        elif kind == 'llama3':
            factor = float(rope_scaling['factor'])
            low = float(rope_scaling['low_freq_factor'])
            high = float(rope_scaling['high_freq_factor'])
            orig = float(rope_scaling['original_max_position_embeddings'])
            wavelen = 2.0 * np.pi / inv_freq
            smooth = np.clip((orig / wavelen - low) / (high - low), 0.0, 1.0)
            inv_freq = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        else:
            raise NotImplementedError(
                f'rope_scaling type {kind!r} (supported: linear, llama3)'
            )
    t = np.arange(max_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
    positions: 'torch.Tensor | None' = None,
) -> torch.Tensor:
    """Rotate ``[B, S, N, H]`` queries/keys by their ``positions [B, S]``
    (``None``: positions ``0..S-1`` in every row, the encoders' case) in
    the HF rotate-half layout (pairs ``(i, i + H/2)``)."""
    h = x.shape[3]
    if positions is None:
        s = x.shape[1]
        table_cos = cos[None, :s, None, :].to(x.dtype)
        table_sin = sin[None, :s, None, :].to(x.dtype)
    else:
        pos = positions.long()
        table_cos = cos[pos][:, :, None, :].to(x.dtype)
        table_sin = sin[pos][:, :, None, :].to(x.dtype)
    x1 = x[..., : h // 2]
    x2 = x[..., h // 2:]
    return torch.cat(
        [x1 * table_cos - x2 * table_sin, x2 * table_cos + x1 * table_sin],
        dim=-1,
    )


@functools.lru_cache(maxsize=32)
def rope_tables(
    head_dim: int, seq_len: int, theta: float, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rope_frequencies` as fp32 tensors on ``device``, made once
    per (head dim, length, theta, device): the encoders' tables."""
    cos, sin = rope_frequencies(head_dim, seq_len, theta)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


# ------------------------------------------------------------ encoders
# 'auto': ops.encoder_attention (kernel K3 on CUDA, its plain version on
# the CPU); 'reference': the plain version on any device (the card-side
# identity checks); 'xla': split heads + sdpa, the JAX 'xla' branch.
ATTN_IMPLS = ('auto', 'reference', 'xla')


def check_attn_impl(attn_impl: str) -> None:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f'attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}')


def encoder_attend(
    q: torch.Tensor,  # [B, S, N*Hd]
    k: torch.Tensor,
    v: torch.Tensor,
    attention_mask: torch.Tensor,  # [B, S] nonzero = valid key
    num_heads: int,
    attn_impl: str = 'auto',
    bias: 'torch.Tensor | None' = None,  # [S, S] fp32, 0 / -1e9
) -> torch.Tensor:
    """The attention site of every encoder forward, heads packed in the
    last dim. ``'auto'`` is ``ops.encoder_attention.encoder_attention``
    (looked up at call time), which launches K3 on a CUDA tensor or
    raises, and runs the plain version on a CPU tensor. ``'xla'`` turns
    the key mask (and, with a 0 / -1e9 ``bias``, its zeros) into a
    boolean mask for :func:`sdpa`, as the JAX models' XLA branch does."""
    if attn_impl == 'auto':
        return _ea.encoder_attention(q, k, v, attention_mask, num_heads, bias=bias)
    if attn_impl == 'reference':
        return _ea.encoder_attention_reference(
            q, k, v, attention_mask, num_heads, bias=bias
        )
    mask = attention_mask.bool()[:, None, None, :]
    if bias is not None:
        mask = mask & (bias == 0)[None, None]
    return merge_heads(sdpa(
        split_heads(q, num_heads), split_heads(k, num_heads),
        split_heads(v, num_heads), mask=mask,
    ))


def _leaf_kind(path: tuple) -> str:
    """How :func:`init_tree` fills a leaf, by its name: LayerNorm scales
    at 1, biases at 0, everything else (kernels, embedding tables)
    normal with std 0.02 — the JAX ``init`` functions' distribution."""
    return {'scale': 'ones', 'bias': 'zeros'}.get(path[-1], 'normal')


def init_tree(
    shapes: dict,
    in_model_dtype: Callable[[tuple], bool],
    generator: 'torch.Generator | None',
    device: 'str | torch.device | None',
    dtype: 'str | torch.dtype',
) -> dict:
    """Random parameters of the nested ``shapes`` made on ``device``
    (``None`` = CUDA; raises without it): leaves where
    ``in_model_dtype(path)`` holds in ``dtype``, the rest fp32, drawn in
    the tree's order from ``generator`` (which must live on ``device``;
    ``None`` seeds a fresh one with 0)."""
    device = resolve_device(device)
    dt = torch_dtype(dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def make(shape, path):
        out_dtype = dt if in_model_dtype(path) else torch.float32
        kind = _leaf_kind(path)
        if kind == 'normal':
            out = torch.randn(shape, generator=generator, device=device)
            return out.mul_(0.02).to(out_dtype)
        return torch.full(shape, 1.0 if kind == 'ones' else 0.0, device=device,
                          dtype=out_dtype)

    def walk(node, path):
        if isinstance(node, dict):
            return {key: walk(value, path + (key,)) for key, value in node.items()}
        return make(node, path)

    return walk(shapes, ())


def place_tree(
    tree: dict,
    shapes: dict,
    in_model_dtype: Callable[[tuple], bool],
    device: 'str | torch.device | None',
    dtype: 'str | torch.dtype',
    family: str,
) -> dict:
    """Check a parameter tree (numpy arrays, CPU tensors, or quantized
    JAX leaves) against the nested ``shapes`` and move it to ``device``
    (``None`` = CUDA): leaves where ``in_model_dtype(path)`` holds in
    ``dtype``, the rest fp32; a quantized JAX leaf keeps its codes and
    fp32 scales. Raises ``ValueError`` naming ``family`` on a missing or
    extra key, or a shape that does not match."""
    device = resolve_device(device)
    dt = torch_dtype(dtype)

    def walk(node, shape, path):
        where = '/' + '/'.join(path)
        if isinstance(shape, dict):
            if not isinstance(node, dict) or set(node) != set(shape):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(
                    f'not a {family} param tree at {where if path else "root"}: '
                    f'expected keys {sorted(shape)}, got {got}'
                )
            return {key: walk(node[key], shape[key], path + (key,)) for key in shape}
        if is_jax_qtensor(node):
            if tuple(node.shape) != shape:
                raise ValueError(
                    f'{where}: shape {tuple(node.shape)} does not match the '
                    f'config ({shape})'
                )
            return qtensor_from_jax(node, device)
        value = torch.tensor(np.asarray(node, np.float32))
        if tuple(value.shape) != shape:
            raise ValueError(
                f'{where}: shape {tuple(value.shape)} does not match the '
                f'config ({shape})'
            )
        out_dtype = dt if in_model_dtype(path) else torch.float32
        return value.to(device=device, dtype=out_dtype)

    return walk(tree, shapes, ())
