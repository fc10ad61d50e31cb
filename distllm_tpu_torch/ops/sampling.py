"""Token sampling: temperature, top-p, top-k and min-p over fp32 logits.

The PyTorch counterpart of ``distllm_tpu.ops.sampling`` (the decode-path
half: ``filter_logits`` and ``sample_tokens``; speculative verification
waits for its slice). Each row carries its own parameters, so one decode
batch mixes sampling configs; temperature ``<= 0`` rows are greedy and
take the first index of the largest logit, exactly as the JAX op does.

PRNG choice. JAX derives a draw's key as
``fold_in(fold_in(PRNGKey(seed), i), tag)`` with threefry. The port keeps
that CONTRACT — a draw is a pure function of (request seed, absolute
token index ``i``, tag), computed on the device with no host loop per
row — but not threefry's bits: :func:`fold_row_keys` mixes the three
32-bit words with the murmur3 finalizer, and :func:`sample_tokens` turns
the row key into one uniform in (0, 1) and inverts the filtered
distribution's CDF. Sampled streams are therefore deterministic per seed
and schedule, and agree with JAX in distribution (chi-square tested), not
bit for bit. Greedy output matches JAX exactly.
"""

from __future__ import annotations

import torch

# Tag of every categorical draw (the JAX package's _SAMPLE_FOLD; its
# accept/reject tag 1 waits for speculative verification).
_SAMPLE_FOLD = 2
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 values held in int64, in 16-bit
    halves so no intermediate overflows int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer: a bijective avalanche mix."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def fold_row_keys(
    seeds: torch.Tensor,  # [B] per-request seeds (uint32 values)
    counters: torch.Tensor,  # [B] absolute token indices
    fold: int = _SAMPLE_FOLD,
) -> torch.Tensor:
    """One 32-bit key per row from (seed, token counter, tag), as int64.

    Counter-based like the JAX twin: the key for a draw depends only on
    the request seed and the absolute index of the token being produced.
    """
    key = _fmix32(seeds.long() & _MASK32)
    key = _fmix32(key ^ (counters.long() & _MASK32))
    return _fmix32(key ^ (fold & _MASK32))


def uniform_from_keys(keys: torch.Tensor) -> torch.Tensor:
    """One fp32 uniform strictly inside (0, 1) per key (23 key bits)."""
    return ((keys >> 9).float() + 0.5) * (2.0 ** -23)


def filter_logits(
    logits: torch.Tensor,  # [B, V] fp32
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B] (1.0 disables)
    min_p: torch.Tensor,  # [B] (0.0 disables)
    top_k: 'torch.Tensor | None' = None,  # [B] int (0 disables)
    top_window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Temperature-scale and filter logits.

    Returns ``(filtered, top_idx)``: the temperature-scaled logits over
    the descending ``top_window`` set (``0`` = whole vocabulary) with every
    filtered-out entry at ``-inf``, and the vocab indices of that window.
    Probabilities use the full-vocabulary normalizer. At least one token
    always survives. Ties keep the lower vocab index first.
    """
    vocab = logits.shape[-1]
    k = vocab if top_window <= 0 else min(top_window, vocab)
    logits = logits.float()
    safe_temp = torch.where(temperature > 0, temperature, 1.0).float()
    scaled = logits / safe_temp[:, None]
    if k == vocab:
        top_vals, top_idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    else:
        top_vals, top_idx = torch.topk(scaled, k, dim=-1, sorted=True)
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    probs = torch.exp(top_vals - lse)
    cumulative = torch.cumsum(probs, dim=-1)
    # Keep the smallest prefix with cumulative >= top_p (always >= 1 token).
    cutoff_idx = torch.clamp(
        (cumulative < top_p.float()[:, None]).sum(dim=-1), max=k - 1
    )
    cutoff_logit = torch.gather(top_vals, 1, cutoff_idx[:, None])
    # A Python scalar, not a tensor made from one: that would be a
    # blocking host-to-device copy, which a CUDA graph capture refuses.
    neg_inf = float('-inf')
    filtered = torch.where(top_vals >= cutoff_logit, top_vals, neg_inf)
    # min-p in log space; log(0) = -inf disables the filter.
    min_p_threshold = top_vals[:, :1] + torch.log(
        torch.clamp(min_p.float(), min=0.0)
    )[:, None]
    filtered = torch.where(top_vals >= min_p_threshold, filtered, neg_inf)
    if top_k is not None:
        eff = torch.where(top_k > 0, torch.clamp(top_k, max=k), k)
        keep = torch.arange(k, device=logits.device)[None, :] < eff[:, None]
        filtered = torch.where(keep, filtered, neg_inf)
    return filtered, top_idx


def sample_tokens(
    logits: torch.Tensor,  # [B, V] fp32
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B] (1.0 disables)
    min_p: torch.Tensor,  # [B] (0.0 disables)
    row_keys: torch.Tensor,  # [B] keys from fold_row_keys
    top_window: int = 0,
    top_k: 'torch.Tensor | None' = None,  # [B] int (0 disables)
    all_greedy: bool = False,
) -> torch.Tensor:
    """Per-row sampling; temperature ``<= 0`` rows are greedy.

    Each sampled row inverts the CDF of its filtered distribution at the
    uniform its key gives (:func:`uniform_from_keys`). ``all_greedy=True``
    is a caller's promise that every row is greedy (known on the host when
    the batch is built): it skips the filter and takes the argmax, which
    is the greedy rows' answer either way. Returns int32 ``[B]``.
    """
    if all_greedy:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    filtered, top_idx = filter_logits(
        logits, temperature, top_p, min_p, top_k=top_k, top_window=top_window
    )
    probs = torch.softmax(filtered, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    u = uniform_from_keys(row_keys)[:, None] * cdf[:, -1:]
    choice = torch.clamp((cdf < u).sum(dim=-1), max=cdf.shape[-1] - 1)
    sampled = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    return torch.where(temperature > 0, sampled, top_idx[:, 0]).to(torch.int32)
