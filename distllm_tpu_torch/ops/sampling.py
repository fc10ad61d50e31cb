"""Token sampling: temperature, top-p, top-k and min-p over fp32 logits.

The PyTorch counterpart of ``distllm_tpu.ops.sampling``:
``filter_logits``, ``sample_tokens`` (and its alias
``sample_tokens_windowed``) and ``verify_spans``, the device-side
verification of speculative draft spans (rejection sampling for sampled
rows, the argmax rule for greedy ones). Each row carries its own
parameters, so one decode batch mixes sampling configs; temperature
``<= 0`` rows are greedy and take the first index of the largest logit,
exactly as the JAX op does.

PRNG choice. JAX derives a draw's key as
``fold_in(fold_in(PRNGKey(seed), i), tag)`` with threefry. The port keeps
that CONTRACT — a draw is a pure function of (request seed, absolute
token index ``i``, tag), computed on the device with no host loop per
row — but not threefry's bits: :func:`fold_row_keys` mixes the three
32-bit words with the murmur3 finalizer, and :func:`sample_tokens` turns
the row key into one uniform in (0, 1) and inverts the filtered
distribution's CDF (:func:`_draw`, the one categorical draw of the port).
The accept/reject uniform of a draft is
``uniform_from_keys(fold_row_keys(seed, pos + 1, _ACCEPT_FOLD))``; every
categorical draw (ordinary sampling, the residual resample and the bonus
token) uses the ``_SAMPLE_FOLD`` key of the token it produces, so a
span-1 verify of a sampled row draws the token the decode step draws.
Sampled streams are therefore deterministic per seed and schedule, and
agree with JAX in distribution (chi-square tested), not bit for bit.
Greedy output matches JAX exactly.
"""

from __future__ import annotations

import torch

# Tags of the key contract (the JAX package's): the accept/reject uniform
# of a speculative draft, and every categorical draw.
_ACCEPT_FOLD = 1
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


def _draw(
    filtered: torch.Tensor,  # [N, W] filtered logits (-inf = dropped)
    top_idx: torch.Tensor,  # [N, W] their vocab indices
    row_keys: torch.Tensor,  # [N] keys from fold_row_keys
) -> torch.Tensor:
    """One categorical draw per row: invert the CDF of the row's filtered
    distribution at the uniform its key gives. Returns vocab indices
    ``[N]`` (int64)."""
    probs = torch.softmax(filtered, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    u = uniform_from_keys(row_keys)[:, None] * cdf[:, -1:]
    choice = torch.clamp((cdf < u).sum(dim=-1), max=cdf.shape[-1] - 1)
    return torch.gather(top_idx, 1, choice[:, None])[:, 0]


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
    uniform its key gives (:func:`_draw`). ``all_greedy=True`` is a
    caller's promise that every row is greedy (known on the host when
    the batch is built): it skips the filter and takes the argmax, which
    is the greedy rows' answer either way. Returns int32 ``[B]``.
    """
    if all_greedy:
        return torch.argmax(logits.float(), dim=-1).to(torch.int32)
    filtered, top_idx = filter_logits(
        logits, temperature, top_p, min_p, top_k=top_k, top_window=top_window
    )
    sampled = _draw(filtered, top_idx, row_keys)
    return torch.where(temperature > 0, sampled, top_idx[:, 0]).to(torch.int32)


def sample_tokens_windowed(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    min_p: torch.Tensor,
    row_keys: torch.Tensor,
    top_window: int,
    top_k: 'torch.Tensor | None' = None,
) -> torch.Tensor:
    """:func:`sample_tokens` with an explicit window (at least 1), for call
    sites that always window (the JAX alias)."""
    return sample_tokens(
        logits, temperature, top_p, min_p, row_keys,
        top_window=max(1, top_window), top_k=top_k,
    )


def _per_position(x: torch.Tensor, s: int) -> torch.Tensor:
    """``[B]`` -> ``[B * s]``, each row's value repeated for its ``s`` span
    positions (``expand``: no host-side repeat count)."""
    return x[:, None].expand(x.shape[0], s).reshape(-1)


def verify_spans(
    span_logits: torch.Tensor,  # [B, S, V] fp32, every span position's logits
    span_ids: torch.Tensor,  # [B, S] int: [last committed, draft_1..m]
    span_lens: torch.Tensor,  # [B] int: 1 + m (0 = inactive row)
    span_positions: torch.Tensor,  # [B, S] int: absolute span positions
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    min_p: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int
    seeds: torch.Tensor,  # [B] per-request seeds (uint32 values)
    top_window: int = 0,
    all_greedy: bool = False,
) -> torch.Tensor:
    """Speculative verification on the device (the JAX ``verify_spans``).

    The drafts are point masses (prompt lookup proposes no
    probabilities), so a sampled row accepts draft ``d_i`` with
    probability ``p~(d_i)``, the filtered target's probability of it, and
    on the first rejection draws from ``p~`` with ``d_i`` masked out (the
    normalised residual ``(p~ - q)+``; where that leaves nothing, from
    ``p~`` itself), and the span stops. The position past the last draft
    draws the bonus token from ``p~``. Greedy rows (temperature ``<= 0``)
    keep JAX's rule bit for bit: ``out[i]`` is the argmax at position
    ``i`` and draft ``d_{i+1}`` is accepted while it equals it.
    ``all_greedy=True`` is the host's promise that every row is greedy
    (the filter is skipped, as in :func:`sample_tokens`).

    Returns packed ``[B, S+1]`` int32: each position's output token, then
    ``accept_len`` (leading accepted drafts, ``0..m``). The host emits
    ``out[0..accept_len]``. Nothing is read back to the host, so the call
    can be captured in a CUDA graph.
    """
    b, s, vocab = span_logits.shape
    m = torch.clamp(span_lens.long() - 1, min=0)  # drafts per row
    drafts = torch.cat(
        [span_ids[:, 1:].long(), torch.zeros_like(span_ids[:, :1]).long()], dim=1
    )
    pos_in_draft = torch.arange(s, device=span_logits.device)[None, :] < m[:, None]
    if all_greedy:
        cand = torch.argmax(span_logits.float(), dim=-1)
        accept = (cand == drafts) & pos_in_draft
        out = cand
    else:
        flat = span_logits.reshape(b * s, vocab)
        filtered, top_idx = filter_logits(
            flat, _per_position(temperature, s), _per_position(top_p, s),
            _per_position(min_p, s), top_k=_per_position(top_k, s),
            top_window=top_window,
        )
        kw = filtered.shape[-1]
        # The token produced at span position i has absolute index pos_i + 1,
        # the decode step's counter for that token.
        counters = (span_positions.long() + 1).reshape(b * s)
        row_seeds = _per_position(seeds.long(), s)
        u = uniform_from_keys(fold_row_keys(row_seeds, counters, _ACCEPT_FOLD))
        s_keys = fold_row_keys(row_seeds, counters, _SAMPLE_FOLD)
        filtered = filtered.reshape(b, s, kw)
        top_idx = top_idx.reshape(b, s, kw)
        cand = top_idx[:, :, 0]  # the greedy candidate of each position
        # log p~(draft): -inf where the draft lies outside the kept set (a
        # point mass outside supp(p~) is never accepted).
        match = top_idx == drafts[:, :, None]
        neg_inf = float('-inf')
        logz = torch.logsumexp(filtered, dim=-1)
        draft_val = torch.where(match, filtered, neg_inf).amax(dim=-1)
        p_draft = torch.exp(draft_val - logz)
        sampled_row = (temperature > 0)[:, None]
        accept = torch.where(sampled_row, u.reshape(b, s) < p_draft, cand == drafts)
        accept = accept & pos_in_draft
        # The residual for a point mass: p~ with the draft masked out. The
        # bonus position, and rows whose kept set is the draft alone, draw
        # from p~ itself.
        residual = torch.where(match, neg_inf, filtered)
        use_residual = pos_in_draft & torch.isfinite(residual).any(dim=-1)
        source = torch.where(use_residual[:, :, None], residual, filtered)
        corr = _draw(
            source.reshape(b * s, kw), top_idx.reshape(b * s, kw), s_keys
        ).reshape(b, s)
        out = torch.where(sampled_row, corr, cand)
    out = torch.where(accept, drafts, out).to(torch.int32)
    accept_len = torch.cumprod(accept.to(torch.int32), dim=-1).sum(dim=-1)
    return torch.cat([out, accept_len.to(torch.int32)[:, None]], dim=-1)
