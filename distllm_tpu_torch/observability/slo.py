"""Multi-window multi-burn-rate SLO engine over the metric history (the
port of ``distllm_tpu.observability.slo``).

Over the request-SLO counters
(``distllm_request_slo_total{outcome=met|missed}``, the TTFT objective
the engine judges) the **burn rate** of a trailing window is

    (missed / finished in the window) / (1 - objective)

— 1.0 spends the error budget exactly at the sustainable rate. A pair
of windows fires only when both its short and its long window burn past
the pair's threshold (window labels owned by
``instruments.SLO_BURN_WINDOW_LABELS``):

- **page pair** — 60 s / 600 s at burn >= 6.0;
- **warn pair** — 300 s / 3600 s at burn >= 1.0.

:func:`slo_status` renders the ok / warn / page verdict with per-window
burn rates, the goodput fraction and uptime. Installed as a history
observer (:func:`install_slo_observer`), every sampler tick refreshes
the ``distllm_slo_burn_rate{window}`` gauges.

``GET /debug/slo`` / ``slo.json`` schema — ``distllm-slo/v1``::

    {"schema": "distllm-slo/v1", "objective": 0.99, "verdict": "ok",
     "burn_rates": {"60s": 0.0, ...},
     "windows": {"60s": {"met": N, "missed": N, "burn_rate": x}, ...},
     "pairs": [{"short": "60s", "long": "600s", "threshold": 6.0,
                "verdict": "page", "firing": false}, ...],
     "goodput_fraction": 0.98, "uptime_s": 123.4}

No traffic in a window reads as burn 0.0; ``goodput_fraction`` is None
until tokens flow.
"""

from __future__ import annotations

import time

from distllm_tpu_torch.observability import instruments as _metrics
from distllm_tpu_torch.observability.history import MetricsHistory

SLO_SCHEMA = 'distllm-slo/v1'

#: Default objective: 99% of finished requests meet the TTFT SLO.
DEFAULT_OBJECTIVE = 0.99

#: (short_label, long_label, burn threshold, verdict) — labels must come
#: from instruments.SLO_BURN_WINDOW_LABELS (the single owner of the
#: gauge's window label set).
DEFAULT_PAIRS = (
    ('60s', '600s', 6.0, 'page'),
    ('300s', '3600s', 1.0, 'warn'),
)


def _window_seconds(label: str) -> float:
    if not label.endswith('s'):
        raise ValueError(f'window label must end in "s": {label!r}')
    return float(label[:-1])


def burn_rate(
    history: MetricsHistory,
    window_s: float,
    *,
    objective: float = DEFAULT_OBJECTIVE,
    now: float | None = None,
) -> dict:
    """One window's burn: ``{'met', 'missed', 'total', 'burn_rate'}``.
    Zero traffic burns nothing (0.0) — the idle replica is healthy."""
    if not 0.0 < objective < 1.0:
        raise ValueError(f'objective must be in (0, 1), got {objective}')
    met = history.counter_window(
        'distllm_request_slo_total', window_s,
        labels={'outcome': 'met'}, now=now,
    )['delta']
    missed = history.counter_window(
        'distllm_request_slo_total', window_s,
        labels={'outcome': 'missed'}, now=now,
    )['delta']
    total = met + missed
    rate = (missed / total) if total > 0 else 0.0
    return {
        'met': met,
        'missed': missed,
        'total': total,
        'burn_rate': rate / (1.0 - objective),
    }


def update_burn_gauges(
    history: MetricsHistory,
    *,
    objective: float = DEFAULT_OBJECTIVE,
    now: float | None = None,
) -> dict[str, float]:
    """Refresh ``distllm_slo_burn_rate{window}`` for every catalogued
    window; returns the label → burn mapping it set."""
    burns: dict[str, float] = {}
    for label in _metrics.SLO_BURN_WINDOW_LABELS:
        burn = burn_rate(
            history, _window_seconds(label), objective=objective, now=now
        )['burn_rate']
        _metrics.SLO_BURN_RATE.labels(window=label).set(burn)
        burns[label] = burn
    return burns


def slo_status(
    history: MetricsHistory | None = None,
    *,
    objective: float = DEFAULT_OBJECTIVE,
    pairs=DEFAULT_PAIRS,
    now: float | None = None,
) -> dict:
    """The ok/warn/page verdict document (module docstring schema).
    Verdict: ``page`` if any page pair fires (both its windows burn past
    threshold), else ``warn`` if any warn pair fires, else ``ok``."""
    if history is None:
        from distllm_tpu_torch.observability.history import get_metrics_history
        history = get_metrics_history()
    now = time.time() if now is None else float(now)
    windows: dict[str, dict] = {}
    for label in _metrics.SLO_BURN_WINDOW_LABELS:
        windows[label] = burn_rate(
            history, _window_seconds(label), objective=objective, now=now
        )
    pair_docs = []
    verdict = 'ok'
    for short, long_, threshold, pair_verdict in pairs:
        firing = (
            windows[short]['burn_rate'] >= threshold
            and windows[long_]['burn_rate'] >= threshold
        )
        pair_docs.append({
            'short': short,
            'long': long_,
            'threshold': threshold,
            'verdict': pair_verdict,
            'firing': firing,
        })
        if firing:
            if pair_verdict == 'page':
                verdict = 'page'
            elif verdict != 'page':
                verdict = 'warn'
    # Goodput fraction over the longest window: tokens from SLO-met
    # requests over all generated tokens — the quality-adjusted share.
    long_s = max(
        _window_seconds(label)
        for label in _metrics.SLO_BURN_WINDOW_LABELS
    )
    good = history.counter_window(
        'distllm_engine_goodput_tokens_total', long_s, now=now
    )['delta']
    generated = history.counter_window(
        'distllm_engine_generated_tokens_total', long_s, now=now
    )['delta']
    return {
        'schema': SLO_SCHEMA,
        'objective': objective,
        'verdict': verdict,
        'burn_rates': {
            label: windows[label]['burn_rate'] for label in windows
        },
        'windows': windows,
        'pairs': pair_docs,
        'goodput_fraction': (good / generated) if generated > 0 else None,
        'uptime_s': _metrics.SERVER_UPTIME.value,
    }


def install_slo_observer(
    history: MetricsHistory, *, objective: float = DEFAULT_OBJECTIVE
):
    """Attach the burn-gauge refresh to the sampler loop; returns the
    observer so callers can ``remove_observer`` it."""

    def _observer(h: MetricsHistory, now: float) -> None:
        update_burn_gauges(h, objective=objective, now=now)

    history.add_observer(_observer)
    return _observer
