"""SLO-aware admission control: predict TTFT at enqueue, shed honestly.

ROADMAP item 4 made the case: the measurement plumbing (roofline cost
model, per-request lifecycle timestamps, goodput counters) exists — turn
it into *policy*. This module is the policy half: a dependency-free TTFT
predictor over a snapshot of engine load, and the shed decision the
engine applies inside ``add_request`` when
``EngineConfig.admission_control`` is on (docs/resilience.md "Shedding
policy").

The predictor is deliberately a coarse queueing model, not a simulator —
what matters for shedding is that the estimate is (a) *monotonic in
backlog*, so offered load beyond capacity drives predictions past the
SLO instead of queueing forever, and (b) *calibrated by observation*:
the engine feeds it EWMA-smoothed measured per-token prefill time and
window cadence (``LLMEngine._record_step``), falling back to the
analytic roofline floor (``observability/roofline.py``) before the first
windows land. A shed request gets an honest ``Retry-After`` derived from
the predicted backlog drain, surfaced by ``chat_server`` as
429/``Retry-After`` (and 503 while draining).
"""

from __future__ import annotations

from dataclasses import dataclass


class EngineOverloaded(RuntimeError):
    """Raised by ``LLMEngine.add_request`` (admission control on) when
    the predicted TTFT busts ``ttft_slo_s`` — and by serving front-ends
    that refuse work while draining. Carries what an honest 429 needs."""

    def __init__(
        self, predicted_ttft_s: float, retry_after_s: float,
        slo_s: float = 0.0,
    ) -> None:
        super().__init__(
            f'predicted TTFT {predicted_ttft_s:.3f}s busts the '
            f'{slo_s:.3f}s SLO; retry after {retry_after_s:.1f}s'
        )
        self.predicted_ttft_s = predicted_ttft_s
        self.retry_after_s = retry_after_s
        self.slo_s = slo_s


@dataclass(frozen=True)
class EngineLoadView:
    """One snapshot of engine load, in predictor units.

    ``prefill_s_per_token`` / ``window_s`` are the engine's EWMA-measured
    values (or the roofline floors before any window landed); the rest is
    scheduler state at the enqueue instant.
    """

    waiting_tokens: int          # prompt tokens of WAITING requests
    # Output-token budgets still owed to live requests (waiting requests'
    # max_tokens + running requests' remaining budget): the decode work
    # committed ahead of a new arrival.
    pending_decode_tokens: int
    num_waiting: int
    num_running: int
    max_num_seqs: int
    decode_steps: int            # tokens one window emits per slot
    prefill_s_per_token: float   # measured EWMA or roofline floor
    window_s: float              # one decode-window wall time
    slo_s: float                 # ttft_slo_s (0 = no SLO)


def predict_ttft(view: EngineLoadView, prompt_tokens: int) -> float:
    """Predicted enqueue→first-token latency for a ``prompt_tokens``
    request arriving NOW.

    Three additive terms: the request's own prefill service time, the
    prefill backlog already queued ahead of it, and the committed decode
    work ahead of it expressed in windows — one window serves up to
    ``max_num_seqs * decode_steps`` output tokens, so
    ``pending_decode_tokens`` over that capacity times the measured
    window wall time is the slot-drain floor an arrival behind the queue
    cannot beat. Coarse by design; monotonic in backlog is the property
    shedding needs.
    """
    per_tok = max(0.0, view.prefill_s_per_token)
    service_s = prompt_tokens * per_tok
    backlog_s = view.waiting_tokens * per_tok
    drain_s = 0.0
    window_capacity = max(1, view.max_num_seqs) * max(1, view.decode_steps)
    if view.pending_decode_tokens > 0:
        drain_s = (
            view.pending_decode_tokens / window_capacity
        ) * max(0.0, view.window_s)
    return service_s + backlog_s + drain_s


def shed_decision(
    view: EngineLoadView, prompt_tokens: int
) -> tuple[bool, float, float]:
    """``(admit, predicted_ttft_s, retry_after_s)`` for one arrival.

    Admits whenever no SLO is configured or the prediction fits it;
    otherwise sheds with a ``Retry-After`` covering the predicted excess
    (clamped to [1, 60] s — a router's retry loop needs a sane bound
    more than a precise one).
    """
    predicted = predict_ttft(view, prompt_tokens)
    if view.slo_s <= 0 or predicted <= view.slo_s:
        return True, predicted, 0.0
    retry_after = min(max(predicted - view.slo_s, 1.0), 60.0)
    return False, predicted, retry_after
