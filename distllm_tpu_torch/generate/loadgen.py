"""Open-loop load generator for the serving engine (the port of
``distllm_tpu_torch.generate.loadgen``).

An *open-loop* generator submits requests on a fixed arrival schedule,
regardless of how fast the system drains them — the only arrival model
under which tail latency means anything (a closed loop self-throttles and
hides queueing collapse).

- :func:`build_workload` — a deterministic seeded workload: Poisson
  arrivals (exponential inter-arrival gaps at ``rate_rps``), a session
  population where *warm* requests share their session's block-aligned
  prompt prefix (prefix-cache hits after the session's first request)
  and *cold* requests are unique, and per-request output budgets. The
  same config gives the JAX package's arrivals exactly.
- :func:`run_loadgen` — drives a built engine through the schedule with
  ``engine.step()`` (arrivals injected the moment their time comes, even
  mid-stream at full batch) and reports TTFT / TPOT / queue-wait
  p50/p95/p99 via :func:`~distllm_tpu_torch.observability.metrics.
  quantile_from_cumulative` over the request-lifecycle histogram deltas,
  goodput (SLO accounting and per-request service-rate percentiles from
  the flight ring), warm-prefix hit counts, and the per-window-kind MFU /
  bandwidth-utilization summary.

A second runner, :func:`run_http_loadgen`, replays the same workload
against an OpenAI-compatible HTTP endpoint: prompt token ids render to a
deterministic text form (:func:`arrival_messages`), each arrival fires on
its own thread at its scheduled instant over ``http.client`` (the
standard library: no ``aiohttp``), and TTFT is measured from the
SCHEDULED arrival instant (never the actual send) — the same
coordinated-omission correction the in-process runner applies to
``t_enqueue``.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse
from dataclasses import dataclass, field

import numpy as np

from distllm_tpu_torch.observability import instruments as _metrics
from distllm_tpu_torch.observability.metrics import quantile_from_cumulative
from distllm_tpu_torch.resilience.admission import EngineOverloaded

_QUANTILES = (0.50, 0.95, 0.99)
_LIFECYCLE_HISTOGRAMS = {
    'ttft': _metrics.REQUEST_TTFT,
    'tpot': _metrics.REQUEST_TPOT,
    'queue_wait': _metrics.REQUEST_QUEUE_WAIT,
}


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: offset from workload start + its payload."""

    at_s: float
    prompt_ids: tuple[int, ...]
    max_tokens: int
    session: int | None  # warm session id, None = cold (unique prompt)
    temperature: float = 0.0
    top_p: float = 1.0


@dataclass
class LoadgenConfig:
    """Workload shape. Defaults are the CPU-smoke scale; chip runs raise
    ``num_requests``/``rate_rps`` and the token ranges."""

    seed: int = 0
    num_requests: int = 32
    # Poisson arrival rate (requests/second). Offered load, not achieved:
    # the open loop keeps submitting on schedule even when the engine
    # falls behind — queue-wait percentiles are the point.
    rate_rps: float = 8.0
    # Warm/cold prefix mix: each warm request joins one of num_sessions
    # sessions and shares that session's prefix_tokens-token prompt
    # prefix (block-aligned → prefix-cache hits after the session's
    # first request); cold requests are globally unique.
    num_sessions: int = 4
    warm_fraction: float = 0.5
    prefix_tokens: int = 32
    prompt_tokens: tuple[int, int] = (8, 48)   # cold/tail length range
    output_tokens: tuple[int, int] = (4, 24)
    vocab_size: int = 2048
    temperature: float = 0.0  # greedy: deterministic across A/B arms
    # Nucleus filtering for sampled (temperature > 0) workloads; 1.0
    # disables. Sampled streams stay deterministic per (seed, schedule)
    # via the engine's counter-based per-request PRNG keys
    # (docs/speculative.md "Sampled verification").
    top_p: float = 1.0
    # Engine paged-pool override (blocks), consumed by the engine-building
    # callers rather than by build_workload: sizing the pool BELOW the workload's warm
    # working set forces HBM-tier eviction, so CPU smokes can exercise
    # the prefix-cache spill/promote tiers with tiny prompts instead of
    # chip-scale ones. None = the caller's default pool.
    cache_blocks: int | None = None


def build_workload(cfg: LoadgenConfig) -> list[Arrival]:
    """Deterministic seeded open-loop workload (see class docs)."""
    if cfg.num_requests < 1:
        raise ValueError('num_requests must be >= 1')
    if cfg.rate_rps <= 0:
        raise ValueError('rate_rps must be > 0')
    rng = np.random.default_rng(cfg.seed)
    arrivals_at = np.cumsum(
        rng.exponential(1.0 / cfg.rate_rps, size=cfg.num_requests)
    )
    prefixes = [
        tuple(
            int(t)
            for t in rng.integers(1, cfg.vocab_size, size=cfg.prefix_tokens)
        )
        for _ in range(max(1, cfg.num_sessions))
    ]
    lo, hi = cfg.prompt_tokens
    out_lo, out_hi = cfg.output_tokens
    workload: list[Arrival] = []
    for at in arrivals_at:
        tail = tuple(
            int(t)
            for t in rng.integers(
                1, cfg.vocab_size, size=int(rng.integers(lo, hi + 1))
            )
        )
        session: int | None = None
        if rng.random() < cfg.warm_fraction:
            session = int(rng.integers(len(prefixes)))
            prompt = prefixes[session] + tail
        else:
            prompt = tail
        workload.append(
            Arrival(
                at_s=float(at),
                prompt_ids=prompt,
                max_tokens=int(rng.integers(out_lo, out_hi + 1)),
                session=session,
                temperature=cfg.temperature,
                top_p=cfg.top_p,
            )
        )
    return workload


@dataclass
class LoadReport:
    """Everything one loadgen run measured. ``percentiles`` maps
    ``'<metric>_p<q>'`` (histogram-estimated); ``tokens_by_request``
    preserves emission order per request for A/B identity checks."""

    requests: int
    tokens: int
    elapsed_s: float
    offered_rps: float | None
    achieved_tok_s: float
    percentiles: dict[str, float | None]
    window_tok_s: dict[str, float | None]
    goodput_tokens: int
    goodput_frac: float | None
    slo_met: int
    slo_missed: int
    warm_prefix_hit_tokens: int
    warm_requests: int
    cold_requests: int
    roofline: dict[str, dict[str, float]]
    # Resilience accounting (docs/resilience.md): arrivals refused by
    # SLO-aware admission control, requests quarantined to FAILED
    # (dispatch failures / deadline timeouts), and the engine's
    # retry/recovery counts over this run — what the gen_chaos stage
    # gates (recoveries, goodput-under-fault) and reports (shed rate).
    shed_requests: int = 0
    shed_rate: float | None = None
    failed_requests: int = 0
    window_retries: int = 0
    recoveries: int = 0
    quarantined: int = 0
    tokens_by_request: list[list[int]] = field(default_factory=list)
    # Schedule-relative TTFT per ARRIVAL, aligned to the workload order
    # (None = shed at admission or never emitted), so two arms can be
    # compared request by request; tokens_by_request is aligned the same
    # way (shed arrivals contribute an empty list).
    ttft_by_request: list = field(default_factory=list)

    def to_fragment(self, prefix: str) -> dict:
        """Flatten into ``{prefix}key`` fields (the JAX report's keys)."""
        out = {
            f'{prefix}requests': self.requests,
            f'{prefix}tokens': self.tokens,
            f'{prefix}elapsed_s': round(self.elapsed_s, 3),
            f'{prefix}offered_rps': (
                round(self.offered_rps, 3)
                if self.offered_rps is not None else None
            ),
            f'{prefix}tok_s': round(self.achieved_tok_s, 2),
            f'{prefix}goodput_tokens': self.goodput_tokens,
            f'{prefix}goodput_frac': self.goodput_frac,
            f'{prefix}slo_met': self.slo_met,
            f'{prefix}slo_missed': self.slo_missed,
            f'{prefix}warm_prefix_hit_tokens': self.warm_prefix_hit_tokens,
            f'{prefix}warm_requests': self.warm_requests,
            f'{prefix}cold_requests': self.cold_requests,
        }
        for key, value in self.percentiles.items():
            out[f'{prefix}{key}'] = (
                round(value, 6) if value is not None else None
            )
        for key, value in self.window_tok_s.items():
            out[f'{prefix}goodput_{key}'] = (
                round(value, 2) if value is not None else None
            )
        out[f'{prefix}shed_requests'] = self.shed_requests
        out[f'{prefix}shed_rate'] = self.shed_rate
        out[f'{prefix}failed_requests'] = self.failed_requests
        out[f'{prefix}window_retries'] = self.window_retries
        out[f'{prefix}recoveries'] = self.recoveries
        out[f'{prefix}quarantined'] = self.quarantined
        for kind, stats in self.roofline.items():
            out[f'{prefix}mfu_{kind}'] = stats.get('mfu')
            out[f'{prefix}bw_util_{kind}'] = stats.get('bw_util')
        return out


def _exact_percentiles(values: list[float]) -> dict[str, float | None]:
    if not values:
        return {f'p{int(q * 100)}': None for q in _QUANTILES}
    arr = np.asarray(values, dtype=np.float64)
    return {
        f'p{int(q * 100)}': float(np.percentile(arr, q * 100))
        for q in _QUANTILES
    }


def arrival_messages(arrival: Arrival) -> list[dict]:
    """Deterministic OpenAI message rendering of one arrival's prompt.

    Space-joined decimal token ids as a single user message: two arrivals
    sharing a token-id prefix share a byte prefix of the rendered content
    — exactly what the router's byte-level digest chain needs to see the
    same warm/cold structure the in-process runner exercises."""
    return [
        {
            'role': 'user',
            'content': ' '.join(str(t) for t in arrival.prompt_ids),
        }
    ]


@dataclass
class HttpLoadReport:
    """What one HTTP loadgen run measured. Per-arrival lists align with
    the sorted schedule (like ``LoadReport.ttft_by_request``); replica
    attribution comes from the ``X-Distllm-Router-Replica`` header when
    the endpoint is the router (empty dict against a bare chat_server).
    """

    requests: int
    ok: int
    rejected: int       # 429 admission rejections (propagated untouched)
    retried: int        # responses carrying X-Distllm-Router-Retry
    errors: int         # transport failures / 5xx
    elapsed_s: float
    goodput_rps: float  # SLO-met ok requests (all ok if no SLO) / elapsed
    percentiles: dict[str, float | None]
    by_replica: dict[str, int]
    ttft_by_request: list
    statuses: list
    contents: list

    def to_fragment(self, prefix: str) -> dict:
        out = {
            f'{prefix}requests': self.requests,
            f'{prefix}ok': self.ok,
            f'{prefix}rejected': self.rejected,
            f'{prefix}retried': self.retried,
            f'{prefix}errors': self.errors,
            f'{prefix}elapsed_s': round(self.elapsed_s, 3),
            f'{prefix}goodput_rps': round(self.goodput_rps, 3),
            f'{prefix}replicas_used': len(self.by_replica),
        }
        for key, value in self.percentiles.items():
            out[f'{prefix}{key}'] = (
                round(value, 6) if value is not None else None
            )
        return out


def _post_one(url: urllib.parse.SplitResult, body: bytes, timeout_s: float):
    """POST one completion; returns ``(status, first_byte_monotonic,
    payload, headers)``. The first byte of the body stamps the TTFT."""
    conn = http.client.HTTPConnection(url.hostname, url.port or 80, timeout=timeout_s)
    try:
        conn.request(
            'POST', url.path, body=body,
            headers={'Content-Type': 'application/json'},
        )
        resp = conn.getresponse()
        first = resp.read(1)
        t_first = time.monotonic()
        payload = first + resp.read()
        return resp.status, t_first, payload, dict(resp.getheaders())
    finally:
        conn.close()


def run_http_loadgen(
    endpoint: str,
    workload: list[Arrival],
    *,
    slo_s: float = 0.0,
    timeout_s: float = 120.0,
    stream: bool | list[bool] = False,
) -> HttpLoadReport:
    """Replay ``workload`` open-loop against an OpenAI-compatible HTTP
    endpoint (the chat server): one thread per arrival sleeps until its
    scheduled instant, posts, and stamps TTFT at the first body byte
    against the SCHEDULED instant. ``stream`` is one flag for every
    arrival or a list parallel to the sorted schedule."""
    schedule = sorted(workload, key=lambda a: a.at_s)
    url = urllib.parse.urlsplit(
        endpoint.rstrip('/') + '/v1/chat/completions'
    )
    n = len(schedule)
    streams = stream if isinstance(stream, list) else [stream] * n
    if len(streams) != n:
        raise ValueError('stream list must parallel the workload')
    ttfts: list = [None] * n
    statuses: list = [None] * n
    contents: list = [None] * n
    replicas: list = [None] * n
    retried_flags = [False] * n
    t0 = time.monotonic()

    def fire(i: int, arrival: Arrival) -> None:
        scheduled_at = t0 + arrival.at_s
        delay = scheduled_at - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        body = json.dumps({
            'messages': arrival_messages(arrival),
            'max_tokens': arrival.max_tokens,
            'temperature': arrival.temperature,
            'top_p': arrival.top_p,
            'stream': streams[i],
        }).encode()
        try:
            status, t_first, payload, headers = _post_one(url, body, timeout_s)
        except (OSError, http.client.HTTPException):
            # A transport failure is a datapoint of an open-loop run (the
            # errors count, a None status), never an abort.
            statuses[i] = None
            return
        ttfts[i] = t_first - scheduled_at
        statuses[i] = status
        replicas[i] = headers.get('X-Distllm-Router-Replica')
        retried_flags[i] = bool(headers.get('X-Distllm-Router-Retry'))
        if status == 200 and not streams[i]:
            try:
                doc = json.loads(payload)
                contents[i] = doc['choices'][0]['message']['content']
            except (ValueError, KeyError, IndexError):
                statuses[i] = -1
        elif status == 200:
            contents[i] = payload.decode('utf-8', 'replace')

    threads = [
        threading.Thread(target=fire, args=(i, a), daemon=True)
        for i, a in enumerate(schedule)
    ]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    elapsed_s = time.monotonic() - t0

    ok_indices = [i for i, s in enumerate(statuses) if s == 200]
    ok_ttfts = [ttfts[i] for i in ok_indices if ttfts[i] is not None]
    met = [
        t for t in ok_ttfts if slo_s <= 0 or t <= slo_s
    ]
    percentiles = {
        f'ttft_{k}': v for k, v in _exact_percentiles(ok_ttfts).items()
    }
    by_replica: dict[str, int] = {}
    for i in ok_indices:
        if replicas[i]:
            by_replica[replicas[i]] = by_replica.get(replicas[i], 0) + 1
    return HttpLoadReport(
        requests=n,
        ok=len(ok_indices),
        rejected=sum(1 for s in statuses if s == 429),
        retried=sum(retried_flags),
        errors=sum(
            1 for s in statuses
            if s is None or s == -1 or (isinstance(s, int) and s >= 500)
        ),
        elapsed_s=elapsed_s,
        goodput_rps=len(met) / elapsed_s if elapsed_s > 0 else 0.0,
        percentiles=percentiles,
        by_replica=by_replica,
        ttft_by_request=[
            round(t, 6) if t is not None else None for t in ttfts
        ],
        statuses=statuses,
        contents=contents,
    )


def run_loadgen(
    engine, workload: list[Arrival], *, poll_sleep_s: float = 0.005
) -> LoadReport:
    """Drive ``engine`` through ``workload`` open-loop and measure.

    The engine should be warmed (compiles inside the run would poison
    every latency percentile) and, for the warm-prefix mix to mean
    anything, built with ``enable_prefix_cache=True``. Greedy workloads
    (``temperature=0``) produce identical token streams across repeat
    runs on equal engine state — the attribution A/B relies on it.
    """
    from distllm_tpu_torch.generate.engine.engine import SamplingParams

    schedule = sorted(workload, key=lambda a: a.at_s)
    hist_before = {
        name: hist.cumulative_counts()
        for name, hist in _LIFECYCLE_HISTOGRAMS.items()
    }
    stats_before = {
        key: int(engine.stats.get(key, 0))
        for key in (
            'prefix_hit_tokens', 'goodput_tokens', 'slo_met', 'slo_missed',
            'window_retries', 'recoveries', 'quarantined_requests',
        )
    }
    flight_total_before = engine.flight.total_recorded
    roofline_before = engine.roofline_snapshot()

    tokens_by_rid: dict[int, list[int]] = {}
    # One slot per ARRIVAL in schedule order; None = shed at admission.
    arrival_rids: list[int | None] = []
    shed = 0
    next_i = 0
    t0 = time.monotonic()
    while next_i < len(schedule) or engine.has_unfinished:
        now = time.monotonic() - t0
        while next_i < len(schedule) and schedule[next_i].at_s <= now:
            arrival = schedule[next_i]
            next_i += 1
            try:
                rid = engine.add_request(
                    list(arrival.prompt_ids),
                    SamplingParams(
                        temperature=arrival.temperature,
                        top_p=arrival.top_p,
                        max_tokens=arrival.max_tokens,
                    ),
                )
            except EngineOverloaded:
                # SLO-aware admission control refused the arrival —
                # honest backpressure, counted (the engine already
                # recorded the 'shed' flight record + metric).
                shed += 1
                arrival_rids.append(None)
                continue
            # Coordinated-omission correction: if this arrival's
            # scheduled instant passed while a blocking step() held the
            # loop, add_request stamped a LATE t_enqueue — measuring
            # from it would erase exactly the schedule-relative queueing
            # an open loop exists to expose. Re-anchor the lifecycle
            # clock to the scheduled arrival, so every downstream
            # TTFT/queue-wait/e2e observation (histograms included) is
            # schedule-relative.
            engine._requests[rid].t_enqueue = t0 + arrival.at_s
            tokens_by_rid[rid] = []
            arrival_rids.append(rid)
        if engine.has_unfinished:
            for rid, tok in engine.step():
                tokens_by_rid.setdefault(rid, []).append(tok)
        elif next_i < len(schedule):
            time.sleep(
                min(poll_sleep_s, max(0.0, schedule[next_i].at_s - now))
            )
    elapsed_s = time.monotonic() - t0
    # step()-driven runs leave finished requests parked in the engine's
    # finished map (generate_ids is what normally pops them); drop this
    # run's entries so back-to-back loadgen arms don't accumulate them.
    # t_enqueue was re-anchored to the scheduled arrival above, so the
    # harvested TTFTs are schedule-relative like the histograms. The
    # finished objects' output_ids are also the AUTHORITATIVE token
    # streams: a recovered step() may have under-reported emissions it
    # folded into request state while failing (docs/resilience.md).
    ttft_by_request: list = []
    failed = 0
    for rid in arrival_rids:
        if rid is None:
            ttft_by_request.append(None)
            continue
        finished = engine._finished.pop(rid, None)
        if finished is not None:
            tokens_by_rid[rid] = list(finished.output_ids)
            if finished.error is not None:
                failed += 1
        ttft_by_request.append(
            round(finished.t_first_token - finished.t_enqueue, 6)
            if finished is not None and finished.t_first_token
            else None
        )

    percentiles: dict[str, float | None] = {}
    for name, hist in _LIFECYCLE_HISTOGRAMS.items():
        after = hist.cumulative_counts()
        delta = [a - b for a, b in zip(after, hist_before[name])]
        for q in _QUANTILES:
            percentiles[f'{name}_p{int(q * 100)}'] = quantile_from_cumulative(
                hist.buckets, delta, q
            )

    # Per-request goodput rate over THIS run's requests: output tokens
    # over enqueue→finish wall time, counting only requests that met the
    # TTFT SLO when one is configured (all requests otherwise) — the
    # distribution of service rate the system actually *delivered*,
    # flight-ring sourced. The ring may have evicted the oldest records
    # of a very long run; percentiles then cover the retained tail (the
    # ring is 4096 records deep).
    new_records = engine.flight.snapshot()
    grew = engine.flight.total_recorded - flight_total_before
    new_records = new_records[-grew:] if grew else []
    slo_s = float(getattr(engine.config, 'ttft_slo_s', 0.0) or 0.0)
    goodput_rates = [
        record['output_tokens'] / record['e2e_s']
        for record in new_records
        if record.get('kind') == 'request'
        and record.get('e2e_s')
        and record.get('output_tokens')
        and (
            slo_s <= 0
            or (record.get('ttft_s') is not None
                and record['ttft_s'] <= slo_s)
        )
    ]
    window_tok_s = {
        f'tok_s_{k}': v for k, v in _exact_percentiles(goodput_rates).items()
    }

    total_tokens = sum(len(v) for v in tokens_by_rid.values())
    met = int(engine.stats.get('slo_met', 0)) - stats_before['slo_met']
    missed = (
        int(engine.stats.get('slo_missed', 0)) - stats_before['slo_missed']
    )
    goodput_tokens = (
        int(engine.stats.get('goodput_tokens', 0))
        - stats_before['goodput_tokens']
    )
    warm = sum(1 for a in schedule if a.session is not None)
    # N arrivals span N-1 inter-arrival gaps; a single-request workload
    # has no meaningful rate (None, not inf — the report must stay
    # strict-JSON serializable).
    span = schedule[-1].at_s - schedule[0].at_s if len(schedule) > 1 else 0.0

    def _stat_delta(key: str) -> int:
        return int(engine.stats.get(key, 0)) - stats_before[key]

    return LoadReport(
        requests=len(schedule),
        tokens=total_tokens,
        elapsed_s=elapsed_s,
        offered_rps=(len(schedule) - 1) / span if span > 0 else None,
        achieved_tok_s=total_tokens / elapsed_s if elapsed_s > 0 else 0.0,
        percentiles=percentiles,
        window_tok_s=window_tok_s,
        goodput_tokens=goodput_tokens,
        goodput_frac=(
            goodput_tokens / total_tokens if total_tokens and (met + missed)
            else None
        ),
        slo_met=met,
        slo_missed=missed,
        warm_prefix_hit_tokens=(
            int(engine.stats.get('prefix_hit_tokens', 0))
            - stats_before['prefix_hit_tokens']
        ),
        warm_requests=warm,
        cold_requests=len(schedule) - warm,
        roofline=engine.roofline_summary(baseline=roofline_before),
        shed_requests=shed,
        shed_rate=shed / len(schedule) if schedule else None,
        failed_requests=failed,
        window_retries=_stat_delta('window_retries'),
        recoveries=_stat_delta('recoveries'),
        quarantined=_stat_delta('quarantined_requests'),
        tokens_by_request=[
            tokens_by_rid.get(rid, []) if rid is not None else []
            for rid in arrival_rids
        ],
        ttft_by_request=ttft_by_request,
    )
