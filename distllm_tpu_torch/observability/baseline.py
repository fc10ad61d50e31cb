"""Benchmark-record parsing and the sentinel's baseline envelope (the port
of ``distllm_tpu.observability.baseline``: the same parser, metric keys
and envelope schema).

A record is a JSON object ``{"n", "cmd", "rc", "parsed": {...}}`` or a
bare metrics object; a record whose run died before it emitted
(``parsed: null``) parses to an empty metrics dict, never a crash.
:func:`build_envelope` distils tok/s, TTFT / TPOT quantiles and the
measured roofline shares into the envelope that
:class:`~distllm_tpu_torch.observability.sentinel.RegressionSentinel`
compares live history against; :func:`load_envelope` reads one from a
file the user names (a raw record is accepted too). Nothing here ships
a default envelope: the sentinel stays disarmed until it is given one.

Dependency-free: no registry import.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

ENVELOPE_SCHEMA = 'distllm-baseline-envelope/v1'

# Direction of "better" per gated metric, matched by substring / suffix
# on the flattened key; anything unmatched is informational (counts,
# batch sizes, cache bookkeeping). The tables are the JAX package's.
_LOWER_BETTER_TOKENS = ('ttft', 'tpot', 'queue_wait', 'warmup_secs')
_HIGHER_BETTER_SUFFIXES = ('value', 'mfu', 'vs_baseline')
# Higher-better tokens: goodput, acceptance and hit rates, tok/s, the
# measured roofline shares, the tier promotions' overlap, recoveries under
# a fault schedule and the greedy match share of a quantized arm.
_HIGHER_BETTER_TOKENS = (
    'goodput', 'accept_rate', 'hit_rate', 'tok_s', 'mfu_measured',
    'bw_util_measured', 'promotion_overlap', 'recoveries', 'greedy_match',
)


def gate_direction(key: str) -> str | None:
    """``'higher'`` / ``'lower'`` for gated metrics, ``None`` for
    informational ones. Lower-better tokens win ties (``gen_load_ttft_s``
    is a latency even though the stage also reports values) — EXCEPT
    ``speedup``, which outranks them: speedups are ratios-of-latencies
    named after their numerator (``gen_prefix_ttft_speedup``,
    ``gen_kernel_speedup``), so the 'ttft' substring alone would gate a
    warm-start IMPROVEMENT as a regression."""
    k = key.lower()
    if 'speedup' in k:
        return 'higher'
    if any(token in k for token in _LOWER_BETTER_TOKENS):
        return 'lower'
    if k.endswith(_HIGHER_BETTER_SUFFIXES):
        return 'higher'
    if any(token in k for token in _HIGHER_BETTER_TOKENS):
        return 'higher'
    return None


def extract_metrics(parsed) -> dict[str, float]:
    """Numeric metrics from one record's parsed payload (flat dict in;
    bools and non-numerics dropped; ``None``/missing payload → empty)."""
    if not isinstance(parsed, dict):
        return {}
    out: dict[str, float] = {}
    for key, value in parsed.items():
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        # bench records round-trip NaN/inf through json (allow_nan): a
        # degenerate 0/0 mfu must not crash the gate, and NaN compares
        # False against every threshold — drop it as "not reported"
        # rather than let it silently pass.
        if not math.isfinite(value):
            continue
        out[key] = float(value)
    return out


def load_record(path: str | Path) -> dict:
    """One record file → ``{'name', 'metrics', 'error'}``. Accepts the
    ``parsed`` wrapper or a bare metrics object; unreadable files become
    an empty record with the error noted, so a crashed run still parses."""
    path = Path(path)
    name = path.stem.replace('BENCH_', '')
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as exc:
        return {'name': name, 'metrics': {}, 'error': repr(exc)[:200]}
    payload = doc.get('parsed', doc) if isinstance(doc, dict) else None
    metrics = extract_metrics(payload)
    error = None
    if isinstance(payload, dict) and payload.get('error'):
        error = str(payload['error'])[:200]
    elif not metrics:
        error = 'no metrics in record (crashed before emitting?)'
    return {'name': name, 'metrics': metrics, 'error': error}


# ------------------------------------------------- the baseline envelope
# Sentinel metric → record keys that can supply its baseline, best first.
# The names mirror instruments.SENTINEL_METRIC_LABELS (single owner of
# the counter label set); this table owns only the record-key mapping.
# Loadgen-measured serving keys first, the bare throughput columns as
# fallbacks.
ENVELOPE_SOURCE_KEYS: dict[str, tuple[str, ...]] = {
    'tok_s': ('gen_load_tok_s', 'gen_history_tok_s', 'gen_value'),
    'ttft_p95_s': ('gen_load_ttft_p95', 'gen_history_ttft_p95'),
    'tpot_p95_s': ('gen_load_tpot_p95', 'gen_history_tpot_p95'),
    'mfu_measured': ('gen_kernel_xla_mfu_measured', 'gen_mfu'),
    'bw_util_measured': ('gen_kernel_xla_bw_util_measured',),
}


def build_envelope(metrics: dict[str, float], *, source: str = '') -> dict:
    """Distill one record's flat metrics into the baseline envelope the
    runtime sentinel consumes. Metrics with no source key present are
    simply absent (the sentinel skips them); an all-absent envelope is
    valid and disarms the sentinel (counted), never raises."""
    envelope_metrics: dict[str, dict] = {}
    for name, candidates in sorted(ENVELOPE_SOURCE_KEYS.items()):
        for key in candidates:
            if key in metrics:
                envelope_metrics[name] = {
                    'value': float(metrics[key]),
                    'direction': gate_direction(name),
                    'from_key': key,
                }
                break
    return {
        'schema': ENVELOPE_SCHEMA,
        'source': source,
        'metrics': envelope_metrics,
    }


def envelope_from_records(records: list[dict]) -> dict:
    """Envelope from the NEWEST record carrying any envelope-source
    metric. Zero usable records yield an empty envelope, not a crash."""
    for record in reversed(records):
        envelope = build_envelope(
            record.get('metrics') or {}, source=record.get('name', '')
        )
        if envelope['metrics']:
            return envelope
    return {'schema': ENVELOPE_SCHEMA, 'source': '', 'metrics': {}}


def load_envelope(path: str | Path) -> dict | None:
    """Read an envelope file; ``None`` on missing/unreadable/wrong-schema
    (the sentinel turns that into a counted disarm, never a raise)."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError, TypeError):
        return None
    if not isinstance(doc, dict) or doc.get('schema') != ENVELOPE_SCHEMA:
        return None
    metrics = doc.get('metrics')
    if not isinstance(metrics, dict):
        return None
    clean: dict[str, dict] = {}
    for name, entry in metrics.items():
        if not isinstance(entry, dict):
            continue
        value = entry.get('value')
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        if not math.isfinite(value):
            continue
        clean[str(name)] = {
            'value': float(value),
            'direction': entry.get('direction') or gate_direction(name),
            'from_key': entry.get('from_key', ''),
        }
    return {
        'schema': ENVELOPE_SCHEMA,
        'source': str(doc.get('source', '')),
        'metrics': clean,
    }
