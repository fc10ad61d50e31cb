"""Catalog of the well-known metric series (name = contract).

Every series the serving stack emits is declared here, in one place, so (a)
``docs/observability.md`` has a single source of truth, (b) importing this
module pre-registers the engine/scheduler/KV series with zero values —
``GET /metrics`` exposes the full schema from the first scrape, before any
traffic — and (c) call sites cannot typo a metric name into a fresh series.

Naming follows Prometheus conventions: ``distllm_`` prefix, ``_total``
suffix on counters, base units (seconds, bytes, ratios in [0, 1]).
"""

from __future__ import annotations

from distllm_tpu_torch import __version__
from distllm_tpu_torch.observability.metrics import get_registry, log_buckets

_registry = get_registry()

# --------------------------------------------------------------- engine
ENGINE_GENERATED_TOKENS = _registry.counter(
    'distllm_engine_generated_tokens_total',
    'Tokens emitted by the generation engine (token throughput source).',
)
ENGINE_PROMPT_TOKENS = _registry.counter(
    'distllm_engine_prompt_tokens_total',
    'Prompt tokens accepted into the engine via add_request.',
)
ENGINE_REQUESTS_ADDED = _registry.counter(
    'distllm_engine_requests_added_total',
    'Requests submitted to the engine.',
)
ENGINE_REQUESTS_FINISHED = _registry.counter(
    'distllm_engine_requests_finished_total',
    'Requests that reached a stop condition.',
)
ENGINE_PREFILL_DISPATCHES = _registry.counter(
    'distllm_engine_prefill_dispatches_total',
    'Batched prefill dispatches (one padded jit call each).',
)
ENGINE_DECODE_WINDOWS = _registry.counter(
    'distllm_engine_decode_windows_total',
    'Fused decode-window dispatches.',
)
ENGINE_OVERSHOOT_TOKENS = _registry.counter(
    'distllm_engine_overshoot_tokens_total',
    'Post-EOS tokens discarded by the pipelined one-window-late design.',
)
ENGINE_PREFILL_BATCH = _registry.histogram(
    'distllm_engine_prefill_batch_size',
    'Requests per batched prefill dispatch (padding rows excluded).',
    buckets=(1, 2, 4, 8, 16, 32, 64),
)
ENGINE_DECODE_UTILIZATION = _registry.histogram(
    'distllm_engine_decode_window_utilization',
    'Fraction of decode-window slots generating tokens (batch occupancy).',
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
)
ATTN_BACKEND_INFO = _registry.gauge(
    'distllm_engine_attn_backend_info',
    'Resolved paged-attention kernel backend serving this engine '
    "(EngineConfig.attn_backend after 'auto' resolution, pinned at "
    'construction; docs/serving.md "Attention kernel backends"). Exactly '
    'one backend label reads 1.',
    labelnames=('backend',),
)
# The resolvable (non-'auto') backend labels. This tuple is the single
# owner: ops.paged_attention derives its legal selector set from it
# (``ATTN_BACKENDS = ('auto', *ATTN_BACKEND_LABELS)``) and the engine's
# gauge loop iterates it, so a new kernel tier cannot leave the scrape
# schema or the 'exactly one label reads 1' invariant behind. Lives here
# (not in ops) because this module must stay importable without jax.
ATTN_BACKEND_LABELS = ('xla', 'pallas', 'interpret')
for _backend in ATTN_BACKEND_LABELS:
    ATTN_BACKEND_INFO.labels(backend=_backend)

KV_CACHE_DTYPE_INFO = _registry.gauge(
    'distllm_engine_kv_cache_dtype_info',
    'RESOLVED storage dtype of the paged KV pool '
    "(EngineConfig.kv_cache_dtype after 'auto' resolution, pinned at "
    'construction; docs/serving.md "Quantized KV cache"). Exactly one '
    'dtype label reads 1.',
    labelnames=('dtype',),
)
# Canonical jnp dtype names for the resolvable pool dtypes, plus a
# catch-all for model dtypes outside the usual set ('auto' follows the
# model). Same single-owner discipline as ATTN_BACKEND_LABELS.
KV_CACHE_DTYPE_LABELS = ('bfloat16', 'float32', 'int8', 'other')
for _dtype in KV_CACHE_DTYPE_LABELS:
    KV_CACHE_DTYPE_INFO.labels(dtype=_dtype)

ENGINE_KV_DISPATCH_BYTES = _registry.gauge(
    'distllm_engine_kv_dispatch_bytes',
    'XLA-measured bytes accessed per serving dispatch, by dispatch kind '
    '(cost_analysis on the compiled executable — the roofline numerator; '
    'docs/observability.md "Measured vs analytic MFU"). The int8 KV '
    'pool shows here as the decode/mixed kinds dropping by roughly the '
    'KV stream share.',
    labelnames=('kind',),
)

# ------------------------------------------------------------- KV cache
KV_BLOCKS_TOTAL = _registry.gauge(
    'distllm_kv_cache_blocks_total',
    'Allocatable KV-cache blocks (pool size minus the reserved trash block).',
)
KV_BLOCKS_IN_USE = _registry.gauge(
    'distllm_kv_cache_blocks_in_use',
    'KV-cache blocks currently owned by running/admitted sequences.',
)
KV_OCCUPANCY = _registry.gauge(
    'distllm_kv_cache_occupancy_ratio',
    'KV-cache block occupancy, in_use / total (0..1).',
)
KV_HBM_BYTES = _registry.gauge(
    'distllm_kv_cache_hbm_bytes',
    'Device memory held by the paged K/V pool arrays.',
)

# ----------------------------------------------------------- prefix cache
PREFIX_HIT_TOKENS = _registry.counter(
    'distllm_prefix_cache_hit_tokens_total',
    'Prompt tokens served from cached KV blocks (prefill skipped).',
)
PREFIX_LOOKUP_TOKENS = _registry.counter(
    'distllm_prefix_cache_lookup_tokens_total',
    'Prompt tokens submitted while the prefix cache was enabled '
    '(hit rate = hit_tokens / lookup_tokens).',
)
PREFIX_CACHED_BLOCKS = _registry.gauge(
    'distllm_prefix_cache_blocks',
    'KV blocks currently held by the prefix cache (referenced + evictable).',
)
PREFIX_EVICTABLE_BLOCKS = _registry.gauge(
    'distllm_prefix_cache_evictable_blocks',
    'Cached blocks with zero request references (LRU eviction candidates).',
)
PREFIX_SHARED_BLOCKS = _registry.gauge(
    'distllm_prefix_cache_shared_blocks',
    'Cached blocks referenced by two or more live requests right now.',
)
PREFIX_EVICTIONS = _registry.counter(
    'distllm_prefix_cache_evictions_total',
    'Cached blocks evicted (LRU) back to the allocator under pressure.',
)
PREFIX_COW_COPIES = _registry.counter(
    'distllm_prefix_cache_cow_copies_total',
    'Copy-on-write block copies (full-cover aligned prefix hits).',
)

# --------------------------------------------- prefix-cache tier hierarchy
# HBM -> host-RAM -> disk -> peer spill/promote tiers (EngineConfig.
# host_kv_tier_bytes / disk_kv_tier_dir / peer_kv_endpoints;
# docs/prefix_caching.md "Tier hierarchy", docs/routing.md "Peer KV
# tier"). Label values are the fixed TIER_LABELS below.
TIER_LABELS = ('hbm', 'host', 'disk', 'peer')
PREFIX_TIER_HITS = _registry.counter(
    'distllm_prefix_tier_hits_total',
    'Prefix-cache block lookups served per tier: hbm = live paged-pool '
    'blocks (no work), host = host-RAM pool (async promotion), disk = '
    'persisted spill files (load + promotion).',
    labelnames=('tier',),
)
PREFIX_TIER_MISSES = _registry.counter(
    'distllm_prefix_tier_misses_total',
    'Prefix-cache lookup walks that stopped at this tier — the lowest '
    'tier consulted found nothing, so the remaining prompt re-prefills.',
    labelnames=('tier',),
)
PREFIX_TIER_SPILLS = _registry.counter(
    'distllm_prefix_tier_spills_total',
    'KV blocks spilled INTO each tier (host = device→host fetch of an '
    'evicted block, disk = write-through persistence of that spill).',
    labelnames=('tier',),
)
PREFIX_TIER_PROMOTIONS = _registry.counter(
    'distllm_prefix_tier_promotions_total',
    'KV blocks promoted OUT of each tier toward the device pool (host = '
    'async device_put back into paged blocks, disk = file load into the '
    'host pool).',
    labelnames=('tier',),
)
PREFIX_TIER_BYTES = _registry.gauge(
    'distllm_prefix_tier_bytes',
    'Bytes of spilled KV currently held per tier (hbm KV bytes are '
    'tracked by distllm_kv_cache_hbm_bytes).',
    labelnames=('tier',),
)
PREFIX_TIER_EVICTIONS = _registry.counter(
    'distllm_prefix_tier_evictions_total',
    'Blocks evicted from each tier under its own pressure: hbm = '
    'pool-pressure LRU eviction out of the device cache (spilled when a '
    'host tier exists, dropped otherwise), host = host-pool byte-budget '
    'LRU, disk = disk byte-budget LRU (always a final drop).',
    labelnames=('tier',),
)
PREFIX_TIER_DROPPED_BLOCKS = _registry.counter(
    'distllm_prefix_tier_dropped_blocks_total',
    'Evicted KV blocks dropped outright — no lower tier existed to catch '
    'them, so the prefix must fully re-prefill on its next arrival. The '
    'attributable cost of cache pressure in incident bundles.',
)
PREFIX_TIER_ERRORS = _registry.counter(
    'distllm_prefix_tier_errors_total',
    'Tier operations that failed and degraded instead of raising into '
    'the serving path: disk = unreadable/corrupt/truncated .kvblock '
    'files or write IO errors (the entry is dropped and the prefix '
    'falls through to cold prefill), host = a failed async promotion '
    'transfer (the request falls back to cold prefill), peer = a '
    'sibling replica fetch that timed out, errored, or returned a '
    'corrupt payload (endpoint backs off, prefix prefills cold).',
    labelnames=('tier',),
)
for _tier in TIER_LABELS:
    PREFIX_TIER_HITS.labels(tier=_tier)
    PREFIX_TIER_MISSES.labels(tier=_tier)
    PREFIX_TIER_SPILLS.labels(tier=_tier)
    PREFIX_TIER_PROMOTIONS.labels(tier=_tier)
    PREFIX_TIER_BYTES.labels(tier=_tier)
    PREFIX_TIER_EVICTIONS.labels(tier=_tier)
    PREFIX_TIER_ERRORS.labels(tier=_tier)
ENGINE_PREFILL_CHUNKS = _registry.counter(
    'distllm_engine_prefill_chunks_total',
    'Chunked-prefill dispatches (uncached tails split under '
    'prefill_chunk_tokens).',
)
ENGINE_PREFILL_CHUNK_TOKENS = _registry.histogram(
    'distllm_engine_prefill_chunk_tokens',
    'Valid tokens per chunked-prefill dispatch.',
    buckets=(16, 32, 64, 128, 256, 512, 1024, 2048),
)

# ------------------------------------------- mixed prefill+decode windows
MIXED_WINDOWS = _registry.counter(
    'distllm_engine_mixed_windows_total',
    'Decode-window dispatches that also carried prefill-chunk rows '
    '(EngineConfig.enable_mixed_batching; docs/serving.md).',
)
MIXED_PREFILL_TOKENS = _registry.counter(
    'distllm_engine_mixed_prefill_tokens_total',
    'Prefill-tail chunk tokens that rode decode windows instead of '
    'standalone prefill dispatches.',
)
MIXED_PREFILL_TOKENS_PER_WINDOW = _registry.histogram(
    'distllm_engine_mixed_prefill_tokens_per_window',
    'Valid prefill-chunk tokens folded into one mixed window '
    '(bounded by EngineConfig.max_window_prefill_tokens).',
    buckets=(1, 16, 32, 64, 128, 256, 512, 1024, 2048),
)
MIXED_PREFILL_ROWS = _registry.histogram(
    'distllm_engine_mixed_prefill_rows',
    'Prefill-chunk rows (requests) folded into one mixed window.',
    buckets=(1, 2, 4, 8),
)

# ------------------------------------- speculative (prompt-lookup) decoding
SPEC_WINDOWS = _registry.counter(
    'distllm_engine_spec_windows_total',
    'Speculative verify-window dispatches (EngineConfig.draft_k; '
    'docs/speculative.md).',
)
SPEC_DRAFT_TOKENS = _registry.counter(
    'distllm_engine_spec_draft_tokens_total',
    'Draft tokens proposed by the prompt-lookup drafter and scored by '
    'verify windows.',
)
SPEC_ACCEPTED_TOKENS = _registry.counter(
    'distllm_engine_spec_accepted_tokens_total',
    'Draft tokens accepted by the verification rule (greedy argmax '
    'comparison or sampled rejection sampling) — each one a decode token '
    'that skipped its weight pass.',
)
SPEC_SAMPLED_ROWS = _registry.counter(
    'distllm_engine_spec_sampled_rows_total',
    'Verify-window rows with temperature > 0 that carried drafts — the '
    'device-side rejection-sampling verification path '
    '(docs/speculative.md "Sampled verification").',
)
SPEC_RESAMPLED_TOKENS = _registry.counter(
    'distllm_engine_spec_resampled_tokens_total',
    'Residual resamples: sampled rows whose span stopped short of its '
    'drafts, emitting one correction token drawn from the normalized '
    'positive residual (p - q)+.',
)
SPEC_ACCEPT_RATE = _registry.histogram(
    'distllm_engine_spec_accept_rate',
    'Per-window draft acceptance rate (accepted / drafted; windows that '
    'drafted nothing are not observed).',
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
)

# ------------------------------------------------- request lifecycle (SLO)
REQUEST_TTFT = _registry.histogram(
    'distllm_request_ttft_seconds',
    'Time to first token: add_request -> first generated token fetched on '
    'the host (the latency a streaming client sees).',
)
REQUEST_TPOT = _registry.histogram(
    'distllm_request_tpot_seconds',
    'Time per output token after the first (decode steady-state), '
    'per finished request: (finish - first_token) / (output_tokens - 1).',
    buckets=log_buckets(1e-4, 10.0),
)
REQUEST_QUEUE_WAIT = _registry.histogram(
    'distllm_request_queue_wait_seconds',
    'Admission queue wait: add_request -> decode-slot admission.',
)
REQUEST_SLO = _registry.counter(
    'distllm_request_slo_total',
    'Finished requests vs the TTFT SLO (EngineConfig.ttft_slo_s), by '
    'outcome met/missed. Only counted when an SLO is configured.',
    labelnames=('outcome',),
)
GOODPUT_TOKENS = _registry.counter(
    'distllm_engine_goodput_tokens_total',
    'Output tokens from requests that met the TTFT SLO — goodput, the '
    'throughput that actually counted.',
)
ENGINE_STEPS = _registry.counter(
    'distllm_engine_steps_total',
    'Engine steps recorded by the flight recorder, by kind '
    '(prefill/decode/mixed/spec).',
    labelnames=('kind',),
)
ENGINE_STEP_SECONDS = _registry.histogram(
    'distllm_engine_step_duration_seconds',
    'Wall time per engine step, by kind: prefill = host-side dispatch of '
    'one padded prefill; decode/mixed = dispatch -> host fetch of one '
    'fused window (includes pipelined in-flight time).',
    labelnames=('kind',),
)

# ------------------------------------------- roofline / MFU attribution
ENGINE_MFU = _registry.gauge(
    'distllm_engine_mfu',
    'Model FLOPs utilization of the most recent engine step of each kind: '
    'analytic matmul FLOPs (2 x n_params per scored position, '
    'observability/roofline.py) over wall time and the chip bf16 peak.',
    labelnames=('kind',),
)
ENGINE_BW_UTIL = _registry.gauge(
    'distllm_engine_bandwidth_utilization',
    'Weight-stream HBM bandwidth utilization of the most recent engine '
    'step of each kind: weight bytes read (decode re-reads the full set '
    'every scan step) over wall time and the chip HBM peak.',
    labelnames=('kind',),
)
ENGINE_MFU_MEASURED = _registry.gauge(
    'distllm_engine_mfu_measured',
    'MFU of the most recent engine step of each kind priced from what XLA '
    'actually compiled: compiled.cost_analysis() FLOPs '
    '(observability/xla_cost.py) over wall time and the chip peak — the '
    'measured twin of distllm_engine_mfu.',
    labelnames=('kind',),
)
ENGINE_BW_UTIL_MEASURED = _registry.gauge(
    'distllm_engine_bandwidth_utilization_measured',
    'HBM bandwidth utilization of the most recent engine step of each '
    'kind from compiled.cost_analysis() bytes accessed — includes KV and '
    'activation traffic the analytic weight-stream model omits.',
    labelnames=('kind',),
)
ENGINE_ROOFLINE_FLOPS_RATIO = _registry.gauge(
    'distllm_engine_roofline_flops_ratio',
    'Measured / analytic FLOPs per dispatch of each kind '
    '(cost_analysis over the 2 x n_params model) — calibration drift of '
    'the analytic roofline, as a visible number (~1.0 = calibrated).',
    labelnames=('kind',),
)
ENGINE_ROOFLINE_BYTES_RATIO = _registry.gauge(
    'distllm_engine_roofline_bytes_ratio',
    'Measured / analytic HBM bytes per dispatch of each kind — >1.0 is '
    'expected (KV + activation traffic the weight-stream model omits); '
    'large jumps mean the compiled graph carries traffic the model '
    'cannot see (layout churn, materialized slices).',
    labelnames=('kind',),
)

# ------------------------------------- startup / compile-phase attribution
COMPILE_SECONDS = _registry.histogram(
    'distllm_compile_seconds',
    'Wall time per startup/compile phase (observability/startup.py), by '
    'phase kind and shape label — the warmup ladder, backend init, '
    'weight-layout migration, and quantization made attributable.',
    labelnames=('kind', 'shape'),
    buckets=log_buckets(1e-3, 3600.0),
)
COMPILE_CACHE_HITS = _registry.counter(
    'distllm_compile_cache_hits_total',
    'Compile phases served from a cache fast path: repeat (kind, shape) '
    'in this process, or zero new persistent-compilation-cache entries '
    'while a cache dir is configured.',
)

# ------------------------------------------------ profiler capture helper
PROFILER_CAPTURES = _registry.counter(
    'distllm_profiler_captures_total',
    'Bounded jax.profiler captures (observability/profiling.py; '
    'GET /debug/xprof, DISTLLM_BENCH_PROFILE), by outcome '
    'ok/error/rejected.',
    labelnames=('outcome',),
)
for _outcome in ('ok', 'error', 'rejected'):
    PROFILER_CAPTURES.labels(outcome=_outcome)

# Pre-create the fixed label sets so the full request-lifecycle schema is
# present in the very first scrape, before any traffic.
for _kind in ('prefill', 'decode', 'mixed', 'spec'):
    ENGINE_STEPS.labels(kind=_kind)
    ENGINE_STEP_SECONDS.labels(kind=_kind)
    ENGINE_MFU.labels(kind=_kind)
    ENGINE_BW_UTIL.labels(kind=_kind)
    ENGINE_MFU_MEASURED.labels(kind=_kind)
    ENGINE_BW_UTIL_MEASURED.labels(kind=_kind)
    ENGINE_ROOFLINE_FLOPS_RATIO.labels(kind=_kind)
    ENGINE_ROOFLINE_BYTES_RATIO.labels(kind=_kind)

# Catalog of FlightRecorder record kinds, mirroring the distllm_* metric-
# name catalog above: every ``kind`` the package ever passes to
# ``FlightRecorder.record`` / the engine's ``_record_step`` must be listed
# here (enforced by tests/test_lint.py). A kind minted at a call site
# would silently fragment the flight schema that debug bundles,
# ``/debug/flight``, and ``aggregate.py`` replay.
FLIGHT_KINDS = frozenset({
    'prefill',  # one padded prefill dispatch (batched or paged-context)
    'decode',   # one fused decode window, dispatch -> host fetch
    'mixed',    # decode window that also carried prefill-chunk rows
    'spec',     # speculative verify window (draft/accepted token fields;
                # sampled_rows/resampled_tokens when temperature > 0 rows
                # rode the rejection-sampling verifier, and
                # prefill_tokens/prefill_rows when chunk rows rode)
    'request',  # per-request lifecycle summary at finish
    'preempt',  # recompute preemption performed by prepare_decode
    'spill',    # evicted prefix blocks fetched device→host into the KV
                # tier (blocks/bytes/fetch_s — the audited spill sync)
    'promote',  # host-tier blocks promoted back into the paged pool
                # (blocks/tokens/put_s/wait_s/overlap; wait_s is the one
                # audited completion sync of the async prefetch)
    'peer_fetch',  # one .kvblock payload fetched from a sibling
                   # replica's KVBlockServer over the fabric
                   # (endpoint/blocks/bytes/fetch_s; docs/routing.md)
    'event',    # rare irregular events (scheduler exhaustion, ...)
    'compile',  # one startup/compile phase (observability/startup.py):
                # backend init, warmup ladder shapes, layout migration
    'fault',    # one injected fault firing (resilience/faults.py:
                # site/fired/call — the chaos schedule made attributable)
    'recovery', # one serving-loop retry after a failed dispatch
                # (status=retry with the error + involved rids) or the
                # first post-failure token (status=recovered)
    'quarantine',  # a request forced to terminal FAILED
                   # (reason=dispatch_failed|timeout, recorded error)
    'shed',     # a request refused at admission (predicted_ttft_s /
                # retry_after_s — the honest-backpressure record)
    'regression',  # runtime sentinel firing: a live history window
                   # degraded past threshold vs the BENCH baseline
                   # envelope (metric/baseline/live/window_s fields)
})

# Catalog of startup/compile phase kinds (observability/startup.py),
# mirroring FLIGHT_KINDS: every phase name passed to
# ``CompileWatcher.phase(...)`` must be listed here (enforced by
# tests/test_lint.py). A phase minted at a call site would fragment the
# startup schema that debug bundles and the Perfetto startup track replay.
COMPILE_PHASES = frozenset({
    'backend_init',       # first jax.devices() touch (PJRT client init)
    'quantize',           # weight-only quantization of the param tree
    'auto_layout',        # AOT decode-window compile with Layout.AUTO
    'migrate_params',     # destructive weight relayout into HBM
    'kv_allocate',        # paged K/V pool materialization
    'prefill',            # one (batch, bucket) prefill warmup shape
    'prefill_paged',      # paged-context prefill twin of that shape
    'cow_copy',           # prefix-cache copy-on-write block copy
    'tier_promote',       # KV-tier gather/scatter ladder (spill fetch +
                          # promotion write-back shapes)
    'decode_window',      # the fused decode window (+ merge helper)
    'mixed_window',       # one chunk-bucket mixed-window shape
    'spec_window',        # the speculative verify window
    'spec_mixed_window',  # one chunk-bucket spec-mixed shape
    # The port's own phases:
    'kernel_build',       # one nvcc build of a CUDA kernel (ops/_build.py)
    'weight_load',        # a checkpoint's tensors read into the param tree
    'tensor_parallel',    # a generator's ranks started, meshed and sharded
})
for _outcome in ('met', 'missed'):
    REQUEST_SLO.labels(outcome=_outcome)

# Catalog of Perfetto/Chrome trace-event categories, mirroring the
# distllm_* metric-name and FLIGHT_KINDS catalogs: every ``cat`` the
# trace-event exporter (observability/perfetto.py) emits must be listed
# here (enforced by tests/test_lint.py). A category minted at a call site
# would fragment the trace schema that Perfetto queries, the exporter
# validator, and downstream tooling filter on.
TRACE_EVENT_CATEGORIES = frozenset({
    'engine_step',   # one engine dispatch slice on its window-kind track
    'engine_event',  # instant marks (preemptions, scheduler events)
    'host_gap',      # idle gap between consecutive engine windows
    'request',       # per-request lifecycle slice + nested ttft/queue_wait
    'span',          # trace-ring spans (server middleware, RAG, stages)
    'startup',       # compile-phase slices on the dedicated startup track
    'history',       # metric-history counter track (ph "C" events from
                     # the history.py ring: tok/s, burn rates, queue
                     # depth, KV occupancy over the trace window)
})

# ------------------------------------------------- resilience / fault layer
# Fault injection, crash-domain recovery, and SLO-aware shedding
# (distllm_tpu/resilience/, engine recovery paths; docs/resilience.md).
# Nothing in the resilience layer degrades silently: every injected
# fault, retry, quarantine, timeout, and shed lands in one of these.
FAULT_SITE_LABELS = ('dispatch', 'device_put', 'tier_io',
                     'sched_exhausted', 'slow_window')
RESILIENCE_FAULTS = _registry.counter(
    'distllm_resilience_faults_injected_total',
    'Faults fired by the deterministic injector '
    '(distllm_tpu/resilience/faults.py), by catalogued site. Zero in '
    'production unless DISTLLM_FAULTS armed a chaos schedule.',
    labelnames=('site',),
)
RESILIENCE_RETRIES = _registry.counter(
    'distllm_resilience_window_retries_total',
    'Serving-loop retries after a failed dispatch (EngineConfig.'
    'max_dispatch_retries > 0): the loop rolled per-row state back and '
    're-dispatched with bounded backoff instead of propagating.',
)
RESILIENCE_RECOVERIES = _registry.counter(
    'distllm_resilience_recoveries_total',
    'Recoveries: the first token emitted after one or more failed '
    'dispatches — the retry ladder worked and serving resumed.',
)
RESILIENCE_QUARANTINED = _registry.counter(
    'distllm_resilience_quarantined_requests_total',
    'Requests forced to the terminal FAILED status with a recorded '
    'error, by reason: dispatch_failed = its dispatches kept failing '
    'past the retry budget (poison-request containment), timeout = it '
    'outlived EngineConfig.request_deadline_s (its KV blocks are freed '
    'instead of held forever).',
    labelnames=('reason',),
)
RESILIENCE_SHED = _registry.counter(
    'distllm_resilience_shed_requests_total',
    'Requests refused with honest backpressure instead of queueing past '
    'the TTFT SLO, by reason: overload = predicted TTFT busts '
    'ttft_slo_s at enqueue (429 + Retry-After), draining = the server '
    'is in the /drain lifecycle (503).',
    labelnames=('reason',),
)
RESILIENCE_PREDICTED_TTFT = _registry.histogram(
    'distllm_resilience_predicted_ttft_seconds',
    'Admission-time TTFT predictions (resilience/admission.py), '
    'admitted and shed alike — compare against the realized '
    'distllm_request_ttft_seconds to read the predictor\'s calibration.',
    buckets=log_buckets(1e-3, 600.0),
)
for _site in FAULT_SITE_LABELS:
    RESILIENCE_FAULTS.labels(site=_site)
for _reason in ('dispatch_failed', 'timeout'):
    RESILIENCE_QUARANTINED.labels(reason=_reason)
for _reason in ('overload', 'draining'):
    RESILIENCE_SHED.labels(reason=_reason)
SERVER_READY = _registry.gauge(
    'distllm_server_ready',
    'chat_server readiness for the multi-replica router to poll: 1 = '
    'admitting, 0 = draining (POST /drain) — /health mirrors it as the '
    '"ready" field and a 503 status while draining.',
)
SERVER_READY.set(1.0)

# ------------------------------------------------ build identity / uptime
# Standard fleet-observability identities (the multi-replica router and
# aggregate tooling key on them): a constant-1 info gauge carrying the
# package version label, and a seconds-since-boot gauge the chat server
# refreshes on every history tick and health probe.
BUILD_INFO = _registry.gauge(
    'distllm_build_info',
    'Constant 1 with the package version as a label — the standard '
    'build-identity series fleet tooling joins per-replica metrics on.',
    labelnames=('version',),
)
BUILD_INFO.labels(version=__version__).set(1.0)
SERVER_UPTIME = _registry.gauge(
    'distllm_server_uptime_seconds',
    'Seconds since this chat_server process built its app (refreshed on '
    'every history-sampler tick and /health probe; 0 until a server runs).',
)

# ------------------------------------- telemetry history (history.py ring)
HISTORY_SAMPLES = _registry.counter(
    'distllm_history_samples_total',
    'Completed history-sampler ticks (observability/history.py) — one '
    'full registry snapshot folded into the bounded time-series ring.',
)
HISTORY_SAMPLE_SECONDS = _registry.histogram(
    'distllm_history_sample_duration_seconds',
    'Wall time per history sampling tick — the overhead bound: '
    'tests/test_history.py asserts a full-catalog tick stays under 50 ms '
    '(typically well under 5 ms), so a 1 s sampling interval costs <1% '
    'of one core.',
    buckets=log_buckets(1e-5, 1.0),
)
HISTORY_SAMPLE_ERRORS = _registry.counter(
    'distllm_history_sample_errors_total',
    'History observer callbacks that raised (swallowed and counted — a '
    'broken SLO/sentinel observer must not kill the sampler thread).',
)

# --------------------------------------- SLO burn rate (observability/slo.py)
# The burn-rate windows, as label values ('<seconds>s'). This tuple is the
# single owner: slo.py derives its short/long window pairs from it and the
# gauge pre-registration below iterates it, so a new window cannot leave
# the scrape schema behind. Default pairing (SRE-workbook style): the fast
# pair (60s short, 600s long) pages, the slow pair (300s, 3600s) warns.
SLO_BURN_WINDOW_LABELS = ('60s', '300s', '600s', '3600s')
SLO_BURN_RATE = _registry.gauge(
    'distllm_slo_burn_rate',
    'TTFT-SLO error-budget burn rate per trailing window: '
    '(missed / finished in the window) / (1 - objective). 1.0 = burning '
    'exactly the budget; sustained >> 1 on both windows of a pair pages '
    '(docs/observability.md "SLO burn rates").',
    labelnames=('window',),
)
for _window in SLO_BURN_WINDOW_LABELS:
    SLO_BURN_RATE.labels(window=_window)

# --------------------------- runtime regression sentinel (sentinel.py)
# The live metrics the sentinel compares against the baseline envelope
# (scripts/benchdiff.py --emit-baseline). Single owner: sentinel.py's
# live-extractor table and the counter pre-registration both iterate it.
SENTINEL_METRIC_LABELS = (
    'tok_s', 'ttft_p95_s', 'tpot_p95_s', 'mfu_measured', 'bw_util_measured',
)
SENTINEL_REGRESSIONS = _registry.counter(
    'distllm_sentinel_regressions_total',
    'Live-window regressions detected by the runtime sentinel, by '
    'baseline metric: a trailing history window degraded past the '
    'sentinel threshold vs the BENCH baseline envelope. One count per '
    'degradation episode (latched until the metric recovers).',
    labelnames=('metric',),
)
for _metric in SENTINEL_METRIC_LABELS:
    SENTINEL_REGRESSIONS.labels(metric=_metric)
SENTINEL_ARMED = _registry.gauge(
    'distllm_sentinel_armed',
    '1 while the regression sentinel holds a baseline envelope with at '
    'least one comparable metric, 0 while disarmed (no baseline — the '
    'counted degraded mode, never a raise).',
)
SENTINEL_DISARMED = _registry.counter(
    'distllm_sentinel_disarmed_total',
    'Sentinel arm attempts that degraded to disarmed, by reason: '
    'no_baseline = envelope file missing/unreadable, empty = envelope '
    'parsed but carried no comparable metrics.',
    labelnames=('reason',),
)
for _reason in ('no_baseline', 'empty'):
    SENTINEL_DISARMED.labels(reason=_reason)

# -------------------------------------------------- watchdog / debug bundle
WATCHDOG_STALLS = _registry.counter(
    'distllm_watchdog_stalls_total',
    'StallWatchdog firings (no observed progress for the stall window).',
)
DEBUG_BUNDLES = _registry.counter(
    'distllm_debug_bundles_total',
    'Debug bundles dumped (watchdog stalls, stage failures, /debug/bundle).',
)

# ------------------------------------------------------------ scheduler
SCHED_QUEUE_DEPTH = _registry.gauge(
    'distllm_scheduler_queue_depth',
    'Requests waiting for admission (continuous-batching backlog).',
)
SCHED_RUNNING = _registry.gauge(
    'distllm_scheduler_running_requests',
    'Requests currently holding a decode slot.',
)
SCHED_ADMITTED = _registry.counter(
    'distllm_scheduler_admitted_total',
    'Waiting requests admitted to a decode slot.',
)
SCHED_DEFERRED = _registry.counter(
    'distllm_scheduler_deferred_total',
    'Admission attempts deferred (no free slot or insufficient blocks).',
)
SCHED_PREEMPTIONS = _registry.counter(
    'distllm_scheduler_preemptions_total',
    'Running requests recompute-preempted back to the waiting queue.',
)

# ------------------------------------------------- pipeline stages (Timer)
STAGE_SECONDS = _registry.histogram(
    'distllm_stage_duration_seconds',
    'Per-stage wall time from timer.Timer spans, labeled by lead tag.',
    labelnames=('stage', 'status'),
)

# ----------------------------------------------------------- HTTP server
HTTP_REQUESTS = _registry.counter(
    'distllm_http_requests_total',
    'HTTP requests served, by normalized path and status class.',
    labelnames=('path', 'status'),
)
HTTP_LATENCY = _registry.histogram(
    'distllm_http_request_duration_seconds',
    'End-to-end request latency, by normalized path.',
    labelnames=('path',),
    buckets=log_buckets(1e-3, 300.0),
)
HTTP_IN_FLIGHT = _registry.gauge(
    'distllm_http_requests_in_flight',
    'Requests currently being handled.',
)
HTTP_RESPONSES = _registry.counter(
    'distllm_http_responses_total',
    'Responses completed by this server process (all paths).',
)

# ---------------------------------------------- multi-replica router
# The prefix-affinity front-end (distllm_tpu/router/; docs/routing.md).
# Runs in its own process, so these series appear on the ROUTER's
# /metrics, not a replica's. Label tuples below are the single owners:
# router/app.py and the pre-registration loops both iterate them.
ROUTER_DECISION_LABELS = ('affinity', 'least_loaded', 'round_robin')
ROUTER_REQUESTS = _registry.counter(
    'distllm_router_requests_total',
    'Requests proxied to a replica, by the routing decision that picked '
    'it: affinity = the learned digest map matched the prompt prefix, '
    'least_loaded = no affinity signal so the lightest /loadinfo queue '
    'won, round_robin = the baseline rotation policy.',
    labelnames=('decision',),
)
ROUTER_RETRIES = _registry.counter(
    'distllm_router_retries_total',
    'In-flight requests retried once on a healthy peer after their '
    'first replica died mid-request (response carries '
    'X-Distllm-Router-Retry: 1).',
)
ROUTER_FAILURES = _registry.counter(
    'distllm_router_failures_total',
    'Requests the router could not serve: no replica in rotation, or '
    'the single retry also failed (client sees 502/503).',
)
ROUTER_UPSTREAM_REJECTIONS = _registry.counter(
    'distllm_router_upstream_rejections_total',
    'Replica 429 + Retry-After admission rejections propagated to the '
    'client untouched — backpressure is the replica\'s call, never '
    'retried elsewhere by the router.',
)
ROUTER_REPLICA_STATE_LABELS = ('healthy', 'draining', 'dead')
ROUTER_REPLICAS = _registry.gauge(
    'distllm_router_replicas',
    'Replicas per rotation state: healthy = receiving new requests, '
    'draining = finishing in-flight only (one-way; never rejoins), '
    'dead = failed /health (rejoins when probes recover).',
    labelnames=('state',),
)
ROUTER_AFFINITY_ENTRIES = _registry.gauge(
    'distllm_router_affinity_entries',
    'Digest entries currently held across all per-replica affinity LRU '
    'maps (bounded by RouterConfig.affinity_map_size each).',
)
ROUTER_PROXY_SECONDS = _registry.histogram(
    'distllm_router_proxy_seconds',
    'End-to-end proxy latency per routed request (replica pick + '
    'upstream round trip + relay), retries included.',
    buckets=log_buckets(1e-3, 300.0),
)
for _decision in ROUTER_DECISION_LABELS:
    ROUTER_REQUESTS.labels(decision=_decision)
for _state in ROUTER_REPLICA_STATE_LABELS:
    ROUTER_REPLICAS.labels(state=_state)

# -------------------------------------------------------- fabric workers
WORKER_HEARTBEATS = _registry.counter(
    'distllm_worker_heartbeats_total',
    'Heartbeats sent by this fabric worker.',
)
WORKER_TASKS = _registry.counter(
    'distllm_worker_tasks_total',
    'Fabric tasks executed, by outcome.',
    labelnames=('outcome',),
)
WORKER_TASK_SECONDS = _registry.histogram(
    'distllm_worker_task_duration_seconds',
    'Wall time per fabric task (heartbeats excluded).',
)

# ------------------------------------------------------------ log funnel
LOG_MESSAGES = _registry.counter(
    'distllm_log_messages_total',
    'Operator log lines emitted through observability.log_event.',
    labelnames=('component',),
)


def log_event(message: str, *, component: str = 'app') -> None:
    """The sanctioned stdout funnel: print + count.

    All operator-facing telemetry lines in ``distllm_tpu`` go through here
    (``tests/test_lint.py`` forbids raw ``print(`` outside ``timer.py`` and
    this package), so every emitted line is also visible as
    ``distllm_log_messages_total{component=...}`` in scrapes.
    """
    LOG_MESSAGES.labels(component=component).inc()
    print(message, flush=True)
