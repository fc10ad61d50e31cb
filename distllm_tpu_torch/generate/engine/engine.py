"""Continuous-batching generation engine over the paged KV cache
(PyTorch counterpart of ``distllm_tpu.generate.engine.engine``).

- **admission**: waiting requests enter free slots under the block budget
  (``scheduler.PyScheduler``); each admitted request prefills its tail —
  the tokens past its cached prefix, all of them without the prefix cache
  — through :func:`~distllm_tpu_torch.models.mistral.prefill_paged`, the
  JAX engine's own path for chunk and prefix-hit tails, so every dispatch
  reaches the paged-attention kernel. Tails of one length bucket prefill
  together in one padded dispatch.
- **chunked prefill** (``EngineConfig.prefill_chunk_tokens``): a tail
  longer than the chunk prefills as sequential chunks, each attending over
  the KV the earlier ones wrote; only the last samples.
- **mixed windows** (``enable_mixed_batching``): once decode windows flow,
  admitted tails on the paged route (a cached prefix, or a tail to chunk)
  ride them as prefill-chunk rows — up to ``max_window_prefill_seqs`` rows
  and ``max_window_prefill_tokens`` tokens a window. A window runs its
  chunk half eagerly (one ``prefill_paged`` pass), then its decode half
  through the decode graphs; a request joins decode once its last chunk
  has emitted its first token.
- **speculation** (``draft_k``): every window is a verify window. Each
  decode row proposes up to ``draft_k`` tokens from its own history
  (:class:`~distllm_tpu_torch.generate.engine.spec.PromptLookupDrafter`)
  and one pass scores every row's ``[last token, drafts]`` span, verified
  on the device (``ops.sampling.verify_spans``: the argmax rule for greedy
  rows, rejection sampling for sampled ones). Blocks are reserved per row
  and trimmed back after acceptance; rejected K/V needs no rollback. On
  the GPU the verify pass replays one captured CUDA graph
  (:class:`~distllm_tpu_torch.generate.engine.decode_graph.VerifyGraphRunner`);
  a chunk half, where present, runs eagerly before it.
- **automatic prefix caching** (``EngineConfig.enable_prefix_cache``):
  full prompt blocks enter a hash-chain cache after their prefill; a later
  request sharing a block-aligned prefix borrows those blocks
  (refcounted, LRU-evicted under pool pressure) and prefills only its
  tail. An exact block-aligned repeat keeps its match and re-prefills its
  last token into a copy of the shared final block (copy-on-write).
- **host, disk and peer KV tiers** (``host_kv_tier_bytes``,
  ``disk_kv_tier_dir``, ``peer_kv_endpoints``): evicted cache blocks spill
  device -> host (writing through to disk) instead of being dropped, a
  miss on both asks the sibling replicas' ``KVBlockServer``s (a peer hit
  enters the host pool as a disk hit does), and with
  ``peer_kv_serve_endpoint`` this engine serves its own spills to them. A
  later same-prefix arrival promotes tier blocks back into its own pool
  blocks: a host -> device copy on a side stream
  whose event the current stream waits on, so the request's tail prefill
  and every later reader of those blocks follow it on the device. Every
  pool write — prefill, decode, copy-on-write, promotion — changes the
  pool tensors in place, so the decode graphs' addresses stay valid.
- **decode**: one window generates up to ``decode_steps`` tokens for the
  whole running batch (``max_num_seqs`` slots) through the engine's
  :class:`~distllm_tpu_torch.generate.engine.decode_graph.DecodeGraphRunner`:
  the window's inputs go to static device buffers in one copy, and on the
  GPU each step replays one captured CUDA graph of
  :func:`~distllm_tpu_torch.models.mistral.decode_window_step` (on the CPU
  the same step runs eagerly; ``mistral.decode_loop`` is its eager twin).
  The sampled tokens stay on the device and the host fetches them once
  per window. :meth:`LLMEngine.warmup` builds the kernels and captures the
  graphs outside the request path; on the GPU the first window calls it
  if the caller has not.
- **pipelining** (``pipeline_depth``; default 1, where JAX's is 2: on the
  H100 the offline loop is device-bound and depth 2 measured slower, see
  ``PERF.md``): ``generate_ids`` keeps up to ``pipeline_depth`` windows
  in flight and processes window N after dispatching window N+1. A continuing row keeps its last id on the
  device (the runner's carry; a row admitted since the last window takes
  the host's), each row reserves blocks for its unacked tokens plus the
  window's steps, no dispatch preempts while windows are in flight (the
  loop evicts cached blocks, then drains), deadlines expire only after a
  drain, and the tokens a row runs past its stop are discarded and counted
  (``stats['overshoot_tokens']``). ``defer_prefill`` (opt-in) keeps each
  standalone prefill's first tokens on the device, scattered into the
  carry, and fetches them with the windows. ``draft_k`` forces depth 1;
  :meth:`LLMEngine.step` is always one synchronous window.
- **preemption**: when the pool runs dry mid-decode the youngest request
  is recompute-preempted (blocks freed, re-prefilled on readmission).
- **scheduler** (``prefer_native_allocator``, default off): the Python
  scheduler, or its native C++ twin (``csrc/host/scheduler.cpp``, built
  with g++ at first use; the Python one when it cannot be built, logged;
  ``scheduler_kind``, ``telemetry['scheduler']``).
- **weight-only quantization** (``EngineConfig.quantization``): the
  engine quantizes its parameters once at construction (int8 projections
  then run through kernel K2, nf4 ones dequantize per layer) and pins the
  quantized-matmul tier into its model config.
- **KV storage dtype** (``EngineConfig.kv_cache_dtype``), resolved once at
  construction: the model dtype (``'auto'`` or the matching pin), the other
  full-precision dtype (read by kernel K1's mixed mode), or an int8 pool
  with per-block, per-KV-head scales, quantized at write time and read by
  K1's int8-KV mode (about half the bytes per block).

- **telemetry** (the JAX engine's series, ``observability.instruments``):
  every request carries its lifecycle timestamps (enqueue, admit, first
  token, finish; the first value kept across preemption) into the TTFT,
  TPOT and queue-wait histograms, the SLO and goodput counters
  (``ttft_slo_s``) and one ``'request'`` record of the process flight ring
  (``engine.flight``); every prefill dispatch and every decode, mixed and
  verify window adds a step record. With ``attribution`` on the record
  also carries the host / put / dispatch / fetch split, read at clock
  points the path has anyway (no added sync), and the analytic roofline
  (``observability.roofline``) prices the step into ``mfu`` /
  ``bw_util`` and the ``distllm_engine_mfu`` /
  ``distllm_engine_bandwidth_utilization`` gauges.
- **resilience** (the JAX fields): ``request_deadline_s`` quarantines
  requests that outlive it (``finish_reason='timeout'``, blocks freed);
  ``max_dispatch_retries`` makes :meth:`LLMEngine.step` charge a failed
  dispatch to the requests involved, roll the host state it advanced
  back, back off and retry on the next call, quarantining a request
  past its budget (``FAILED``, ``finish_reason='dispatch_failed'``);
  ``admission_control`` refuses an arrival whose predicted TTFT busts
  ``ttft_slo_s`` (``resilience.EngineOverloaded``). The fault sites of
  ``resilience.faults`` sit at the JAX points: ``dispatch`` before each
  prefill, decode and verify dispatch (before anything reaches the
  device), ``device_put`` in the tier promotion, ``sched_exhausted`` in
  window planning and ``slow_window`` in window processing. Recovery
  covers faults raised on the host: a sticky CUDA error fails every
  later dispatch too, and the retry budget then drains the live
  requests into ``FAILED``.

- **start-up and measured cost**: the CUDA context, quantization, kernel
  builds and graph captures are start-up phases
  (``observability.startup``); the decode and verify steps are priced at
  warmup and the first prefill dispatch at its shape
  (``observability.op_cost``), behind the measured-MFU and bandwidth
  gauges.

- **tensor and expert parallelism** (``mesh=``, a
  ``parallel.mesh.Mesh``): the engine on each rank holds that rank's
  slice of the weights (``parallel.sharding.shard_pytree`` under the
  family's ``param_specs``) and its ``num_kv_heads / model`` KV heads of
  the pool, and its model config is bound to the mesh
  (``parallel.comm.bind``), so every program runs the rank's heads and
  widths with the all-reduces in the forward. Rank 0 schedules: each
  device program — a prefill dispatch, a chunk half, a decode window's
  load and steps, a verify window's, a copy-on-write, the warm-up — is
  sent with its host inputs to the other ranks (``followers``, a
  ``parallel.multihost.RankGroup``) before rank 0 runs it, and each of
  them runs it in :meth:`LLMEngine.follow`. The logits are whole on every
  rank, so every rank samples the same tokens (each keeps a digest of
  them: :meth:`LLMEngine.tp_report`). Over gloo the windows run eagerly
  (gloo's collectives cannot be captured; ``stats['decode_graphs']`` is
  false and ``telemetry['decode_graphs_reason']`` says why); over NCCL
  they stay captured graphs with the collectives inside. The prefix
  cache, chunked prefill, mixed windows, speculation, the int8 KV pool
  and pipelining run as they do on one rank. The host, disk and peer KV
  tiers are rank 0's and hold whole blocks, every KV head, as the JAX
  engine's do (its spill fetches the model-sharded pool whole): a spill
  is a program in which each rank gathers its heads of the evicted blocks
  and rank 0 assembles them in head order over the ``model`` group
  (``TensorParallel.gather_heads``); a promotion reads whole blocks on
  rank 0 and sends each rank its heads' slice with the program. So
  ``.kvblock`` files and peer payloads keep the JAX layout, and a tier
  written at one ``tensor_parallel_size`` serves another. Only rank 0
  serves requests and exports metrics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import itertools
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
import torch

from distllm_tpu_torch.generate.engine.decode_graph import (
    DecodeGraphRunner,
    VerifyGraphRunner,
)
from distllm_tpu_torch.generate.engine.kv_cache import (
    DiskKVTier,
    HostKVTier,
    PagedKVCache,
    PeerKVTier,
    PrefixCache,
    block_digests,
)
from distllm_tpu_torch.generate.engine.scheduler import (
    SchedulerExhausted,
    make_scheduler,
)
from distllm_tpu_torch.generate.engine.spec import PromptLookupDrafter
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.models.tokenizer import bucket_ladder, pick_bucket
from distllm_tpu_torch.observability import instruments as _metrics
from distllm_tpu_torch.observability import op_cost as _op_cost
from distllm_tpu_torch.observability.flight import get_flight_recorder
from distllm_tpu_torch.observability.instruments import log_event
from distllm_tpu_torch.observability.roofline import CostModel, device_peaks
from distllm_tpu_torch.observability.startup import (
    get_compile_watcher,
    record_backend_init,
)
from distllm_tpu_torch.observability.tracing import current_request_id
from distllm_tpu_torch.ops.paged_attention import (
    kv_storage_dtype,
    resolve_attn_backend,
)
from distllm_tpu_torch.ops.quantization import (
    MODES,
    leaves,
    quantize_pytree,
    quantized_nbytes,
)
from distllm_tpu_torch.ops.sampling import fold_row_keys, sample_tokens
from distllm_tpu_torch.parallel.comm import bind, local_heads
from distllm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS
from distllm_tpu_torch.resilience.admission import (
    EngineLoadView,
    EngineOverloaded,
    shed_decision,
)
from distllm_tpu_torch.resilience.faults import InjectedFault, get_fault_injector
from distllm_tpu_torch.utils import BaseConfig, resolve_device

KV_CACHE_DTYPES = ('auto', 'bf16', 'fp32', 'int8')
SPEC_DRAFT_SOURCES = ('prompt_lookup', 'none')
# A pinned KV dtype's storage name; 'auto' stores the model dtype.
_KV_POOL_DTYPES = {'bf16': 'bfloat16', 'fp32': 'float32', 'int8': 'int8'}


@dataclass
class SamplingParams:
    """vLLM-parity sampling knobs (the JAX ``SamplingParams``)."""

    temperature: float = 0.5
    top_p: float = 1.0
    min_p: float = 0.0
    top_k: int = 0  # 0 disables
    seed: int | None = None  # None: derived from the request id
    max_tokens: int = 2000
    stop_token_ids: tuple[int, ...] = ()


def _request_seed(engine_seed: int, request_id: int, explicit: int | None) -> int:
    """A request's uint32 sampling seed: the explicit one, else a stable
    hash of (engine seed, request id) — the JAX derivation."""
    if explicit is not None:
        return explicit & 0xFFFFFFFF
    digest = hashlib.blake2s(
        f'{engine_seed}:{request_id}'.encode(), digest_size=4
    ).digest()
    return int.from_bytes(digest, 'little')


class RequestState(Enum):
    WAITING = 'waiting'
    RUNNING = 'running'
    FINISHED = 'finished'
    # Terminal quarantine: the request's dispatches kept failing past the
    # retry budget, or it outlived request_deadline_s. Its blocks are
    # freed, the error is recorded on it, and it never re-enters the
    # scheduler.
    FAILED = 'failed'


@dataclass
class Request:
    request_id: int
    prompt_ids: list[int]
    params: SamplingParams
    state: RequestState = RequestState.WAITING
    output_ids: list[int] = field(default_factory=list)
    sample_seed: int = 0
    # '' while live; 'stop' / 'length' for normal finishes, 'timeout' past
    # request_deadline_s, 'dispatch_failed' after the retry budget. A
    # FAILED request also records the error text.
    finish_reason: str = ''
    error: str | None = None
    # --- lifecycle (monotonic seconds; 0.0 = not reached) ---
    # t_admit and t_first_token keep their FIRST value across recompute
    # preemption: the client-visible latencies run from enqueue.
    t_enqueue: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_finish: float = 0.0
    # The server's X-Request-Id, captured from tracing.request_scope at
    # add_request and carried on the 'request' flight record.
    trace_id: str | None = None
    # --- automatic prefix caching ---
    # Chained digests of the prompt's full blocks (the cache keys).
    digests: list[bytes] = field(default_factory=list)
    # Prompt tokens whose KV is valid in cache blocks at prefill time: the
    # prefill runs on the tail past them.
    num_cached_tokens: int = 0
    # Leading blocks of the request's row owned by the prefix cache (the
    # scheduler's borrowed-prefix count).
    num_borrowed_blocks: int = 0
    # Aligned full-cover hit: the shared final block, copied into the
    # request's own block before its last token is re-prefilled.
    cow_src_block: int | None = None
    # Digests past the cached prefix that the host or disk tier holds at
    # add_request; promoted at admission, cleared when promotion begins.
    promo_digests: list[bytes] = field(default_factory=list)
    # --- mixed windows ---
    # Absolute token counts of a tail riding windows as chunk rows: target
    # = tokens to prefill (set at enrollment), sent = dispatched in some
    # window, done = confirmed by a processed window. The request decodes
    # once done >= target; all three stay 0 outside mixed mode.
    prefill_target: int = 0
    prefill_sent: int = 0
    prefill_done: int = 0
    # --- speculation ---
    # The request's drafter (None: it never drafts, draft_k is 0 or
    # spec_draft_source is 'none'). Its index covers prompt and outputs,
    # which recompute preemption keeps, so it survives preemption.
    drafter: 'PromptLookupDrafter | None' = None

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)


@dataclass
class EngineConfig(BaseConfig):
    """Capacity knobs (vLLM analogues ``block_size``, ``num_blocks``,
    ``max_num_seqs``, ``max_model_len``) plus the decode window length,
    the prefill batch cap, weight-only quantization, the KV pool's storage
    dtype, chunked prefill, mixed windows and speculation (the JAX
    fields, defaults and checks)."""

    block_size: int = 16
    num_blocks: int = 256
    max_num_seqs: int = 8
    max_model_len: int = 1024
    # Smallest prefill length bucket.
    prefill_min_bucket: int = 16
    decode_steps: int = 8
    max_prefill_batch: int = 8
    # Upper bound on rows x bucket tokens of one prefill dispatch.
    max_prefill_tokens: int = 2048
    quantization: str | None = None  # None | 'int8' | 'nf4' (weight-only)
    # Automatic prefix caching: full prompt blocks enter a hash-chain
    # cache as they prefill; later requests sharing a block-aligned prefix
    # reuse those blocks and prefill only the uncached tail.
    enable_prefix_cache: bool = False
    # Host-RAM KV tier behind the prefix cache: byte budget (LRU) of the
    # host pool evicted cache blocks spill into; 0 disables. Requires
    # enable_prefix_cache.
    host_kv_tier_bytes: int = 0
    # Disk tier under the host pool: spills write through to one
    # digest-named .kvblock file per block here, so a fresh engine
    # promotes from a previous process's spills. None disables; requires
    # host_kv_tier_bytes.
    disk_kv_tier_dir: str | None = None
    # Disk-tier byte budget (LRU; evictions there are final drops).
    disk_kv_tier_bytes: int = 1 << 30
    # Peer KV tier: sibling replicas' KVBlockServer endpoints
    # ('tcp://host:port') asked after host and disk miss; a fetched
    # .kvblock payload enters the host pool and promotes as a disk hit
    # does. None disables the tier; an empty tuple enables it with no peers
    # yet (engine.kv_tier.peer.add_endpoint). Requires host_kv_tier_bytes.
    peer_kv_endpoints: tuple[str, ...] | None = None
    # Serve this engine's spilled blocks to peers: a zmq bind spec for its
    # KVBlockServer ('tcp://127.0.0.1:0' picks a free port; the endpoint
    # is engine.peer_kv_endpoint). None disables. Requires
    # host_kv_tier_bytes.
    peer_kv_serve_endpoint: str | None = None
    # One peer HAS / GET round trip's timeout, and how long a failing
    # endpoint sits out (a failure is a cold prefill, never a stall).
    peer_kv_timeout_ms: int = 500
    peer_kv_backoff_s: float = 5.0
    # Storage dtype of the paged KV pool (the JAX field): 'auto' stores the
    # model dtype, bit-identical to an engine without the field; 'int8'
    # stores int8 codes with per-block, per-KV-head fp32 scales; a
    # full-precision pin of the other dtype than the model's ('bf16' under
    # fp32, 'fp32' under bf16) is attended in K1's mixed mode.
    kv_cache_dtype: str = 'auto'  # 'auto' | 'bf16' | 'fp32' | 'int8'
    # Sample from the top-K logits of each step instead of the whole
    # sorted vocabulary (vLLM's top_k semantic, before top-p); 0 = exact
    # full-vocabulary semantics.
    sampling_top_window: int = 0
    # Split uncached prefill tails longer than this many tokens into
    # sequential chunks, each attending over the KV already in the pool;
    # 0 disables chunking.
    prefill_chunk_tokens: int = 0
    # Mixed prefill+decode windows: once windows flow, cache-hit tails and
    # tails to chunk ride them as prefill-chunk rows.
    enable_mixed_batching: bool = False
    # Prefill-chunk tokens one mixed window may carry (a chunk span is
    # further capped by prefill_chunk_tokens when set).
    max_window_prefill_tokens: int = 256
    # Prefill-chunk rows (requests) one mixed window may carry.
    max_window_prefill_seqs: int = 2
    # Prompt-lookup speculative decoding: up to draft_k tokens a row are
    # proposed from its own history and verified in one pass; 0 disables.
    draft_k: int = 0
    # n-gram length the prompt-lookup drafter matches on.
    spec_ngram: int = 2
    # Where drafts come from: 'prompt_lookup', or 'none' (no drafts: every
    # window is a span-1 verify through the same graph, the identity
    # baseline of speculation in bf16).
    spec_draft_source: str = 'prompt_lookup'
    # TTFT service-level objective in seconds (0 = no SLO accounting).
    # When set, every finished request counts into
    # distllm_request_slo_total{outcome=met|missed} and met requests'
    # output tokens into distllm_engine_goodput_tokens_total.
    ttft_slo_s: float = 0.0
    # Per-request wall-clock deadline (enqueue -> terminal state) in
    # seconds; 0 disables. A request that outlives it finishes with
    # finish_reason='timeout' and frees its KV blocks.
    request_deadline_s: float = 0.0
    # Crash-domain recovery: how many times a request's dispatches may fail
    # before it is quarantined to FAILED. 0 keeps the plain contract (the
    # first dispatch exception propagates); > 0 makes step() roll the
    # host state back, back off (retry_backoff_s * 2^attempt, capped at
    # 2 s) and retry on the next call.
    max_dispatch_retries: int = 0
    # Base of the bounded exponential backoff between retries.
    retry_backoff_s: float = 0.05
    # SLO-aware admission control (needs ttft_slo_s > 0): predict TTFT at
    # enqueue from EWMA-measured prefill and window rates (roofline floors
    # before traffic) and the backlog, and refuse with EngineOverloaded
    # what would bust the SLO. Flippable at run time through
    # engine.admission_control.
    admission_control: bool = False
    # Serving-path attribution: the host / put / dispatch / fetch split on
    # flight records, torch.profiler labels around every dispatch, and
    # the roofline gauges. Host bookkeeping only: tokens are identical
    # either way. Flippable at run time through engine.attribution.
    attribution: bool = True
    # Decode windows in flight during generate_ids (2 overlaps the host's
    # work on one window with the device's on the next). The default is 1,
    # not JAX's 2: the port's offline loop keeps the H100 busy at depth 1,
    # and depth 2 admits rows a window later (more passes, fewer tok/s).
    # step() is always one window at a time; draft_k forces 1.
    pipeline_depth: int = 1
    # Keep each standalone prefill's first tokens on the device (scattered
    # into the decode carry) and fetch them with the in-flight window
    # records instead of at the prefill. Opt-in, exclusive with
    # enable_mixed_batching and with draft_k (the JAX checks).
    defer_prefill: bool = False
    # Take the native (C++) scheduler, built with g++ at first use, and
    # fall back to the Python one with a log line when it cannot build.
    # Off by default, where JAX's is on: its ctypes calls cost the host
    # more than the Python twin's list work at these slot counts (measured
    # on the engines of chip_smoke.py's phases 16 and 17, PERF.md).
    prefer_native_allocator: bool = False
    # > 0 makes this engine own a HistorySampler ticking the process
    # MetricsHistory at this interval (stopped in shutdown()); 0 starts
    # nothing: the chat server owns the process sampler.
    history_interval_s: float = 0.0
    # Engine-wide seed behind requests that carry no explicit seed.
    seed: int = 0

    def validate(self) -> None:
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                "kv_cache_dtype must be 'auto', 'bf16', 'fp32', or "
                f"'int8', got {self.kv_cache_dtype!r}"
            )
        if self.quantization not in (None, *MODES):
            raise ValueError(
                f'quantization must be None or one of {MODES}, got '
                f'{self.quantization!r}'
            )
        for name in ('block_size', 'max_num_seqs', 'max_model_len',
                     'decode_steps', 'max_prefill_batch'):
            if getattr(self, name) < 1:
                raise ValueError(f'{name} must be >= 1')
        for name in ('sampling_top_window', 'prefill_chunk_tokens',
                     'max_window_prefill_tokens', 'draft_k',
                     'max_dispatch_retries', 'request_deadline_s',
                     'retry_backoff_s', 'history_interval_s',
                     'peer_kv_timeout_ms', 'peer_kv_backoff_s'):
            if getattr(self, name) < 0:
                raise ValueError(f'{name} must be >= 0')
        if self.spec_ngram < 1:
            raise ValueError('spec_ngram must be >= 1')
        if self.max_window_prefill_seqs < 1:
            raise ValueError('max_window_prefill_seqs must be >= 1')
        if self.spec_draft_source not in SPEC_DRAFT_SOURCES:
            raise ValueError("spec_draft_source must be 'prompt_lookup' or 'none'")
        if self.enable_mixed_batching and self.defer_prefill:
            raise ValueError(
                'enable_mixed_batching and defer_prefill are mutually '
                'exclusive: both re-route prefill emission through the window '
                'pipeline; disable one'
            )
        if self.enable_mixed_batching and self.max_window_prefill_tokens < 1:
            raise ValueError('enable_mixed_batching needs max_window_prefill_tokens >= 1')
        if self.enable_mixed_batching and not (
            self.enable_prefix_cache or self.prefill_chunk_tokens
        ):
            raise ValueError(
                'enable_mixed_batching needs enable_prefix_cache and/or '
                'prefill_chunk_tokens: only cache-hit tails and chunked spans '
                'ride mixed windows'
            )
        if self.draft_k and self.defer_prefill:
            raise ValueError(
                'draft_k and defer_prefill are mutually exclusive: speculative '
                'windows fetch every window synchronously (the drafter needs '
                "host-side history), which removes defer_prefill's in-flight "
                'deque'
            )
        if self.num_blocks < 2:
            raise ValueError('num_blocks must be >= 2 (block 0 is reserved)')
        if self.max_model_len < 2:
            raise ValueError('max_model_len must be >= 2')
        if self.host_kv_tier_bytes < 0 or self.disk_kv_tier_bytes < 0:
            raise ValueError('KV tier byte budgets must be >= 0')
        if self.host_kv_tier_bytes and not self.enable_prefix_cache:
            raise ValueError(
                'host_kv_tier_bytes needs enable_prefix_cache: the tier spills '
                'and promotes prefix-cache blocks'
            )
        if self.disk_kv_tier_dir and not self.host_kv_tier_bytes:
            raise ValueError(
                'disk_kv_tier_dir needs host_kv_tier_bytes > 0: spills reach '
                'disk by writing through the host tier, and promotions route '
                'disk -> host -> device'
            )
        if self.peer_kv_endpoints is not None:
            self.peer_kv_endpoints = tuple(self.peer_kv_endpoints)
            if not self.host_kv_tier_bytes:
                raise ValueError(
                    'peer_kv_endpoints needs host_kv_tier_bytes > 0: peer '
                    'fetches land in the host pool and promote host -> device '
                    'as a disk hit does'
                )
        if self.peer_kv_serve_endpoint and not self.host_kv_tier_bytes:
            raise ValueError(
                'peer_kv_serve_endpoint needs host_kv_tier_bytes > 0: the '
                'KVBlockServer answers HAS / GET from the host and disk pools'
            )
        if self.admission_control and self.ttft_slo_s <= 0:
            raise ValueError(
                'admission_control needs ttft_slo_s > 0: shedding refuses '
                'load whose predicted TTFT busts the SLO'
            )


def _weight_bytes(params: dict) -> dict[str, int]:
    """Weight bytes of a tree: ``weight_bytes_quantized`` /
    ``weight_bytes_float`` over every leaf, and the same two over the 4-D
    leaves alone (Mixtral's ``[L, E, in, out]`` expert banks,
    ``expert_bank_bytes_*``; 0 for a dense family)."""
    banks = [leaf for leaf in leaves(params) if len(getattr(leaf, 'shape', ())) == 4]
    q_all, f_all = quantized_nbytes(params)
    q_banks, f_banks = quantized_nbytes(dict(enumerate(banks)))
    return {
        'weight_bytes_quantized': q_all, 'weight_bytes_float': f_all,
        'expert_bank_bytes_quantized': q_banks, 'expert_bank_bytes_float': f_banks,
    }


def check_tp_heads(model_cfg, tp: int) -> None:
    """Raise ``ValueError`` when the heads do not split over ``tp`` ranks
    (the JAX engine's check: KV pages shard over the KV heads)."""
    if model_cfg.num_kv_heads % tp or model_cfg.num_heads % tp:
        raise ValueError(
            f'num_kv_heads={model_cfg.num_kv_heads} not divisible by tensor '
            f'parallel degree {tp}'
        )


class TokenDigest:
    """A running digest of token tensors, kept on the device (no host sync
    per update): ``h = (h * B + sum_i t_i * (i + 1)) mod M`` over each
    flattened result in turn. Two ranks that sampled the same tokens in
    the same order hold the same value."""

    _BASE, _MOD = 1_000_003, 2**31 - 1

    def __init__(self, device) -> None:
        self._h = torch.zeros((), dtype=torch.int64, device=device)
        self.count = 0

    def add(self, tokens: torch.Tensor) -> None:
        flat = tokens.reshape(-1).to(torch.int64)
        weights = torch.arange(1, flat.numel() + 1, device=flat.device, dtype=torch.int64)
        self._h = (self._h * self._BASE + (flat * weights).sum()) % self._MOD
        self.count += 1

    def value(self) -> int:
        return int(self._h.item())


class LLMEngine:
    """Drives a decoder of the Mistral forward (Mistral, Llama, Qwen2,
    Gemma / Gemma-2 through a ``GemmaConfig``, and Mixtral's sparse MoE
    through a ``MixtralConfig``: its layers' router routes the MLP to the
    expert bank) with paged KV + continuous batching.

    ``params`` must already live on ``device`` (``None`` = the GPU; raises
    without one). ``attn_backend`` is resolved once, here
    (``ops.paged_attention.resolve_attn_backend``, kept in
    ``self.attn_backend``): ``'auto'`` attends through
    ``ops.paged_attention.ragged_paged_attention`` (kernel K1) on the GPU,
    and is refused there for a head dim K1 lacks; on the CPU it is the
    plain op; ``'reference'`` pins the plain op on any device. ``qmm_backend`` does the same for the int8 projections
    (``ops.quantized_matmul``; ``None`` = the model config's). With ``config.quantization`` the float leaves of
    ``params`` are quantized here; ``own_params=True`` lets the engine
    drop each source leaf from the caller's dict as its codes appear
    (device memory then peaks at the float weights, not weights plus
    codes).

    ``mesh`` (tensor / expert parallelism; see the module docstring):
    ``params`` are this rank's slices, already quantized when
    ``config.quantization`` is set (quantize before sharding, as the JAX
    generator does: a row-parallel int8 scale spans the whole input
    axis); ``followers`` is rank 0's channel to the other ranks, which
    each call :meth:`follow`. ``num_kv_heads`` must divide over the
    ``model`` axis.
    """

    def __init__(
        self,
        model_cfg: mistral.MistralConfig,  # or a GemmaConfig / MixtralConfig
        params: dict,
        tokenizer,
        config: EngineConfig | None = None,
        device: 'str | torch.device | None' = None,
        attn_backend: str = 'auto',
        qmm_backend: str | None = None,
        own_params: bool = False,
        mesh=None,
        followers=None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = config or EngineConfig()
        self.mesh = mesh
        self._check_mesh(model_cfg, params, mesh)
        # Rank 0 schedules and sends each device program to the other
        # ranks first; every other rank only runs what it is sent.
        self._followers = followers
        self._leader = mesh is None or mesh.rank == 0
        # Start-up phases (observability.startup): the CUDA context here,
        # quantization below, the kernel builds and graph captures at
        # warmup; this engine's scope keeps its repeats apart from another
        # engine's.
        self._compile_watcher = get_compile_watcher()
        self._compile_scope = self._compile_watcher.new_scope()
        record_backend_init(self.device, self._compile_watcher)
        attn_backend = resolve_attn_backend(attn_backend, model_cfg, self.device)
        if params['embed'].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, engine device is "
                f'{self.device}'
            )
        self.tokenizer = tokenizer
        self.attn_backend = attn_backend
        cfg = self.config
        if cfg.quantization:
            # Weight-only quantization (reference: bnb NF4 in the HF
            # generator): codes live on the device; already quantized
            # leaves pass through.
            with self._compile_watcher.phase(
                'quantize', cfg.quantization, scope=self._compile_scope,
            ) as phase:
                params = quantize_pytree(
                    params, mode=cfg.quantization, out_dtype=model_cfg.dtype,
                    delete_source=own_params,
                )
                phase.update(_weight_bytes(params))
        # The quantized-matmul tier, resolved once and pinned into the
        # model config every dispatch reads (which validates it).
        self.qmm_backend = qmm_backend or model_cfg.qmm_backend
        # Bound last: a replace of a bound config would drop its mesh.
        self.model_cfg = bind(
            dataclasses.replace(model_cfg, qmm_backend=self.qmm_backend), mesh,
        )
        self.params = params
        self.weight_bytes_quantized, self.weight_bytes_float = quantized_nbytes(params)
        # The KV storage dtype, resolved once (the JAX resolution): 'auto'
        # stores the model dtype; a full-precision pin of the other dtype
        # is K1's mixed mode.
        kv_name = _KV_POOL_DTYPES.get(cfg.kv_cache_dtype, model_cfg.dtype)
        kv_dtype = torch.int8 if kv_name == 'int8' else mistral.torch_dtype(kv_name)
        self.kv = PagedKVCache(
            num_layers=model_cfg.num_layers,
            num_blocks=cfg.num_blocks,
            block_size=cfg.block_size,
            num_kv_heads=local_heads(self.model_cfg)[1],  # this rank's
            head_dim=model_cfg.head_size,
            dtype=kv_dtype,
            device=self.device,
        )
        # What the pool stores ('auto' is never surfaced).
        self.kv_cache_dtype = str(kv_storage_dtype(self.kv.k)).removeprefix('torch.')
        self.max_blocks_per_seq = self.kv.blocks_needed(cfg.max_model_len)
        self.prefill_buckets = bucket_ladder(
            cfg.max_model_len, cfg.prefill_min_bucket, scheme='pow2'
        )
        # The native scheduler when asked for and buildable, else the
        # Python twin (logged); which one is in self.scheduler_kind.
        self.sched = make_scheduler(
            cfg.num_blocks, cfg.block_size, cfg.max_num_seqs,
            prefer_native=cfg.prefer_native_allocator,
        )
        self.scheduler_kind = self.sched.kind
        self.prefix_cache = PrefixCache(cfg.block_size) if cfg.enable_prefix_cache else None
        # Host (disk, peer) KV tier behind the prefix cache: eviction
        # cascades device -> host -> disk -> drop, tier hits promote back,
        # and a local miss asks the siblings' servers; this engine's own
        # spills are served back with peer_kv_serve_endpoint.
        self.kv_tier = None
        self.peer_kv_endpoint: str | None = None
        self._peer_kv_server = None
        # Under a mesh the tiers are rank 0's (whole blocks); the other
        # ranks only run the spill and promotion programs.
        if cfg.host_kv_tier_bytes and self._leader:
            disk = (
                DiskKVTier(cfg.disk_kv_tier_dir, cfg.disk_kv_tier_bytes)
                if cfg.disk_kv_tier_dir else None
            )
            peer = (
                PeerKVTier(
                    cfg.peer_kv_endpoints, timeout_ms=cfg.peer_kv_timeout_ms,
                    failure_backoff_s=cfg.peer_kv_backoff_s,
                )
                if cfg.peer_kv_endpoints is not None else None
            )
            self.kv_tier = HostKVTier(cfg.host_kv_tier_bytes, disk=disk, peer=peer)
            if cfg.peer_kv_serve_endpoint:
                from distllm_tpu_torch.parallel.fabric import KVBlockServer

                self._peer_kv_server = KVBlockServer(
                    self.kv_tier.contains_local, self.kv_tier.encoded_local,
                    bind=cfg.peer_kv_serve_endpoint,
                ).start()
                self.peer_kv_endpoint = self._peer_kv_server.endpoint
        # Promotion copies in flight on CUDA: each record keeps the pinned
        # staging its side-stream copy reads, and the copy's timing events,
        # until the copy has completed. Nothing on the host waits for them.
        self._promotions: list[dict] = []
        self._promote_stream = None  # the side stream of promotion copies
        # tier_summary's seconds: spills and promotion staging on the host,
        # promotion copies on the device.
        self._tier_times = dict.fromkeys(
            ('spill_s', 'promote_host_s', 'promote_copy_s', 'promote_wait_s'), 0.0
        )
        # This rank's part of the tier programs (tp_report): spill and
        # promotion programs run, the bytes of its own heads each moved,
        # and their host seconds.
        self._rank_tier: Counter[str] = Counter()
        self._requests: dict[int, Request] = {}
        self._next_id = itertools.count()
        self._finished: dict[int, Request] = {}
        # Cumulative counters over the engine's life: forward_passes (model
        # passes over all layers), prefill_dispatches, decode_windows,
        # generated_tokens, preemptions; with the prefix cache
        # prefix_lookup_tokens, prefix_hit_tokens, prefix_cow_copies and
        # prefix_evicted_blocks; with the tiers tier_spills,
        # tier_spilled_blocks, tier_promotions, tier_promoted_blocks,
        # tier_payload_mismatches and tier_promotion_failures; on the GPU
        # decode_graph_captures, decode_graph_replays (one per decode step)
        # and decode_graph_capture_s (the captures' seconds, a float);
        # prefill_chunks (chunked-prefill dispatches); mixed_windows (decode
        # windows with a chunk half, one eager pass each) and
        # mixed_prefill_tokens (chunk tokens ridden, spec windows' too);
        # spec_windows (verify passes), spec_chunk_windows (spec windows
        # with a chunk half), spec_draft_tokens, spec_accepted_tokens,
        # spec_sampled_rows, spec_resampled_tokens, and on the GPU
        # verify_graph_captures / _replays / _capture_s. On the GPU every
        # forward pass is a prefill dispatch, a chunk half, a decode graph
        # replay or a verify graph replay.
        self.stats: Counter[str] = Counter()
        # Weight bytes by kind, the expert banks (4-D leaves) on their own:
        # constant over the engine's life, so they sit in stats beside the
        # counters without entering a run's telemetry delta.
        self.stats.update(_weight_bytes(self.params))
        # Gloo's collectives stage CUDA tensors through the host and cannot
        # be captured: over gloo the windows run eagerly (the caller chose
        # gloo). NCCL's are captured with the step.
        capture = self.model_cfg.tp is None or self.model_cfg.tp.backend != 'gloo'
        self._graph_notes: dict[str, str] = {}
        if self.device.type == 'cuda' and not capture:
            self._graph_notes['decode_graphs_reason'] = 'gloo collectives cannot be captured'
            log_event(
                'tensor parallelism over gloo: decode and verify windows run '
                'eagerly (gloo collectives cannot be captured in a CUDA graph)',
                component='engine',
            )
        runner_args = dict(
            max_num_seqs=cfg.max_num_seqs,
            max_blocks_per_seq=self.max_blocks_per_seq,
            max_table_positions=cfg.max_model_len,
            attn_backend=attn_backend, device=self.device,
            sampling_top_window=cfg.sampling_top_window, stats=self.stats,
            capture=capture,
        )
        self._decode = DecodeGraphRunner(
            self.params, self.model_cfg, self.kv.k, self.kv.v,
            decode_steps=cfg.decode_steps, **runner_args,
        )
        # Whether the windows replay captured graphs (the GPU, unless gloo).
        self.stats['decode_graphs'] = self._decode.capture
        # The verify window's graphs: [max_num_seqs, 1 + draft_k] spans.
        self._verify = (
            VerifyGraphRunner(
                self.params, self.model_cfg, self.kv.k, self.kv.v,
                span=1 + cfg.draft_k, **runner_args,
            )
            if cfg.draft_k else None
        )
        # Requests whose tails ride mixed windows, in FIFO order.
        self._prefilling: list[int] = []
        # Tokens dispatched on the device but not yet fetched, per request:
        # the pipelined loop's lag bookkeeping (always empty under step()).
        self._unacked: dict[int, int] = {}
        # Set by the pipelined loop: lets chunked prefill retire one window
        # in flight between chunks.
        self._drain_hook = None
        # Windows in flight in the running pipelined loop (1 outside it).
        self._live_depth = 1
        # Per-run summary written by generate_ids; the resolved KV storage
        # dtype ('bfloat16', 'float32' or 'int8') from construction on.
        self.telemetry: dict[str, float] = {
            'kv_cache_dtype': self.kv_cache_dtype, 'scheduler': self.scheduler_kind,
            **self._graph_notes,
        }
        # The process flight ring: one record per prefill dispatch, window,
        # finished request, shed, quarantine, recovery and fault.
        self.flight = get_flight_recorder()
        # Resilience: the process fault injector (inert unless armed),
        # per-request consecutive dispatch failures, prefills to re-run
        # after a failed attempt, and the backoff state.
        self._faults = get_fault_injector()
        self._dispatch_failures: dict[int, int] = {}
        self._pending_prefill: list[int] = []
        self._consecutive_failures = 0
        # Admission control (flippable) and its EWMA-measured inputs.
        self.admission_control = cfg.admission_control
        self._ewma: dict[str, float] = {}
        # Attribution (flippable) and the roofline priced from the final
        # parameters (quantized codes and scales included), with per-kind
        # accumulators behind roofline_summary().
        self.attribution = cfg.attribution
        self._roofline: dict[str, dict[str, float]] = {}
        # Measured cost of one dispatch of each priced step shape
        # (observability.op_cost), filled by warmup(): the measured twin of
        # the analytic model, behind the distllm_engine_mfu_measured gauges.
        self._measured_costs: dict[str, _op_cost.OpCost] = {}
        self._cost_model = None
        try:
            self._cost_model = self._make_cost_model()
        except (ValueError, RuntimeError) as exc:
            self.telemetry['roofline_fallback'] = repr(exc)[:300]
        # A digest of every token this rank sampled, in program order (the
        # ranks' digests agree when they hold the same tokens).
        self._digest = TokenDigest(self.device) if mesh is not None else None
        self._programs = 0
        self._kernel_marks: dict[str, dict] = {}
        # Prefill chunks before a tail's last return without a host sync:
        # their tokens and the first one's start are priced with the
        # sampled dispatch that follows, whose fetch waits for them all.
        self._unsynced_prefill: list = []
        for label in _metrics.KV_CACHE_DTYPE_LABELS:
            _metrics.KV_CACHE_DTYPE_INFO.labels(dtype=label).set(
                1.0 if label == self.kv_cache_dtype else 0.0
            )
        if self.kv_cache_dtype not in _metrics.KV_CACHE_DTYPE_LABELS:
            _metrics.KV_CACHE_DTYPE_INFO.labels(dtype='other').set(1.0)
        _metrics.KV_BLOCKS_TOTAL.set(cfg.num_blocks - 1)
        _metrics.KV_HBM_BYTES.set(self.kv.hbm_bytes)
        self._publish_sched()
        # An engine-owned metric-history sampler, only when asked for.
        self._history_sampler = None
        if cfg.history_interval_s > 0:
            from distllm_tpu_torch.observability.history import (
                HistorySampler,
                get_metrics_history,
            )

            self._history_sampler = HistorySampler(
                get_metrics_history(), interval_s=cfg.history_interval_s
            )
            self._history_sampler.start()

    def _check_mesh(self, model_cfg, params: dict, mesh) -> None:
        """Refuse what this rank's engine cannot serve on ``mesh``: a
        ``data`` or ``seq`` axis (ROADMAP A10c), heads that do not divide
        over ``model`` (the JAX check), and float leaves still to be
        quantized (quantize before sharding)."""
        if mesh is None:
            return
        if mesh.shape[DATA_AXIS] != 1 or mesh.shape[SEQ_AXIS] != 1:
            raise NotImplementedError(
                'an engine mesh with a data or seq axis is not ported yet '
                '(ROADMAP A10c); data-parallel replicas run as separate '
                'engines behind python -m distllm_tpu_torch.router; use '
                'MeshSpec(data=1, model=N)'
            )
        check_tp_heads(model_cfg, mesh.shape[MODEL_AXIS])
        if self.config.quantization:
            from distllm_tpu_torch.models import decoder_family
            from distllm_tpu_torch.ops.quantization import should_quantize
            from distllm_tpu_torch.parallel.sharding import spec_at, spec_parts

            specs = decoder_family(model_cfg.name)[1].param_specs(model_cfg, params)

            def walk(node, path):
                if isinstance(node, dict):
                    for key, value in node.items():
                        walk(value, path + (key,))
                    return
                # The whole leaf's size decides, as quantize_pytree decides
                # it before sharding.
                parts = spec_parts(spec_at(specs, path), mesh)
                if should_quantize(path, node, -(-4096 // parts)):
                    raise ValueError(
                        f"{'/'.join(path)} is a float leaf under quantization="
                        f'{self.config.quantization!r}: quantize before sharding '
                        '(quantize_pytree, then shard_pytree), as the JAX '
                        'generator does'
                    )

            walk(params, ())

    def _make_cost_model(self) -> CostModel:
        """The roofline of this engine's weights. Under a mesh the whole
        tree's elements and bytes (each rank's slices times their parts,
        replicated leaves once) over the peaks of the mesh's distinct
        devices (two ranks on one card are one device), as the JAX engine
        prices global leaves over ``mesh.size`` chips."""
        if self.mesh is None:
            return CostModel.from_params(
                self.params, self.config.decode_steps, device=self.device,
            )
        from distllm_tpu_torch.models import decoder_family
        from distllm_tpu_torch.parallel.sharding import global_numel

        specs = decoder_family(self.model_cfg.name)[1].param_specs(
            self.model_cfg, self.params,
        )
        n_params, weight_bytes = global_numel(self.params, specs, self.mesh)
        peak_flops, peak_bw = device_peaks(self.device)
        scale = self.mesh.num_devices
        return CostModel(n_params, weight_bytes, self.config.decode_steps,
                         peak_flops * scale, peak_bw * scale)

    # ------------------------------------------------------ device programs
    def _program(self, op: str, *args, each=None):
        """Run device program ``op`` (``_op_<op>``) on this rank, after
        sending it with its host inputs to the follower ranks, which run
        it in :meth:`follow`: every rank runs the same programs in the
        same order, and their collectives meet. ``each``, where given, is
        a function of a rank giving that rank's own last argument (its
        slice of a host input), sent to each rank alone. Everything that
        can fail on rank 0 alone (the fault sites, scheduling) runs before
        a program is sent; a program that fails on some ranks and not on
        the others leaves their collectives to the process group's
        timeout."""
        if self._followers is not None:
            if each is None:
                self._followers.send((op, args))
            else:
                self._followers.send_each([
                    (op, args + (each(rank),)) for rank in range(1, self.mesh.size)
                ])
        self._programs += 1
        if each is not None:
            args = args + (each(0),)
        return getattr(self, f'_op_{op}')(*args)

    def follow(self, conn) -> dict:
        """A follower rank's loop: run each program rank 0 sends until it
        sends ``stop``; returns :meth:`tp_report`."""
        while True:
            op, args = conn.recv()
            if op == 'stop':
                return self.tp_report()
            self._programs += 1
            getattr(self, f'_op_{op}')(*args)

    def tp_report(self) -> dict:
        """This rank's programs run, the digest of every token it sampled
        (``None`` without a mesh: equal on every rank of a mesh that
        served the same tokens), its weight bytes, and its kernel counters
        at each :meth:`mark_kernels`."""
        return {
            'rank': 0 if self.mesh is None else self.mesh.rank,
            'programs': self._programs,
            'results': None if self._digest is None else self._digest.count,
            'digest': None if self._digest is None else self._digest.value(),
            'weight_bytes': self.weight_bytes_quantized + self.weight_bytes_float,
            'kernel_marks': self._kernel_marks,
            'tier': self._rank_tier_report(),
        }

    def _rank_tier_report(self) -> dict:
        """This rank's part of the tier programs: spills and promotions
        run, the bytes of its own KV heads each moved, the spills' host
        seconds (the gather, the exchange and, on rank 0, the fetch) and
        the promotion copies' device seconds; on rank 0 also the host
        tier's blocks and bytes (every head)."""
        self._retire_promotions()
        out = dict(self._rank_tier, promote_copy_s=self._tier_times['promote_copy_s'])
        if self.kv_tier is not None:
            out.update(host_blocks=self.kv_tier.num_blocks, host_bytes=self.kv_tier.bytes_used)
        return out

    def mark_kernels(self, tag: str) -> None:
        """Every rank records its process's kernel counters
        (``decode_graph.COUNTERS``) under ``tag``, in program order: the
        difference of two marks is what a rank launched between them
        (reported by :meth:`tp_report`)."""
        self._program('mark', tag)

    def _digest_add(self, tokens: torch.Tensor) -> None:
        if self._digest is not None:
            self._digest.add(tokens)

    def _op_prefill(self, host, sampling, defer_slots, price: bool):
        """The prefill dispatch: the padded span arrays ``host`` through
        ``mistral.prefill_paged``; with ``sampling`` (from
        :meth:`_sampling_host`) each row's token sampled on the device and,
        with ``defer_slots``, scattered into the decode carry there.
        ``price`` counts the pass (``_op_cost.count``) into
        ``measured_costs()['prefill']``. Returns ``(tokens or None, t_put)``."""
        ids, positions, block_rows, context_lens, tail_lens = self._put(*host)
        t_put = time.monotonic()
        prefill = functools.partial(
            mistral.prefill_paged, self.params, self.model_cfg, ids, positions,
            self.kv.k, self.kv.v, block_rows, context_lens, tail_lens,
            max_table_positions=self.config.max_model_len,
            attn_backend=self.attn_backend,
        )
        with self._annotate('prefill'):
            if not price:
                last_logits, _, _ = prefill()
            else:
                # The first prefill dispatch prices its shape (the measured
                # cost of a prefill, in measured_costs()): the same pass,
                # counted by the op-cost dispatch mode.
                cost, (last_logits, _, _) = _op_cost.count(prefill)
                self._measured_costs['prefill'] = cost
                _metrics.ENGINE_KV_DISPATCH_BYTES.labels(kind='prefill').set(
                    cost.bytes_accessed
                )
        if sampling is None:
            return None, t_put
        tokens = self._sample_on_device(last_logits, sampling)
        self._digest_add(tokens)
        if defer_slots is not None:
            self._decode.scatter_ids(
                torch.as_tensor(defer_slots, device=self.device), tokens,
            )
        return tokens, t_put

    def _op_chunk(self, arrays, all_greedy: bool) -> torch.Tensor:
        """A window's chunk half: one ``prefill_chunk_rows`` pass."""
        tokens = mistral.prefill_chunk_rows(
            self.params, self.model_cfg, self.kv.k, self.kv.v,
            tuple(self._put(*arrays)),
            max_table_positions=self.config.max_model_len,
            attn_backend=self.attn_backend,
            sampling_top_window=self.config.sampling_top_window,
            all_greedy=all_greedy,
        )
        self._digest_add(tokens)
        return tokens

    def _op_decode_load(self, inputs: dict) -> None:
        self._decode.load(**inputs)

    def _op_decode_run(self, num_steps: int, all_greedy: bool) -> torch.Tensor:
        tokens = self._decode.run(num_steps, all_greedy)
        self._digest_add(tokens)
        return tokens

    def _op_verify_load(self, arrays) -> None:
        self._verify.load(*arrays)

    def _op_verify_run(self, all_greedy: bool) -> torch.Tensor:
        packed = self._verify.run(all_greedy)
        self._digest_add(packed)
        return packed

    def _op_cow(self, srcs: list[int], dsts: list[int]) -> None:
        src = torch.as_tensor(srcs, device=self.device)
        dst = torch.as_tensor(dsts, device=self.device)
        for plane in self._pool_planes():
            plane.index_copy_(1, dst, plane.index_select(1, src))

    def _op_mark(self, tag: str) -> None:
        from distllm_tpu_torch.generate.engine.decode_graph import COUNTERS, read_counters

        self._kernel_marks[tag] = {
            f'{fn.__name__}.{name}': value
            for (fn, name), value in zip(COUNTERS, read_counters())
        }

    def _op_warmup(self) -> None:
        self._decode.warmup()
        if self._verify is not None:
            self._verify.warmup()
        self._price_step_shapes()

    # ------------------------------------------------------------- requests
    def add_request(
        self, prompt_ids: list[int], params: SamplingParams | None = None
    ) -> int:
        if not prompt_ids:
            raise ValueError('empty prompt')
        # Reserve room for at least one generated token.
        prompt_ids = list(prompt_ids)[-(self.config.max_model_len - 1):]
        needed = self.kv.blocks_needed(len(prompt_ids) + 1)
        if needed > self.kv.num_blocks - 1:  # block 0 is reserved
            raise ValueError(
                f'prompt needs {needed} KV blocks but the pool only has '
                f'{self.kv.num_blocks - 1}; increase num_blocks'
            )
        if self.admission_control:
            # May raise EngineOverloaded before any engine state is
            # touched: a shed request owns nothing.
            self._maybe_shed(len(prompt_ids))
        request = Request(
            request_id=next(self._next_id),
            prompt_ids=prompt_ids,
            params=params or SamplingParams(),
            t_enqueue=time.monotonic(),
            # Bound by the server's request_scope (X-Request-Id); None
            # for offline callers.
            trace_id=current_request_id(),
        )
        request.sample_seed = _request_seed(
            self.config.seed, request.request_id, request.params.seed
        )
        if self.config.draft_k and self.config.spec_draft_source == 'prompt_lookup':
            # Greedy and sampled rows draft alike; verify_spans applies
            # each row's rule.
            request.drafter = PromptLookupDrafter(self.config.spec_ngram)
        cached_blocks = self._acquire_prefix(request) if self.prefix_cache else []
        self._requests[request.request_id] = request
        self.sched.add(request.request_id, request.num_tokens, cached_blocks)
        _metrics.ENGINE_REQUESTS_ADDED.inc()
        _metrics.ENGINE_PROMPT_TOKENS.inc(len(prompt_ids))
        self._publish_sched()
        return request.request_id

    def _acquire_prefix(self, request: Request) -> list[int]:
        """Match the prompt's blocks in the prefix cache (and past the match
        in the tiers); returns the blocks the request borrows."""
        bs = self.config.block_size
        prompt_len = len(request.prompt_ids)
        request.digests = block_digests(request.prompt_ids, bs)
        matched = self.prefix_cache.acquire(request.request_id, request.digests)
        if matched and len(matched) * bs == prompt_len:
            # Aligned full cover: the last token must still be prefilled
            # (its logits), and its K/V write would land inside the shared
            # final block. Keep the match, re-prefill the last token, and
            # copy that block first (copy-on-write at dispatch).
            request.cow_src_block = matched[-1]
            cached_blocks = matched[:-1]
            request.num_cached_tokens = prompt_len - 1
        else:
            cached_blocks = matched
            request.num_cached_tokens = len(matched) * bs
        request.num_borrowed_blocks = len(cached_blocks)
        if matched:
            _metrics.PREFIX_TIER_HITS.labels(tier='hbm').inc(len(matched))
        if self.kv_tier is not None and request.cow_src_block is None:
            # Digests past the device match that the host or disk tier
            # holds, up to the first one neither holds; at least one prompt
            # token stays uncached (the prefill's logits).
            promo: list[bytes] = []
            for digest in request.digests[len(cached_blocks):]:
                if self.kv_tier.lookup(digest) is None:
                    break
                promo.append(digest)
            while promo and (len(cached_blocks) + len(promo)) * bs >= prompt_len:
                promo.pop()
            request.promo_digests = promo
        elif self.kv_tier is None and len(matched) < len(request.digests):
            _metrics.PREFIX_TIER_MISSES.labels(tier='hbm').inc()
        _metrics.PREFIX_LOOKUP_TOKENS.inc(prompt_len)
        if request.num_cached_tokens:
            _metrics.PREFIX_HIT_TOKENS.inc(request.num_cached_tokens)
        self.stats['prefix_hit_tokens'] += request.num_cached_tokens
        self.stats['prefix_lookup_tokens'] += prompt_len
        return cached_blocks

    # ------------------------------------------- SLO-aware admission control
    def _ewma_update(self, key: str, value: float, alpha: float = 0.25) -> None:
        prev = self._ewma.get(key)
        self._ewma[key] = value if prev is None else prev + alpha * (value - prev)

    def _load_view(self) -> EngineLoadView:
        """Engine load for the TTFT predictor (``resilience.admission``):
        the scheduler backlog plus the EWMA-measured per-token prefill time
        and window cadence, with the roofline floors before the first
        windows land."""
        cfg = self.config
        waiting_tokens = 0
        pending_decode = 0
        for r in self._requests.values():
            if r.state is RequestState.WAITING:
                waiting_tokens += r.num_tokens
                pending_decode += r.params.max_tokens
            elif r.state is RequestState.RUNNING:
                pending_decode += max(0, r.params.max_tokens - len(r.output_ids))
        per_tok = self._ewma.get('prefill_s_per_token')
        window_s = self._ewma.get('window_s')
        if (per_tok is None or window_s is None) and self._cost_model is not None:
            cm = self._cost_model
            if per_tok is None:
                per_tok = 2.0 * cm.n_params / cm.peak_flops
            if window_s is None:
                window_s = cm.weight_bytes * cm.decode_steps / cm.peak_hbm_bytes
        return EngineLoadView(
            waiting_tokens=waiting_tokens,
            pending_decode_tokens=pending_decode,
            num_waiting=self.sched.num_waiting,
            num_running=self.sched.num_running,
            max_num_seqs=cfg.max_num_seqs,
            decode_steps=cfg.decode_steps,
            prefill_s_per_token=per_tok or 0.0,
            window_s=window_s or 0.0,
            slo_s=cfg.ttft_slo_s,
        )

    def _maybe_shed(self, prompt_tokens: int) -> None:
        """Refuse at enqueue when the predicted TTFT busts the SLO
        (honest backpressure, surfaced by the server as 429)."""
        admit, predicted, retry_after = shed_decision(self._load_view(), prompt_tokens)
        _metrics.RESILIENCE_PREDICTED_TTFT.observe(predicted)
        if admit:
            return
        _metrics.RESILIENCE_SHED.labels(reason='overload').inc()
        self.stats['shed_requests'] += 1
        self.flight.record(
            'shed',
            reason='overload',
            predicted_ttft_s=round(predicted, 6),
            retry_after_s=round(retry_after, 3),
            prompt_tokens=prompt_tokens,
            queue_depth=self.sched.num_waiting,
        )
        raise EngineOverloaded(predicted, retry_after, self.config.ttft_slo_s)

    def _publish_sched(self) -> None:
        """The scheduler gauges: queue depth, running slots and KV block
        occupancy (process-wide; with several engines the last wins)."""
        usable = self.config.num_blocks - 1
        in_use = usable - self.sched.num_free_blocks
        _metrics.KV_BLOCKS_IN_USE.set(in_use)
        _metrics.KV_OCCUPANCY.set(in_use / usable if usable else 0.0)
        _metrics.SCHED_QUEUE_DEPTH.set(self.sched.num_waiting)
        _metrics.SCHED_RUNNING.set(self.sched.num_running)
        if self.prefix_cache is not None:
            _metrics.PREFIX_CACHED_BLOCKS.set(self.prefix_cache.num_cached)
            _metrics.PREFIX_EVICTABLE_BLOCKS.set(self.prefix_cache.num_evictable)
            _metrics.PREFIX_SHARED_BLOCKS.set(self.prefix_cache.num_shared)
        if self.kv_tier is not None:
            _metrics.PREFIX_TIER_BYTES.labels(tier='host').set(self.kv_tier.bytes_used)
            if self.kv_tier.disk is not None:
                _metrics.PREFIX_TIER_BYTES.labels(tier='disk').set(self.kv_tier.disk.bytes_used)

    @property
    def has_unfinished(self) -> bool:
        return self.sched.has_unfinished

    # ------------------------------------------------------------ admission
    def _admit(self, defer_to=None) -> list[tuple[int, int]]:
        """Admit waiting requests while the scheduler allows (evicting
        unreferenced cache blocks when blocks run short) and prefill their
        tails, same-bucket tails batched; returns the first tokens as
        ``(request_id, token)`` (none with ``defer_to``, the pipelined
        loop's deque of windows in flight: the first tokens stay on the
        device and their fetch records join it). A request with tier hits
        first promotes them (a copy the device orders before its tail
        prefill). Under mixed batching, once windows flow, tails on the
        paged route (a cached prefix, or a tail to chunk) ride the windows
        instead. A prefill may finish its request at once (stop token /
        max_tokens=1), freeing a slot, so admission repeats until the
        scheduler yields nothing."""
        self._retire_promotions()
        # Recovery: prefills whose earlier dispatch failed run first; their
        # requests hold slots and blocks and take no decode steps until
        # this succeeds.
        emitted: list[tuple[int, int]] = self._retry_pending_prefills(defer_to)
        chunk = self.config.prefill_chunk_tokens
        while True:
            admitted: list[Request] = []
            while (rid := self._admit_next_evicting()) is not None:
                request = self._requests[rid]
                request.state = RequestState.RUNNING
                _metrics.SCHED_ADMITTED.inc()
                if request.t_admit == 0.0:  # the first admission only
                    request.t_admit = time.monotonic()
                    _metrics.REQUEST_QUEUE_WAIT.observe(
                        request.t_admit - request.t_enqueue
                    )
                admitted.append(request)
            if not admitted:
                return emitted
            # Decided once per admitted batch: at a cold start nothing
            # decodes, so the first batch prefills standalone and starts
            # the windows the rest ride.
            ride = self.config.enable_mixed_batching and self._mixed_can_ride()
            standalone: list[Request] = []
            try:
                for request in admitted:
                    if request.promo_digests:
                        self._promote(request)
                    tail = request.num_tokens - request.num_cached_tokens
                    if ride and (request.num_cached_tokens or (chunk and tail > chunk)):
                        self._enroll_mixed(request)
                    else:
                        standalone.append(request)
            except Exception:
                # Nothing of this batch prefilled yet: gate all of it.
                self._mark_prefill_retry(
                    [r for r in admitted if r.request_id not in self._prefilling]
                )
                raise
            emitted.extend(self._run_prefill_paged(standalone, defer_to))

    def _run_prefill_paged(self, requests: list[Request], defer_to=None) -> list[tuple[int, int]]:
        """Prefill each request's tail — the tokens past its cached prefix,
        generated tokens included after a recompute preemption — in
        padded dispatches of one length bucket, after the copy-on-write of
        aligned full-cover hits; tails longer than ``prefill_chunk_tokens``
        prefill in chunks. ``defer_to``: see :meth:`_admit`."""
        if not requests:
            return []
        self._resolve_cow([r for r in requests if r.cow_src_block is not None])
        chunk = self.config.prefill_chunk_tokens
        groups: dict[int, list[Request]] = {}
        chunked: list[Request] = []
        for request in requests:
            tail = request.num_tokens - request.num_cached_tokens
            if chunk and tail > chunk:
                chunked.append(request)
            else:
                groups.setdefault(pick_bucket(tail, self.prefill_buckets), []).append(request)
        emitted: list[tuple[int, int]] = []
        # The recovery contract: when a dispatch fails, every request whose
        # prefill has not landed yet is gated out of decode and queued for
        # a re-dispatch before the error propagates.
        pending = {r.request_id: r for r in requests}
        try:
            for bucket, group in sorted(groups.items()):
                cap = self._prefill_batch_cap(bucket)
                for i in range(0, len(group), cap):
                    spans = [
                        (r, r.num_cached_tokens, r.num_tokens - r.num_cached_tokens)
                        for r in group[i:i + cap]
                    ]
                    emitted.extend(self._dispatch_prefill_paged(spans, defer_to=defer_to))
                    for request, _, _ in spans:
                        pending.pop(request.request_id)
            for request in chunked:
                emitted.extend(self._run_prefill_chunked(request, defer_to))
                pending.pop(request.request_id)
        except Exception:
            self._mark_prefill_retry(
                [r for r in pending.values() if r.state is RequestState.RUNNING]
            )
            raise
        return emitted

    def _mark_prefill_retry(self, requests: list[Request]) -> None:
        """A prefill dispatch for ``requests`` failed: gate each out of
        decode (decode must never read KV the prefill never wrote) and
        queue it for a re-dispatch (:meth:`_retry_pending_prefills`).
        Progress falls back to the cached prefix; rewriting positions
        already written is idempotent, so the retry is exact."""
        for request in requests:
            request.prefill_target = request.num_tokens
            request.prefill_sent = request.num_cached_tokens
            request.prefill_done = request.num_cached_tokens
            if request.request_id not in self._pending_prefill:
                self._pending_prefill.append(request.request_id)

    def _retry_pending_prefills(self, defer_to=None) -> list[tuple[int, int]]:
        """Re-dispatch the prefills whose earlier attempt failed, tail
        only over whatever KV is already valid."""
        if not self._pending_prefill:
            return []
        rids, self._pending_prefill = self._pending_prefill, []
        requests: list[Request] = []
        for rid in rids:
            request = self._requests.get(rid)
            if request is None or request.state is not RequestState.RUNNING:
                continue  # quarantined, preempted or finished meanwhile
            request.prefill_target = 0
            request.prefill_sent = request.num_cached_tokens
            request.prefill_done = request.num_cached_tokens
            requests.append(request)
        return self._run_prefill_paged(requests, defer_to)

    def _run_prefill_chunked(self, request: Request, defer_to=None) -> list[tuple[int, int]]:
        """Prefill one long tail as sequential chunks of at most
        ``prefill_chunk_tokens``. Each chunk attends over the KV already in
        the pool (the cached prefix and the earlier chunks), so splitting
        is exact; only the last chunk samples. Between chunks the pipelined
        loop may retire one window in flight (``_drain_hook``), so a long
        prompt does not stall decode for its whole prefill."""
        chunk = self.config.prefill_chunk_tokens
        start, total = request.num_cached_tokens, request.num_tokens
        emitted: list[tuple[int, int]] = []
        while start < total:
            ntok = min(chunk, total - start)
            final = start + ntok >= total
            self.stats['prefill_chunks'] += 1
            _metrics.ENGINE_PREFILL_CHUNKS.inc()
            _metrics.ENGINE_PREFILL_CHUNK_TOKENS.observe(ntok)
            emitted.extend(self._dispatch_prefill_paged(
                [(request, start, ntok)], sample=final, defer_to=defer_to,
            ))
            start += ntok
            if not final and self._drain_hook is not None:
                self._drain_hook()
        return emitted

    def _admit_next_evicting(self) -> int | None:
        """``admit_next`` under prefix-cache pressure: when admission
        stalls on blocks while unreferenced cache blocks exist, evict just
        enough (LRU) and retry."""
        while True:
            try:
                rid = self.sched.admit_next()
            except SchedulerExhausted:
                if not self._evict_for_admission():
                    raise
                continue
            if rid is not None:
                return rid
            if not self._evict_for_admission():
                if self.sched.num_waiting:
                    _metrics.SCHED_DEFERRED.inc()
                return None

    def _evict_for_admission(self) -> bool:
        if (
            self.prefix_cache is None
            or not self.prefix_cache.num_evictable
            or not self.sched.num_waiting
            # With every slot busy eviction admits nothing: it would only
            # flush warm prefixes.
            or self.sched.num_running >= self.config.max_num_seqs
        ):
            return False
        # The worst shortfall over waiting requests: a few blocks too many
        # cost cache entries, never correctness.
        need = 0
        for request in self._requests.values():
            if request.state is RequestState.WAITING:
                short = self.kv.blocks_needed(request.num_tokens + 1) - len(
                    self.sched.block_row(request.request_id)
                )
                need = max(need, short)
        return self._evict_cached_blocks(need - self.sched.num_free_blocks) > 0

    def _evict_cached_blocks(self, shortfall: int) -> int:
        """Evict up to ``shortfall`` LRU cache blocks into the scheduler's
        free list, spilling their KV to the host tier first when there is
        one; returns how many were freed."""
        if self.prefix_cache is None or shortfall <= 0:
            return 0
        entries = self.prefix_cache.evict_entries(shortfall)
        if not entries:
            return 0
        if self.kv_tier is not None:
            self._spill_blocks(entries)
        freed = [bid for _, bid in entries]
        self.sched.release_blocks(freed)
        self.stats['prefix_evicted_blocks'] += len(freed)
        _metrics.PREFIX_EVICTIONS.inc(len(freed))
        _metrics.PREFIX_TIER_EVICTIONS.labels(tier='hbm').inc(len(freed))
        if self.kv_tier is None:
            _metrics.PREFIX_TIER_DROPPED_BLOCKS.inc(len(freed))
        return len(freed)

    # ------------------------------------------------- host and disk tiers
    def _pool_planes(self) -> list[torch.Tensor]:
        """The pool's tensors, each with the block axis at dim 1: K and V
        data, and an int8 pool's K and V scales."""
        if self.kv.quantized:
            return [self.kv.k.data, self.kv.v.data, self.kv.k.scale, self.kv.v.scale]
        return [self.kv.k, self.kv.v]

    @staticmethod
    def _head_axis(plane: torch.Tensor) -> int:
        """The KV-head axis of a pool plane (block axis at dim 1): data
        ``[L, blocks, block_size, N_kv, Hd]``, int8 scales ``[L, blocks,
        N_kv]``."""
        return 3 if plane.dim() == 5 else 2

    def _block_shapes(self) -> list[torch.Size]:
        """One block of each pool plane with every KV head: what the tiers
        hold and a promotion checks, at any ``tensor_parallel_size``."""
        shapes = []
        for plane in self._pool_planes():
            shape = list(plane.shape[:1] + plane.shape[2:])
            shape[self._head_axis(plane) - 1] = self.model_cfg.num_kv_heads
            shapes.append(torch.Size(shape))
        return shapes

    def _rank_slices(self, whole: list[torch.Tensor], rank: int) -> list[torch.Tensor]:
        """Rank ``rank``'s KV heads of staged whole blocks (each tensor
        with the block axis at dim 1), contiguous; the tensors themselves
        without a mesh. The ``model`` coordinate is the rank (``data=1``)."""
        if self.model_cfg.tp is None:
            return whole
        n = local_heads(self.model_cfg)[1]
        return [
            t.narrow(self._head_axis(t), rank * n, n).contiguous() for t in whole
        ]

    def _op_spill(self, block_ids: list[int]):
        """A spill's device half on every rank: one gather of the evicted
        blocks per pool plane; under a mesh the ranks' heads assembled in
        head order over the ``model`` group (``gather_heads``), whole on
        every rank. Rank 0 fetches them to the host and returns them (the
        other ranks return None)."""
        t0 = time.perf_counter()
        idx = torch.as_tensor(block_ids, device=self.device)
        planes = [plane.index_select(1, idx) for plane in self._pool_planes()]
        self._rank_tier['spills'] += 1
        self._rank_tier['spilled_bytes'] += sum(p.numel() * p.element_size() for p in planes)
        tp = self.model_cfg.tp
        if tp is not None:
            planes = [tp.gather_heads(p, self._head_axis(p)) for p in planes]
        host = [p.cpu() for p in planes] if self._leader else None
        self._rank_tier['spill_s'] += time.perf_counter() - t0
        return host

    def _spill_blocks(self, entries: list[tuple[bytes, int]]) -> None:
        """Copy the evicted blocks' KV device -> host (the ``spill``
        program: one gather per plane, no padding, PyTorch compiles no
        shape; under a mesh every head assembled on rank 0) and one host
        fetch, then adopt each block into the host tier as its own CPU
        tensors (LRU frees blocks one at a time, which views of the
        gathered tensor could not). Sent before the blocks are released,
        so every rank gathers them before any later program reuses them.
        An int8 pool spills its codes and scale rows as they are:
        promotion is bit-exact, no requantization."""
        t0 = time.perf_counter()
        host = self._program('spill', [bid for _, bid in entries])
        for i, (digest, _) in enumerate(entries):
            self.kv_tier.put(digest, *(plane[:, i].clone() for plane in host))
        self.stats['tier_spills'] += 1
        self.stats['tier_spilled_blocks'] += len(entries)
        _metrics.PREFIX_TIER_SPILLS.labels(tier='host').inc(len(entries))
        self.stats['tier_spilled_bytes'] += sum(p.numel() * p.element_size() for p in host)
        self._tier_times['spill_s'] += time.perf_counter() - t0

    def _promote(self, request: Request) -> None:
        """Copy ``request``'s tier blocks into its own pool blocks (the ones
        after its borrowed prefix) and adopt them into the prefix cache at
        once, so they are borrowed: never freed, kept across preemption.
        On CUDA the copy runs on a side stream from pinned staging, after
        the work already queued (which may still read those blocks: an
        eviction's spill), and the current stream waits on its event, so
        every later read of those blocks — this request's tail prefill, a
        later request that borrows them, a decode window — is ordered
        after it on the device while the host goes on. When no tier block
        could be used (evicted since ``add_request``, or a payload of
        another pool's dtype or geometry: a counted mismatch) the request
        prefills as usual."""
        digests, request.promo_digests = request.promo_digests, []
        rid = request.request_id
        planes = self._pool_planes()
        shapes = self._block_shapes()  # every KV head, at any mesh
        pulled: list[tuple[torch.Tensor, ...]] = []
        for digest in digests:
            arrays = self.kv_tier.get(digest)
            if arrays is None:
                break  # evicted from the tier since add_request
            if len(arrays) != len(planes) or any(
                a.dtype != p.dtype or a.shape != shape
                for a, p, shape in zip(arrays, planes, shapes)
            ):
                # A spill of another kv_cache_dtype or geometry: a miss,
                # never another encoding's bytes in the pool.
                self.stats['tier_payload_mismatches'] += 1
                break
            pulled.append(arrays)
        if not pulled:
            return
        t0 = time.perf_counter()
        n = len(pulled)
        nb = request.num_borrowed_blocks
        blocks = self.sched.block_row(rid)[nb:nb + n]
        cuda = self.device.type == 'cuda'
        try:
            whole = [
                torch.stack([arrays[j] for arrays in pulled], dim=1)
                for j in range(len(planes))
            ]
            # Rank 0's heads (all of them without a mesh), pinned here so
            # a host that cannot stage fails before anything is sent.
            staging = self._rank_slices(whole, 0)
            if cuda:
                staging = [t.pin_memory() for t in staging]
        except (MemoryError, torch.OutOfMemoryError):
            # The host could not stage the copy: a counted failure and a
            # cold prefill. A fault of the device copy itself raises.
            self.stats['tier_promotion_failures'] += 1
            return
        self._tier_times['promote_host_s'] += time.perf_counter() - t0
        try:
            # Fault site 'device_put': a failed promotion copy degrades to a
            # counted failure and a cold prefill, never an error in
            # admission. Fired before the copy is queued.
            self._faults.fail('device_put')
        except InjectedFault as exc:
            _metrics.PREFIX_TIER_ERRORS.labels(tier='host').inc()
            self.stats['tier_promotion_failures'] += 1
            self.flight.record(
                'event', event='promotion_failed', rids=[rid], blocks=n,
                error=repr(exc)[:200],
            )
            return
        # Each other rank gets its heads' slice as raw bytes (numpy, as
        # every program's host inputs travel).
        self._program('promote', list(blocks), each=lambda r: staging if r == 0 else [
            t.view(torch.uint8).numpy() for t in self._rank_slices(whole, r)
        ])
        # Adopt now: the blocks are cache property from here on. First
        # writer wins; blocks past a rejected digest stay owned.
        lent = nb
        for digest, bid in zip(digests, blocks):
            if not self.prefix_cache.insert(rid, digest, bid):
                break
            lent += 1
        if lent > nb:
            self.sched.lend_prefix(rid, lent)
            request.num_borrowed_blocks = lent
        request.num_cached_tokens = (nb + n) * self.config.block_size
        self.stats['tier_promotions'] += 1
        self.stats['tier_promoted_blocks'] += n
        _metrics.PREFIX_TIER_PROMOTIONS.labels(tier='host').inc(n)
        _metrics.PREFIX_HIT_TOKENS.inc(n * self.config.block_size)
        self.stats['tier_promoted_bytes'] += sum(t.numel() * t.element_size() for t in whole)
        self.stats['prefix_hit_tokens'] += n * self.config.block_size

    def _op_promote(self, blocks: list[int], staging: list) -> None:
        """A promotion's device copy on every rank: this rank's heads of
        the staged blocks (tensors on rank 0, raw bytes elsewhere) into
        pool blocks ``blocks``. On CUDA the copy runs on a side stream
        from pinned staging, after the work already queued (which may
        still read those blocks: an eviction's spill), and the current
        stream waits on its event, so every later program's read of those
        blocks on this rank is ordered after it."""
        self._retire_promotions()
        planes = self._pool_planes()
        staging = [
            src if isinstance(src, torch.Tensor) else torch.from_numpy(src).view(plane.dtype)
            for plane, src in zip(planes, staging)
        ]
        cuda = self.device.type == 'cuda'
        if cuda:
            staging = [t if t.is_pinned() else t.pin_memory() for t in staging]
        events = None
        on_side_stream = contextlib.nullcontext()
        if cuda:
            if self._promote_stream is None:
                self._promote_stream = torch.cuda.Stream(self.device)
            current = torch.cuda.current_stream(self.device)
            self._promote_stream.wait_stream(current)
            on_side_stream = torch.cuda.stream(self._promote_stream)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record(self._promote_stream)
        with on_side_stream:
            idx = torch.as_tensor(blocks, device=self.device)
            for plane, src in zip(planes, staging):
                plane.index_copy_(1, idx, src.to(self.device, non_blocking=True))
        if cuda:
            events[1].record(self._promote_stream)
            current.wait_event(events[1])
            self._promotions.append({'events': events, 'staging': staging})
        self._rank_tier['promotions'] += 1
        self._rank_tier['promoted_bytes'] += sum(t.numel() * t.element_size() for t in staging)

    def _retire_promotions(self, wait: bool = False) -> None:
        """Drop the records of the promotion copies that have completed
        (all of them, once the host has waited, with ``wait``), with the
        staging each copy read, and add up the copies' device time."""
        live = []
        for record in self._promotions:
            start, end = record['events']
            if wait:
                t0 = time.perf_counter()
                end.synchronize()
                self._tier_times['promote_wait_s'] += time.perf_counter() - t0
            elif not end.query():
                live.append(record)
                continue
            self._tier_times['promote_copy_s'] += start.elapsed_time(end) / 1e3
        self._promotions = live

    def tier_summary(self) -> dict:
        """Host and disk tier counters (empty without the tier): spills and
        promotions with their blocks and bytes, the host seconds of the
        spills and of the promotions' staging, and the device seconds of
        the promotion copies that have completed (0 on the CPU)."""
        if self.kv_tier is None:
            return {}
        self._retire_promotions()
        out = {
            'spills': int(self.stats['tier_spills']),
            'spilled_blocks': int(self.stats['tier_spilled_blocks']),
            'spilled_bytes': int(self.stats['tier_spilled_bytes']),
            'spill_s': self._tier_times['spill_s'],
            'promotions': int(self.stats['tier_promotions']),
            'promoted_blocks': int(self.stats['tier_promoted_blocks']),
            'promoted_bytes': int(self.stats['tier_promoted_bytes']),
            'promote_host_s': self._tier_times['promote_host_s'],
            'promote_copy_s': self._tier_times['promote_copy_s'],
            # The JAX overlap, 1 - blocking wait / promotion span: the host
            # waits on a promotion copy only at shutdown, the span is the
            # copies' device time.
            'promote_wait_s': self._tier_times['promote_wait_s'],
            'promote_span_s': self._tier_times['promote_copy_s'],
            'promotion_overlap': (
                round(max(0.0, 1.0 - self._tier_times['promote_wait_s']
                          / self._tier_times['promote_copy_s']), 4)
                if self._tier_times['promote_copy_s'] > 0 else None
            ),
            'payload_mismatches': int(self.stats['tier_payload_mismatches']),
            'promotion_failures': int(self.stats['tier_promotion_failures']),
            'host_blocks': self.kv_tier.num_blocks,
            'host_bytes': self.kv_tier.bytes_used,
        }
        if self.kv_tier.disk is not None:
            out['disk_blocks'] = self.kv_tier.disk.num_blocks
            out['disk_bytes'] = self.kv_tier.disk.bytes_used
            out['disk_errors'] = self.kv_tier.disk.errors
        if self.kv_tier.peer is not None:
            out['peer_fetched_blocks'] = self.kv_tier.peer.fetched_blocks
            out['peer_fetched_bytes'] = self.kv_tier.peer.fetched_bytes
        if self._peer_kv_server is not None:
            out['peer_served_blocks'] = self._peer_kv_server.served_blocks
            out['peer_served_bytes'] = self._peer_kv_server.served_bytes
        return out

    # ------------------------------------------------------- prefix cache
    def _resolve_cow(self, requests: list[Request]) -> None:
        """Copy-on-write of aligned full-cover hits: copy each shared final
        block, every layer, into the request's first owned block, in place
        (one gather and one ``index_copy_`` per pool plane, scale rows
        with codes), so the last token's K/V write touches no block other
        requests read."""
        if not requests:
            return
        srcs, dsts = [], []
        for request in requests:
            dsts.append(self.sched.block_row(request.request_id)[request.num_borrowed_blocks])
            srcs.append(request.cow_src_block)
            request.cow_src_block = None
        self._program('cow', srcs, dsts)
        self.stats['prefix_cow_copies'] += len(srcs)
        _metrics.PREFIX_COW_COPIES.inc(len(srcs))

    def _insert_prompt_blocks(self, request: Request) -> None:
        """Adopt the request's freshly prefilled full prompt blocks into the
        prefix cache (first writer wins) and mark them borrowed in the
        scheduler, so finish and preemption keep them."""
        if self.prefix_cache is None or not request.digests:
            return
        rid = request.request_id
        row = self.sched.block_row(rid)
        nb = request.num_borrowed_blocks
        lent = nb
        for i in range(nb, len(request.digests)):
            if not self.prefix_cache.insert(rid, request.digests[i], row[i]):
                break
            lent = i + 1
        if lent > nb:
            self.sched.lend_prefix(rid, lent)
            request.num_borrowed_blocks = lent

    # ------------------------------------------------------ mixed windows
    def _mixed_rows(self) -> int:
        """Chunk rows of every chunk half: the pow2 ceiling of
        ``max_window_prefill_seqs``, fixed (the planner under-fills with pad
        rows), as the JAX engine fixes its mixed executable's rows."""
        b = 1
        while b < self.config.max_window_prefill_seqs:
            b *= 2
        return b

    def _mixed_span_cap(self) -> int:
        """Largest chunk span one request may ride a window: the window's
        budget, capped by ``prefill_chunk_tokens`` when set."""
        cap = min(self.config.max_window_prefill_tokens, self.config.max_model_len)
        if self.config.prefill_chunk_tokens:
            cap = min(cap, self.config.prefill_chunk_tokens)
        return max(1, cap)

    @staticmethod
    def _decode_ready(request: Request) -> bool:
        """May this running request take decode steps? Not while its tail
        still rides mixed windows (its last chunk's sample makes it
        ready)."""
        return request.prefill_done >= request.prefill_target

    def _mixed_can_ride(self) -> bool:
        """Whether windows flow for chunks to ride: chunk work is pending,
        or some running request has emitted tokens. At a cold start
        neither holds and admission prefills standalone: a chunk-only
        window would pay a whole pass for a few prefill tokens."""
        if self._prefilling:
            return True
        return any(
            self._requests[rid].output_ids for _, rid in self.sched.running()
        )

    def _enroll_mixed(self, request: Request) -> None:
        """Route this admitted request's tail through mixed windows. The
        copy-on-write resolves here: the source block's contents are final
        already."""
        if request.cow_src_block is not None:
            self._resolve_cow([request])
        request.prefill_target = request.num_tokens
        request.prefill_sent = request.num_cached_tokens
        request.prefill_done = request.num_cached_tokens
        self._prefilling.append(request.request_id)

    def _plan_window_chunks(self) -> list[tuple[Request, int, int]]:
        """Chunk spans riding the next window: FIFO over mid-prefill
        requests, one span each, within the window's token budget, the
        row cap and the span cap. Returns ``[(request, start, ntok)]``
        in absolute tokens; drops finished or preempted entries."""
        if not self.config.enable_mixed_batching or not self._prefilling:
            return []
        budget = self.config.max_window_prefill_tokens
        span_cap = self._mixed_span_cap()
        plan: list[tuple[Request, int, int]] = []
        for rid in list(self._prefilling):
            if budget <= 0 or len(plan) >= self.config.max_window_prefill_seqs:
                break
            request = self._requests.get(rid)
            if request is None or request.state is not RequestState.RUNNING:
                self._prefilling.remove(rid)
                continue
            remaining = request.prefill_target - request.prefill_sent
            if remaining <= 0:
                continue  # its last chunk is already dispatched
            ntok = min(remaining, span_cap, budget)
            plan.append((request, request.prefill_sent, ntok))
            budget -= ntok
        return plan

    def _build_chunk_arrays(self, chunk_plan) -> list[np.ndarray]:
        """Host arrays of a chunk half, in ``mistral.prefill_chunk_rows``'s
        operand order: the span arrays (``_mixed_rows()`` rows, the chunk
        bucket wide) and each row's sampling inputs."""
        rows = self._mixed_rows()
        bucket = pick_bucket(max(n for _, _, n in chunk_plan), self.prefill_buckets)
        arrays = list(self._span_host_arrays(chunk_plan, bucket, rows))
        temperature = np.zeros((rows,), np.float32)
        top_p = np.ones((rows,), np.float32)
        min_p = np.zeros((rows,), np.float32)
        top_k = np.zeros((rows,), np.int32)
        seeds = np.zeros((rows,), np.int64)
        for i, (request, _, _) in enumerate(chunk_plan):
            temperature[i] = request.params.temperature
            top_p[i] = request.params.top_p
            min_p[i] = request.params.min_p
            top_k[i] = request.params.top_k
            seeds[i] = request.sample_seed
        return arrays + [temperature, top_p, min_p, top_k, seeds]

    def _run_chunk_half(self, chunk_plan) -> tuple[torch.Tensor, list[tuple]]:
        """One eager ``prefill_paged`` pass over a window's chunk rows, each
        row's token sampled on the device; records the spans as sent.
        Returns the device tokens and the window's chunk entries
        ``(row, rid, start, ntok, final)``."""
        chunk_tokens = self._program(
            'chunk', self._build_chunk_arrays(chunk_plan),
            all(r.params.temperature <= 0 for r, _, _ in chunk_plan),
        )
        self.stats['forward_passes'] += 1
        entries = []
        for i, (request, start, ntok) in enumerate(chunk_plan):
            request.prefill_sent = start + ntok
            entries.append((i, request.request_id, start, ntok,
                            start + ntok >= request.prefill_target))
        ridden = sum(n for _, _, n in chunk_plan)
        self.stats['mixed_prefill_tokens'] += ridden
        _metrics.MIXED_PREFILL_TOKENS.inc(ridden)
        _metrics.MIXED_PREFILL_TOKENS_PER_WINDOW.observe(ridden)
        _metrics.MIXED_PREFILL_ROWS.observe(len(chunk_plan))
        return chunk_tokens, entries

    def _process_chunk_entries(self, window: dict) -> list[tuple[int, int]]:
        """Fold a fetched window's chunk spans into request state: the
        caller's token fetch ordered the chunk writes before it. A final
        chunk inserts the prompt's blocks into the prefix cache, then emits
        the request's first token."""
        entries = window.get('chunk_plan') or []
        if not entries:
            return []
        chunk_tokens = window['chunk_tokens'].cpu().tolist()
        emitted: list[tuple[int, int]] = []
        for row, rid, start, ntok, final in entries:
            request = self._requests.get(rid)
            if request is None or request.state is not RequestState.RUNNING:
                continue
            request.prefill_done = max(request.prefill_done, start + ntok)
            if final:
                self._insert_prompt_blocks(request)
                if rid in self._prefilling:
                    self._prefilling.remove(rid)
                token = int(chunk_tokens[row])
                self._emit_token(request, token)
                emitted.append((rid, token))
        return emitted

    def _prefill_batch_cap(self, bucket: int) -> int:
        """Prompts of one bucket that prefill together."""
        return max(1, min(
            self.config.max_prefill_batch,
            self.config.max_prefill_tokens // bucket,
            self.config.max_num_seqs,
        ))

    def _block_row(self, rid: int) -> np.ndarray:
        row = np.zeros((self.max_blocks_per_seq,), np.int32)
        blocks = self.sched.block_row(rid)
        n = min(len(blocks), self.max_blocks_per_seq)
        row[:n] = blocks[:n]
        return row

    def _span_host_arrays(self, spans, width: int, rows: int, token_rows=None):
        """The padded span arrays ``(ids, positions, block_rows,
        context_lens, tail_lens)`` for ``spans = [(request, start, ntok)]``,
        ``rows`` rows of ``width`` columns, for standalone prefill, chunk
        rows and verify spans alike, so the pad contract cannot diverge
        between them: pad columns clamp their RoPE position to
        ``max_model_len - 1`` and write to the trash block; pad rows, and
        spans whose request is None or ``ntok`` 0 (a verify window's
        inactive slots), carry tail 0 and an all-trash table. ``token_rows``
        (parallel to ``spans``) gives each span's tokens instead of the
        request's history: a verify span carries drafts."""
        ids = np.zeros((rows, width), np.int32)
        positions = np.zeros((rows, width), np.int32)
        block_rows = np.zeros((rows, self.max_blocks_per_seq), np.int32)
        context_lens = np.ones((rows,), np.int32)
        tail_lens = np.zeros((rows,), np.int32)
        max_pos = self.config.max_model_len - 1
        for i, (request, start, ntok) in enumerate(spans):
            if request is None or ntok <= 0:
                continue
            if token_rows is not None:
                ids[i, :ntok] = token_rows[i][:ntok]
            else:
                ids[i, :ntok] = (request.prompt_ids + request.output_ids)[start:start + ntok]
            positions[i] = np.minimum(start + np.arange(width), max_pos)
            block_rows[i] = self._block_row(request.request_id)
            context_lens[i] = start + ntok
            tail_lens[i] = ntok
        return ids, positions, block_rows, context_lens, tail_lens

    def _put(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        return [torch.as_tensor(a, device=self.device) for a in arrays]

    def _dispatch_prefill_paged(
        self, spans, sample: bool = True, defer_to=None,
    ) -> list[tuple[int, int]]:
        """One paged-context prefill dispatch for ``spans``, padded to the
        longest; samples and emits each request's first token (one host
        fetch). ``sample=False`` (a chunk before the last) emits nothing.
        With ``defer_to`` the sampled tokens stay on the device: they are
        scattered into the decode carry, each request counts one unacked
        token, and a one-step fetch record joins ``defer_to`` (processed
        with the windows, one window late). The fault site ``dispatch``
        fires first, before anything reaches the device."""
        self._faults.fail('dispatch')
        requests = [r for r, _, _ in spans]
        _metrics.ENGINE_PREFILL_BATCH.observe(len(requests))
        t_start = time.monotonic()
        width = max(ntok for _, _, ntok in spans)
        host = self._span_host_arrays(spans, width, len(spans))
        sampling = self._sampling_host(requests) if sample else None
        defer_slots = None
        if sample and defer_to is not None:
            slot_of = {rid: slot for slot, rid in self.sched.running()}
            defer_slots = [slot_of[r.request_id] for r in requests]
        t_host = time.monotonic()
        tokens_dev, t_put = self._program(
            'prefill', host, sampling, defer_slots, 'prefill' not in self._measured_costs,
        )
        t_dispatch = time.monotonic()
        self.stats['forward_passes'] += 1
        self.stats['prefill_dispatches'] += 1
        _metrics.ENGINE_PREFILL_DISPATCHES.inc()
        ntokens = int(host[4].sum())
        rids = [r.request_id for r in requests]
        if not sample:
            # No host sync: the launch returned before the device ran it,
            # so the step is priced with the sampled dispatch that syncs.
            self._unsynced_prefill.append((ntokens, t_start))
            self._record_step(
                'prefill', t_start, batch=len(requests), tokens=ntokens, priced=False,
                **self._attribution_fields(t_start, t_host, t_put, t_dispatch, rids=rids),
            )
            return []
        for request in requests:
            self._insert_prompt_blocks(request)
        # The fetch, here or with the windows, waits for every unsynced
        # chunk before this one too.
        priced_tokens = ntokens + sum(n for n, _ in self._unsynced_prefill)
        t_first = min([t_start] + [t for _, t in self._unsynced_prefill])
        self._unsynced_prefill = []
        emitted, fetch_s = [], None
        if defer_to is not None:
            self._defer_prefill_tokens(requests, tokens_dev, defer_to)
        else:
            t_fetch = time.monotonic()
            tokens = tokens_dev.cpu().tolist()
            fetch_s = time.monotonic() - t_fetch
            for request, token in zip(requests, tokens):
                self._emit_token(request, token)
                emitted.append((request.request_id, token))
        self._record_step(
            'prefill', t_first, batch=len(requests), tokens=ntokens,
            priced_tokens=priced_tokens,
            **self._attribution_fields(
                t_start, t_host, t_put, t_dispatch, fetch_s=fetch_s, rids=rids,
            ),
        )
        return emitted

    def _defer_prefill_tokens(self, requests, tokens_dev, defer_to) -> None:
        """The deferred path of :meth:`_dispatch_prefill_paged` (whose
        program scattered the first tokens into the decode carry at the
        requests' slots, so the next window reads them on the device):
        count one unacked token a request, and queue their fetch as a
        one-step record, processed with the windows (the step is priced
        without its fetch)."""
        plan = []
        for i, request in enumerate(requests):
            rid = request.request_id
            self._unacked[rid] = self._unacked.get(rid, 0) + 1
            plan.append((i, rid, 1))
        defer_to.append({'tokens': tokens_dev[None, :], 'plan': plan, 'deferred': True,
                         'chunk_tokens': None, 'chunk_plan': []})

    @staticmethod
    def _sampling_host(requests) -> tuple:
        """The host inputs of sampling each request's next token: its
        knobs, seed and PRNG counter (the prompt occupies indices
        ``0..num_tokens-1``, so the counter is ``num_tokens``), and
        whether every row is greedy."""
        params = [r.params for r in requests]
        arrays = (
            np.asarray([p.temperature for p in params], np.float32),
            np.asarray([p.top_p for p in params], np.float32),
            np.asarray([p.min_p for p in params], np.float32),
            np.asarray([p.top_k for p in params], np.int32),
            np.asarray([r.sample_seed for r in requests], np.int64),
            np.asarray([r.num_tokens for r in requests], np.int64),
        )
        return arrays, all(p.temperature <= 0 for p in params)

    def _sample_on_device(self, logits: torch.Tensor, sampling: tuple) -> torch.Tensor:
        """Sample each row's next token on the device (no host sync)."""
        arrays, all_greedy = sampling
        temperature, top_p, min_p, top_k, seeds, counters = self._put(*arrays)
        return sample_tokens(
            logits, temperature, top_p, min_p, fold_row_keys(seeds, counters),
            top_window=self.config.sampling_top_window, top_k=top_k,
            all_greedy=all_greedy,
        )

    # ------------------------------------------------- step records
    def _annotate(self, kind: str):
        """``torch.profiler.record_function('distllm:<kind>')`` around a
        dispatch's host side when attribution is on, so a profiler trace
        ties device time back to engine step kinds. Never around a graph
        capture (warmup runs outside it)."""
        if not self.attribution:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f'distllm:{kind}')

    def _attribution_fields(
        self, t_start, t_host, t_put, t_dispatch, *, fetch_s=None, rids=None,
    ) -> dict:
        """The host/device split of one flight record (empty with
        attribution off): ``host_s`` (plan build), ``put_s`` (the copy of
        the plan to the device), ``dispatch_s`` (the launches; they return
        before the device finishes), ``fetch_s`` (the token fetch, where
        the device time surfaces) and the participating ``rids``."""
        if not self.attribution:
            return {}
        fields = {
            'host_s': round(t_host - t_start, 6),
            'put_s': round(t_put - t_host, 6),
            'dispatch_s': round(t_dispatch - t_put, 6),
        }
        if fetch_s is not None:
            fields['fetch_s'] = round(fetch_s, 6)
        if rids is not None:
            fields['rids'] = list(rids)
        return fields

    def _record_step(self, kind: str, t_start: float, *, batch: int, tokens: int,
                     priced: bool = True, passes: int | None = None,
                     priced_tokens: int | None = None, lengths: tuple | None = None,
                     device_s: float | None = None, **extra) -> None:
        """One flight-ring record and the step metrics for one engine step.

        ``duration_s`` runs from ``t_start`` — the start of the step's
        planning — through its token fetch (a chunk before a tail's last,
        which fetches nothing, stops at its launch and is not priced
        itself: ``priced=False``). With attribution on, the roofline prices
        the step from the weight passes that ran (``passes``; ``None``
        keeps the JAX counts) and ``priced_tokens`` scored tokens (default
        ``tokens``), and the record carries ``mfu`` / ``bw_util``, mirrored
        into the gauges and the per-kind ``roofline_summary()``
        accumulators. ``lengths`` (``(context_lens[, q_lens])``, one row a
        pass) re-prices K1 in the measured twin at the lengths the window
        ran (:meth:`OpCost.at_lengths`). ``device_s`` (a decode window's
        own CUDA-event seconds, set when windows are pipelined on the GPU)
        replaces ``duration_s`` in the measured shares only: with a window
        ahead in flight, dispatch-to-fetch covers both windows.
        """
        duration_s = time.monotonic() - t_start
        _metrics.ENGINE_STEPS.labels(kind=kind).inc()
        _metrics.ENGINE_STEP_SECONDS.labels(kind=kind).observe(duration_s)
        # The admission predictor's inputs, fed whatever the attribution
        # flag says.
        if priced:
            if kind == 'prefill' and tokens > 0:
                self._ewma_update(
                    'prefill_s_per_token',
                    duration_s / (tokens if priced_tokens is None else priced_tokens),
                )
            elif kind != 'prefill':
                self._ewma_update('window_s', duration_s)
        if priced and self._cost_model is not None and self.attribution:
            cost = self._cost_model.step_cost(
                kind,
                tokens=tokens if priced_tokens is None else priced_tokens,
                batch=batch,
                draft_tokens=extra.get('draft_tokens', 0),
                prefill_tokens=extra.get('prefill_tokens', 0),
                passes=passes,
            )
            if cost is not None:
                mfu, bw_util = self._cost_model.utilization(cost, duration_s)
                _metrics.ENGINE_MFU.labels(kind=kind).set(mfu)
                _metrics.ENGINE_BW_UTIL.labels(kind=kind).set(bw_util)
                acc = self._roofline.setdefault(
                    kind, {'windows': 0.0, 'seconds': 0.0, 'flops': 0.0, 'hbm_bytes': 0.0},
                )
                acc['windows'] += 1
                acc['seconds'] += duration_s
                acc['flops'] += cost.flops
                acc['hbm_bytes'] += cost.hbm_bytes
                extra = {**extra, 'mfu': round(mfu, 5), 'bw_util': round(bw_util, 5)}
                # The measured twin (observability.op_cost), only where the
                # dispatch ran the priced shape: a decode window is
                # ``passes`` replays of the priced step, a verify window
                # without chunk rows one, each with K1 at the window's
                # live lengths. Prefill and chunk halves run at varying
                # shapes: their prices stay in measured_costs().
                measured = None
                if lengths is not None and (
                    kind == 'decode' or (kind == 'spec' and not extra.get('prefill_tokens'))
                ) and kind in self._measured_costs:
                    measured = self._measured_costs[kind].at_lengths(*lengths)
                if measured is not None:
                    m_mfu, m_bw = _op_cost.publish_measured(
                        kind, measured, duration_s if device_s is None else device_s,
                        self._cost_model.peak_flops, self._cost_model.peak_hbm_bytes,
                    )
                    _op_cost.record_calibration(kind, cost.flops, cost.hbm_bytes, measured)
                    extra = {
                        **extra,
                        'mfu_measured': round(m_mfu, 5),
                        'bw_util_measured': round(m_bw, 5),
                    }
        usable = self.config.num_blocks - 1  # block 0 is reserved
        self.flight.record(
            kind,
            duration_s=round(duration_s, 6),
            batch=batch,
            occupancy=round(batch / self.config.max_num_seqs, 4),
            tokens=tokens,
            queue_depth=self.sched.num_waiting,
            running=self.sched.num_running,
            kv_occupancy=round(
                (usable - self.sched.num_free_blocks) / usable, 4
            ) if usable > 0 else 0.0,
            **extra,
        )

    def roofline_snapshot(self) -> dict[str, dict[str, float]]:
        """Copy of the raw per-kind roofline accumulators: pass it to
        ``roofline_summary(baseline=...)`` to scope the summary to the
        steps recorded since."""
        return {kind: dict(acc) for kind, acc in self._roofline.items()}

    def roofline_summary(
        self, baseline: dict[str, dict[str, float]] | None = None
    ) -> dict[str, dict[str, float]]:
        """Per step kind ``{windows, seconds, mfu, bw_util}``, the shares
        time-weighted (total FLOPs and bytes over total seconds over the
        device peaks); ``baseline`` subtracts an earlier snapshot. Empty
        without a cost model (and nothing accumulates with attribution
        off)."""
        if self._cost_model is None:
            return {}
        out: dict[str, dict[str, float]] = {}
        for kind, acc in self._roofline.items():
            base = (baseline or {}).get(kind, {})
            acc = {key: value - base.get(key, 0.0) for key, value in acc.items()}
            seconds = acc['seconds']
            if seconds <= 0:
                continue
            out[kind] = {
                'windows': int(acc['windows']),
                'seconds': round(seconds, 4),
                'mfu': round(acc['flops'] / seconds / self._cost_model.peak_flops, 5),
                'bw_util': round(
                    acc['hbm_bytes'] / seconds / self._cost_model.peak_hbm_bytes, 5
                ),
            }
        return out

    def warmup(self) -> None:
        """Build the decode window, and with ``draft_k`` the verify window,
        outside the request path (the JAX ``warmup``'s window part): run
        one eager step of each kind on trash-block inputs (which builds
        the kernels the steps launch), then, on the GPU, capture the
        greedy and the sampled step of each as CUDA graphs. Every KV write
        lands in the trash block 0: the scheduler, the pool's other
        blocks, ``stats['generated_tokens']`` and every sampling stream
        stay as they were. Raises if a capture fails. (Chunk halves run
        eagerly and need nothing here.)"""
        self._program('warmup')

    def _price_step_shapes(self) -> None:
        """Store the measured cost of one dispatch of the decode and verify
        step shapes (observability.op_cost), as their runners priced them at
        warmup, and set ``distllm_engine_kv_dispatch_bytes{kind}``. (The
        first prefill dispatch prices its own shape.)"""
        for kind, runner in (('decode', self._decode), ('spec', self._verify)):
            if runner is not None and runner.step_cost is not None:
                self._measured_costs[kind] = runner.step_cost
        for kind, cost in self._measured_costs.items():
            if cost.bytes_accessed:
                _metrics.ENGINE_KV_DISPATCH_BYTES.labels(kind=kind).set(cost.bytes_accessed)

    def measured_costs(self) -> dict[str, dict]:
        """Measured cost of one dispatch by step kind (``{'flops',
        'bytes_accessed', 'source'}``; a decode entry is one step of a
        window), filled by :meth:`warmup`; empty before it."""
        return {kind: cost.to_dict() for kind, cost in self._measured_costs.items()}

    @property
    def graph_pool_bytes(self) -> int:
        """Device bytes the captured graphs' private pools reserved (0 on
        the CPU)."""
        return self._decode.pool_bytes + (self._verify.pool_bytes if self._verify else 0)

    # --------------------------------------------------------------- decode
    def step(self) -> list[tuple[int, int]]:
        """One engine iteration: quarantine requests past their deadline,
        admit, then generate one window of up to ``decode_steps`` tokens
        per running sequence (with ``draft_k``, one verify window),
        carrying any chunk rows planned. Returns ``[(request_id, token)]``
        in emission order.

        With ``max_dispatch_retries > 0`` a failed dispatch does not
        propagate: the host state the step advanced is rolled back, the
        failure is charged (:meth:`_recover`) and the next call retries.
        Tokens the failed step had already folded into request state are
        then missing from its return value; the finished requests'
        ``output_ids`` are authoritative."""
        emitted: list[tuple[int, int]] = []
        try:
            self._expire_deadlines()
            emitted = self._admit()
            if self.sched.num_running == 0:
                return emitted
            window = self._dispatch_window()
            if window is not None:
                emitted.extend(self._process_window(window))
            return emitted
        except Exception as exc:
            # Whatever the failed step dispatched is lost with its device
            # tokens: no unacked lag survives, and chunk spans sent but
            # never processed fall back to what is done, so a retry
            # replans them from host state.
            self._unacked.clear()
            for rid in self._prefilling:
                pending = self._requests.get(rid)
                if pending is not None:
                    pending.prefill_sent = pending.prefill_done
            self._unsynced_prefill = []
            if not self._recover(exc):
                raise
            return emitted
        finally:
            self._publish_sched()

    def _window_budget(self, request: Request, unacked: int, k: int) -> int:
        """Tokens this request may still generate in a new window, after
        the ``unacked`` tokens already dispatched but not yet fetched; 0
        while its tail still rides mixed windows."""
        if not self._decode_ready(request):
            return 0
        budget = min(
            request.params.max_tokens - len(request.output_ids) - unacked,
            self.config.max_model_len - request.num_tokens - unacked,
        )
        return max(0, min(k, budget))

    def _window_kmax(self) -> int:
        """Per-row reservation target of the next window: the unacked
        tokens plus this window's steps, maxed over the running batch."""
        k = self.config.decode_steps
        kmax = 1
        for _, rid in self.sched.running():
            unacked = self._unacked.get(rid, 0)
            kmax = max(kmax, unacked + self._window_budget(self._requests[rid], unacked, k))
        return kmax

    def _reserve_shortfall(self, kmax: int) -> int:
        """Blocks reserving ``kmax`` more tokens for every decode-ready
        running row would take beyond what the rows own: the pipelined
        loop drains before any dispatch that would have to preempt (a
        window in flight may still write a victim's blocks)."""
        bs = self.config.block_size
        short = 0
        for _, rid in self.sched.running():
            request = self._requests[rid]
            if not self._decode_ready(request):
                continue  # chunk rows write blocks granted at admission
            target = -(-(request.num_tokens + kmax) // bs)
            short += max(0, target - self.sched.num_blocks_of(rid))
        return short

    def _on_preempt(self, request: Request) -> None:
        request.state = RequestState.WAITING
        self.stats['preemptions'] += 1
        _metrics.SCHED_PREEMPTIONS.inc()
        self.flight.record(
            'preempt', rids=[request.request_id],
            free_blocks=self.sched.num_free_blocks, queue_depth=self.sched.num_waiting,
        )
        if self.prefix_cache is not None:
            # Recompute preemption kept only the borrowed prefix; the rest
            # was freed and prefills again.
            request.num_cached_tokens = request.num_borrowed_blocks * self.config.block_size
        # Chunk progress is recompute state too: chunks past the borrowed
        # prefix lived in the freed blocks. Readmission re-enrolls or
        # prefills standalone.
        request.prefill_target = 0
        request.prefill_sent = request.prefill_done = request.num_cached_tokens
        if request.request_id in self._prefilling:
            self._prefilling.remove(request.request_id)

    def _reserve(self, rids: list[int], ks: list[int]) -> list[int]:
        """Reserve ``ks[i]`` more tokens for each of ``rids`` (evicting
        unreferenced cache blocks first: eviction pressure beats
        preemption), preempting the youngest on exhaustion; returns the
        preempted rids, already moved back to waiting."""
        short = sum(
            max(0, self.kv.blocks_needed(self._requests[rid].num_tokens + k)
                - self.sched.num_blocks_of(rid))
            for rid, k in zip(rids, ks)
        )
        self._evict_cached_blocks(short - self.sched.num_free_blocks)
        try:
            preempted = self.sched.prepare_decode(max(ks), rids=rids, ks=ks)
        except SchedulerExhausted as exc:
            # Victims moved before the fatal exhaustion stay moved: sync
            # their states so a caller that catches sees a consistent engine.
            for rid in exc.preempted:
                self._on_preempt(self._requests[rid])
            raise
        for rid in preempted:
            self._on_preempt(self._requests[rid])
        return preempted

    def _dispatch_window(self) -> dict | None:
        """Reserve blocks (preempting the youngest on exhaustion), then
        dispatch one window: the chunk half of any chunk rows planned
        (eager), then the decode rows' fused steps. Returns the window
        record, or ``None`` when no running slot has budget left and no
        chunk rides. With ``draft_k`` the window is a verify window
        (:meth:`_dispatch_spec_window`). The fault site ``dispatch`` fires
        first, before any reservation and before anything reaches the
        device; ``sched_exhausted`` fires in the reservation."""
        if self.config.draft_k:
            return self._dispatch_spec_window()
        self._faults.fail('dispatch')
        t_start = time.monotonic()
        k = self.config.decode_steps
        # Rows still prefilling through windows take no decode steps and
        # their chunks write blocks granted at admission: no reservation.
        rids = [
            rid for _, rid in self.sched.running()
            if self._decode_ready(self._requests[rid])
        ]
        if rids:
            # Each row covers its unacked tokens and this window's steps:
            # a row that stopped inside a window in flight runs on in the
            # next one, writing only blocks it still owns.
            kmax = self._window_kmax()
            if self._faults.fire('sched_exhausted') is not None:
                # Fault site 'sched_exhausted': the pool-pressure hazard
                # without a pool sized to hit it.
                raise SchedulerExhausted('injected scheduler exhaustion', preempted=[])
            self._reserve(rids, [kmax] * len(rids))
        # Planned after preemption, so a victim's span never rides.
        chunk_plan = self._plan_window_chunks()
        running = [(slot, self._requests[rid]) for slot, rid in self.sched.running()]
        if not running:
            return None
        b = self.config.max_num_seqs
        ids = np.zeros((b,), np.int32)
        positions = np.zeros((b,), np.int32)
        context_lens = np.ones((b,), np.int32)
        block_tables = np.zeros((b, self.max_blocks_per_seq), np.int32)
        steps_left = np.zeros((b,), np.int32)
        temperature = np.zeros((b,), np.float32)
        top_p = np.ones((b,), np.float32)
        min_p = np.zeros((b,), np.float32)
        top_k = np.zeros((b,), np.int32)
        seeds = np.zeros((b,), np.int64)
        # Rows with unacked tokens keep the device-side carry of last ids;
        # the rest (fresh admissions, reused slots, a drained pipeline)
        # take the host's.
        take_host = np.zeros((b,), np.int32)
        plan: list[tuple[int, int, int]] = []
        for slot, request in running:
            rid = request.request_id
            unacked = self._unacked.get(rid, 0)
            steps = self._window_budget(request, unacked, k)
            total = request.num_tokens + unacked
            positions[slot] = total - 1
            context_lens[slot] = total
            block_tables[slot] = self._block_row(rid)
            steps_left[slot] = steps
            temperature[slot] = request.params.temperature
            top_p[slot] = request.params.top_p
            min_p[slot] = request.params.min_p
            top_k[slot] = request.params.top_k
            seeds[slot] = request.sample_seed
            if unacked == 0:
                ids[slot] = (request.output_ids or request.prompt_ids)[-1]
                take_host[slot] = 1
            plan.append((slot, rid, steps))
        num_steps = max(steps for _, _, steps in plan)
        if num_steps == 0 and not chunk_plan:
            return None
        window = {'tokens': None, 'plan': plan, 'chunk_tokens': None, 'chunk_plan': [],
                  'passes': num_steps + bool(chunk_plan),
                  # K1's live lengths in each step (the measured cost).
                  'lengths': (_op_cost.decode_lengths(context_lens, steps_left, num_steps),)}
        if num_steps and not self._decode.ready:
            self.warmup()  # the first window on the GPU captures the graphs
        t_host = time.monotonic()
        if num_steps:
            # Every row taking the host's id is the plain load (step()).
            inputs = dict(
                ids=ids, positions=positions, context_lens=context_lens,
                block_tables=block_tables, steps_left=steps_left,
                temperature=temperature, top_p=top_p, min_p=min_p, top_k=top_k,
                seeds=seeds,
            )
            if not take_host.all():
                inputs['take_host'] = take_host
            self._program('decode_load', inputs)
        t_put = time.monotonic()
        with self._annotate('mixed' if chunk_plan else 'decode'):
            if chunk_plan:
                window['chunk_tokens'], window['chunk_plan'] = self._run_chunk_half(chunk_plan)
                self.stats['mixed_windows'] += 1
                _metrics.MIXED_WINDOWS.inc()
            if num_steps:
                events = None
                if self._live_depth >= 2 and self.device.type == 'cuda':
                    # With a window ahead in flight, dispatch-to-fetch spans
                    # both: the measured shares take these events instead.
                    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    events[0].record()
                window['tokens'] = self._program(
                    'decode_run', num_steps,
                    all(r.params.temperature <= 0 for _, r in running),
                )
                if events is not None:
                    events[1].record()
                    window['events'] = events
                # Out of the token buffer before another window writes it.
                window['fetch'] = self._decode.stage_tokens(num_steps)
                self.stats['forward_passes'] += num_steps
        for _, rid, steps in plan:
            if steps:
                self._unacked[rid] = self._unacked.get(rid, 0) + steps
        self.stats['decode_windows'] += 1
        _metrics.ENGINE_DECODE_WINDOWS.inc()
        _metrics.ENGINE_DECODE_UTILIZATION.observe(
            sum(1 for _, _, steps in plan if steps > 0) / b
        )
        window['timing'] = (t_start, t_host, t_put, time.monotonic())
        return window

    def _process_window(self, window: dict) -> list[tuple[int, int]]:
        """Fetch one window's tokens (the decode path's one host sync: the
        token ring slot's event) and fold them into request state. Tokens
        past a finish — a row that stopped inside this window, or one that
        finished in an earlier window while this one was in flight — are
        discarded and counted (``stats['overshoot_tokens']``,
        ``distllm_engine_overshoot_tokens_total``). Then the window's chunk
        rows. A deferred prefill's fetch record (one token a request, no
        step record) goes the same way; a verify window goes to
        :meth:`_process_spec_window`. The fault site ``slow_window`` sleeps
        where a stalled fetch would."""
        if window.get('spec'):
            return self._process_spec_window(window)
        self._faults.maybe_sleep('slow_window')
        emitted: list[tuple[int, int]] = []
        t_fetch = time.monotonic()
        tokens = None
        if 'fetch' in window:
            tokens = self._decode.fetch_tokens(window['fetch'])  # [steps, B]
        elif window['tokens'] is not None:
            tokens = window['tokens'].cpu().numpy()
        if window.get('chunk_tokens') is not None:
            window['chunk_tokens'] = window['chunk_tokens'].cpu()
        fetch_s = time.monotonic() - t_fetch
        chunk_entries = window.get('chunk_plan') or []
        if not window.get('deferred'):
            extra = {}
            if chunk_entries:
                extra = {
                    'prefill_tokens': sum(n for *_, n, _ in chunk_entries),
                    'prefill_rows': len(chunk_entries),
                }
            extra.update(self._attribution_fields(*window['timing'], fetch_s=fetch_s))
            device_s = None
            if 'events' in window:  # complete: the token fetch waited on later work
                start, end = window['events']
                device_s = start.elapsed_time(end) / 1e3
            self._record_step(
                'mixed' if chunk_entries else 'decode', window['timing'][0],
                batch=sum(1 for _, _, s in window['plan'] if s > 0),
                tokens=sum(s for _, _, s in window['plan']),
                passes=window['passes'], lengths=window['lengths'],
                device_s=device_s, **extra,
            )
        if tokens is not None:
            for slot, rid, steps in window['plan']:
                if rid in self._unacked:
                    self._unacked[rid] = max(0, self._unacked[rid] - steps)
                if rid not in self._requests:
                    # Finished in an earlier window: all overshoot.
                    self._count_overshoot(steps)
                    continue
                request = self._requests[rid]
                if request.state is not RequestState.RUNNING:
                    continue
                for i in range(steps):
                    token = int(tokens[i, slot])
                    self._emit_token(request, token)
                    emitted.append((rid, token))
                    if rid not in self._requests:
                        self._count_overshoot(steps - i - 1)
                        break  # finished mid-window
        emitted.extend(self._process_chunk_entries(window))
        return emitted

    def _count_overshoot(self, tokens: int) -> None:
        if tokens > 0:
            self.stats['overshoot_tokens'] += tokens
            _metrics.ENGINE_OVERSHOOT_TOKENS.inc(tokens)

    # ------------------------------------------------ speculative windows
    def _dispatch_spec_window(self) -> dict | None:
        """Plan and dispatch one speculative verify window. Each decode-ready
        row's drafter proposes up to ``draft_k`` tokens (at most its budget
        less one: a window emits accepted + 1 tokens); the row's span
        ``[last emitted token, drafts]`` rides one verify pass over the
        ``[max_num_seqs, 1 + draft_k]`` spans, after the chunk half of any
        chunk rows planned. Blocks are reserved per row, each for its own
        span. Returns the window record, or ``None`` when nothing rides.
        The fault site ``dispatch`` fires first."""
        self._faults.fail('dispatch')
        t_start = time.monotonic()
        draft_k = self.config.draft_k
        drafts_by_rid: dict[int, list[int]] = {}
        rids: list[int] = []
        row_ks: list[int] = []
        for _, rid in self.sched.running():
            request = self._requests[rid]
            budget = self._window_budget(request, 0, draft_k + 1)
            if budget <= 0:
                continue
            drafts: list[int] = []
            if budget > 1 and request.drafter is not None:
                drafts = request.drafter.draft(
                    request.prompt_ids + request.output_ids, min(draft_k, budget - 1)
                )
            drafts_by_rid[rid] = drafts
            rids.append(rid)
            # The span writes K/V through position num_tokens - 1 +
            # len(drafts); 1 keeps the single-step floor.
            row_ks.append(max(1, len(drafts)))
        if rids:
            for rid in self._reserve(rids, row_ks):
                # Preemption mid-draft: the undispatched draft is dropped
                # with the rest of the row's state.
                drafts_by_rid.pop(rid, None)
        chunk_plan = self._plan_window_chunks()
        b = self.config.max_num_seqs
        spans: list = [(None, 0, 0)] * b
        token_rows: list = [[]] * b
        temperature = np.zeros((b,), np.float32)
        top_p = np.ones((b,), np.float32)
        min_p = np.zeros((b,), np.float32)
        top_k = np.zeros((b,), np.int32)
        seeds = np.zeros((b,), np.int64)
        plan: list[tuple[int, int, list[int]]] = []
        for slot, rid in self.sched.running():
            drafts = drafts_by_rid.get(rid)
            if drafts is None:
                continue
            request = self._requests[rid]
            # The span starts at the last emitted token's position (its K/V
            # is not written yet: write-then-attend) and runs through the
            # drafts.
            spans[slot] = (request, request.num_tokens - 1, 1 + len(drafts))
            token_rows[slot] = [(request.output_ids or request.prompt_ids)[-1]] + drafts
            temperature[slot] = request.params.temperature
            top_p[slot] = request.params.top_p
            min_p[slot] = request.params.min_p
            top_k[slot] = request.params.top_k
            seeds[slot] = request.sample_seed
            plan.append((slot, rid, drafts))
        if not plan and not chunk_plan:
            return None
        window = {'spec': True, 'tokens': None, 'plan': plan, 'chunk_tokens': None,
                  'chunk_plan': [], 'passes': bool(plan) + bool(chunk_plan), 'lengths': None}
        if plan:
            if not self._verify.ready:
                self.warmup()  # the first window on the GPU captures the graphs
            span_arrays = self._span_host_arrays(spans, 1 + draft_k, b, token_rows=token_rows)
            # K1's live lengths: each row's context and its span's tokens.
            window['lengths'] = (span_arrays[3][None], span_arrays[4][None])
        t_host = time.monotonic()
        if plan:
            self._program(
                'verify_load', (*span_arrays, temperature, top_p, min_p, top_k, seeds),
            )
        t_put = time.monotonic()
        with self._annotate('spec'):
            if chunk_plan:
                window['chunk_tokens'], window['chunk_plan'] = self._run_chunk_half(chunk_plan)
                self.stats['spec_chunk_windows'] += 1
            if plan:
                window['tokens'] = self._program(
                    'verify_run',
                    all(self._requests[rid].params.temperature <= 0 for _, rid, _ in plan),
                )
        if plan:
            ndrafted = sum(len(d) for _, _, d in plan)
            self.stats['forward_passes'] += 1
            self.stats['spec_windows'] += 1
            self.stats['spec_draft_tokens'] += ndrafted
            _metrics.SPEC_WINDOWS.inc()
            if ndrafted:
                _metrics.SPEC_DRAFT_TOKENS.inc(ndrafted)
        window['timing'] = (t_start, t_host, t_put, time.monotonic())
        return window

    def _process_spec_window(self, window: dict) -> list[tuple[int, int]]:
        """Fetch one verify window's packed ``[B, S+1]`` result (its one host
        sync) and emit each row's tokens: ``out[0]`` always, then one more
        per accepted draft, the last of them the correction or the bonus
        token, so the stream is exactly the sequential one. A stop token
        or ``max_tokens`` inside the accepted prefix finishes the request
        there and the rest is dropped. ``sched.trim`` then returns each
        row's unused blocks, so the scheduler matches a never-drafted run;
        rejected K/V sits at positions every later pass overwrites before
        attending, or masks out. Then the window's chunk rows."""
        emitted: list[tuple[int, int]] = []
        t_fetch = time.monotonic()
        tokens = None
        if window['tokens'] is not None:
            tokens = window['tokens'].cpu().numpy()
        elif window['chunk_tokens'] is not None:
            window['chunk_tokens'] = window['chunk_tokens'].cpu()
        fetch_s = time.monotonic() - t_fetch
        drafted = accepted = rows = sampled_rows = resampled = 0
        if tokens is not None:
            for slot, rid, drafts in window['plan']:
                request = self._requests.get(rid)
                if request is None or request.state is not RequestState.RUNNING:
                    continue
                sampled = request.params.temperature > 0
                rows += 1
                drafted += len(drafts)
                n_acc = min(int(tokens[slot, -1]), len(drafts))
                if sampled and drafts:
                    sampled_rows += 1
                    # A sampled row that stopped short drew one residual.
                    resampled += n_acc < len(drafts)
                for i in range(n_acc + 1):
                    if rid not in self._requests:
                        break  # finished inside the accepted prefix
                    token = int(tokens[slot, i])
                    self._emit_token(request, token)
                    emitted.append((rid, token))
                    accepted += i > 0
                if rid in self._requests:
                    self.sched.trim(rid)
            self.stats['spec_accepted_tokens'] += accepted
            self.stats['spec_sampled_rows'] += sampled_rows
            self.stats['spec_resampled_tokens'] += resampled
            if accepted:
                _metrics.SPEC_ACCEPTED_TOKENS.inc(accepted)
            if drafted:
                _metrics.SPEC_ACCEPT_RATE.observe(accepted / drafted)
            if sampled_rows:
                _metrics.SPEC_SAMPLED_ROWS.inc(sampled_rows)
            if resampled:
                _metrics.SPEC_RESAMPLED_TOKENS.inc(resampled)
        chunk_entries = window['chunk_plan']
        extra = {
            'draft_tokens': drafted,
            'accepted_tokens': accepted,
            'sampled_rows': sampled_rows,
            'resampled_tokens': resampled,
        }
        if chunk_entries:
            extra['prefill_tokens'] = sum(n for *_, n, _ in chunk_entries)
            extra['prefill_rows'] = len(chunk_entries)
        extra.update(self._attribution_fields(*window['timing'], fetch_s=fetch_s))
        self._record_step(
            'spec', window['timing'][0], batch=rows, tokens=len(emitted),
            passes=window['passes'], lengths=window['lengths'], **extra,
        )
        emitted.extend(self._process_chunk_entries(window))
        return emitted

    def _stop_ids(self, request: Request) -> set[int]:
        stops = set(request.params.stop_token_ids)
        eos = getattr(self.tokenizer, 'eos_id', None)
        if eos is not None:
            stops.add(eos)
        return stops

    def _emit_token(self, request: Request, token: int) -> None:
        if self._consecutive_failures:
            # The first token after failed dispatches: the retry worked.
            self._consecutive_failures = 0
            self.stats['recoveries'] += 1
            _metrics.RESILIENCE_RECOVERIES.inc()
            self.flight.record('recovery', status='recovered', request_id=request.request_id)
        if self._dispatch_failures:
            # Progress clears the request's charge: only consecutive
            # failures quarantine.
            self._dispatch_failures.pop(request.request_id, None)
        if not request.output_ids and request.t_first_token == 0.0:
            # TTFT runs to the host fetch of the first token: what a
            # streaming client sees.
            request.t_first_token = time.monotonic()
            _metrics.REQUEST_TTFT.observe(request.t_first_token - request.t_enqueue)
        request.output_ids.append(token)
        self.sched.append_token(request.request_id)
        self.stats['generated_tokens'] += 1
        _metrics.ENGINE_GENERATED_TOKENS.inc()
        stops = self._stop_ids(request)
        if (
            token in stops
            or len(request.output_ids) >= request.params.max_tokens
            or request.num_tokens >= self.config.max_model_len
        ):
            request.finish_reason = 'stop' if token in stops else 'length'
            self._finish(request)

    def _finish(self, request: Request) -> None:
        request.state = RequestState.FINISHED
        request.t_finish = time.monotonic()
        self._observe_lifecycle(request)
        _metrics.ENGINE_REQUESTS_FINISHED.inc()
        self.sched.finish(request.request_id)
        if self.prefix_cache is not None:
            # Blocks at refcount 0 become LRU-evictable and keep their KV.
            self.prefix_cache.release(request.request_id)
        self._unacked.pop(request.request_id, None)
        del self._requests[request.request_id]
        self._finished[request.request_id] = request

    def _observe_lifecycle(self, request: Request) -> None:
        """Fold one finished request into the lifecycle series and the
        flight ring: the TPOT histogram, the SLO and goodput counters when
        an SLO is set, and one ``'request'`` record carrying the whole
        enqueue -> admit -> first token -> finish timeline."""
        n_out = len(request.output_ids)
        ttft_s = (
            request.t_first_token - request.t_enqueue if request.t_first_token else None
        )
        tpot_s = None
        if request.t_first_token and n_out > 1:
            tpot_s = (request.t_finish - request.t_first_token) / (n_out - 1)
            _metrics.REQUEST_TPOT.observe(tpot_s)
        slo = self.config.ttft_slo_s
        if slo > 0 and ttft_s is not None:
            met = ttft_s <= slo
            _metrics.REQUEST_SLO.labels(outcome='met' if met else 'missed').inc()
            self.stats['slo_met' if met else 'slo_missed'] += 1
            if met:
                _metrics.GOODPUT_TOKENS.inc(n_out)
                self.stats['goodput_tokens'] += n_out
        self.flight.record(
            'request',
            request_id=request.request_id,
            trace_id=request.trace_id,
            prompt_tokens=len(request.prompt_ids),
            output_tokens=n_out,
            queue_wait_s=round(request.t_admit - request.t_enqueue, 6)
            if request.t_admit else None,
            ttft_s=round(ttft_s, 6) if ttft_s is not None else None,
            tpot_s=round(tpot_s, 6) if tpot_s is not None else None,
            e2e_s=round(request.t_finish - request.t_enqueue, 6),
            cached_tokens=request.num_cached_tokens,
        )

    # -------------------------------------------------- crash-domain recovery
    def _recover(self, exc: Exception) -> bool:
        """Whether a failed step retries. True: the failure is charged to
        every request involved (the running batch, or the waiting head
        when admission failed with nothing running), those past
        ``max_dispatch_retries`` are quarantined to ``FAILED``, and a
        bounded exponential backoff sleeps. False (recovery off, or
        nothing live to charge): the caller re-raises. Every True return
        charges a live request and a request is quarantined after at
        most ``max_dispatch_retries + 1`` charges, so a permanent fault
        drains the requests into ``FAILED`` instead of looping."""
        cfg = self.config
        if cfg.max_dispatch_retries <= 0:
            return False
        involved = [rid for _, rid in self.sched.running()]
        if not involved:
            waiting = [
                r.request_id for r in self._requests.values()
                if r.state is RequestState.WAITING
            ]
            if waiting:
                involved = [min(waiting)]
        if not involved:
            return False
        self._consecutive_failures += 1
        self.stats['window_retries'] += 1
        _metrics.RESILIENCE_RETRIES.inc()
        for rid in involved:
            self._dispatch_failures[rid] = self._dispatch_failures.get(rid, 0) + 1
        self.flight.record(
            'recovery', status='retry', error=repr(exc)[:200],
            attempt=self._consecutive_failures, rids=involved[:16],
        )
        for rid in involved:
            if self._dispatch_failures.get(rid, 0) > cfg.max_dispatch_retries:
                request = self._requests.get(rid)
                if request is not None:
                    self._fail_request(
                        request, reason='dispatch_failed', error=repr(exc)[:300],
                    )
        delay = cfg.retry_backoff_s * (2 ** min(self._consecutive_failures - 1, 6))
        if delay > 0:
            time.sleep(min(delay, 2.0))
        return True

    def _expired_requests(self) -> list[Request]:
        """Live requests past ``request_deadline_s`` (none when it is 0)."""
        deadline = self.config.request_deadline_s
        if deadline <= 0 or not self._requests:
            return []
        now = time.monotonic()
        return [
            r for r in self._requests.values()
            if r.state in (RequestState.WAITING, RequestState.RUNNING)
            and now - r.t_enqueue > deadline
        ]

    def _expire_deadlines(self) -> None:
        """Quarantine every request past its deadline with
        ``finish_reason='timeout'``, freeing its KV blocks."""
        for request in self._expired_requests():
            self._fail_request(
                request, reason='timeout',
                error=f'request exceeded request_deadline_s={self.config.request_deadline_s}',
            )

    def _fail_request(self, request: Request, *, reason: str, error: str) -> None:
        """Terminal quarantine: record the error, free every resource the
        request holds and park it in the finished map as ``FAILED`` (one
        ``'quarantine'`` flight record and
        ``distllm_resilience_quarantined_requests_total{reason}``). Its
        prefix-cache references are released once. No window is in flight
        here (the pipelined loop drains before it expires deadlines, and
        step() fetches its window within the step), and a promotion copy
        still running on the side stream is safe: the current stream, on
        which every later write of those blocks is queued, already waits
        on its event, and its staging stays held until it completes."""
        rid = request.request_id
        request.state = RequestState.FAILED
        request.finish_reason = reason
        request.error = error
        request.t_finish = time.monotonic()
        _metrics.RESILIENCE_QUARANTINED.labels(reason=reason).inc()
        self.stats['quarantined_requests'] += 1
        self.flight.record(
            'quarantine', request_id=rid, trace_id=request.trace_id, reason=reason,
            error=error[:300], prompt_tokens=len(request.prompt_ids),
            output_tokens=len(request.output_ids),
        )
        self.sched.finish(rid)
        if self.prefix_cache is not None:
            self.prefix_cache.release(rid)
        self._dispatch_failures.pop(rid, None)
        self._unacked.pop(rid, None)
        for pending in (self._prefilling, self._pending_prefill):
            if rid in pending:
                pending.remove(rid)
        del self._requests[rid]
        self._finished[rid] = request

    # ------------------------------------------------------ the pipelined loop
    def _run_to_completion(self) -> None:
        """Drive every request to a terminal state through the pipelined
        loop. With ``max_dispatch_retries == 0`` the first dispatch
        exception propagates; with recovery on, a failed pass — its windows
        in flight already folded back by :meth:`_serve_pipelined` — is
        charged, backed off and retried (:meth:`_recover`)."""
        while True:
            try:
                self._serve_pipelined()
                return
            except Exception as exc:
                if not self._recover(exc):
                    raise
            finally:
                self._publish_sched()

    def _serve_pipelined(self) -> None:
        """Drive all requests to completion with ``pipeline_depth`` decode
        windows in flight (the JAX engine's ``_serve_pipelined``): window
        N is processed after window N+1 has been dispatched, so the host's
        fetch and bookkeeping of one window overlap the device's work on
        the next. Stops and admission react one window late; the tokens a
        row runs past its stop are discarded and counted as overshoot.

        - Deadline expiry drains first: freeing a victim's blocks is safe
          only with nothing in flight.
        - No dispatch may preempt while windows are in flight: the loop
          evicts unreferenced cached blocks, then drains, until the next
          window's reservation fits (``_reserve_shortfall``).
        - ``defer_prefill``: admission's first-token fetch records join
          the deque.
        - ``draft_k > 0`` forces depth 1 (the drafter needs each window's
          tokens on the host).
        - On an exception every dispatched window is folded back into
          request state; if that fails too, the windows are dropped with an
          ``abnormal_drain`` flight event, the unacked lag is cleared and
          chunk spans roll ``prefill_sent`` back to ``prefill_done``."""
        depth = 1 if self.config.draft_k else max(1, self.config.pipeline_depth)
        inflight: deque[dict] = deque()
        self._unacked.clear()

        def process_one() -> None:
            self._process_window(inflight.popleft())

        def drain_one() -> None:
            if inflight:
                process_one()

        self._drain_hook = drain_one
        self._live_depth = depth
        try:
            while self.has_unfinished or inflight:
                if self._expired_requests():
                    while inflight:
                        process_one()
                    self._expire_deadlines()
                self._admit(defer_to=inflight if self.config.defer_prefill else None)
                if self.sched.num_running == 0:
                    if inflight:
                        process_one()
                    continue
                while inflight and (
                    short := self._reserve_shortfall(self._window_kmax())
                    - self.sched.num_free_blocks
                ) > 0:
                    if self._evict_cached_blocks(short):
                        continue
                    process_one()
                window = self._dispatch_window()
                if window is None:
                    if inflight:
                        process_one()
                    continue
                inflight.append(window)
                if len(inflight) >= depth:
                    process_one()
                self._publish_sched()
        except BaseException:
            while inflight:
                try:
                    process_one()
                except Exception as drain_exc:
                    # The windows in flight cannot be folded back: their
                    # tokens are lost (KV written at positions >= num_tokens
                    # is overwritten before it is ever attended). Recorded.
                    self.flight.record(
                        'event', event='abnormal_drain',
                        dropped_windows=len(inflight) + 1,
                        error=repr(drain_exc)[:200],
                    )
                    inflight.clear()
                    self._unacked.clear()
            # A chunk span whose window was dropped advanced prefill_sent
            # but never prefill_done: rolled back, it rides again.
            for rid in self._prefilling:
                request = self._requests.get(rid)
                if request is not None:
                    request.prefill_sent = request.prefill_done
            self._unsynced_prefill = []
            raise
        finally:
            self._drain_hook = None
            self._live_depth = 1

    # -------------------------------------------------------------- offline
    def generate_ids(
        self,
        prompts: list[list[int]],
        params: 'SamplingParams | list[SamplingParams] | None' = None,
    ) -> list[list[int]]:
        """Offline batch API: token ids in, generated token ids out (stop
        token stripped), served by the pipelined loop
        (:meth:`_serve_pipelined`, ``pipeline_depth`` windows in flight).
        ``params`` is one ``SamplingParams`` for every prompt or a list
        parallel to ``prompts``. Writes ``telemetry``: the run's counters,
        ``loop_s`` and ``tokens_per_s``, and the JAX engine's keys
        (``decode_loop_s``, ``windows_per_s``, ``prefix_hit_rate``,
        ``spec_accept_rate``, ``spec_windows_per_s``,
        ``tier_promotion_overlap``, ``overshoot_frac``)."""
        per_prompt = params if isinstance(params, list) else [params] * len(prompts)
        if len(per_prompt) != len(prompts):
            raise ValueError('params list must parallel prompts')
        before = Counter(self.stats)
        ids = [self.add_request(p, sp) for p, sp in zip(prompts, per_prompt)]
        start = time.perf_counter()
        self._run_to_completion()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        loop_s = time.perf_counter() - start
        run = self.stats - before
        self.telemetry = {
            key: value if isinstance(value, float) else int(value)
            for key, value in run.items()
        }
        self.telemetry.update(
            attn_backend=self.attn_backend,
            quantization=self.config.quantization,
            qmm_backend=self.qmm_backend,
            kv_cache_dtype=self.kv_cache_dtype,
            weight_bytes_quantized=self.weight_bytes_quantized,
            weight_bytes_float=self.weight_bytes_float,
        )
        self.telemetry['loop_s'] = loop_s
        if loop_s > 0:
            self.telemetry['tokens_per_s'] = run['generated_tokens'] / loop_s
        self.telemetry.update(
            scheduler=self.scheduler_kind,
            pipeline_depth=1 if self.config.draft_k else max(1, self.config.pipeline_depth),
            **self._graph_notes,
        )
        self.telemetry.update(self._jax_telemetry(run, loop_s))
        outs = []
        for rid in ids:
            request = self._finished.pop(rid)
            out = request.output_ids
            if out and out[-1] in self._stop_ids(request):
                out = out[:-1]
            outs.append(out)
        return outs

    def _jax_telemetry(self, run: Counter, loop_s: float) -> dict:
        """The JAX ``generate_ids`` telemetry keys, computed as it computes
        them from this run's counters."""
        out: dict = {'decode_loop_s': round(loop_s, 3)}
        windows = run.get('decode_windows', 0)
        if windows and loop_s > 0:
            out['windows_per_s'] = round(windows / loop_s, 2)
        lookups = run.get('prefix_lookup_tokens', 0)
        if lookups:
            out['prefix_hit_rate'] = round(run.get('prefix_hit_tokens', 0) / lookups, 4)
        drafted = run.get('spec_draft_tokens', 0)
        if drafted:
            out['spec_accept_rate'] = round(run.get('spec_accepted_tokens', 0) / drafted, 4)
        spec_windows = run.get('spec_windows', 0)
        if spec_windows and loop_s > 0:
            out['spec_windows_per_s'] = round(spec_windows / loop_s, 2)
        if self.kv_tier is not None:
            overlap = self.tier_summary().get('promotion_overlap')
            if overlap is not None:
                out['tier_promotion_overlap'] = overlap
        n_out = sum(len(r.output_ids) for r in self._finished.values())
        if n_out:
            out['overshoot_frac'] = round(run.get('overshoot_tokens', 0) / n_out, 4)
        return out

    def generate(
        self,
        prompts: list[str],
        params: 'SamplingParams | list[SamplingParams] | None' = None,
    ) -> list[str]:
        """Offline text API (vLLM ``llm.generate`` parity)."""
        batch = self.tokenizer(prompts)
        prompt_ids = [
            [int(t) for t, m in zip(row_ids, row_mask) if m]
            for row_ids, row_mask in zip(batch.input_ids, batch.attention_mask)
        ]
        outputs = self.generate_ids(prompt_ids, params)
        return [self.tokenizer.decode(out) for out in outputs]

    def shutdown(self) -> None:
        """Drop the weights, the pool and the decode graphs with their
        memory pool (after any promotion copy in flight has landed); close
        the peer tier's server and client."""
        self._retire_promotions(wait=True)
        if self._history_sampler is not None:
            self._history_sampler.stop()
            self._history_sampler = None
        if self._peer_kv_server is not None:
            self._peer_kv_server.close()
            self._peer_kv_server = None
        if self.kv_tier is not None and self.kv_tier.peer is not None:
            self.kv_tier.peer.close()
        self._decode.close()
        if self._verify is not None:
            self._verify.close()
        self.params = None
        self.kv = None
