"""Continuous-batching generation engine over the paged KV cache
(PyTorch counterpart of ``distllm_tpu.generate.engine.engine``).

- **admission**: waiting requests enter free slots under the block budget
  (``scheduler.PyScheduler``); each admitted prompt is prefilled through
  :func:`~distllm_tpu_torch.models.mistral.prefill_paged` as a tail with no
  cached prefix — the JAX engine's own path for chunk and prefix-hit
  tails — so every dispatch reaches the paged-attention kernel. Same-bucket
  prompts prefill together in one padded dispatch.
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
- **preemption**: when the pool runs dry mid-decode the youngest request
  is recompute-preempted (blocks freed, re-prefilled on readmission).
- **weight-only quantization** (``EngineConfig.quantization``): the
  engine quantizes its parameters once at construction (int8 projections
  then run through kernel K2, nf4 ones dequantize per layer) and pins the
  quantized-matmul tier into its model config.
- **KV storage dtype** (``EngineConfig.kv_cache_dtype``), resolved once at
  construction: the model dtype (``'auto'`` or the matching pin), or an
  int8 pool with per-block, per-KV-head scales, quantized at write time
  and read by kernel K1's int8-KV mode (about half the bytes per block).

Later slices bring mixed batching, speculation, the prefix cache and its
tiers, recovery, admission control, pipelining (this engine runs one
window at a time: ``pipeline_depth=1``) and observability.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
from collections import Counter
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
import torch

from distllm_tpu_torch.generate.engine.decode_graph import DecodeGraphRunner
from distllm_tpu_torch.generate.engine.kv_cache import PagedKVCache
from distllm_tpu_torch.generate.engine.scheduler import (
    PyScheduler,
    SchedulerExhausted,
)
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.models.tokenizer import bucket_ladder, pick_bucket
from distllm_tpu_torch.ops.paged_attention import kv_storage_dtype
from distllm_tpu_torch.ops.quantization import (
    MODES,
    quantize_pytree,
    quantized_nbytes,
)
from distllm_tpu_torch.ops.sampling import fold_row_keys, sample_tokens
from distllm_tpu_torch.utils import BaseConfig, resolve_device

# Smallest prefill length bucket and the token cap of one prefill dispatch
# (the JAX EngineConfig defaults prefill_min_bucket / max_prefill_tokens).
_PREFILL_MIN_BUCKET = 16
_MAX_PREFILL_TOKENS = 2048
# Engine-wide seed behind requests that carry no explicit seed (the JAX
# EngineConfig.seed default).
_ENGINE_SEED = 0
KV_CACHE_DTYPES = ('auto', 'bf16', 'fp32', 'int8')
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


@dataclass
class Request:
    request_id: int
    prompt_ids: list[int]
    params: SamplingParams
    state: RequestState = RequestState.WAITING
    output_ids: list[int] = field(default_factory=list)
    sample_seed: int = 0
    finish_reason: str = ''  # 'stop' | 'length' once finished

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)


@dataclass
class EngineConfig(BaseConfig):
    """Capacity knobs (vLLM analogues ``block_size``, ``num_blocks``,
    ``max_num_seqs``, ``max_model_len``) plus the decode window length,
    the prefill batch cap, weight-only quantization and the KV pool's
    storage dtype."""

    block_size: int = 16
    num_blocks: int = 256
    max_num_seqs: int = 8
    max_model_len: int = 1024
    decode_steps: int = 8
    max_prefill_batch: int = 8
    quantization: str | None = None  # None | 'int8' | 'nf4' (weight-only)
    # Storage dtype of the paged KV pool (the JAX field): 'auto' stores the
    # model dtype, bit-identical to an engine without the field; 'int8'
    # stores int8 codes with per-block, per-KV-head fp32 scales. A
    # full-precision pin that differs from the model dtype is not ported
    # (ROADMAP A15).
    kv_cache_dtype: str = 'auto'  # 'auto' | 'bf16' | 'fp32' | 'int8'

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
        if self.num_blocks < 2:
            raise ValueError('num_blocks must be >= 2 (block 0 is reserved)')
        if self.max_model_len < 2:
            raise ValueError('max_model_len must be >= 2')


class LLMEngine:
    """Drives a Mistral-family decoder with paged KV + continuous batching.

    ``params`` must already live on ``device`` (``None`` = the GPU; raises
    without one). ``attn_backend='auto'`` attends through
    ``ops.paged_attention.ragged_paged_attention`` (the CUDA kernel on the
    GPU, the plain op on the CPU); ``'reference'`` pins the plain op on
    any device. ``qmm_backend`` does the same for the int8 projections
    (``ops.quantized_matmul``; ``None`` = the model config's). With ``config.quantization`` the float leaves of
    ``params`` are quantized here; ``own_params=True`` lets the engine
    drop each source leaf from the caller's dict as its codes appear
    (device memory then peaks at the float weights, not weights plus
    codes).
    """

    def __init__(
        self,
        model_cfg: mistral.MistralConfig,
        params: dict,
        tokenizer,
        config: EngineConfig | None = None,
        device: 'str | torch.device | None' = None,
        attn_backend: str = 'auto',
        qmm_backend: str | None = None,
        own_params: bool = False,
    ) -> None:
        if attn_backend not in mistral.ATTN_BACKENDS:
            raise ValueError(
                f'attn_backend must be one of {mistral.ATTN_BACKENDS}, '
                f'got {attn_backend!r}'
            )
        self.device = resolve_device(device)
        if params['embed'].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, engine device is "
                f'{self.device}'
            )
        self.tokenizer = tokenizer
        self.config = config or EngineConfig()
        self.attn_backend = attn_backend
        cfg = self.config
        if cfg.quantization:
            # Weight-only quantization (reference: bnb NF4 in the HF
            # generator): codes live on the device; already quantized
            # leaves pass through.
            params = quantize_pytree(
                params, mode=cfg.quantization, out_dtype=model_cfg.dtype,
                delete_source=own_params,
            )
        # The quantized-matmul tier, resolved once and pinned into the
        # model config every dispatch reads (which validates it).
        self.qmm_backend = qmm_backend or model_cfg.qmm_backend
        self.model_cfg = dataclasses.replace(model_cfg, qmm_backend=self.qmm_backend)
        self.params = params
        self.weight_bytes_quantized, self.weight_bytes_float = quantized_nbytes(params)
        # The KV storage dtype, resolved once (the JAX resolution): 'auto'
        # stores the model dtype.
        model_dtype = mistral.torch_dtype(model_cfg.dtype)
        kv_name = _KV_POOL_DTYPES.get(cfg.kv_cache_dtype, model_cfg.dtype)
        kv_dtype = torch.int8 if kv_name == 'int8' else mistral.torch_dtype(kv_name)
        if kv_dtype not in (torch.int8, model_dtype):
            raise NotImplementedError(
                f'kv_cache_dtype={cfg.kv_cache_dtype!r} under a '
                f'{model_cfg.dtype} model (a full-precision pool of another '
                "dtype than the model's) is not ported yet (ROADMAP A15); "
                "use 'auto' or 'int8'"
            )
        self.kv = PagedKVCache(
            num_layers=model_cfg.num_layers,
            num_blocks=cfg.num_blocks,
            block_size=cfg.block_size,
            num_kv_heads=model_cfg.num_kv_heads,
            head_dim=model_cfg.head_size,
            dtype=kv_dtype,
            device=self.device,
        )
        # What the pool stores ('auto' is never surfaced).
        self.kv_cache_dtype = str(kv_storage_dtype(self.kv.k)).removeprefix('torch.')
        self.max_blocks_per_seq = self.kv.blocks_needed(cfg.max_model_len)
        self.prefill_buckets = bucket_ladder(
            cfg.max_model_len, _PREFILL_MIN_BUCKET, scheme='pow2'
        )
        self.sched = PyScheduler(cfg.num_blocks, cfg.block_size, cfg.max_num_seqs)
        self._requests: dict[int, Request] = {}
        self._next_id = itertools.count()
        self._finished: dict[int, Request] = {}
        # Cumulative counters over the engine's life: forward_passes (model
        # passes over all layers), prefill_dispatches, decode_windows,
        # generated_tokens, preemptions; on the GPU decode_graph_captures,
        # decode_graph_replays (one per decode step) and
        # decode_graph_capture_s (the captures' seconds, a float).
        self.stats: Counter[str] = Counter()
        self._decode = DecodeGraphRunner(
            self.params, self.model_cfg, self.kv.k, self.kv.v,
            max_num_seqs=cfg.max_num_seqs,
            max_blocks_per_seq=self.max_blocks_per_seq,
            decode_steps=cfg.decode_steps,
            max_table_positions=cfg.max_model_len,
            attn_backend=attn_backend, device=self.device, stats=self.stats,
        )
        # Per-run summary written by generate_ids; the resolved KV storage
        # dtype ('bfloat16', 'float32' or 'int8') from construction on.
        self.telemetry: dict[str, float] = {'kv_cache_dtype': self.kv_cache_dtype}

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
        request = Request(
            request_id=next(self._next_id),
            prompt_ids=prompt_ids,
            params=params or SamplingParams(),
        )
        request.sample_seed = _request_seed(
            _ENGINE_SEED, request.request_id, request.params.seed
        )
        self._requests[request.request_id] = request
        self.sched.add(request.request_id, request.num_tokens)
        return request.request_id

    @property
    def has_unfinished(self) -> bool:
        return self.sched.has_unfinished

    # ------------------------------------------------------------ admission
    def _admit(self) -> list[tuple[int, int]]:
        """Admit waiting requests while the scheduler allows and prefill
        them, same-bucket prompts batched; returns the first tokens as
        ``(request_id, token)``. A prefill may finish its request at once
        (stop token / max_tokens=1), freeing a slot, so admission repeats
        until the scheduler yields nothing."""
        emitted: list[tuple[int, int]] = []
        while True:
            admitted: list[Request] = []
            while (rid := self.sched.admit_next()) is not None:
                request = self._requests[rid]
                request.state = RequestState.RUNNING
                admitted.append(request)
            if not admitted:
                return emitted
            groups: dict[int, list[Request]] = {}
            for request in admitted:
                # Re-prefill covers generated tokens too (recompute
                # preemption).
                bucket = pick_bucket(request.num_tokens, self.prefill_buckets)
                groups.setdefault(bucket, []).append(request)
            for bucket, requests in sorted(groups.items()):
                cap = self._prefill_batch_cap(bucket)
                for i in range(0, len(requests), cap):
                    spans = [
                        (r, 0, r.num_tokens) for r in requests[i:i + cap]
                    ]
                    emitted.extend(self._dispatch_prefill_paged(spans))

    def _prefill_batch_cap(self, bucket: int) -> int:
        """Prompts of one bucket that prefill together."""
        return max(1, min(
            self.config.max_prefill_batch,
            _MAX_PREFILL_TOKENS // bucket,
            self.config.max_num_seqs,
        ))

    def _block_row(self, rid: int) -> np.ndarray:
        row = np.zeros((self.max_blocks_per_seq,), np.int32)
        blocks = self.sched.block_row(rid)
        n = min(len(blocks), self.max_blocks_per_seq)
        row[:n] = blocks[:n]
        return row

    def _span_host_arrays(self, spans):
        """Padded span arrays ``(ids, positions, block_rows, context_lens,
        tail_lens)`` for ``spans = [(request, start, ntok)]``, padded to the
        longest span. Pad columns clamp their RoPE position to
        ``max_model_len - 1`` and write to the trash block."""
        rows = len(spans)
        width = max(ntok for _, _, ntok in spans)
        ids = np.zeros((rows, width), np.int32)
        positions = np.zeros((rows, width), np.int32)
        block_rows = np.zeros((rows, self.max_blocks_per_seq), np.int32)
        context_lens = np.ones((rows,), np.int32)
        tail_lens = np.zeros((rows,), np.int32)
        max_pos = self.config.max_model_len - 1
        for i, (request, start, ntok) in enumerate(spans):
            tokens = request.prompt_ids + request.output_ids
            ids[i, :ntok] = tokens[start:start + ntok]
            positions[i] = np.minimum(start + np.arange(width), max_pos)
            block_rows[i] = self._block_row(request.request_id)
            context_lens[i] = start + ntok
            tail_lens[i] = ntok
        return ids, positions, block_rows, context_lens, tail_lens

    def _put(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        return [torch.as_tensor(a, device=self.device) for a in arrays]

    def _dispatch_prefill_paged(self, spans) -> list[tuple[int, int]]:
        """One paged-context prefill dispatch for ``spans``; samples and
        emits each request's first token (one host fetch)."""
        ids, positions, block_rows, context_lens, tail_lens = self._put(
            *self._span_host_arrays(spans)
        )
        last_logits, _, _ = mistral.prefill_paged(
            self.params, self.model_cfg, ids, positions, self.kv.k, self.kv.v,
            block_rows, context_lens, tail_lens,
            max_table_positions=self.config.max_model_len,
            attn_backend=self.attn_backend,
        )
        self.stats['forward_passes'] += 1
        self.stats['prefill_dispatches'] += 1
        requests = [r for r, _, _ in spans]
        tokens = self._sample_device(last_logits, requests).cpu().tolist()
        emitted = []
        for request, token in zip(requests, tokens):
            self._emit_token(request, token)
            emitted.append((request.request_id, token))
        return emitted

    def _sample_device(self, logits: torch.Tensor, requests) -> torch.Tensor:
        """Sample each request's next token on the device (no host sync).
        The prompt occupies indices ``0..num_tokens-1``, so the token's
        PRNG counter is ``num_tokens``."""
        params = [r.params for r in requests]
        temperature, top_p, min_p, top_k, seeds, counters = self._put(
            np.asarray([p.temperature for p in params], np.float32),
            np.asarray([p.top_p for p in params], np.float32),
            np.asarray([p.min_p for p in params], np.float32),
            np.asarray([p.top_k for p in params], np.int32),
            np.asarray([r.sample_seed for r in requests], np.int64),
            np.asarray([r.num_tokens for r in requests], np.int64),
        )
        return sample_tokens(
            logits, temperature, top_p, min_p, fold_row_keys(seeds, counters),
            top_k=top_k, all_greedy=all(p.temperature <= 0 for p in params),
        )

    def warmup(self) -> None:
        """Build the decode window outside the request path (the JAX
        ``warmup``'s decode-window part): run one eager step of each kind
        on trash-block inputs with ``steps_left = 0`` (which builds the
        kernels the step launches), then, on the GPU, capture the greedy
        and the sampled step as CUDA graphs. Every KV write lands in the
        trash block 0: the scheduler, the pool's other blocks,
        ``stats['generated_tokens']`` and every sampling stream stay as
        they were. Raises if a capture fails."""
        self._decode.warmup()

    @property
    def graph_pool_bytes(self) -> int:
        """Device bytes the captured decode graphs' private pool reserved
        (0 on the CPU)."""
        return self._decode.pool_bytes

    # --------------------------------------------------------------- decode
    def step(self) -> list[tuple[int, int]]:
        """One engine iteration: admit, then generate one window of up to
        ``decode_steps`` tokens per running sequence. Returns
        ``[(request_id, token)]`` in emission order."""
        emitted = self._admit()
        if self.sched.num_running == 0:
            return emitted
        window = self._dispatch_window()
        if window is not None:
            emitted.extend(self._process_window(window))
        return emitted

    def _window_budget(self, request: Request, k: int) -> int:
        """Tokens this request may still generate in a new window."""
        budget = min(
            request.params.max_tokens - len(request.output_ids),
            self.config.max_model_len - request.num_tokens,
        )
        return max(0, min(k, budget))

    def _on_preempt(self, request: Request) -> None:
        request.state = RequestState.WAITING
        self.stats['preemptions'] += 1

    def _dispatch_window(self) -> dict | None:
        """Reserve blocks (preempting the youngest on exhaustion), then
        dispatch one fused decode window. Returns the window record, or
        ``None`` when no running slot has budget left."""
        k = self.config.decode_steps
        kmax = 1
        for _, rid in self.sched.running():
            kmax = max(kmax, self._window_budget(self._requests[rid], k))
        try:
            preempted = self.sched.prepare_decode(kmax)
        except SchedulerExhausted as exc:
            # Victims moved before the fatal exhaustion stay moved: sync
            # their states so a caller that catches sees a consistent engine.
            for rid in exc.preempted:
                self._on_preempt(self._requests[rid])
            raise
        for rid in preempted:
            self._on_preempt(self._requests[rid])
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
        plan: list[tuple[int, int, int]] = []
        for slot, request in running:
            steps = self._window_budget(request, k)
            positions[slot] = request.num_tokens - 1
            context_lens[slot] = request.num_tokens
            block_tables[slot] = self._block_row(request.request_id)
            steps_left[slot] = steps
            temperature[slot] = request.params.temperature
            top_p[slot] = request.params.top_p
            min_p[slot] = request.params.min_p
            top_k[slot] = request.params.top_k
            seeds[slot] = request.sample_seed
            ids[slot] = (request.output_ids or request.prompt_ids)[-1]
            plan.append((slot, request.request_id, steps))
        num_steps = max(steps for _, _, steps in plan)
        if num_steps == 0:
            return None
        if not self._decode.ready:
            self.warmup()  # the first window on the GPU captures the graphs
        self._decode.load(ids, positions, context_lens, block_tables, steps_left,
                          temperature, top_p, min_p, top_k, seeds)
        tokens = self._decode.run(
            num_steps, all(r.params.temperature <= 0 for _, r in running)
        )
        self.stats['forward_passes'] += num_steps
        self.stats['decode_windows'] += 1
        return {'tokens': tokens, 'plan': plan}

    def _process_window(self, window: dict) -> list[tuple[int, int]]:
        """Fetch one window's tokens (the decode path's one host sync) and
        fold them into request state; tokens past a finish are dropped."""
        tokens = window['tokens'].cpu().numpy()  # [steps, B]
        emitted: list[tuple[int, int]] = []
        for slot, rid, steps in window['plan']:
            request = self._requests.get(rid)
            if request is None or request.state is not RequestState.RUNNING:
                continue
            for i in range(steps):
                token = int(tokens[i, slot])
                self._emit_token(request, token)
                emitted.append((rid, token))
                if rid not in self._requests:
                    break  # finished mid-window
        return emitted

    def _stop_ids(self, request: Request) -> set[int]:
        stops = set(request.params.stop_token_ids)
        eos = getattr(self.tokenizer, 'eos_id', None)
        if eos is not None:
            stops.add(eos)
        return stops

    def _emit_token(self, request: Request, token: int) -> None:
        request.output_ids.append(token)
        self.sched.append_token(request.request_id)
        self.stats['generated_tokens'] += 1
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
        self.sched.finish(request.request_id)
        del self._requests[request.request_id]
        self._finished[request.request_id] = request

    # -------------------------------------------------------------- offline
    def generate_ids(
        self,
        prompts: list[list[int]],
        params: 'SamplingParams | list[SamplingParams] | None' = None,
    ) -> list[list[int]]:
        """Offline batch API: token ids in, generated token ids out (stop
        token stripped). ``params`` is one ``SamplingParams`` for every
        prompt or a list parallel to ``prompts``."""
        per_prompt = params if isinstance(params, list) else [params] * len(prompts)
        if len(per_prompt) != len(prompts):
            raise ValueError('params list must parallel prompts')
        before = Counter(self.stats)
        ids = [self.add_request(p, sp) for p, sp in zip(prompts, per_prompt)]
        start = time.perf_counter()
        while self.has_unfinished:
            self.step()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        loop_s = time.perf_counter() - start
        run = self.stats - before
        self.telemetry = {
            key: value if isinstance(value, float) else int(value)
            for key, value in run.items()
        }
        self.telemetry.update(
            quantization=self.config.quantization,
            qmm_backend=self.qmm_backend,
            kv_cache_dtype=self.kv_cache_dtype,
            weight_bytes_quantized=self.weight_bytes_quantized,
            weight_bytes_float=self.weight_bytes_float,
        )
        self.telemetry['loop_s'] = loop_s
        if loop_s > 0:
            self.telemetry['tokens_per_s'] = run['generated_tokens'] / loop_s
        outs = []
        for rid in ids:
            request = self._finished.pop(rid)
            out = request.output_ids
            if out and out[-1] in self._stop_ids(request):
                out = out[:-1]
            outs.append(out)
        return outs

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
        memory pool."""
        self._decode.close()
        self.params = None
        self.kv = None
