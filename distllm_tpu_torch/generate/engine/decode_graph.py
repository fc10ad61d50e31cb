"""The decode window as one device program: one decode step captured as a
CUDA graph and replayed once per step of every window — the port's
counterpart of the JAX engine's jitted ``lax.scan`` window
(``distllm_tpu.models.mistral.decode_loop``, compiled once at fixed
shapes).

:class:`DecodeGraphRunner` owns, for one engine:

- static device buffers for every window input (the host's last ``ids``
  with a ``take_host`` row mask, ``positions``, ``context_lens``,
  ``block_tables [max_num_seqs, max_blocks_per_seq]``, ``steps_left``,
  ``temperature``, ``top_p``, ``min_p``, ``top_k``, ``seeds``) and the
  window's step counter, all views of ONE device buffer that
  :meth:`~DecodeGraphRunner.load` fills from one pinned host buffer (one
  whose last copy has completed, so staging never waits on a window in
  flight) in one non-blocking copy;
- the carry: ``positions``, ``context_lens`` and ``steps_left`` are
  advanced in place by each step
  (:func:`~distllm_tpu_torch.models.mistral.decode_window_step`) and
  restaged by the next window; the last ids live in their own buffer
  (``DecodeGraphRunner.ids``), into which a window's load merges the
  host's id only for the rows marked ``take_host`` — the pipelined loop's
  device-side carry (the JAX engine's ``jnp.where(mask, host_ids,
  carried)``), so a continuing row keeps the token the host has not
  fetched yet;
- the token buffer ``[decode_steps, max_num_seqs]`` (each step writes its
  row, picked by the device-side step counter), pinned host copies of
  it, one per window in flight
  (:meth:`~DecodeGraphRunner.stage_tokens` /
  :meth:`~DecodeGraphRunner.fetch_tokens`), and the RoPE tables, made
  once per engine;
- on CUDA, one captured graph per value of ``all_greedy`` (greedy rows
  skip the sampling filter), both captured by
  :meth:`~DecodeGraphRunner.warmup` into one private memory pool.

:meth:`~DecodeGraphRunner.run` replays the graph ``num_steps`` times on
CUDA: no Python per layer and no kernel wrapper's host work. A runner
made with ``capture=False`` (a tensor-parallel engine over gloo, whose
collectives cannot be captured) runs the step eagerly on CUDA too, as it
does on the CPU; that is the caller's choice of backend, stated in the
engine's stats, not a fallback. The eager
warm-up step is priced once (:mod:`~distllm_tpu_torch.observability.op_cost`:
``step_cost``) and each capture is a start-up phase. On the CPU it
runs the same step eagerly over the same buffers (how the tests reach the
buffer and carry logic without a card). On CUDA it always replays: a
capture or replay that fails raises with the CUDA error, and nothing
gives way to the eager step.

Kernel counters. The kernel wrappers tick Python counters as they launch
(``launches``, ``launches_by_route``, ``launches_by_kv``, and the plain
versions' ``launches``; each ops module lists its own in ``COUNTERS``); a
replay runs no Python. :func:`capture_step` records each counter's change
while the step is captured, takes it back (a capture launches nothing),
and :class:`CapturedStep` adds it once per replay, so the counts stay
those of kernels launched on the device.
"""

from __future__ import annotations

import gc
import time
from collections import Counter

import numpy as np
import torch

from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.observability import op_cost
from distllm_tpu_torch.observability.startup import get_compile_watcher
from distllm_tpu_torch.ops import encoder_attention, paged_attention, quantized_matmul

# Every kernel counter of the port, each list kept by the module that
# ticks it: (function, attribute), the value an int or a dict of ints.
COUNTERS = (
    paged_attention.COUNTERS + quantized_matmul.COUNTERS + encoder_attention.COUNTERS
)


def read_counters() -> list:
    """A copy of every counter of :data:`COUNTERS`, in order."""
    return [
        dict(value) if isinstance(value, dict) else value
        for value in (getattr(fn, name) for fn, name in COUNTERS)
    ]


def counter_delta(before: list, after: list) -> list:
    """``after - before`` per counter (dicts key by key)."""
    return [
        {key: count - b.get(key, 0) for key, count in a.items()}
        if isinstance(a, dict) else a - b
        for b, a in zip(before, after)
    ]


def add_counters(delta: list, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the live counters, dicts in place (a
    caller may have rebound a dict since the capture: the current one is
    updated)."""
    for (fn, name), change in zip(COUNTERS, delta):
        if isinstance(change, dict):
            counts = getattr(fn, name)
            for key, count in change.items():
                if count:
                    counts[key] = counts.get(key, 0) + times * count
        elif change:
            setattr(fn, name, getattr(fn, name) + times * change)


class CapturedStep:
    """A captured decode step: :meth:`replay` launches the graph and adds
    the counters' captured change once."""

    def __init__(self, graph, delta: list) -> None:
        self.graph = graph
        self.delta = delta

    def replay(self) -> None:
        self.graph.replay()
        add_counters(self.delta)


def capture_step(step, graph, capturing) -> CapturedStep:
    """Run ``step()`` inside the context ``capturing`` (on CUDA,
    ``torch.cuda.graph(graph, ...)``) and return it as a
    :class:`CapturedStep`, with the counters as they were before (what the
    wrappers counted was captured, not launched), whether or not the
    capture succeeds.

    The garbage collector runs first and is held off until the capture
    ends: an unreachable cycle that holds another CUDA graph (an engine
    never shut down) would otherwise be collected mid-capture, and
    destroying a graph while a stream captures invalidates the capture."""
    before = read_counters()
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with capturing:
            step()
    finally:
        if collecting:
            gc.enable()
        delta = counter_delta(before, read_counters())
        add_counters(delta, times=-1)
    return CapturedStep(graph, delta)


# One side stream per device for warm-up steps and captures, shared by
# every engine: PyTorch keeps a cuBLAS workspace for each stream that ran a
# product, for the life of the process, so a stream per engine would leak
# one workspace per engine.
_capture_streams: dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> 'torch.cuda.Stream':
    index = torch.cuda.current_device() if device.index is None else device.index
    stream = _capture_streams.get(index)
    if stream is None:
        stream = _capture_streams[index] = torch.cuda.Stream(index)
    return stream


class _GraphRunner:
    """What the decode and the verify runner share: static device buffers
    for every input of a step, views of ONE device buffer that
    :meth:`load` fills from one pinned host buffer in one non-blocking
    copy; one captured graph of the step per value of ``all_greedy``, in a
    private memory pool; the capture's stats. A subclass names its input
    ``FIELDS``, its stats prefix ``KIND``, and defines ``_step(all_greedy)``
    and ``_load_trash()`` (inputs that write only the trash block 0)."""

    FIELDS: tuple = ()  # (name, dtype, shape from (b, mb, s))
    KIND = ''
    PHASE = ''  # the start-up phase kind of the capture

    def __init__(
        self,
        params: dict,
        model_cfg: mistral.MistralConfig,
        k_cache,
        v_cache,
        *,
        max_num_seqs: int,
        max_blocks_per_seq: int,
        max_table_positions: int,
        attn_backend: str,
        device: torch.device,
        sampling_top_window: int = 0,
        span: int = 1,
        stats: Counter | None = None,
        capture: bool = True,
    ) -> None:
        self.params = params
        # Whether the step is captured on CUDA (eager otherwise).
        self.capture = capture and device.type == 'cuda'
        self.model_cfg = model_cfg
        self.k_cache, self.v_cache = k_cache, v_cache
        self.attn_backend = attn_backend
        self.device = device
        self.sampling_top_window = sampling_top_window
        self.stats = Counter() if stats is None else stats
        dims = {'b': max_num_seqs, 'mb': max_blocks_per_seq, 's': span}
        spans, words = [], 0
        for name, dtype, shape in self.FIELDS:
            shape = tuple(dims[d] if isinstance(d, str) else d for d in shape)
            n = int(np.prod(shape)) * dtype.itemsize // 4
            spans.append((name, dtype, shape, words, n))
            words += n
        # Pinned staging buffers, each with the event of the last copy that
        # read it: staging takes one whose copy has completed (growing the
        # set when none has), so it never waits on a copy queued behind a
        # window still in flight.
        self._spans, self._words = spans, words
        self._staging: list[torch.Tensor] = []
        self._staging_views: list[dict] = []
        self._staging_copied: list = []
        for _ in range(2):  # more are made while every one is in use
            self._add_staging()
        self._host = self._staging[0]  # the buffer staged last
        self._host_views = self._staging_views[0]
        self._dev = torch.zeros(words, dtype=torch.int32, device=device)
        self.buffers = {
            name: self._dev[at:at + n].view(dtype).view(shape)
            for name, dtype, shape, at, n in spans
        }
        self.cos, self.sin = mistral._rope_tables(model_cfg, max_table_positions, device)
        self.graphs: dict[bool, CapturedStep] = {}
        self._warm = False
        self._pool = None
        self._stream = None
        self.pool_bytes = 0
        # What one pass of the step costs (observability.op_cost), counted
        # on the eager greedy warm-up step; None before warmup.
        self.step_cost: op_cost.OpCost | None = None

    @property
    def ready(self) -> bool:
        """Whether the runner can serve: eager (the CPU, or
        ``capture=False``) always, captured once :meth:`warmup` has
        captured both graphs."""
        return not self.capture or len(self.graphs) == 2

    def _add_staging(self) -> int:
        host = torch.zeros(self._words, dtype=torch.int32,
                           pin_memory=self.device.type == 'cuda')
        self._staging.append(host)
        self._staging_views.append({
            name: host.numpy()[at:at + n]
            .view(np.dtype(str(dtype).removeprefix('torch.'))).reshape(shape)
            for name, dtype, shape, at, n in self._spans
        })
        self._staging_copied.append(None)
        return len(self._staging) - 1

    def _stage(self, values: dict) -> None:
        """Write ``values`` (name -> array) into a pinned host buffer no
        copy still reads and copy it to the device in one non-blocking
        copy: the host never waits on a window in flight."""
        i = next(
            (j for j, event in enumerate(self._staging_copied)
             if event is None or event.query()),
            None,
        )
        if i is None:
            i = self._add_staging()
        self._host, self._host_views = self._staging[i], self._staging_views[i]
        for name, value in values.items():
            self._host_views[name][...] = value
        self._dev.copy_(self._host, non_blocking=True)
        if self.device.type == 'cuda':
            event = torch.cuda.Event()
            event.record()
            self._staging_copied[i] = event

    def _step(self, all_greedy: bool) -> None:
        raise NotImplementedError

    def _load_trash(self) -> None:
        raise NotImplementedError

    def _rewind(self) -> None:
        """Undo what an eager warm-up step advanced in the static buffers
        (a device op on the step's stream), so the next one starts as the
        first did."""

    def warmup(self) -> None:
        """Build the step outside the request path. On CUDA: run one eager
        step of each kind on trash-block inputs — PyTorch's rule before a
        capture; it also builds every kernel the step launches
        (``ops._build``, at first use), loads it and makes K1's split
        tickets outside any capture — then capture the greedy and the
        sampled step. On the CPU (or with ``capture=False``) the eager
        steps alone. Scheduler state, the pool outside block 0 and every
        sampling stream stay as they were."""
        if self._warm:
            return
        if not self.capture:
            self._load_trash()
            self._eager_warm_steps()
            self._warm = True
            return
        with torch.cuda.device(self.device):
            self._stream = _capture_stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
            self._load_trash()
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                self._eager_warm_steps()
            torch.cuda.current_stream().wait_stream(self._stream)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            b = self.buffers['block_tables'].shape[0]
            try:
                with get_compile_watcher().phase(
                    self.PHASE, f'b{b}', scope=f'{self.KIND}-{id(self)}',
                ):
                    for all_greedy in (True, False):
                        graph = torch.cuda.CUDAGraph()
                        self.graphs[all_greedy] = capture_step(
                            lambda g=all_greedy: self._step(g), graph,
                            torch.cuda.graph(graph, pool=self._pool, stream=self._stream),
                        )
                        self.stats[f'{self.KIND}_graph_captures'] += 1
                    torch.cuda.synchronize()
            except BaseException:
                self._release()
                raise
            self.stats[f'{self.KIND}_graph_capture_s'] += time.perf_counter() - t0
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self._warm = True

    def _eager_warm_steps(self) -> None:
        """The eager greedy and sampled steps on the trash inputs, the
        greedy one counted into :attr:`step_cost` (the step shape's price,
        at its capture)."""
        self.step_cost, _ = op_cost.count(self._step, True)
        self._rewind()
        self._step(False)
        self._rewind()

    def _replay(self, all_greedy: bool, times: int) -> None:
        """``times`` replays of the captured step (CUDA; raises before
        :meth:`warmup`), or the eager step on the CPU and without
        ``capture``."""
        if not self.capture:
            for _ in range(times):
                self._step(all_greedy)
            return
        captured = self.graphs.get(all_greedy)
        if captured is None:
            raise RuntimeError(
                f'the {self.KIND} graphs are not captured: call warmup() first'
            )
        with torch.cuda.device(self.device):
            for _ in range(times):
                captured.replay()
        self.stats[f'{self.KIND}_graph_replays'] += times

    def _release(self) -> None:
        for captured in self.graphs.values():
            captured.graph.reset()
        self.graphs.clear()
        self._pool = self._stream = None
        self.pool_bytes = 0

    def close(self) -> None:
        """Release the graphs and their memory pool."""
        self._release()
        self._staging_copied = [None] * len(self._staging)
        self.params = self.k_cache = self.v_cache = None


class DecodeGraphRunner(_GraphRunner):
    """Static buffers, the carry and the captured decode step of one
    engine (see the module docstring). ``k_cache`` / ``v_cache`` are the
    engine's pools (bare tensors or ``QuantizedKV``), written in place;
    ``stats`` is the engine's counter, which gains
    ``decode_graph_captures``, ``decode_graph_replays`` and
    ``decode_graph_capture_s``."""

    KIND = 'decode'
    PHASE = 'decode_window'
    # (name, dtype, shape): the 8-byte fields first, so each int64 view of
    # the int32 buffer starts on an 8-byte boundary. The staged 'ids' are
    # the host's last ids and 'take_host' marks the rows that take them;
    # the carry itself (self.ids, buffers['ids']) lives outside the staged
    # buffer.
    FIELDS = (
        ('seeds', torch.int64, ('b',)),
        ('step', torch.int64, (1,)),
        ('ids', torch.int32, ('b',)),
        ('take_host', torch.int32, ('b',)),
        ('positions', torch.int32, ('b',)),
        ('context_lens', torch.int32, ('b',)),
        ('steps_left', torch.int32, ('b',)),
        ('top_k', torch.int32, ('b',)),
        ('temperature', torch.float32, ('b',)),
        ('top_p', torch.float32, ('b',)),
        ('min_p', torch.float32, ('b',)),
        ('block_tables', torch.int32, ('b', 'mb')),
    )

    def __init__(self, params, model_cfg, k_cache, v_cache, *, decode_steps: int,
                 max_num_seqs: int, **kwargs) -> None:
        super().__init__(params, model_cfg, k_cache, v_cache,
                         max_num_seqs=max_num_seqs, **kwargs)
        self.decode_steps = decode_steps
        # The carry of last ids, across windows: each step advances it in
        # place, and a window's load merges in the rows that take the
        # host's id (fresh admissions, a drained pipeline). buffers['ids']
        # is the carry; the staged host ids stay in their own view.
        self._host_ids = self.buffers['ids']
        self.ids = torch.zeros(max_num_seqs, dtype=torch.int32, device=self.device)
        self.buffers['ids'] = self.ids
        self.token = torch.zeros(max_num_seqs, dtype=torch.int32, device=self.device)
        self.tokens = torch.zeros((decode_steps, max_num_seqs), dtype=torch.int32,
                                  device=self.device)
        # The token buffers: each window's tokens are copied out of the
        # token buffer (to pinned host memory on CUDA, with an event) before
        # the next window's steps can overwrite it; a buffer is free again
        # once its window is fetched, and more are made while every one
        # holds a window in flight (deferred prefill records let more than
        # pipeline_depth windows be in flight).
        self._tok_host: list[torch.Tensor] = []
        self._tok_free: list[int] = []
        for _ in range(2):
            self._tok_free.append(self._add_token_buffer())

    # ---------------------------------------------------------------- inputs
    def load(
        self,
        ids: np.ndarray,
        positions: np.ndarray,
        context_lens: np.ndarray,
        block_tables: np.ndarray,
        steps_left: np.ndarray,
        temperature: np.ndarray,
        top_p: np.ndarray,
        min_p: np.ndarray,
        top_k: np.ndarray,
        seeds: np.ndarray,
        take_host: 'np.ndarray | None' = None,
    ) -> None:
        """Stage one window's inputs (``[max_num_seqs]`` each,
        ``block_tables [max_num_seqs, max_blocks_per_seq]``) into the
        static buffers: one pinned host buffer, one non-blocking copy. The
        step counter restarts at 0. Then, on the device, each row marked in
        ``take_host`` (None: every row) takes ``ids`` into the carry and
        every other row keeps its carried last id: the pipelined loop's
        merge, for rows whose last tokens the host has not fetched yet."""
        take = np.ones(ids.shape, np.int32) if take_host is None else take_host
        self._stage(dict(
            ids=ids, positions=positions, context_lens=context_lens,
            block_tables=block_tables, steps_left=steps_left,
            temperature=temperature, top_p=top_p, min_p=min_p, top_k=top_k,
            seeds=seeds, step=0, take_host=take,
        ))
        buf = self.buffers
        self.ids.copy_(torch.where(buf['take_host'] != 0, self._host_ids, self.ids))

    def scatter_ids(self, slots: torch.Tensor, tokens: torch.Tensor) -> None:
        """Write ``tokens`` into the carry at ``slots`` on the device (a
        deferred prefill's first tokens, which the host fetches later)."""
        self.ids.index_copy_(0, slots, tokens.to(torch.int32))

    def _load_trash(self) -> None:
        """Inputs that touch no state: every table row at the trash block
        0 and ``steps_left = 0``, so every KV write lands in block 0 and the
        carry keeps its ids (a deferred prefill may have scattered some)."""
        b, mb = self.buffers['block_tables'].shape
        zeros = np.zeros((b,), np.int32)
        self.load(
            zeros, zeros, np.ones((b,), np.int32), np.zeros((b, mb), np.int32),
            zeros, np.zeros((b,), np.float32), np.ones((b,), np.float32),
            np.zeros((b,), np.float32), zeros, np.zeros((b,), np.int64),
            take_host=zeros,
        )

    def _rewind(self) -> None:
        # The step counter picks the token buffer's row: two eager steps
        # from one load would write row 1, past the buffer at
        # decode_steps = 1.
        self.buffers['step'].zero_()

    # ------------------------------------------------------------------ step
    def _step(self, all_greedy: bool) -> None:
        """One decode+sample step over the static buffers: the carry
        advances in place and the token lands in row ``step`` of
        ``tokens``."""
        buf = self.buffers
        mistral.decode_window_step(
            self.params, self.model_cfg, self.k_cache, self.v_cache,
            buf['block_tables'], buf['ids'], buf['positions'], buf['context_lens'],
            buf['steps_left'], buf['temperature'], buf['top_p'], buf['min_p'],
            buf['top_k'], buf['seeds'], self.token, self.cos, self.sin,
            attn_backend=self.attn_backend, all_greedy=all_greedy,
            sampling_top_window=self.sampling_top_window,
        )
        self.tokens.index_copy_(0, buf['step'], self.token[None])
        buf['step'].add_(1)

    def run(self, num_steps: int, all_greedy: bool) -> torch.Tensor:
        """``num_steps`` decode steps over the loaded window: graph
        replays on CUDA (after :meth:`warmup`; raises without it), the
        eager step on the CPU. Returns ``tokens [num_steps, max_num_seqs]``
        int32, a view of the token buffer valid until the next window."""
        if not 0 < num_steps <= self.decode_steps:
            raise ValueError(f'num_steps must be in 1..{self.decode_steps}, got {num_steps}')
        self._replay(all_greedy, num_steps)
        return self.tokens[:num_steps]

    def _add_token_buffer(self) -> int:
        self._tok_host.append(torch.zeros(
            self.tokens.shape, dtype=torch.int32, pin_memory=self.device.type == 'cuda',
        ))
        return len(self._tok_host) - 1

    def stage_tokens(self, num_steps: int) -> tuple:
        """Copy the last :meth:`run`'s tokens into a free token buffer
        (device -> pinned host, non-blocking, with an event, on CUDA)
        before another window can overwrite the token buffer; returns the
        handle :meth:`fetch_tokens` takes."""
        i = self._tok_free.pop() if self._tok_free else self._add_token_buffer()
        cuda = self.device.type == 'cuda'
        self._tok_host[i][:num_steps].copy_(self.tokens[:num_steps], non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return i, event, num_steps

    def fetch_tokens(self, handle: tuple) -> np.ndarray:
        """The ``[num_steps, max_num_seqs]`` tokens of a staged window (the
        window's one host sync: its event); frees its buffer."""
        i, event, num_steps = handle
        if event is not None:
            event.synchronize()
        tokens = self._tok_host[i][:num_steps].numpy().copy()
        self._tok_free.append(i)
        return tokens


class VerifyGraphRunner(_GraphRunner):
    """The speculative verify window as one device program: static
    buffers for the ``[max_num_seqs, 1 + draft_k]`` verify spans and their
    sampling inputs, the packed result ``[max_num_seqs, 2 + draft_k]``,
    and on CUDA one captured graph of
    :func:`~distllm_tpu_torch.models.mistral.verify_window_step` (the verify
    half of ``mistral.spec_window``: ``prefill_paged(all_logits=True)``
    and ``verify_spans``) per value of ``all_greedy``, in its own private
    pool — the counterpart of the JAX engine's one compiled ``spec_fn``
    shape. Rows of shorter spans pad through ``span_lens``; inactive rows
    carry span 0 and an all-trash table. ``stats`` gains
    ``verify_graph_captures``, ``verify_graph_replays`` and
    ``verify_graph_capture_s``."""

    KIND = 'verify'
    PHASE = 'spec_window'
    FIELDS = (
        ('seeds', torch.int64, ('b',)),
        ('ids', torch.int32, ('b', 's')),
        ('positions', torch.int32, ('b', 's')),
        ('context_lens', torch.int32, ('b',)),
        ('span_lens', torch.int32, ('b',)),
        ('top_k', torch.int32, ('b',)),
        ('temperature', torch.float32, ('b',)),
        ('top_p', torch.float32, ('b',)),
        ('min_p', torch.float32, ('b',)),
        ('block_tables', torch.int32, ('b', 'mb')),
    )

    def __init__(self, params, model_cfg, k_cache, v_cache, *, max_num_seqs: int,
                 span: int, **kwargs) -> None:
        super().__init__(params, model_cfg, k_cache, v_cache,
                         max_num_seqs=max_num_seqs, span=span, **kwargs)
        self.span = span
        self.packed = torch.zeros((max_num_seqs, span + 1), dtype=torch.int32,
                                  device=self.device)

    def load(
        self,
        ids: np.ndarray,
        positions: np.ndarray,
        block_tables: np.ndarray,
        context_lens: np.ndarray,
        span_lens: np.ndarray,
        temperature: np.ndarray,
        top_p: np.ndarray,
        min_p: np.ndarray,
        top_k: np.ndarray,
        seeds: np.ndarray,
    ) -> None:
        """Stage one verify window (the engine's span arrays, then the
        per-row sampling inputs) in one pinned copy."""
        self._stage(dict(
            ids=ids, positions=positions, block_tables=block_tables,
            context_lens=context_lens, span_lens=span_lens,
            temperature=temperature, top_p=top_p, min_p=min_p, top_k=top_k,
            seeds=seeds,
        ))

    def _load_trash(self) -> None:
        """Every row inactive: span 0, tables at the trash block 0."""
        b, s = self.buffers['ids'].shape
        mb = self.buffers['block_tables'].shape[1]
        zeros = np.zeros((b,), np.int32)
        self.load(
            np.zeros((b, s), np.int32), np.zeros((b, s), np.int32),
            np.zeros((b, mb), np.int32), np.ones((b,), np.int32), zeros,
            np.zeros((b,), np.float32), np.ones((b,), np.float32),
            np.zeros((b,), np.float32), zeros, np.zeros((b,), np.int64),
        )

    def _step(self, all_greedy: bool) -> None:
        buf = self.buffers
        mistral.verify_window_step(
            self.params, self.model_cfg, self.k_cache, self.v_cache,
            buf['ids'], buf['positions'], buf['block_tables'], buf['context_lens'],
            buf['span_lens'], buf['temperature'], buf['top_p'], buf['min_p'],
            buf['top_k'], buf['seeds'], self.packed, self.cos, self.sin,
            attn_backend=self.attn_backend, all_greedy=all_greedy,
            sampling_top_window=self.sampling_top_window,
        )

    def run(self, all_greedy: bool) -> torch.Tensor:
        """One verify pass over the loaded spans: one graph replay on CUDA
        (after :meth:`warmup`; raises without it), the eager step on the
        CPU. Returns the packed ``[max_num_seqs, span + 1]`` int32 result,
        the runner's buffer, valid until the next window."""
        self._replay(all_greedy, 1)
        return self.packed
