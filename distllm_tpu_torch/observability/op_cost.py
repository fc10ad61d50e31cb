"""Measured per-dispatch cost of the engine's step shapes (the port's
counterpart of ``distllm_tpu.observability.xla_cost``).

The analytic roofline (``observability/roofline.py``) prices engine steps
from the parameter tree. The JAX module prices each compiled executable
from XLA's ``cost_analysis()``; PyTorch compiles nothing, so this module
counts what one eager pass of a step shape actually runs, once, when the
step is captured (:func:`count`):

- every PyTorch operator the pass dispatches, seen by a
  ``TorchDispatchMode``: its FLOPs from ``torch.utils.flop_counter``'s
  formulas (products, attention, convolutions; 0 for the rest) and its
  bytes, each tensor input read once and each output written once, with
  three exceptions: views and uninitialised allocations move nothing; an
  operator that writes into an argument (in place, a scatter such as a KV
  write into the pool, an ``out=``) reads its other tensor inputs and
  writes as many bytes, never the whole destination; a gather (index,
  ``index_select``, ``embedding``, ``gather``) reads the rows it returns
  and its indices, never the whole source;
- the hand-written kernels, which are ``ctypes`` calls no dispatch mode
  sees: each wrapper adds its kernel's own FLOPs and bytes through
  :func:`add_kernel_cost`, by the formulas of the kernel bounds that
  ``chip_smoke.py`` prints. K1 (paged attention) reports each launch's
  shape (:func:`add_attention_launch`): the pass is priced with every
  query row attending over its whole block table, the way XLA prices a
  padded attention, and :meth:`OpCost.at_lengths` re-prices K1 at the
  context lengths a window really ran (:func:`attention_work`, the
  bound's formula: each live key of each row read once).

A decode window is ``steps`` replays of the priced decode step, a verify
window one replay of the priced verify step, each with K1 re-priced at
the lengths the host staged for it. The engine publishes:

- ``distllm_engine_mfu_measured{kind}`` /
  ``distllm_engine_bandwidth_utilization_measured{kind}`` — the measured
  FLOPs and bytes of a window (K1 at its live lengths) over its wall time
  and the card's peaks (:func:`publish_measured`);
- ``distllm_engine_roofline_flops_ratio{kind}`` /
  ``distllm_engine_roofline_bytes_ratio{kind}`` — measured over analytic
  (:func:`record_calibration`);
- ``distllm_engine_kv_dispatch_bytes{kind}`` — the bytes of one dispatch
  of each priced kind at its padded shape (as XLA's ``cost_analysis``
  prices a compiled executable).
"""

from __future__ import annotations

import threading
from collections import Counter
from dataclasses import dataclass

import numpy as np

from distllm_tpu_torch.observability import instruments as _metrics

_local = threading.local()


@dataclass(frozen=True)
class AttentionLaunch:
    """The shape of one K1 launch of a priced pass: ``rows x span`` query
    positions, a block table of ``table_blocks`` blocks of ``block_size``
    a row, the head geometry, the element sizes of q and of the pool, an
    int8 pool's per-page scales, the sliding window (0: none)."""

    rows: int
    span: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    q_itemsize: int
    kv_itemsize: int
    table_blocks: int
    block_size: int
    int8_scales: bool
    window: int

    def padded_work(self) -> tuple[float, float]:
        """FLOPs and bytes with every row attending over its whole block
        table (the priced pass's own inputs are trash lengths)."""
        keys = self.table_blocks * self.block_size
        if self.window:
            keys = min(keys, self.window + self.span - 1)
        return paged_attention_cost(
            self.rows, self.span, self.num_heads, self.num_kv_heads, self.head_dim,
            keys, self.q_itemsize, self.kv_itemsize, self.rows * self.table_blocks,
            self.block_size, self.int8_scales,
        )


@dataclass(frozen=True)
class OpCost:
    """Cost of one pass of a step shape: total FLOPs and bytes moved
    (operator inputs and outputs, kernel traffic, K1 at its padded shape).
    ``source`` says how it was obtained (``'dispatch'``: an eager pass
    under :func:`count`); ``attention`` holds the pass's K1 launches, so
    :meth:`at_lengths` can price them at live lengths."""

    flops: float
    bytes_accessed: float
    source: str
    attention: tuple[AttentionLaunch, ...] = ()

    def to_dict(self) -> dict:
        return {
            'flops': self.flops,
            'bytes_accessed': self.bytes_accessed,
            'source': self.source,
        }

    def at_lengths(self, context_lens, q_lens=None) -> 'OpCost':
        """The cost of ``len(context_lens)`` passes of this shape with K1
        at live lengths: ``context_lens[p]`` holds each row's context
        length in pass ``p`` (the query tokens included) and ``q_lens[p]``
        its query tokens (default 1 a row, a decode step; 0 idles the
        row). Everything but K1 costs what the priced pass did."""
        context_lens = np.asarray(context_lens, np.int64)
        passes = context_lens.shape[0]
        if q_lens is None:
            q_lens = np.ones_like(context_lens)
        flops, bytes_ = self.flops * passes, self.bytes_accessed * passes
        # A pass launches K1 once a layer, at one or two shapes: price each
        # shape once.
        for launch, times in Counter(self.attention).items():
            pad_flops, pad_bytes = launch.padded_work()
            live_flops, live_bytes = attention_work(launch, context_lens, q_lens)
            flops += times * (live_flops - pad_flops * passes)
            bytes_ += times * (live_bytes - pad_bytes * passes)
        return OpCost(flops, bytes_, self.source, self.attention)


def counting() -> bool:
    """Whether a :func:`count` is running on this thread (kernel wrappers
    skip pricing otherwise)."""
    return bool(getattr(_local, 'stack', None))


def add_kernel_cost(flops: float, bytes_accessed: float) -> None:
    """Add a hand-written kernel's work to every :func:`count` running on
    this thread (a no-op outside one). Kernel wrappers call it where they
    launch."""
    for counter in getattr(_local, 'stack', ()):
        counter.flops += flops
        counter.bytes += bytes_accessed


def add_attention_launch(launch: AttentionLaunch) -> None:
    """Add a K1 launch to every :func:`count` running on this thread, at
    its padded price, and keep its shape for :meth:`OpCost.at_lengths`."""
    add_kernel_cost(*launch.padded_work())
    for counter in getattr(_local, 'stack', ()):
        counter.attention.append(launch)


def decode_lengths(context_lens, steps_left, steps: int) -> np.ndarray:
    """``[steps, rows]`` context lengths of a decode window's steps: a
    row stops advancing when its ``steps_left`` run out (its later steps
    still attend over its last length)."""
    ctx = np.asarray(context_lens, np.int64)
    advanced = np.minimum(np.arange(steps)[:, None], np.asarray(steps_left, np.int64)[None])
    return ctx[None] + advanced


def attention_work(launch: AttentionLaunch, context_lens, q_lens) -> tuple[float, float]:
    """K1's FLOPs and bytes over live lengths, the formula of its bound
    in ``chip_smoke.py``: the queries of a row of ``ctx`` keys and ``n``
    query tokens sit at positions ``ctx - n .. ctx - 1`` and each attends
    ``min(position + 1, window)`` keys (4 * head_dim FLOPs per query head
    and key); each row reads its live K and V once (from the first key
    its first query sees), an int8 pool's fp32 scales of those pages; q
    read and the output written once, the block table and the three
    per-row int32 vectors, for every row of every pass. ``context_lens``
    and ``q_lens`` are ``[passes, rows]`` (rows with ``n`` 0 attend
    nothing)."""
    ctx = np.asarray(context_lens, np.int64)
    n = np.asarray(q_lens, np.int64)
    live = n > 0
    start = ctx - n  # the first query's position
    window = launch.window if launch.window else np.iinfo(np.int64).max // 4
    # Sum over the row's queries of min(start + 1 + j, window), j < n.
    uncapped = np.clip(window - start, 0, n)
    keys = uncapped * (start + 1) + uncapped * (uncapped - 1) // 2 + (n - uncapped) * window
    first_lo = np.maximum(start - window + 1, 0)
    kv_row = launch.num_kv_heads * launch.head_dim * launch.kv_itemsize * 2
    flops = 4.0 * launch.num_heads * launch.head_dim * float(keys[live].sum())
    bytes_ = float(((ctx - first_lo)[live]).sum()) * kv_row
    if launch.int8_scales:
        bs = launch.block_size
        pages = -(-ctx // bs) - first_lo // bs
        bytes_ += float(pages[live].sum()) * launch.num_kv_heads * 4 * 2
    passes = ctx.shape[0]
    per_pass = (2.0 * launch.rows * launch.span * launch.num_heads * launch.head_dim
                * launch.q_itemsize + launch.rows * launch.table_blocks * 4
                + 3 * launch.rows * 4)
    return flops, bytes_ + per_pass * passes


def paged_attention_cost(
    rows: int, span: int, num_heads: int, num_kv_heads: int, head_dim: int,
    keys: int, q_itemsize: int, kv_itemsize: int, table_entries: int,
    block_size: int, int8_scales: bool,
) -> tuple[float, float]:
    """K1's FLOPs and bytes at its shape: ``rows x span`` queries, each
    attending over ``keys`` keys (4 * head_dim FLOPs per query head and
    key); q read and the output written once, each row's K and V read
    once, the block table and the three per-row int32 vectors, and an
    int8 pool's fp32 scale per page, KV head, K and V."""
    flops = 4.0 * rows * span * num_heads * keys * head_dim
    bytes_ = 2.0 * rows * span * num_heads * head_dim * q_itemsize
    bytes_ += rows * keys * num_kv_heads * head_dim * kv_itemsize * 2
    bytes_ += table_entries * 4 + 3 * rows * 4
    if int8_scales:
        bytes_ += rows * -(-keys // block_size) * num_kv_heads * 4 * 2
    return flops, bytes_


# Operators that allocate without writing or only make views: no bytes.
_NO_TRAFFIC = frozenset({
    'aten::empty', 'aten::empty_like', 'aten::empty_strided', 'aten::new_empty',
    'aten::new_empty_strided', 'aten::_local_scalar_dense', 'aten::detach',
    'aten::lift_fresh', 'aten::alias', 'aten::set_',
})
# Gathers: they read the rows they return (and their indices), not the
# whole source.
_GATHERS = frozenset({'aten::index', 'aten::index_select', 'aten::embedding', 'aten::gather'})


def _tensor_bytes(values) -> int:
    """Bytes of the tensors among ``values`` and one level of the lists,
    tuples and dicts in them (operator arguments nest no deeper)."""
    import torch

    total = 0
    for value in values:
        if isinstance(value, torch.Tensor):
            total += value.numel() * value.element_size()
        elif isinstance(value, (list, tuple)):
            total += sum(v.numel() * v.element_size() for v in value
                         if isinstance(v, torch.Tensor))
        elif isinstance(value, dict):
            total += _tensor_bytes(value.values())
    return total


# Per operator: (moves nothing, the positions and names of the arguments
# it writes, whether it gathers), read from its schema once.
_SCHEMAS: dict = {}


def _schema_of(func) -> tuple:
    info = _SCHEMAS.get(func)
    if info is None:
        name = func.name().split('.')[0]
        arguments = func._schema.arguments
        written = frozenset(
            i for i, arg in enumerate(arguments)
            if arg.alias_info is not None and arg.alias_info.is_write
        )
        info = _SCHEMAS[func] = (
            func.is_view or name in _NO_TRAFFIC,
            written,
            frozenset(arguments[i].name for i in written),
            name in _GATHERS,
            name == 'aten::embedding',
        )
    return info


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one operator moves (the rules of the module docstring)."""
    silent, written, written_names, gather, embedding = _schema_of(func)
    if silent:
        return 0
    if written:
        read = _tensor_bytes(a for i, a in enumerate(args) if i not in written)
        read += _tensor_bytes(v for k, v in kwargs.items() if k not in written_names)
        return 2 * read if read else _tensor_bytes((out,))
    if gather:
        indices = (args[1],) if embedding else (*args[1:], *kwargs.values())
        return 2 * _tensor_bytes((out,)) + _tensor_bytes(indices)
    return _tensor_bytes(args) + _tensor_bytes(kwargs.values()) + _tensor_bytes((out,))


_MODE_CLASS = None


def _counting_mode(counter):
    """A ``TorchDispatchMode`` that adds each operator's FLOPs and bytes
    to ``counter`` (the class built on first use: ``torch`` loads
    lazily)."""
    global _MODE_CLASS
    if _MODE_CLASS is None:
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        class _Counting(TorchDispatchMode):
            def __init__(self, counter):
                super().__init__()
                self.counter = counter

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                formula = flop_registry.get(func._overloadpacket)
                if formula is not None:
                    self.counter.flops += formula(*args, **kwargs, out_val=out)
                self.counter.bytes += op_bytes(func, args, kwargs, out)
                return out

        _MODE_CLASS = _Counting
    return _MODE_CLASS(counter)


class _Counter:
    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0
        self.attention: list[AttentionLaunch] = []


def count(fn, *args, **kwargs) -> tuple[OpCost, object]:
    """Run ``fn(*args, **kwargs)`` once, counting the FLOPs and bytes of
    every operator it dispatches and of every kernel whose wrapper reports
    through :func:`add_kernel_cost`; returns ``(cost, fn's result)``."""
    counter = _Counter()
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    stack.append(counter)
    try:
        with _counting_mode(counter):
            result = fn(*args, **kwargs)
    finally:
        stack.remove(counter)
    return OpCost(counter.flops, counter.bytes, 'dispatch', tuple(counter.attention)), result


def publish_measured(
    kind: str,
    cost: OpCost,
    duration_s: float,
    peak_flops: float,
    peak_hbm_bytes: float,
) -> tuple[float, float]:
    """Set the measured utilization gauges for one dispatch; returns
    ``(mfu, bw_util)``, uncapped as the analytic gauges are (a reading
    above 1 indicts the peak table, and a clamp would hide it)."""
    if duration_s <= 0 or peak_flops <= 0 or peak_hbm_bytes <= 0:
        return 0.0, 0.0
    mfu = cost.flops / duration_s / peak_flops
    bw_util = cost.bytes_accessed / duration_s / peak_hbm_bytes
    _metrics.ENGINE_MFU_MEASURED.labels(kind=kind).set(mfu)
    _metrics.ENGINE_BW_UTIL_MEASURED.labels(kind=kind).set(bw_util)
    return mfu, bw_util


def record_calibration(
    kind: str, analytic_flops: float, analytic_bytes: float, cost: OpCost
) -> tuple[float | None, float | None]:
    """Set the measured / analytic ratio gauges for one dispatch; returns
    ``(flops_ratio, bytes_ratio)`` (``None`` where the analytic side is
    zero)."""
    flops_ratio = bytes_ratio = None
    if analytic_flops > 0:
        flops_ratio = cost.flops / analytic_flops
        _metrics.ENGINE_ROOFLINE_FLOPS_RATIO.labels(kind=kind).set(flops_ratio)
    if analytic_bytes > 0 and cost.bytes_accessed > 0:
        bytes_ratio = cost.bytes_accessed / analytic_bytes
        _metrics.ENGINE_ROOFLINE_BYTES_RATIO.labels(kind=kind).set(bytes_ratio)
    return flops_ratio, bytes_ratio
