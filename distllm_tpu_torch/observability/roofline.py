"""Analytic roofline accounting for the serving engine (the port of
``distllm_tpu.observability.roofline``, with the card's own peaks).

Turns per-window wall times into *utilization*: achieved matmul FLOP/s
over the card's bf16 dense peak (MFU; prefill lives on this roof), and
weight bytes streamed from HBM per second over the card's HBM rate
(decode lives on this roof: every decode step re-reads the whole weight
set to emit one token per row).

The model is a *weight-stream* roofline: attention KV traffic and
activation bytes are left out, so the bandwidth share is a lower bound.
FLOPs are ``2 * n_params`` per scored token (matmuls only). For a
Mixtral tree that counts all 8 experts of every layer, not the 2 a
token is routed to: both packages compute every expert as dense
products (``models/mixtral.moe_mlp``), so that is the work done, the
JAX formula kept.

Costs come from the engine's *actual* parameter tree — ``numel`` and
``nbytes`` summed over every tensor, int8 and nf4 codes and their scales
included — so a quantized engine is priced at the bytes that really
stream.

Peaks come from a table of NVIDIA cards matched on
``torch.cuda.get_device_name()``, overridable with ``DISTLLM_PEAK_FLOPS``
/ ``DISTLLM_PEAK_BW_BYTES``. On the CPU the JAX package's placeholder
peaks keep the gauges populated: those numbers exercise the plumbing,
not silicon. An fp32 engine is divided by the bf16 peak too, so its
shares read low.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# Device-name prefix -> (bf16 dense peak FLOP/s, HBM bytes/s), matched
# case-insensitively by prefix, longest prefix wins. The H100 SXM row is
# NVIDIA's datasheet figure at the card's 700 W limit.
DEVICE_PEAKS: dict[str, tuple[float, float]] = {
    'NVIDIA H100 80GB HBM3': (989.4e12, 3.35e12),
}

# Order-of-magnitude placeholders for devices not in the table (the CPU
# tier): the JAX package's values.
FALLBACK_PEAKS = (1e12, 1e11)


def device_peaks(device) -> tuple[float, float]:
    """``(peak_flops, peak_hbm_bytes_per_s)`` for a torch device, or for a
    device name as ``torch.cuda.get_device_name`` gives it.

    Env overrides ``DISTLLM_PEAK_FLOPS`` / ``DISTLLM_PEAK_BW_BYTES`` win
    over the table; unknown devices fall back to :data:`FALLBACK_PEAKS`.
    """
    import torch

    if isinstance(device, torch.device) and device.type == 'cuda':
        kind = torch.cuda.get_device_name(device)
    else:
        kind = str(device or '')
    kind = kind.lower()
    flops = bw = None
    best = -1
    for name, (f, b) in DEVICE_PEAKS.items():
        if kind.startswith(name.lower()) and len(name) > best:
            best, flops, bw = len(name), f, b
    if flops is None:
        flops, bw = FALLBACK_PEAKS
    env_flops = os.environ.get('DISTLLM_PEAK_FLOPS')
    env_bw = os.environ.get('DISTLLM_PEAK_BW_BYTES')
    if env_flops:
        flops = float(env_flops)
    if env_bw:
        bw = float(env_bw)
    return flops, bw


def tree_tensors(tree) -> list:
    """Every tensor of a parameter tree: dicts, lists and tuples walked,
    and a ``QTensor`` leaf of ``ops.quantization`` giving its codes and
    its scales."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for value in tree.values() for t in tree_tensors(value)]
    if isinstance(tree, (list, tuple)):
        return [t for value in tree for t in tree_tensors(value)]
    if isinstance(getattr(tree, 'q', None), torch.Tensor):
        return [tree.q, tree.scale]
    return []


@dataclass(frozen=True)
class StepCost:
    """Analytic cost of one engine step: matmul FLOPs + HBM weight bytes."""

    flops: float
    hbm_bytes: float


class CostModel:
    """Per-window-kind FLOPs/bytes model for one engine's weight set.

    Built once per engine from the live parameter tree; ``step_cost``
    prices each flight-recorded step kind from the fields the engine
    already records. The engine divides by the step's wall time and the
    device peaks to publish ``distllm_engine_mfu{kind}`` and
    ``distllm_engine_bandwidth_utilization{kind}``.
    """

    def __init__(
        self,
        n_params: float,
        weight_bytes: float,
        decode_steps: int,
        peak_flops: float,
        peak_hbm_bytes: float,
    ) -> None:
        if n_params <= 0 or weight_bytes <= 0:
            raise ValueError('cost model needs a non-empty parameter tree')
        self.n_params = float(n_params)
        self.weight_bytes = float(weight_bytes)
        self.decode_steps = max(1, int(decode_steps))
        self.peak_flops = float(peak_flops)
        self.peak_hbm_bytes = float(peak_hbm_bytes)

    @classmethod
    def from_params(
        cls, params, decode_steps: int, device=None, num_devices: int = 1
    ) -> 'CostModel':
        """Price the ACTUAL weight set: whatever tensors are in the tree
        are what streams from HBM. ``device`` defaults to the device of
        the tree's first tensor; ``num_devices`` scales the peaks for a
        tree sharded over that many cards."""
        tensors = tree_tensors(params)
        n_params = sum(t.numel() for t in tensors)
        weight_bytes = sum(t.numel() * t.element_size() for t in tensors)
        if device is None and tensors:
            device = tensors[0].device
        peak_flops, peak_bw = device_peaks(device)
        scale = max(1, int(num_devices))
        return cls(n_params, weight_bytes, decode_steps,
                   peak_flops * scale, peak_bw * scale)

    def step_cost(
        self,
        kind: str,
        *,
        tokens: int = 0,
        batch: int = 0,
        draft_tokens: int = 0,
        prefill_tokens: int = 0,
        passes: int | None = None,
    ) -> StepCost | None:
        """Cost of one recorded step, or ``None`` for kinds with no
        dispatch behind them (``request``/``preempt``/``event``).

        - ``prefill``: one weight pass scoring ``tokens`` positions.
        - ``decode``/``mixed``: ``decode_steps`` weight passes (every step
          re-reads the weights, frozen slots included); FLOPs cover
          generated tokens plus any ridden chunk positions.
        - ``spec``: one weight pass scoring every row's span —
          ``batch + draft_tokens`` positions (plus ridden chunks).

        ``passes`` replaces those pass counts with the weight passes the
        step really ran: a port window replays one graph per step it
        needs (fewer than ``decode_steps`` when every row's budget is
        short), and a chunk half is an eager pass of its own. ``None``
        keeps the JAX package's counts.
        """
        two_np = 2.0 * self.n_params
        if kind == 'prefill':
            return StepCost(two_np * tokens, self.weight_bytes * (passes or 1))
        if kind in ('decode', 'mixed'):
            return StepCost(
                two_np * (tokens + prefill_tokens),
                self.weight_bytes * (
                    self.decode_steps if passes is None else passes
                ),
            )
        if kind == 'spec':
            positions = batch + draft_tokens + prefill_tokens
            return StepCost(
                two_np * positions,
                self.weight_bytes * (1 if passes is None else passes),
            )
        return None

    def utilization(
        self, cost: StepCost, duration_s: float
    ) -> tuple[float, float]:
        """``(mfu, bandwidth_utilization)`` for a step that took
        ``duration_s`` — uncapped ratios (a reading above 1 means the
        model or the peak table is wrong for this card; clamping would
        hide that)."""
        if duration_s <= 0:
            return 0.0, 0.0
        return (
            cost.flops / duration_s / self.peak_flops,
            cost.hbm_bytes / duration_s / self.peak_hbm_bytes,
        )
