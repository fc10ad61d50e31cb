"""Engine-to-endpoint metrics and tracing (the port of the parts of
``distllm_tpu.observability`` the serving path needs):

- :mod:`~distllm_tpu_torch.observability.metrics` — ``Counter`` /
  ``Gauge`` / ``Histogram`` registry with Prometheus text exposition;
- :mod:`~distllm_tpu_torch.observability.tracing` — ``Span`` records, a
  bounded trace ring, and the request-id scope the server binds;
- :mod:`~distllm_tpu_torch.observability.instruments` — the catalogue of
  well-known series, the JAX package's names, types, labels and buckets;
- :mod:`~distllm_tpu_torch.observability.flight` — the bounded
  per-engine-step flight ring;
- :mod:`~distllm_tpu_torch.observability.roofline` — the analytic
  FLOPs/bytes cost model behind ``distllm_engine_mfu`` and the
  bandwidth-utilization gauges, over the card's own peaks.

Host Python only: nothing here touches the device.
"""

from __future__ import annotations

from distllm_tpu_torch.observability.flight import (
    FlightRecorder,
    get_flight_recorder,
)
from distllm_tpu_torch.observability.instruments import log_event
from distllm_tpu_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    log_buckets,
    quantile_from_cumulative,
    render_prometheus,
)
from distllm_tpu_torch.observability.roofline import CostModel, device_peaks
from distllm_tpu_torch.observability.tracing import (
    Span,
    TraceBuffer,
    begin_span,
    current_request_id,
    dump_traces,
    end_span,
    get_trace_buffer,
    request_scope,
    span,
)

__all__ = [
    'CostModel',
    'Counter',
    'FlightRecorder',
    'Gauge',
    'Histogram',
    'MetricsRegistry',
    'Span',
    'TraceBuffer',
    'begin_span',
    'current_request_id',
    'device_peaks',
    'dump_traces',
    'end_span',
    'get_flight_recorder',
    'get_registry',
    'log_buckets',
    'log_event',
    'quantile_from_cumulative',
    'render_prometheus',
    'request_scope',
    'span',
]
