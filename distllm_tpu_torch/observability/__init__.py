"""Engine-to-endpoint observability (the port of
``distllm_tpu.observability``; the same series, record kinds and
documents):

- :mod:`~distllm_tpu_torch.observability.metrics` — ``Counter`` /
  ``Gauge`` / ``Histogram`` registry with Prometheus text exposition;
- :mod:`~distllm_tpu_torch.observability.tracing` — ``Span`` records, a
  bounded trace ring and the request-id scope the server binds
  (``timer.Timer`` is a shim over it);
- :mod:`~distllm_tpu_torch.observability.instruments` — the catalogue of
  well-known series, the JAX package's names, types, labels and buckets;
- :mod:`~distllm_tpu_torch.observability.flight` — the per-engine-step
  flight ring, debug bundles, the stall watchdog, ``RunRecord`` and
  ``Deadline``;
- :mod:`~distllm_tpu_torch.observability.perfetto` — Perfetto / Chrome
  trace-event export of the rings and request lifecycles;
- :mod:`~distllm_tpu_torch.observability.roofline` — the analytic
  FLOPs / bytes cost model over the card's peaks;
- :mod:`~distllm_tpu_torch.observability.op_cost` — measured per-dispatch
  cost (the counterpart of ``xla_cost``): one eager pass of each step
  shape under a dispatch mode, plus the kernels' own work;
- :mod:`~distllm_tpu_torch.observability.startup` — start-up phase
  attribution (CUDA context, kernel builds, weight load, graph captures);
- :mod:`~distllm_tpu_torch.observability.profiling` — the bounded
  ``torch.profiler`` capture (``GET /debug/xprof``);
- :mod:`~distllm_tpu_torch.observability.history` — the metric-history
  ring and its sampler;
- :mod:`~distllm_tpu_torch.observability.slo` — multi-window burn rates
  and the ok / warn / page verdict;
- :mod:`~distllm_tpu_torch.observability.baseline` and
  :mod:`~distllm_tpu_torch.observability.sentinel` — the baseline
  envelope and the runtime regression sentinel.

``aggregate`` (imported lazily: it imports ``timer``) rolls multi-host
``[timer]`` logs and JSONL rings into one table and one trace. Host
Python only: nothing here launches device work.
"""

from __future__ import annotations

from distllm_tpu_torch.observability.baseline import (
    build_envelope,
    envelope_from_records,
    load_envelope,
)
from distllm_tpu_torch.observability.flight import (
    Deadline,
    FlightRecorder,
    RunRecord,
    StallWatchdog,
    dump_debug_bundle,
    get_flight_recorder,
)
from distllm_tpu_torch.observability.history import (
    HistorySampler,
    MetricsHistory,
    get_metrics_history,
    history_excerpt,
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
from distllm_tpu_torch.observability.perfetto import (
    merge_host_traces,
    to_trace_events,
    validate_trace_events,
)
from distllm_tpu_torch.observability.profiling import (
    ProfilerCapture,
    get_profiler_capture,
)
from distllm_tpu_torch.observability.roofline import CostModel, device_peaks
from distllm_tpu_torch.observability.sentinel import (
    RegressionSentinel,
    get_regression_sentinel,
    install_regression_sentinel,
)
from distllm_tpu_torch.observability.slo import (
    install_slo_observer,
    slo_status,
    update_burn_gauges,
)
from distllm_tpu_torch.observability.startup import (
    CompileWatcher,
    get_compile_watcher,
    record_backend_init,
)
from distllm_tpu_torch.observability.op_cost import OpCost, add_kernel_cost, count
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
    'CompileWatcher',
    'CostModel',
    'Counter',
    'Deadline',
    'FlightRecorder',
    'Gauge',
    'Histogram',
    'HistorySampler',
    'MetricsHistory',
    'MetricsRegistry',
    'ProfilerCapture',
    'RegressionSentinel',
    'RunRecord',
    'Span',
    'StallWatchdog',
    'TraceBuffer',
    'OpCost',
    'add_kernel_cost',
    'begin_span',
    'build_envelope',
    'count',
    'current_request_id',
    'device_peaks',
    'dump_debug_bundle',
    'dump_traces',
    'end_span',
    'envelope_from_records',
    'get_compile_watcher',
    'get_flight_recorder',
    'get_metrics_history',
    'get_profiler_capture',
    'get_registry',
    'get_regression_sentinel',
    'get_trace_buffer',
    'history_excerpt',
    'install_regression_sentinel',
    'install_slo_observer',
    'load_envelope',
    'log_buckets',
    'log_event',
    'merge_host_traces',
    'quantile_from_cumulative',
    'record_backend_init',
    'render_prometheus',
    'request_scope',
    'slo_status',
    'span',
    'to_trace_events',
    'update_burn_gauges',
    'validate_trace_events',
]
