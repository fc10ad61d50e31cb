"""Resilience layer (the port of ``distllm_tpu.resilience``): fault
injection and TTFT-predictive admission control.

The crash-domain *recovery* half (window retry, quarantine, per-request
deadlines) lives in the engine itself
(``distllm_tpu_torch/generate/engine/engine.py``); this package holds the
engine-independent parts: the deterministic fault-injection framework and
the shedding policy. Host Python only.
"""

from distllm_tpu_torch.resilience.admission import (
    EngineLoadView,
    EngineOverloaded,
    predict_ttft,
    shed_decision,
)
from distllm_tpu_torch.resilience.faults import (
    FAULT_SITES,
    FaultInjector,
    InjectedFault,
    get_fault_injector,
    parse_fault_spec,
)

__all__ = [
    'EngineLoadView',
    'EngineOverloaded',
    'predict_ttft',
    'shed_decision',
    'FAULT_SITES',
    'FaultInjector',
    'InjectedFault',
    'get_fault_injector',
    'parse_fault_spec',
]
