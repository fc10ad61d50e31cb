"""Paged-KV continuous-batching generation engine (PyTorch port)."""

from distllm_tpu_torch.generate.engine.engine import (
    KV_CACHE_DTYPES,
    EngineConfig,
    LLMEngine,
    Request,
    RequestState,
    SamplingParams,
)
from distllm_tpu_torch.generate.engine.kv_cache import (
    PagedKVCache,
    PyBlockAllocator,
)
from distllm_tpu_torch.generate.engine.scheduler import (
    PyScheduler,
    SchedulerExhausted,
)

__all__ = [
    'KV_CACHE_DTYPES',
    'EngineConfig',
    'LLMEngine',
    'PagedKVCache',
    'PyBlockAllocator',
    'PyScheduler',
    'Request',
    'RequestState',
    'SamplingParams',
    'SchedulerExhausted',
]
