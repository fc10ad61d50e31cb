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
    NativeBlockAllocator,
    PagedKVCache,
    PyBlockAllocator,
    make_allocator,
)
from distllm_tpu_torch.generate.engine.scheduler import (
    NativeScheduler,
    PyScheduler,
    SchedulerExhausted,
    make_scheduler,
)

__all__ = [
    'KV_CACHE_DTYPES',
    'EngineConfig',
    'LLMEngine',
    'NativeBlockAllocator',
    'NativeScheduler',
    'PagedKVCache',
    'PyBlockAllocator',
    'PyScheduler',
    'Request',
    'RequestState',
    'SamplingParams',
    'SchedulerExhausted',
    'make_allocator',
    'make_scheduler',
]
