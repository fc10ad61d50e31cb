"""The port's native scheduler and block allocator against their Python
twins and the JAX package's natives.

``NativeScheduler`` binds ``csrc/host/scheduler.cpp`` (the port's copy of
``distllm_tpu/native/scheduler.cpp``, built with g++ into ``_build/`` at
first use). On ``tests/test_scheduler.py``'s random operation sequences
(admission, multi-step and per-row reservations, preemption, trims,
finishes) it makes the decisions of the port's ``PyScheduler`` and of
the JAX ``NativeScheduler``, as do the borrowed-prefix trace and the free
list, bottom to top. ``make_scheduler`` takes the native one and falls
back to the Python twin with a log line when it cannot build; the engine
records which one it took. ``NativeBlockAllocator`` hands out and frees
blocks as ``PyBlockAllocator`` does.
"""

import numpy as np
import pytest
import test_scheduler
from test_torch_scheduler import _borrowed_trace

from distllm_tpu.generate.engine.kv_cache import NativeBlockAllocator as JaxNativeAllocator
from distllm_tpu.generate.engine.scheduler import NativeScheduler as JaxNativeScheduler
from distllm_tpu.generate.engine.scheduler import SchedulerExhausted as JaxExhausted
from distllm_tpu_torch.generate.engine import (
    NativeBlockAllocator,
    NativeScheduler,
    PyBlockAllocator,
    PyScheduler,
    SchedulerExhausted,
    make_allocator,
    make_scheduler,
)
from distllm_tpu_torch.generate.engine import scheduler as port_scheduler
from distllm_tpu_torch.observability import instruments


@pytest.mark.parametrize('seed', [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize('shape', [(24, 4, 3), (40, 2, 5)])
def test_native_decisions_match_the_twin_and_jax(monkeypatch, seed, shape):
    monkeypatch.setattr(
        test_scheduler, 'SchedulerExhausted', (JaxExhausted, SchedulerExhausted)
    )
    native = NativeScheduler(*shape)
    trace = test_scheduler.drive(native, seed)
    assert trace == test_scheduler.drive(PyScheduler(*shape), seed)
    assert trace == test_scheduler.drive(JaxNativeScheduler(*shape), seed)


def test_borrowed_prefix_and_free_list_match():
    assert _borrowed_trace(NativeScheduler(16, 4, 2)) == _borrowed_trace(
        JaxNativeScheduler(16, 4, 2)
    ) == _borrowed_trace(PyScheduler(16, 4, 2))
    native, twin = NativeScheduler(20, 4, 3), PyScheduler(20, 4, 3)
    for sched in (native, twin):
        for rid, tokens in enumerate((5, 9, 3)):
            sched.add(rid, tokens)
        while sched.admit_next() is not None:
            pass
        sched.prepare_decode(6)
        sched.trim(1)
        sched.finish(0)
    assert native.free_list() == twin.free_list()
    assert native.num_free_blocks == len(native.free_list())


def test_make_scheduler_prefers_native_and_falls_back(monkeypatch, capsys):
    assert make_scheduler(16, 4, 2).kind == 'native'
    assert make_scheduler(16, 4, 2, prefer_native=False).kind == 'python'

    def no_compiler(name):
        raise RuntimeError('g++ not found')

    monkeypatch.setattr('distllm_tpu_torch.ops._build.build_host', no_compiler)
    before = instruments.LOG_MESSAGES.labels(component='engine').value
    sched = make_scheduler(16, 4, 2)
    assert isinstance(sched, PyScheduler) and sched.kind == 'python'
    assert 'native scheduler unavailable' in capsys.readouterr().out
    assert instruments.LOG_MESSAGES.labels(component='engine').value == before + 1
    assert isinstance(make_allocator(8), PyBlockAllocator)
    assert port_scheduler.NativeScheduler is NativeScheduler


def test_native_allocator_matches_the_twin_and_jax():
    rng = np.random.default_rng(0)
    allocators = [NativeBlockAllocator(12), PyBlockAllocator(12), JaxNativeAllocator(12)]
    held: list[int] = []
    for _ in range(200):
        if held and rng.integers(0, 2):
            block = held.pop(int(rng.integers(0, len(held))))
            for a in allocators:
                a.free(block)
        else:
            got = [a.alloc() for a in allocators]
            assert len(set(got)) == 1, got
            if got[0] > 0:
                held.append(got[0])
        assert len({a.num_free for a in allocators}) == 1
    assert make_allocator(8).__class__ is NativeBlockAllocator
