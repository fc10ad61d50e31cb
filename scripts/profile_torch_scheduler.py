#!/usr/bin/env python3
"""Host time a step with the native (C++) scheduler and with its Python twin.

Builds Mistral-7B at full width and depth (bf16, random weights made on the
card from seed 0) and, for each scheduler, the engines of ``chip_smoke.py``'s
phase 16 (the JAX ``gen_load`` stage's configuration under its open-loop
workload, through ``run_loadgen``) and phase 17 (its 128 prompts through
``generate_ids`` at ``pipeline_depth`` 1, with the stop ids of a first run).
Each run wraps the engine's scheduler in a proxy that times every call and
attribute read on the host's clock. Per workload and scheduler it prints:

- ``sched_ms_per_step``: the scheduler's host ms over the run's steps
  (decode windows and prefill dispatches);
- ``sched_calls_per_step``;
- ``plan_ms_per_window``: the median ``host_s`` of the decode windows'
  flight records (the window's plan: reservation, block rows, staging);
- tok/s.

The runs go native, Python, Python, native on each workload (one card, one
call), each on a fresh engine. Needs CUDA and ``g++``.

    python3 scripts/profile_torch_scheduler.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams  # noqa: E402
from distllm_tpu_torch.generate.loadgen import run_loadgen  # noqa: E402
from distllm_tpu_torch.models import mistral  # noqa: E402

ORDER = (True, False, False, True)  # prefer_native_allocator, run by run
DEVICE = 'cuda'


class TimedScheduler:
    """Delegates to a scheduler, timing each method call and attribute
    read (the properties run the native calls) on the host's clock."""

    def __init__(self, inner) -> None:
        self.__dict__.update(_inner=inner, seconds=0.0, calls=0)

    def __getattr__(self, name):
        t0 = time.perf_counter()
        value = getattr(self._inner, name)
        if not callable(value):
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return value

        def timed(*args, **kwargs):
            t1 = time.perf_counter()
            try:
                return value(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t1
                self.calls += 1

        return timed


def run_arm(cfg, params, fields, native, drive):
    engine = LLMEngine(cfg, params, None, EngineConfig(
        **fields, prefer_native_allocator=native), device=DEVICE)
    want = 'native' if native else 'python'
    if engine.scheduler_kind != want:
        raise SystemExit(f'asked for the {want} scheduler, got {engine.scheduler_kind}')
    engine.warmup()
    engine.generate_ids([[1] * n for n in (24, 60, 120, 250)],
                        SamplingParams(temperature=0.0, max_tokens=2))
    timed = TimedScheduler(engine.sched)
    engine.sched = timed
    stats0, ring0 = dict(engine.stats), engine.flight.total_recorded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = drive(engine)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    run = cs.stats_delta(engine, stats0)
    steps = run.get('decode_windows', 0) + run.get('prefill_dispatches', 0)
    plans = [r['host_s'] for r in cs.new_records(engine.flight, ring0)
             if r['kind'] == 'decode' and 'host_s' in r]
    engine.sched = timed._inner
    cs.shut_down(torch, 'scheduler profile', engine)
    return dict(
        scheduler=want, steps=steps, windows=run.get('decode_windows', 0),
        prefills=run.get('prefill_dispatches', 0),
        sched_ms_per_step=1e3 * timed.seconds / steps,
        sched_calls_per_step=timed.calls / steps,
        plan_ms_per_window=1e3 * float(np.median(plans)),
        tokens_per_s=tokens / wall_s, wall_s=wall_s,
    )


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit('needs a GPU')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f'[device] {smi}', flush=True)
    cfg = mistral.MistralConfig()
    params = mistral.init(cfg, torch.Generator(device='cuda').manual_seed(0), device='cuda')

    workload = cs.workload_of(cs.LOAD, cfg.vocab_size)

    def drive_load(engine):
        return run_loadgen(engine, workload).tokens

    prompts, new = cs.pipe_workload(cfg.vocab_size)
    first = LLMEngine(cfg, params, None, EngineConfig(**cs.PIPE_ENGINE), device=DEVICE)
    stops = cs.stop_ids_of(first.generate_ids(
        prompts[:48], SamplingParams(temperature=0.0, max_tokens=64)), cs.PIPE_STOPS)
    cs.shut_down(torch, 'scheduler profile', first)
    del first
    sampling = [SamplingParams(temperature=0.0, max_tokens=n, stop_token_ids=stops)
                for n in new]

    def drive_pipe(engine):
        return sum(len(out) for out in engine.generate_ids(prompts, sampling))

    results = {}
    for name, fields, drive in (
        ('load (phase 16)', cs.LOAD_ENGINE, drive_load),
        ('pipeline depth 1 (phase 17)', dict(cs.PIPE_ENGINE, pipeline_depth=1), drive_pipe),
    ):
        runs = [run_arm(cfg, params, fields, native, drive) for native in ORDER]
        results[name] = runs
        for r in runs:
            print(f'[scheduler] {smi}: {name}, {r["scheduler"]}: '
                  f'{r["sched_ms_per_step"]:.4f} ms a step in the scheduler '
                  f'({r["sched_calls_per_step"]:.1f} calls), plan {r["plan_ms_per_window"]:.4f} '
                  f'ms a window (median), {r["steps"]} steps ({r["windows"]} windows, '
                  f'{r["prefills"]} prefills), {r["tokens_per_s"]:.1f} tok/s', flush=True)
    print(json.dumps(dict(device=smi, results=results)))


if __name__ == '__main__':
    main()
