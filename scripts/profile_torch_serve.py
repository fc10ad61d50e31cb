#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one GPU.

Builds the same random-init Mistral-7B bf16 engine as ``chip_smoke.py``
(``LLMEngine`` over weights made on the card from seed 0, the
``WhitespaceTokenizer``; depth settable with ``--layers``;
``max_num_seqs=8``; ``--quantization int8`` quantizes the weights on the
card so every projection runs through the int8 matmul kernel K2;
``--kv-cache-dtype int8`` stores the KV pool as int8 with per-block
scales, read by K1's int8-KV mode and written by the quantize-at-write
ops), warms it up (``LLMEngine.warmup``: the decode step captured as two
CUDA graphs, greedy and sampled; capture seconds and the graph pool's
MiB are printed with every result), then for each workload runs it
twice: once plainly, timed by the host clock (wall seconds, tokens/s,
wall milliseconds per forward pass), and once under ``torch.profiler`` at
a reduced token count, summing the device time of the CUDA kernels only
(profiling inflates the host side, not the kernels' device time):

- ``prefill``: 8 prompts of 1024 tokens, one new token each;
- ``decode``: 8 prompts of 16 tokens, greedy decode windows (128 new
  tokens each timed; 24 each profiled);
- ``decode_long``: 8 prompts of 1024 tokens, then 64 new greedy tokens
  each (24 profiled): the decode passes alone, at the contexts where
  attention's share of a pass is largest — wall time from the first
  decode window's dispatch, device time that of the profiled run minus
  that of a profiled run of one new token (the prefill passes);
- ``mixed``: the smoke run's batch — 16 prompts of 16..1024 tokens, 64
  new greedy tokens each (timed only).

Each line of output is one JSON object: device milliseconds per forward
pass by category (the ragged paged-attention kernel, the int8 matmul
kernel, other matrix products, everything else), the top kernels, and
the device's busy share of the profiled run: its kernels' device time
over its own wall time (of its decode windows, for ``decode_long``;
tracing slows the host, so it reads lower than a plain run's would). Where the engine replays decode graphs, the plain run's own
share too: CUDA events around each window's replays over the host time
from its first window's dispatch to its end (``replay_busy_share``,
``replay_device_ms_per_pass``). Also the decode graph replays of the
plain run (one per decode pass) and, as the check that the profiler sees
the kernels a replayed graph launches, the attention kernel's profiled
launches against layers x profiled passes
(``attention_launches_profiled`` / ``attention_launches_expected``).
``--model mixtral`` profiles Mixtral-8x7B widths instead (its family's
``init``, quantized layer by layer with ``--quantization``: in bf16 only
a cut depth fits the card); its expert banks' dequantization is the
elementwise multiply of int8 codes by bf16 scales, under ``other``. Needs
CUDA; exits nonzero without it.

    python3 scripts/profile_torch_serve.py [--model mixtral] [--layers 32]
        [--quantization int8] [--kv-cache-dtype int8]
        [--workloads decode_long,...] [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from distllm_tpu_torch.generate.engine import (  # noqa: E402
    KV_CACHE_DTYPES,
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distllm_tpu_torch.models import mistral, mixtral  # noqa: E402
from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer  # noqa: E402


WORKLOADS = ('prefill', 'decode', 'mixed', 'decode_long')


def _category(name: str) -> str:
    low = name.lower()
    if 'ragged_paged_attention' in low:
        return 'attention_kernel'
    if 'int8_matmul' in low or 'reduce_splits' in low:  # K2 and its split-K sum
        return 'int8_matmul_kernel'
    if any(t in low for t in ('gemm', 'gemv', 'nvjet', 'cutlass', 'xmma', 'cublas')):
        return 'matmul'
    return 'other'


def _prompts(rng, n, lo, hi):
    words = [f'w{i}' for i in range(5000)]
    lengths = np.linspace(lo, hi, n).astype(int) - 2  # + CLS and SEP
    return [' '.join(rng.choice(words, size=int(m))) for m in lengths]


class _WindowClock:
    """Times the decode windows of one run, on the engine it wraps until
    :meth:`close`: the host clock from the first window's dispatch to the
    run's end (``decode_wall_s``; every prompt here is admitted and
    prefilled before the first window), and, where the engine replays
    decode graphs, CUDA events around each window's replays
    (``replay_ms``: the device's time on them, the replays queued back to
    back). Both come from the run they time."""

    def __init__(self, engine) -> None:
        self.engine, self.first, self.events = engine, None, []
        self._dispatch = engine._dispatch_window
        engine._dispatch_window = self._dispatch_window
        self.runner = getattr(engine, '_decode', None)  # None: the eager window
        if self.runner is not None:
            self._replay = self.runner.run
            self.runner.run = self._run

    def _dispatch_window(self):
        if self.first is None:
            self.first = time.perf_counter()
        return self._dispatch()

    def _run(self, num_steps, all_greedy):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        tokens = self._replay(num_steps, all_greedy)
        end.record()
        self.events.append((start, end))
        return tokens

    def close(self, t_end: float) -> dict:
        del self.engine._dispatch_window
        if self.runner is not None:
            del self.runner.run
        return {
            'decode_wall_s': None if self.first is None else t_end - self.first,
            'replay_ms': None if self.runner is None
            else sum(a.elapsed_time(b) for a, b in self.events),
        }


def _run(engine, prompts, max_tokens):
    """Wall seconds, telemetry and the windows' clock (:class:`_WindowClock`)
    of one greedy run."""
    clock = _WindowClock(engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        engine.generate(prompts, SamplingParams(temperature=0.0, max_tokens=max_tokens))
        torch.cuda.synchronize()
    finally:
        t_end = time.perf_counter()
        windows = clock.close(t_end)
    return t_end - t0, dict(engine.telemetry), windows


def _kernel_times(prof) -> list[tuple[float, int, str]]:
    """(device µs, launches, name) of each CUDA kernel (not of the CPU ops
    that launched them, nor of the engine's ``distllm:<kind>`` ranges,
    which the trace also places on the device: either would count the
    kernels twice)."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for avg in prof.key_averages():
        if getattr(avg, 'device_type', None) != cuda or avg.key.startswith('distllm:'):
            continue
        us = getattr(avg, 'self_device_time_total', None)
        if us is None:
            us = avg.self_cuda_time_total
        rows.append((float(us), avg.count, avg.key))
    return sorted(rows, reverse=True)


def _attention_launches(kernels) -> int:
    return sum(c for _, c, key in kernels if _category(key) == 'attention_kernel')


def _profiled(engine, prompts, max_tokens):
    """Device µs by category, launches and attention-kernel launches of
    one profiled run (CUDA kernels only), the run's telemetry and its
    windows' clock."""
    activities = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=activities) as prof:
        wall_s, tele, windows = _run(engine, prompts, max_tokens)
    kernels = _kernel_times(prof)
    by_cat: dict[str, float] = {}
    for us, _, key in kernels:
        by_cat[_category(key)] = by_cat.get(_category(key), 0.0) + us
    return {'by_cat': by_cat, 'launches': sum(c for _, c, _ in kernels),
            'attention': _attention_launches(kernels), 'kernels': kernels,
            'wall_s': wall_s, 'tele': tele, 'windows': windows}


def _replay_shares(result, windows, replays) -> None:
    """The replayed graphs' device ms a decode pass and busy share of the
    plain run's decode windows, both from that run's clock (graph engines
    only)."""
    if windows['replay_ms'] is not None and replays:
        result['replay_device_ms_per_pass'] = windows['replay_ms'] / replays
        result['replay_busy_share'] = windows['replay_ms'] / (windows['decode_wall_s'] * 1e3)


def measure_decode_only(engine, name, prompts, max_tokens, profiled_tokens):
    """The decode passes after long prompts. Wall time: the host clock from
    the first decode window's dispatch to the run's end (every prompt is
    prefilled before it). Device time by category and launches: a
    profiled run of ``profiled_tokens`` new tokens minus one of one new
    token, whose only passes are the prefill's. The busy share divides
    those kernels' time by the profiled run's own decode windows' wall
    time."""
    _, tele, windows = _run(engine, prompts, max_tokens)
    passes = tele['forward_passes'] - tele['prefill_dispatches']
    replays = tele.get('decode_graph_replays', 0)
    decode_s = windows['decode_wall_s']
    result = {
        'workload': name,
        'prompts': len(prompts),
        'new_tokens_each': max_tokens,
        'decode_passes': passes,
        'decode_tokens_per_s': (tele['generated_tokens'] - len(prompts)) / decode_s,
        'wall_ms_per_pass': decode_s / passes * 1e3,
        'decode_graph_replays': replays,
    }
    _replay_shares(result, windows, replays)
    p0 = _profiled(engine, prompts, 1)
    p1 = _profiled(engine, prompts, profiled_tokens)
    ppasses = p1['tele']['forward_passes'] - p0['tele']['forward_passes']
    cats0, cats1 = p0['by_cat'], p1['by_cat']
    by_cat = {k: (cats1.get(k, 0.0) - cats0.get(k, 0.0)) / 1e3 / ppasses
              for k in sorted(set(cats0) | set(cats1))}
    device_ms = sum(by_cat.values())
    result.update({
        'profiled_decode_passes': ppasses,
        'device_ms_per_pass': device_ms,
        'device_ms_per_pass_by_category': by_cat,
        'attention_kernel_share': by_cat.get('attention_kernel', 0.0) / device_ms,
        'profiled_wall_ms_per_pass': p1['windows']['decode_wall_s'] / ppasses * 1e3,
        'device_busy_share': device_ms * ppasses / (p1['windows']['decode_wall_s'] * 1e3),
        'kernel_launches_per_pass': (p1['launches'] - p0['launches']) / ppasses,
        'attention_launches_profiled': p1['attention'] - p0['attention'],
        'attention_launches_expected': engine.model_cfg.num_layers * ppasses,
    })
    return result


def measure(engine, name, prompts, max_tokens, profiled_tokens):
    """One workload: a plain run, then (``profiled_tokens``) a profiled
    one, whose busy share is its kernels' device time over its own wall
    time."""
    wall_s, tele, windows = _run(engine, prompts, max_tokens)
    replays = tele.get('decode_graph_replays', 0)
    result = {
        'workload': name,
        'prompts': len(prompts),
        'new_tokens_each': max_tokens,
        'wall_s': wall_s,
        'tokens_per_s': tele['generated_tokens'] / wall_s,
        'forward_passes': tele['forward_passes'],
        'wall_ms_per_pass': wall_s / tele['forward_passes'] * 1e3,
        'decode_graph_replays': replays,
    }
    _replay_shares(result, windows, replays)
    if profiled_tokens is None:
        return result
    prof = _profiled(engine, prompts, profiled_tokens)
    kernels, passes = prof['kernels'], prof['tele']['forward_passes']
    device_ms = sum(prof['by_cat'].values()) / 1e3
    result.update({
        'profiled_forward_passes': passes,
        'device_ms_per_pass': device_ms / passes,
        'device_ms_per_pass_by_category': {
            k: v / 1e3 / passes for k, v in sorted(prof['by_cat'].items())
        },
        'profiled_wall_ms_per_pass': prof['wall_s'] / passes * 1e3,
        'device_busy_share': device_ms / (prof['wall_s'] * 1e3),
        'kernel_launches_per_pass': prof['launches'] / passes,
        'attention_launches_profiled': prof['attention'],
        'attention_launches_expected': engine.model_cfg.num_layers * passes,
        'top_kernels': [
            {'device_ms_per_pass': us / 1e3 / passes, 'launches': count,
             'name': key[:100]}
            for us, count, key in kernels[:10]
        ],
    })
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model', choices=('mistral', 'mixtral'), default='mistral')
    parser.add_argument('--layers', type=int, default=32)
    parser.add_argument('--quantization', choices=('int8', 'nf4'), default=None)
    parser.add_argument('--kv-cache-dtype', choices=KV_CACHE_DTYPES, default='auto')
    parser.add_argument('--workloads', default=','.join(WORKLOADS),
                        help='comma-separated subset of ' + ', '.join(WORKLOADS))
    parser.add_argument('--out', default=None, help='also write the results here')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('profile_torch_serve: needs CUDA')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    family = mixtral if args.model == 'mixtral' else mistral
    config_cls = mixtral.MixtralConfig if args.model == 'mixtral' else mistral.MistralConfig
    model_cfg = config_cls(num_layers=args.layers)
    params = family.init(model_cfg, torch.Generator(device='cuda').manual_seed(0),
                         quantization=args.quantization)
    engine = LLMEngine(
        model_cfg, params,
        WhitespaceTokenizer(vocab_size=model_cfg.vocab_size, model_max_length=2048),
        EngineConfig(num_blocks=1024, max_num_seqs=8, max_model_len=2048,
                     quantization=args.quantization,
                     kv_cache_dtype=args.kv_cache_dtype),
        own_params=True,
    )
    del params
    rng = np.random.default_rng(1)
    # Warm-up: builds the kernels and captures the decode graphs (an
    # engine without ``warmup`` decodes eagerly: the same call can time an
    # earlier tree's eager window), then a short run loads cuBLAS handles
    # and fills caches.
    if hasattr(engine, 'warmup'):
        engine.warmup()
    _run(engine, _prompts(rng, 4, 16, 300), 16)
    runs = {
        'prefill': lambda: measure(engine, 'prefill', _prompts(rng, 8, 1024, 1024), 1, 1),
        'decode': lambda: measure(engine, 'decode', _prompts(rng, 8, 16, 16), 128, 24),
        'mixed': lambda: measure(engine, 'mixed', _prompts(rng, 16, 16, 1024), 64, None),
        'decode_long': lambda: measure_decode_only(
            engine, 'decode_long', _prompts(rng, 8, 1024, 1024), 64, 24),
    }
    results = [runs[name]() for name in args.workloads.split(',')]
    head = {'card': card, 'model': args.model, 'layers': args.layers,
            'quantization': args.quantization,
            'kv_cache_dtype': engine.telemetry['kv_cache_dtype'],
            'kv_pool_bytes': engine.kv.hbm_bytes,
            'decode_graph_captures': engine.stats.get('decode_graph_captures', 0),
            'decode_graph_capture_s': engine.stats.get('decode_graph_capture_s', 0.0),
            'graph_pool_mib': getattr(engine, 'graph_pool_bytes', 0) / 2**20}
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({**head, 'results': results}, indent=1))
    for result in results:
        print(json.dumps({**head, **result}))
    engine.shutdown()


if __name__ == '__main__':
    main()
