#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one GPU.

Builds the same random-init Mistral-7B bf16 engine as ``chip_smoke.py``
(``LLMEngine`` over weights made on the card from seed 0, the
``WhitespaceTokenizer``; depth settable with ``--layers``;
``max_num_seqs=8``; ``--quantization int8`` quantizes the weights on the
card so every projection runs through the int8 matmul kernel K2;
``--kv-cache-dtype int8`` stores the KV pool as int8 with per-block
scales, read by K1's int8-KV mode and written by the quantize-at-write
ops), warms it up, then for each workload runs it twice: once plainly, timed by
the host clock (wall seconds, tokens/s, wall milliseconds per forward
pass), and once under ``torch.profiler`` at a reduced token count, summing
the device time of the CUDA kernels only (profiling inflates the host
side, not the kernels' device time):

- ``prefill``: 8 prompts of 1024 tokens, one new token each;
- ``decode``: 8 prompts of 16 tokens, greedy decode windows (128 new
  tokens each timed; 24 each profiled);
- ``decode_long``: 8 prompts of 1024 tokens, then 64 new greedy tokens
  each (24 profiled): the decode passes alone, at the contexts where
  attention's share of a pass is largest — each quantity is that of the
  run minus that of a run of one new token (the prefill passes);
- ``mixed``: the smoke run's batch — 16 prompts of 16..1024 tokens, 64
  new greedy tokens each (timed only).

Each line of output is one JSON object: device milliseconds per forward
pass by category (the ragged paged-attention kernel, the int8 matmul
kernel, other matrix products, everything else), the device's busy share of the plain run's wall time
(device ms per pass over wall ms per pass) and the top kernels. Needs
CUDA; exits nonzero without it.

    python3 scripts/profile_torch_serve.py [--layers 32] [--quantization int8]
        [--kv-cache-dtype int8] [--workloads decode_long,...] [--out results.json]
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
from distllm_tpu_torch.models import mistral  # noqa: E402
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


def _run(engine, prompts, max_tokens):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(prompts, SamplingParams(temperature=0.0, max_tokens=max_tokens))
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(engine.telemetry)


def _kernel_times(prof) -> list[tuple[float, int, str]]:
    """(device µs, launches, name) of each CUDA kernel (not of the CPU ops
    that launched them, whose device time would count the kernels twice)."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for avg in prof.key_averages():
        if getattr(avg, 'device_type', None) != cuda:
            continue
        us = getattr(avg, 'self_device_time_total', None)
        if us is None:
            us = avg.self_cuda_time_total
        rows.append((float(us), avg.count, avg.key))
    return sorted(rows, reverse=True)


def _profiled(engine, prompts, max_tokens):
    """Device µs by category and launches of one profiled run (CUDA
    kernels only), and the run's telemetry."""
    activities = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=activities) as prof:
        _, tele = _run(engine, prompts, max_tokens)
    kernels = _kernel_times(prof)
    by_cat: dict[str, float] = {}
    for us, _, key in kernels:
        by_cat[_category(key)] = by_cat.get(_category(key), 0.0) + us
    return by_cat, sum(c for _, c, _ in kernels), tele


def measure_decode_only(engine, name, prompts, max_tokens, profiled_tokens):
    """The decode passes after long prompts: wall time, device time by
    category and launches of a run of ``max_tokens`` new tokens (profiled:
    ``profiled_tokens``) minus those of a run of one new token, whose only
    passes are the prefill's."""
    base_s, base = _run(engine, prompts, 1)
    wall_s, tele = _run(engine, prompts, max_tokens)
    passes = tele['forward_passes'] - base['forward_passes']
    result = {
        'workload': name,
        'prompts': len(prompts),
        'new_tokens_each': max_tokens,
        'decode_passes': passes,
        'decode_tokens_per_s': (tele['generated_tokens'] - base['generated_tokens'])
        / (wall_s - base_s),
        'wall_ms_per_pass': (wall_s - base_s) / passes * 1e3,
    }
    cats0, launches0, tele0 = _profiled(engine, prompts, 1)
    cats1, launches1, tele1 = _profiled(engine, prompts, profiled_tokens)
    ppasses = tele1['forward_passes'] - tele0['forward_passes']
    by_cat = {k: (cats1.get(k, 0.0) - cats0.get(k, 0.0)) / 1e3 / ppasses
              for k in sorted(set(cats0) | set(cats1))}
    device_ms = sum(by_cat.values())
    result.update({
        'profiled_decode_passes': ppasses,
        'device_ms_per_pass': device_ms,
        'device_ms_per_pass_by_category': by_cat,
        'attention_kernel_share': by_cat.get('attention_kernel', 0.0) / device_ms,
        'device_busy_share': device_ms / result['wall_ms_per_pass'],
        'kernel_launches_per_pass': (launches1 - launches0) / ppasses,
    })
    return result


def measure(engine, name, prompts, max_tokens, profiled_tokens):
    wall_s, tele = _run(engine, prompts, max_tokens)
    result = {
        'workload': name,
        'prompts': len(prompts),
        'new_tokens_each': max_tokens,
        'wall_s': wall_s,
        'tokens_per_s': tele['generated_tokens'] / wall_s,
        'forward_passes': tele['forward_passes'],
        'wall_ms_per_pass': wall_s / tele['forward_passes'] * 1e3,
    }
    if profiled_tokens is None:
        return result
    activities = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=activities) as prof:
        _, ptele = _run(engine, prompts, profiled_tokens)
    kernels = _kernel_times(prof)
    passes = ptele['forward_passes']
    by_cat: dict[str, float] = {}
    for us, _, key in kernels:
        by_cat[_category(key)] = by_cat.get(_category(key), 0.0) + us
    device_ms_per_pass = sum(by_cat.values()) / 1e3 / passes
    result.update({
        'profiled_forward_passes': passes,
        'device_ms_per_pass': device_ms_per_pass,
        'device_ms_per_pass_by_category': {
            k: v / 1e3 / passes for k, v in sorted(by_cat.items())
        },
        'device_busy_share': device_ms_per_pass / result['wall_ms_per_pass'],
        'kernel_launches_per_pass': sum(c for _, c, _ in kernels) / passes,
        'top_kernels': [
            {'device_ms_per_pass': us / 1e3 / passes, 'launches': count,
             'name': key[:100]}
            for us, count, key in kernels[:10]
        ],
    })
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
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
    model_cfg = mistral.MistralConfig(num_layers=args.layers)
    params = mistral.init(model_cfg, torch.Generator(device='cuda').manual_seed(0))
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
    # Warm-up: builds the kernel, loads cuBLAS handles, fills caches.
    _run(engine, _prompts(rng, 4, 16, 300), 16)
    runs = {
        'prefill': lambda: measure(engine, 'prefill', _prompts(rng, 8, 1024, 1024), 1, 1),
        'decode': lambda: measure(engine, 'decode', _prompts(rng, 8, 16, 16), 128, 24),
        'mixed': lambda: measure(engine, 'mixed', _prompts(rng, 16, 16, 1024), 64, None),
        'decode_long': lambda: measure_decode_only(
            engine, 'decode_long', _prompts(rng, 8, 1024, 1024), 64, 24),
    }
    results = [runs[name]() for name in args.workloads.split(',')]
    head = {'card': card, 'layers': args.layers, 'quantization': args.quantization,
            'kv_cache_dtype': engine.telemetry['kv_cache_dtype'],
            'kv_pool_bytes': engine.kv.hbm_bytes}
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({**head, 'results': results}, indent=1))
    for result in results:
        print(json.dumps({**head, **result}))
    engine.shutdown()


if __name__ == '__main__':
    main()
