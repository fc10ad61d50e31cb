#!/usr/bin/env python3
"""Sweep the split-K counts of K2's tensor-core route on the card.

    python3 scripts/profile_torch_qmm_splits.py

Launches ``distllm_tpu_torch/csrc/int8_matmul.cu`` (built as the port
builds it) through its C entry on bf16 inputs with every split count that
divides K's steps evenly: the 16-row tiles at Mistral-7B decode shapes
(1..32 splits), the 128-row tiles at prefill shapes whose tiles cannot
fill the card (1..3). Each time is the mean over a CUDA graph of launches
that cycle through weight copies larger than the L2 cache, with the
worst element's ratio to ``comparison_tolerance`` beside it, and the plan
``quantized_matmul.launch_shape`` picks is printed beside the sweep: the
evidence for the wrapper's blocks-per-SM targets. Prints one JSON line
per shape and the card's name and power limit. Needs CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from distllm_tpu_torch.ops import quantization as tq  # noqa: E402
from distllm_tpu_torch.ops import quantized_matmul as tqm  # noqa: E402

# (name, M, K, N, split counts tried, timed launches)
CASES = (
    ('decode_8x4096x14336', 8, 4096, 14336, (1, 2, 3, 4, 6, 8, 16, 32), 40),
    ('decode_8x14336x4096', 8, 14336, 4096, (1, 2, 4, 8, 9, 12, 16, 32), 40),
    ('decode_8x4096x4096', 8, 4096, 4096, (1, 2, 4, 8, 16, 32), 40),
    ('decode_8x4096x1024', 8, 4096, 1024, (1, 4, 8, 16, 32), 40),
    ('decode_16x4096x14336', 16, 4096, 14336, (1, 2, 3, 4, 6, 8, 16), 40),
    ('prefill_2048x4096x1024', 2048, 4096, 1024, (1, 2, 3), 20),
    ('prefill_1040x4096x4096', 1040, 4096, 4096, (1, 2, 3), 20),
)
COLD_BYTES = 256 << 20


def plan(k: int, splits: int, block_k: int) -> tuple[int, int]:
    """(splits, k_per_split) of ``splits`` even shares of K's steps."""
    steps = -(-k // block_k)
    per = -(-steps // splits)
    return -(-steps // per), per * block_k


def sweep(name, m, k, n, wanted, reps, gen, sms):
    x = torch.randn((m, k), generator=gen, device='cuda').bfloat16()
    weights = [
        tq.quantize_int8(torch.randn((k, n), generator=gen, device='cuda') * 0.02, 'bfloat16')
        for _ in range(max(1, min(16, COLD_BYTES // (k * n))))
    ]
    rows, _, block_k, _ = tqm.tile_config('tensor_cores', m)
    lib, fn = tqm._kernel()
    out = torch.empty((m, n), dtype=torch.bfloat16, device='cuda')
    q0, s0 = weights[0].q, weights[0].scale
    ref = tqm.int8_matmul_reference(x, q0, s0).float()
    tol = tqm.comparison_tolerance(x, q0, s0)
    res = {}
    for want in wanted:
        splits, per = plan(k, want, block_k)
        if splits != want:
            continue
        partial = torch.empty((splits, m, n), device='cuda') if splits > 1 else None

        def launch(qt):
            err = fn(x.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(), out.data_ptr(),
                     None if partial is None else partial.data_ptr(), m, k, n, rows, splits,
                     per, tqm.KERNEL_DTYPES[torch.bfloat16], tqm.ROUTES['tensor_cores'],
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(lib.distllm_qmm_error_string(err).decode())

        launch(weights[0])
        torch.cuda.synchronize()
        worst = float(((out.float() - ref).abs() / tol).max())
        turn = iter(range(1 << 30))
        ms = cs.graph_ms(torch, lambda: launch(weights[next(turn) % len(weights)]), reps)
        res[f's{splits}'] = [ms, worst]
    chosen = tqm.launch_shape(m, k, n, sms, 'tensor_cores')
    print(json.dumps({'case': name, 'block_rows': rows, 'launch_shape': chosen,
                      'ms_and_worst': res}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit('needs CUDA')
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({'device': smi}), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device='cuda').manual_seed(0)
    for case in CASES:
        sweep(*case, gen, sms)
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
