#!/usr/bin/env python3
"""Time the kernels' headline cases of two checkouts, in turns.

    python3 scripts/profile_torch_kernels_ab.py PARENT_ROOT CHANGE_ROOT

Each root is a checkout of this repository (for example a parent commit
unpacked with ``git archive`` into an ignored directory). The roots run in
the order parent, change, change, parent, each in its own process that
imports that root's ``distllm_tpu_torch`` and ``chip_smoke`` (so each
builds and times its own kernels), on the same card. Cases, bf16, the
inputs made from fixed seeds: K1 ``serve_decode_8x18-1090`` and
``serve_prefill_2x1024``, K3 ``embed_512x288``, K2 ``decode_8x4096x14336``,
``prefill_1040x4096x14336`` and ``embed_147456x768x3072``
(``chip_smoke.py``'s shapes; K2's weight copies cycled so each launch
finds its weight cold in L2). Prints one JSON line per run (mean ms over
CUDA-event timed launches; K2's over a CUDA graph of its launches, so the
host's enqueue time is not counted) and the card's name and power limit.
Needs CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys

_RUN = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
from distllm_tpu_torch.ops import encoder_attention as tea
from distllm_tpu_torch.ops import paged_attention as tpa
from distllm_tpu_torch.ops import quantization as tq
from distllm_tpu_torch.ops import quantized_matmul as tqm


def graph_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (2 * iters)


bf16 = torch.bfloat16
rng = np.random.default_rng(7)
decode = cs.build_case(torch, rng, rng.integers(18, 1091, size=8), np.ones(8), 1, bf16)
prefill = cs.build_case(torch, rng, [1024, 700], [1024, 700], 1024, bf16)
lens = rng.integers(257, 289, size=512)
embed = cs.k3_case(torch, rng, 512, 288, lens, bf16)
out = {}
for name, case, iters in (('serve_decode_8x18-1090', decode, 50),
                          ('serve_prefill_2x1024', prefill, 50)):
    args = (case['q'], case['k'], case['v'], case['bt'], case['ctx'], case['pos'])
    out[name] = cs.cuda_ms(
        torch, lambda: tpa.ragged_paged_attention(*args, q_lens=case['q_lens']), iters)
args = (embed['q'], embed['k'], embed['v'], embed['mask'], cs.BERT_HEADS)
out['embed_512x288'] = cs.cuda_ms(torch, lambda: tea.encoder_attention(*args), 20)
del decode, prefill, embed
gen = torch.Generator(device='cuda').manual_seed(4)
for name, m, k, n, iters in (('decode_8x4096x14336', 8, 4096, 14336, 50),
                             ('prefill_1040x4096x14336', 1040, 4096, 14336, 10),
                             ('embed_147456x768x3072', 512 * 288, 768, 3072, 3)):
    case = cs.k2_case(torch, tq, gen, m, k, n, bf16)
    turn = iter(range(1 << 30))
    ws = case['weights']
    out[name] = graph_ms(
        lambda: tqm.int8_matmul(case['x'], *ws[next(turn) % len(ws)]), iters)
    del case, ws
    torch.cuda.empty_cache()
print(json.dumps(out))
'''


def main() -> None:
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    parent, change = sys.argv[1:]
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({'device': smi}), flush=True)
    for tag, root in (('parent', parent), ('change', change),
                      ('change', change), ('parent', parent)):
        proc = subprocess.run(
            [sys.executable, '-c', _RUN, root], cwd=root, capture_output=True,
            text=True, check=False,
        )
        if proc.returncode:
            sys.exit(f'{tag} run in {root} failed:\n{proc.stderr[-3000:]}')
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({'run': tag, 'root': root, 'ms': times}), flush=True)


if __name__ == '__main__':
    main()
