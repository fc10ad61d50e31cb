#!/usr/bin/env python3
"""Time the kernels' headline cases of two checkouts, in turns.

    python3 scripts/profile_torch_kernels_ab.py PARENT_ROOT CHANGE_ROOT

Each root is a checkout of this repository (for example a parent commit
unpacked with ``git archive`` into an ignored directory). The roots run in
the order parent, change, change, parent, each in its own process that
imports that root's ``distllm_tpu_torch`` and ``chip_smoke`` (so each
builds and times its own kernels), on the same card. Cases, bf16 queries,
the inputs made from fixed seeds (``chip_smoke.py``'s shapes): K1's decode
rows over a bf16 pool (``serve_decode_8x18-1090``, ``decode_32x1-4096``,
``decode_6x1-4096_edges``: contexts at the split-KV plan's edges) and over
an int8 pool (``int8_serve_decode_8x18-1090``, ``int8_decode_32x1-4096``,
``int8_bs32_decode_16x1-2048``, ``int8_decode_32x33-320``), its prefill
pair ``serve_prefill_2x1024``, K3 ``embed_512x288``, K2
``decode_8x4096x14336``, ``prefill_1040x4096x14336`` and
``embed_147456x768x3072`` (K2's weight copies cycled so each launch finds
its weight cold in L2). Prints one JSON line per run (mean ms of a launch
over a CUDA graph of many, so the host's enqueue time is not counted; K3
by CUDA events around eager calls; for K1's two serve decode cases also the
host's time per eager call, ``*_host_us``) and the card's name and power limit.
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
edges = np.asarray([1, 703, 704, 705, 1409, 4096])  # the H100 plan's split of 704 keys
k1_cases = (
    ('serve_decode_8x18-1090', rng.integers(18, 1091, size=8), 1, 16, False),
    ('decode_32x1-4096', np.concatenate([[1, 4096], rng.integers(1, 4097, size=30)]), 1,
     16, False),
    ('decode_6x1-4096_edges', edges, 1, 16, False),
    ('int8_serve_decode_8x18-1090', rng.integers(18, 1091, size=8), 1, 16, True),
    ('int8_decode_32x1-4096', np.concatenate([[1, 4096], rng.integers(1, 4097, size=30)]),
     1, 16, True),
    ('int8_bs32_decode_16x1-2048', rng.integers(1, 2049, size=16), 1, 32, True),
    ('int8_decode_32x33-320', rng.integers(33, 321, size=32), 1, 16, True),
    ('serve_prefill_2x1024', np.asarray([1024, 700]), 1024, 16, False),
)
out = {}
for name, ctxs, span, bs, int8_kv in k1_cases:
    q_lens = np.minimum(ctxs, span)
    case = cs.build_case(torch, rng, ctxs, q_lens, span, bf16, int8_kv=int8_kv, block_size=bs)
    args = (case['q'], case['k'], case['v'], case['bt'], case['ctx'], case['pos'])
    call = lambda: tpa.ragged_paged_attention(*args, q_lens=case['q_lens'])  # noqa: E731
    out[name] = graph_ms(call, 50)
    if name.endswith('serve_decode_8x18-1090'):  # the wrapper's host time a call, µs
        out[name + '_host_us'] = cs.host_call_us(torch, call, 200)
    del case, args
lens = rng.integers(257, 289, size=512)
embed = cs.k3_case(torch, rng, 512, 288, lens, bf16)
args = (embed['q'], embed['k'], embed['v'], embed['mask'], cs.BERT_HEADS)
out['embed_512x288'] = cs.cuda_ms(torch, lambda: tea.encoder_attention(*args), 20)
del embed
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
