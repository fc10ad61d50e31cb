#!/usr/bin/env python3
"""Where the cycles of a step go inside the tensor-core routes of K1 and K3.

Two parts. The first covers route 1 (``mma.sync``):

Builds a copy of ``distllm_tpu_torch/csrc`` into
``distllm_tpu_torch/_build/phases/`` with ``clock64()`` counters added to
the tensor-core kernels (``ragged_paged_attention_mma_kernel`` and
``encoder_attention_mma_kernel``), launches each once at the main paths'
shapes and prints, per warp and per key-tile step, the cycles spent in
each phase:

- ``prologue``: query tile, block table or key bias, first tile issued;
- ``stage_issue``: issuing the next tile's ``cp.async`` copies;
- ``wait_sync``: waiting for this tile's copies and the block barrier;
- ``scores``: Q·Kᵀ products, bias or mask and (K1) the online softmax,
  the copies' issue included;
- ``softmax_pv``: K1's P·V products; K3's pass-1 max and sum or its
  pass-2 P·V products;
- ``end_sync``: the closing barrier; ``epilogue``: the output written.

The counters are read after one launch. The kernel's own time
(``kernel_ms``, CUDA events) is printed beside the counted copy's
(``counted_ms``), which is slower by the counters' cost. Needs CUDA and
``nvcc``; the source anchors are asserted, so a kernel edited out of step
with this script fails loudly.

The second covers the 'wgmma' routes (K1's route 3, K3's route 2), whose
counters are compiled in with ``-DDISTLLM_PHASES`` (``csrc/
hopper_attention.cuh``): the copy is built into
``distllm_tpu_torch/_build/`` under its own hash and launched once a case;
each consumer warpgroup's thread 0 adds its cycles to ``WGMMA_PHASES``,
the producer thread to the last two. Printed per consumer warpgroup of a
block (kcycles), and the producer's per block.

    python3 scripts/profile_torch_kernel_phases.py
"""

from __future__ import annotations

import ctypes
import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from distllm_tpu_torch.ops import _build  # noqa: E402
from distllm_tpu_torch.ops import encoder_attention as tea  # noqa: E402
from distllm_tpu_torch.ops import paged_attention as tpa  # noqa: E402

MARK = '// ------------------------------------------------- route 1, tensor cores'
DECL = MARK + '''
__device__ unsigned long long g_phases[16];
#define PHASE_NOW() clock64()
'''
EXPORT = '''
extern "C" int distllm_read_phases(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phases, sizeof(g_phases));
  if (reset) {
    unsigned long long zero[16] = {0};
    cudaMemcpyToSymbol(g_phases, zero, sizeof(zero));
  }
  return int(e);
}
'''
START = '''  const long long t_start = PHASE_NOW();
  long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long c0 = 0, c2 = 0, c3 = 0, c4 = 0, loop_end = 0;
'''
FLUSH = '''
  acc[7] = PHASE_NOW() - t_start;
  if (lane == 0) {
    for (int i = 0; i < 8; ++i) atomicAdd(&g_phases[i], (unsigned long long)acc[i]);
    atomicAdd(&g_phases[8], 1ull);
    atomicAdd(&g_phases[9], (unsigned long long)(STEPS));
  }
'''
PHASES = ('prologue', 'stage_issue', 'wait_sync', 'scores', 'softmax_pv',
          'end_sync', 'epilogue', 'total')

EDITS = {
    'encoder_attention.cu': [
        (MARK, DECL),
        ('''  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;''', START + '''  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;'''),
        ('''  for (int step = 0; step < 2 * nt; ++step) {
    const int buf = step & 1;
    const int t0 = (step % nt) * kBK;
    cp_async_wait<0>();  // the query tile and this step's tile have landed
    __syncthreads();''', '''  acc[0] = PHASE_NOW() - t_start;
  for (int step = 0; step < 2 * nt; ++step) {
    const int buf = step & 1;
    const int t0 = (step % nt) * kBK;
    c0 = PHASE_NOW();
    cp_async_wait<0>();  // the query tile and this step's tile have landed
    __syncthreads();
    c2 = PHASE_NOW(); acc[2] += c2 - c0;'''),
        ('''    if (step + 1 < 2 * nt) stage(step + 1);
    cp_async_commit();
    add_bias(t0);''', '''    { const long long c1 = PHASE_NOW();
    if (step + 1 < 2 * nt) stage(step + 1);
    cp_async_commit();
    acc[1] += PHASE_NOW() - c1; }
    add_bias(t0);
    c3 = PHASE_NOW(); acc[3] += c3 - c2;'''),
        ('''    __syncthreads();  // this step's buffer is free for step + 2
  }
''', '''    c4 = PHASE_NOW(); acc[4] += c4 - c3;
    __syncthreads();  // this step's buffer is free for step + 2
    acc[5] += PHASE_NOW() - c4;
  }
  loop_end = PHASE_NOW();
'''),
        ('''          __floats2bfloat162_rn(o[n][2 * i], o[n][2 * i + 1]);
    }
  }
}''', '''          __floats2bfloat162_rn(o[n][2 * i], o[n][2 * i + 1]);
    }
  }
  acc[6] = PHASE_NOW() - loop_end;
''' + FLUSH.replace('STEPS', '2 * nt') + '}'),
    ],
    'ragged_paged_attention.cu': [
        (MARK, DECL),
        ('''  const int qt = gridDim.x - 1 - blockIdx.x;''',
         START + '''  const int qt = gridDim.x - 1 - blockIdx.x;'''),
        ('''  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kKeys;
    const int buf = it & 1;
    cp_async_wait<0>();  // the query tile and tile it have landed
    __syncthreads();''', '''  acc[0] = PHASE_NOW() - t_start;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kKeys;
    const int buf = it & 1;
    c0 = PHASE_NOW();
    cp_async_wait<0>();  // the query tile and tile it have landed
    __syncthreads();
    c2 = PHASE_NOW(); acc[2] += c2 - c0;'''),
        ('''    if (it + 1 < n_tiles) stage(buf ^ 1, t0 + kKeys);
    cp_async_commit();''', '''    { const long long c1 = PHASE_NOW();
    if (it + 1 < n_tiles) stage(buf ^ 1, t0 + kKeys);
    cp_async_commit();
    acc[1] += PHASE_NOW() - c1; }'''),
        ('''      // O += P V: the S accumulators, rounded to bf16, are P's A fragments;''',
         '''      c3 = PHASE_NOW(); acc[3] += c3 - c2;
      // O += P V: the S accumulators, rounded to bf16, are P's A fragments;'''),
        ('''    __syncthreads();  // tile it's buffer is free for tile it + 2
  }''', '''    c4 = PHASE_NOW();
    if (c3 > c2) acc[4] += c4 - c3;
    c3 = 0;
    __syncthreads();  // tile it's buffer is free for tile it + 2
    acc[5] += PHASE_NOW() - c4;
  }
  loop_end = PHASE_NOW();'''),
        ('''        *reinterpret_cast<const uint4*>(s_q + r * kStride + col);
  }
}''', '''        *reinterpret_cast<const uint4*>(s_q + r * kStride + col);
  }
  acc[6] = PHASE_NOW() - loop_end;
''' + FLUSH.replace('STEPS', 'n_tiles') + '}'),
    ],
}


def instrumented_libraries() -> dict[str, ctypes.CDLL]:
    """Build the counted copies of the two attention kernels in parallel."""
    work = _build.BUILD_DIR / 'phases'
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, work)
    for name, edits in EDITS.items():
        path = work / name
        head, tail = path.read_text().split(MARK)
        tail = MARK + tail
        for old, new in edits:
            if tail.count(old) != 1:
                raise RuntimeError(f'{name}: anchor not found once:\n{old}')
            tail = tail.replace(old, new)
        path.write_text(head + tail + EXPORT)
    procs = {
        name: subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, '-o',
             str(work / f'lib{name}.so'), str(work / f'{name}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name in ('ragged_paged_attention', 'encoder_attention')
    }
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed on the counted {name}:\n{log}')
        libs[name] = ctypes.CDLL(str(work / f'lib{name}.so'))
    return libs


# The wgmma routes' counters (csrc/*.cu PHASE(i) marks), by index.
WGMMA_PHASES = {
    'encoder_attention': (
        'prologue', 'pass1_k_wait', 'pass1_qk_wait', 'pass1_softmax', 'verdict',
        'pass2_kv_wait', None, 'pass2_exp_under_products', 'pass2_pv_wait', 'pass2_pack',
        'pass2_edges_and_output', 'producer_acquire', 'producer_issue'),
    'ragged_paged_attention': (
        'prologue', 'k_wait', 'v_ready_zero_rescale', 'qk_wait', 'softmax', 'pv_wait',
        'pack', 'idle_tiles', 'first_tile_and_output', None, None, 'producer_acquire',
        'producer_issue'),
}


def wgmma_phases() -> None:
    """The wgmma routes' cycle split at the headline cases (one launch
    each, counters compiled in)."""
    flags = _build.NVCC_FLAGS
    _build.NVCC_FLAGS = flags + ('-DDISTLLM_PHASES',)
    _build._loaded.clear()
    try:
        libs = {name: _build.load(name) for name in WGMMA_PHASES}
    finally:
        _build.NVCC_FLAGS = flags
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    cases = []
    with cs.k1_geometry(cs.GEMMA2_HEADS, cs.GEMMA2_KV_HEADS, cs.GEMMA2_HEAD_DIM):
        case = cs.build_case(torch, rng, [4600], [4600], 4736, bf16)
        args = (case['q'], case['k'], case['v'], case['bt'], case['ctx'], case['pos'])
        cases.append((cs.HD256_PREFILL, 'ragged_paged_attention', functools.partial(
            tpa.ragged_paged_attention_cuda, *args, q_lens=case['q_lens'],
            scale=cs.GEMMA2_SCALE, route='wgmma'), 72 * cs.GEMMA2_KV_HEADS))
    case = cs.build_case(torch, rng, [1024, 700], [1024, 700], 1024, bf16)
    args = (case['q'], case['k'], case['v'], case['bt'], case['ctx'], case['pos'])
    cases.append(('serve_prefill_2x1024', 'ragged_paged_attention', functools.partial(
        tpa.ragged_paged_attention_cuda, *args, q_lens=case['q_lens'], route='wgmma'),
        2 * 32 * cs.NUM_KV_HEADS))
    for name, b, s, heads, window in cs.K3_MODEL_CASES:
        lens = rng.integers(min(s, cs.PROTEIN_LENS[0]), s + 1, size=b)
        lens[0] = s
        case = cs.k3_case(torch, rng, b, s, lens, bf16, window=window, heads=heads)
        args = (case['q'], case['k'], case['v'], case['mask'], heads)
        cases.append((name, 'encoder_attention', functools.partial(
            tea.encoder_attention_cuda, *args, bias=case['bias'], route='wgmma'),
            -(-s // 128) * heads * b))
    for name, kernel, launch, blocks in cases:
        lib = libs[kernel]
        _build._loaded[kernel] = lib
        read = lib.distllm_read_phases
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_ulonglong * 16)()
        counted_ms = cs.cuda_ms(torch, launch, 5)
        read(ctypes.addressof(buf), 1)
        launch()
        torch.cuda.synchronize()
        read(ctypes.addressof(buf), 1)
        names = WGMMA_PHASES[kernel]
        row = {'case': name, 'kernel': kernel, 'route': 'wgmma', 'counted_ms': counted_ms,
               'blocks': blocks}
        row['kcycles_per_consumer_warpgroup'] = {
            p: round(buf[i] / (2 * blocks) / 1000, 2)
            for i, p in enumerate(names) if p and not p.startswith('producer')}
        row['kcycles_per_block_producer'] = {
            p: round(buf[i] / blocks / 1000, 2)
            for i, p in enumerate(names) if p and p.startswith('producer')}
        print(json.dumps(row), flush=True)
    _build._loaded.clear()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit('profile_torch_kernel_phases: needs a CUDA GPU')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm',
         '--format=csv,noheader'], capture_output=True, text=True, check=True,
    ).stdout.strip()
    _build.build_all()
    plain_libs = {name: _build.load(name) for name in
                  ('ragged_paged_attention', 'encoder_attention')}
    counted = instrumented_libraries()
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    cases = {
        'serve_prefill_2x1024': cs.build_case(torch, rng, [1024, 700], [1024, 700], 1024, bf16),
        'b_prefill_4x512': cs.build_case(
            torch, rng, np.asarray([512, 400, 1017, 2001]),
            np.asarray([512, 300, 17, 0]), 512, bf16),
    }
    for s in (128, 288):
        lens = rng.integers(s - 31, s + 1, size=512)
        cases[f'embed_512x{s}'] = cs.k3_case(torch, rng, 512, s, lens, bf16)
    print(json.dumps({'device': smi}), flush=True)
    for name, case in cases.items():
        if name.startswith('embed'):
            kernel = 'encoder_attention'
            args = (case['q'], case['k'], case['v'], case['mask'], cs.BERT_HEADS)
            launch = functools.partial(tea.encoder_attention_cuda, *args, route='tensor_cores')
        else:
            kernel = 'ragged_paged_attention'
            args = (case['q'], case['k'], case['v'], case['bt'], case['ctx'], case['pos'])
            launch = functools.partial(tpa.ragged_paged_attention_cuda, *args,
                                       q_lens=case['q_lens'], route='tensor_cores')
        row = {'case': name, 'kernel': kernel}
        for tag, lib in (('kernel', plain_libs[kernel]), ('counted', counted[kernel])):
            _build._loaded[kernel] = lib
            row[f'{tag}_ms'] = cs.cuda_ms(torch, launch, 20)
        buf = (ctypes.c_ulonglong * 16)()
        lib = counted[kernel]
        lib.distllm_read_phases(buf, 1)
        launch()
        torch.cuda.synchronize()
        lib.distllm_read_phases(buf, 1)
        _build._loaded[kernel] = plain_libs[kernel]
        warps, steps = buf[8], max(buf[9], 1)
        row.update(
            warps=warps, warp_steps=buf[9],
            cycles_per_warp={p: round(buf[i] / warps) for i, p in enumerate(PHASES)},
            cycles_per_step={p: round(buf[i] / steps) for i, p in enumerate(PHASES)
                             if p in ('stage_issue', 'wait_sync', 'scores',
                                      'softmax_pv', 'end_sync')},
        )
        print(json.dumps(row), flush=True)
    wgmma_phases()


if __name__ == '__main__':
    main()
