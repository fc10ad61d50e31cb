#!/usr/bin/env python3
"""Measure how K2's routes accumulate their fp32 sums, against fp64.

    python3 scripts/profile_torch_qmm_accumulation.py

On the tensor cores the int8 matmul's products are exact in fp32 (bf16 x
bf16, the codes widened exactly). The CUDA cores take fp32 x only, and
an fp32 x int8 product is not exact in fp32 (a 24-bit significand times
a code of up to 7 bits); each ``fmaf`` there rounds product and sum
together. Either way what is measured is the rounding of each route's
fp32 sum. This script takes the unscaled fp32 sums ``sum_k x[m, k] * q[k, n]`` of each
route, before the scale and before any rounding to bf16, and compares them
with the fp64 sum of the same products. It reports the error in units of
``sqrt(K) * 2**-24 * (|x| @ |q|)``, the unit of the order term of
``quantized_matmul.comparison_tolerance`` (whose factor is ``ORDER``),
and the worst error in units of ``2**-24 * W``, the unit of the
tensor-core route's truncation term (``W`` from
``quantized_matmul.partial_sum_magnitude``, whose factor is ``TRUNC``):

- ``'tensor_cores'``, bf16 x: the kernel launched with one split and a
  partial buffer, which receives the raw fp32 sums (16-row and 128-row
  tile configurations);
- ``'cuda_cores'``, fp32 x only (the route's one dtype): the kernel with
  a scale of 1 and fp32 output, which is the raw sum.

Data: x ~ N(0, 1) with codes uniform in [-127, 127] (cancelling, the case
the order term is argued for); their absolute values (every partial sum
as large as the total); and ``chip_smoke.late_cancelling`` (partial sums
near their peak all the way, cancelling exactly at the end: ref = 0); K =
768, 4096 and 14336; N = 1024. Prints one JSON line per case (worst,
99.9th percentile, median and mean signed error, in those units) and the
card's name and power limit. Needs CUDA.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from distllm_tpu_torch.ops import quantized_matmul as tqm  # noqa: E402

N = 1024


def raw_sums(x: torch.Tensor, q: torch.Tensor, route: str) -> torch.Tensor:
    """The route's unscaled fp32 sums ``x @ q`` for one split."""
    m, k = x.shape
    n = q.shape[1]
    block_rows, _, block_k, _ = tqm.tile_config(route, m)
    k_per_split = -(-k // block_k) * block_k
    ones = torch.ones(n, dtype=torch.float32, device=x.device)
    sums = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if route == 'tensor_cores':  # the partial buffer of one split
        out = torch.empty((m, n), dtype=x.dtype, device=x.device)
        out_ptr, partial_ptr = out.data_ptr(), sums.data_ptr()
    else:  # fp32 out with scale 1 is the raw sum
        assert x.dtype == torch.float32
        out_ptr, partial_ptr = sums.data_ptr(), None
    lib, fn = tqm._kernel()
    err = fn(
        x.data_ptr(), q.data_ptr(), ones.data_ptr(), out_ptr, partial_ptr,
        m, k, n, block_rows, 1, k_per_split, tqm.KERNEL_DTYPES[x.dtype],
        tqm.ROUTES[route], torch.cuda.current_stream().cuda_stream,
    )
    if err:
        raise RuntimeError(lib.distllm_qmm_error_string(err).decode())
    torch.cuda.synchronize()
    return sums


def inputs(data: str, dtype: torch.dtype, m: int, k: int, gen: torch.Generator,
           rng: np.random.Generator):
    if data == 'late-cancelling':
        xs, codes = chip_smoke.late_cancelling(rng, m, k, N)
        return torch.from_numpy(xs).to('cuda', dtype), torch.from_numpy(codes).cuda()
    x = torch.randn((m, k), generator=gen, device='cuda').to(dtype)
    q = torch.randint(-127, 128, (k, N), generator=gen, device='cuda', dtype=torch.int8)
    return (x, q) if data == 'cancelling' else (x.abs(), q.abs())


def measure(route: str, dtype: torch.dtype, m: int, k: int, data: str,
            gen: torch.Generator, rng: np.random.Generator) -> dict:
    x, q = inputs(data, dtype, m, k, gen, rng)
    exact = torch.matmul(x.double(), q.double())
    diff = raw_sums(x, q, route).double() - exact
    unit = math.sqrt(k) * 2.0 ** -24 * torch.matmul(x.double().abs(), q.double().abs())
    err = diff / unit
    mag = err.abs().flatten()
    trunc = diff.abs() / (2.0 ** -24 * tqm.partial_sum_magnitude(x, q).double())
    return dict(
        route=route, dtype=str(dtype).removeprefix('torch.'), m=m, k=k, n=N, data=data,
        worst=float(mag.max()), p999=float(mag.kthvalue(int(0.999 * mag.numel())).values),
        median=float(mag.median()), mean_signed=float(err.mean()),
        order_factor=tqm.ORDER, worst_in_w_units=float(trunc.max()), trunc_factor=tqm.TRUNC,
    )


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit('needs CUDA')
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({'device': smi}), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(11)
    rng = np.random.default_rng(11)
    for k in (768, 4096, 14336):
        for data in ('cancelling', 'one-signed', 'late-cancelling'):
            for route, dtype, m in (('tensor_cores', torch.bfloat16, 8),
                                    ('tensor_cores', torch.bfloat16, 256),
                                    ('cuda_cores', torch.float32, 256)):
                print(json.dumps(measure(route, dtype, m, k, data, gen, rng)), flush=True)


if __name__ == '__main__':
    main()
