#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's embed path, on one GPU.

Builds an embed configuration of ``chip_smoke.py``: a ``TorchEncoder`` in
bf16 with random weights made on the card from seed 0 and the mean
pooler over ``--model``:

- ``bert`` (phase 10): BERT-base (S-PubMedBert-MS-MARCO widths), the
  ``WhitespaceTokenizer``, batch 512, 2048 texts of 120..259 words (seed
  0, a 5000-word vocabulary); ``--quantization int8`` quantizes the dense
  kernels on the card so every projection runs through the int8 matmul
  kernel K2;
- ``esm2`` / ``esmc`` (phases 14 / 14b): ESM-2 650M / ESM-C 600M, the
  ``EsmcSequenceTokenizer``, batch 64, phase 14's 2048 random proteins of
  50..1022 residues;
- ``modernbert`` (phase 14c): ModernBERT-base over the ``bert`` texts at
  vocab 50368, batch 512, L2-normalised.

``--layers`` cuts the depth. After one warm-up pass it

- times ``--repeats`` passes of ``compute_embeddings`` by the host clock
  (embeddings/s; every pass ends in the host copy of its results);
- profiles one more pass under ``torch.profiler`` and sums the device
  time of the CUDA kernels only, by category: the encoder-attention
  kernel (K3), the int8 matmul kernel (K2), other matrix products,
  everything else; per bucket batch and in
  all, with the device's busy share of the plain pass's wall time.

Prints one JSON object per line; ``--out`` also writes them to a file.
Needs CUDA; exits nonzero without it.

    python3 scripts/profile_torch_embed.py [--model bert] [--layers N] [--repeats 3] [--quantization int8] [--out results.json]
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

import chip_smoke  # noqa: E402
from distllm_tpu_torch.embed import get_pooler  # noqa: E402
from distllm_tpu_torch.embed.embedders.full_sequence import (  # noqa: E402
    compute_embeddings,
)
from distllm_tpu_torch.embed.encoders.base import TorchEncoder  # noqa: E402
from distllm_tpu_torch.models import bert, esm2, esmc, modernbert  # noqa: E402
from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer  # noqa: E402


def _model(name: str, layers: 'int | None'):
    """(module, config, tokenizer, batch, normalize, texts) of ``--model``."""
    if name == 'esm2':
        cfg = esm2.Esm2Config.from_hf_config(chip_smoke.ESM2_650M_HF)
        tok = esmc.EsmcSequenceTokenizer(model_max_length=chip_smoke.PROTEIN_LENS[1] + 2)
        out = (esm2, cfg, tok, chip_smoke.PROTEIN_BATCH, False)
    elif name == 'esmc':
        cfg = esmc.EsmcConfig.from_hidden_size(1152)
        out = (esmc, cfg, esmc.EsmcSequenceTokenizer(), chip_smoke.PROTEIN_BATCH, False)
    else:
        module = bert if name == 'bert' else modernbert
        cfg = bert.BertConfig() if name == 'bert' else modernbert.ModernBertConfig()
        tok = WhitespaceTokenizer(vocab_size=cfg.vocab_size, model_max_length=512)
        out = (module, cfg, tok, 512, name == 'modernbert')
    if layers:
        cfg.num_layers = layers
    return out


def _category(name: str) -> str:
    low = name.lower()
    if 'encoder_attention' in low:
        return 'encoder_attention_kernel'
    if 'int8_matmul' in low or 'reduce_splits' in low:  # K2 and its split-K sum
        return 'int8_matmul_kernel'
    if any(t in low for t in ('gemm', 'gemv', 'nvjet', 'cutlass', 'xmma', 'cublas')):
        return 'matmul'
    return 'other'


def _texts(n: int) -> list[str]:
    rng = np.random.default_rng(0)
    vocab = [f'tok{i}' for i in range(5000)]
    return [
        ' '.join(rng.choice(vocab, size=int(rng.integers(120, 260))))
        for _ in range(n)
    ]


def _pass(encoder, texts, batch, normalize, stats=None) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compute_embeddings(
        texts, encoder, get_pooler({'name': 'mean'}), batch, normalize=normalize,
        stats=stats,
    )
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _kernel_times(prof) -> list[tuple[float, int, str]]:
    """(device µs, launches, name) of each CUDA kernel."""
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model', choices=('bert', 'esm2', 'esmc', 'modernbert'),
                        default='bert')
    parser.add_argument('--layers', type=int, default=None, help='cut the depth')
    parser.add_argument('--texts', type=int, default=2048)
    parser.add_argument('--repeats', type=int, default=3)
    parser.add_argument('--quantization', choices=('int8', 'nf4'), default=None)
    parser.add_argument('--out', default=None, help='also write the results here')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('profile_torch_embed: needs CUDA')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    module, cfg, tokenizer, batch, normalize = _model(args.model, args.layers)
    params = module.init(cfg, torch.Generator(device='cuda').manual_seed(0))
    encoder = TorchEncoder(
        None, module.apply, cfg, params, tokenizer, cfg.hidden_size,
        quantization=args.quantization,
    )
    texts = (chip_smoke.protein_sequences(args.texts) if args.model in ('esm2', 'esmc')
             else _texts(args.texts))
    # The warm-up pass builds the kernel and loads cuBLAS handles.
    warm_s = _pass(encoder, texts, batch, normalize)
    stats: dict = {}
    walls = [_pass(encoder, texts, batch, normalize, stats if i == 0 else None)
             for i in range(args.repeats)]
    batches = sum(stats['bucket_batches'].values())
    timed = {
        'card': card, 'model': args.model, 'layers': cfg.num_layers, 'texts': args.texts,
        'quantization': args.quantization,
        'warmup_s': warm_s, 'wall_s': walls,
        'embeddings_per_s': [args.texts / w for w in walls],
        'batches': batches,
        'bucket_batches': {int(k): v for k, v in sorted(stats['bucket_batches'].items())},
        'padding_share': 1.0 - stats['tokens_real'] / stats['tokens_padded'],
    }

    activities = [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA,
    ]
    with torch.profiler.profile(activities=activities) as prof:
        _pass(encoder, texts, batch, normalize)
    kernels = _kernel_times(prof)
    by_cat: dict[str, float] = {}
    for us, _, key in kernels:
        by_cat[_category(key)] = by_cat.get(_category(key), 0.0) + us
    device_ms = sum(by_cat.values()) / 1e3
    wall_ms = min(walls) * 1e3
    profiled = {
        'card': card, 'model': args.model, 'layers': cfg.num_layers, 'profiled_pass': True,
        'quantization': args.quantization,
        'device_ms': device_ms,
        'device_ms_by_category': {k: v / 1e3 for k, v in sorted(by_cat.items())},
        'device_ms_per_batch': device_ms / batches,
        'encoder_attention_share_of_device': (
            by_cat.get('encoder_attention_kernel', 0.0) / 1e3 / device_ms
        ),
        'int8_matmul_share_of_device': (
            by_cat.get('int8_matmul_kernel', 0.0) / 1e3 / device_ms
        ),
        'device_busy_share_of_fastest_wall': device_ms / wall_ms,
        'kernel_launches': sum(c for _, c, _ in kernels),
        'top_kernels': [
            {'device_ms': us / 1e3, 'launches': count, 'name': key[:100]}
            for us, count, key in kernels[:10]
        ],
    }
    results = [timed, profiled]
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1))
    for result in results:
        print(json.dumps(result))


if __name__ == '__main__':
    main()
