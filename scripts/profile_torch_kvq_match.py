#!/usr/bin/env python3
"""How far greedy streams of the int8-KV engine follow the bf16-KV engine's,
against how far two bf16 engines that differ only in rounding follow each
other.

    python3 scripts/profile_torch_kvq_match.py [--layers 32]

Serves ``chip_smoke.py`` phase 6b's workload (the JAX ``gen_kvq`` stage's:
64 greedy prompts of 32..192 tokens, every third behind a shared 32-token
prefix, 16..96 new tokens each) through four ``LLMEngine`` arms on the
same random bf16 Mistral-7B weights (made on the card from seed 0; block
16, 1024 blocks, 32 slots, 16-step windows): a bf16 and an int8 KV pool,
each attended by kernel K1 (``attn_backend='auto'``) and by its plain
version (``'reference'``). For each pair of arms it prints the fraction
of positions whose greedy tokens match (the ``gen_kvq`` measure), the
fraction of first tokens that match (the prefill alone) and the mean
index of the first mismatch; then the first 12 tokens of three requests
in each arm, and the gap between the top two logits of each prompt's
first token over a bf16 pool (how close the greedy choices are to a
tie). Needs CUDA.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from distllm_tpu_torch.generate.engine import (  # noqa: E402
    EngineConfig,
    LLMEngine,
    PagedKVCache,
    SamplingParams,
)
from distllm_tpu_torch.models import mistral  # noqa: E402


def compare(a: list[list[int]], b: list[list[int]]) -> dict:
    matched = total = first = 0
    divergence = []
    for x, y in zip(a, b):
        total += max(len(x), len(y))
        matched += sum(1 for i, j in zip(x, y) if i == j)
        first += x[:1] == y[:1]
        diff = [k for k, (i, j) in enumerate(zip(x, y)) if i != j]
        divergence.append(diff[0] if diff else min(len(x), len(y)))
    return {'greedy_match': matched / total, 'first_token_match': first / len(a),
            'mean_first_mismatch': float(np.mean(divergence))}


def first_token_gaps(cfg, params, prompts) -> list[float]:
    """Top-1 minus top-2 logit of each prompt's first token: the prefill
    of each prompt alone over a bf16 pool (how close the greedy choice is
    to a tie)."""
    device = params['embed'].device
    gaps = []
    for prompt in prompts:
        n = len(prompt)
        pool = PagedKVCache(cfg.num_layers, 2 + n // cs.BLOCK_SIZE, cs.BLOCK_SIZE,
                            cfg.num_kv_heads, cfg.head_size, torch.bfloat16, device)
        put = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)  # noqa: E731
        logits, _, _ = mistral.prefill_paged(
            params, cfg, put([prompt]), put([np.arange(n)]), pool.k, pool.v,
            put([np.arange(1, pool.num_blocks)]), put([n]), put([n]),
            max_table_positions=2048,
        )
        top = torch.topk(logits[0].float(), 2).values
        gaps.append(float(top[0] - top[1]))
    return gaps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--layers', type=int, default=32)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('profile_torch_kvq_match: needs CUDA')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cfg = mistral.MistralConfig(num_layers=args.layers)
    params = mistral.init(cfg, torch.Generator(device='cuda').manual_seed(0))
    prompts, budgets = cs.kvq_workload(cfg.vocab_size)
    sampling = [SamplingParams(temperature=0.0, max_tokens=n) for n in budgets]
    streams = {}
    for kv, backend in itertools.product(('bf16', 'int8'), ('auto', 'reference')):
        engine = LLMEngine(cfg, params, None, EngineConfig(
            block_size=cs.BLOCK_SIZE, num_blocks=1024, max_num_seqs=32,
            max_model_len=2048, decode_steps=16, kv_cache_dtype=kv,
        ), attn_backend=backend)
        streams[f'{kv}_{backend}'] = engine.generate_ids(prompts, sampling)
        engine.shutdown()
    names = list(streams)
    for a, b in itertools.combinations(names, 2):
        print(json.dumps({'card': card, 'layers': args.layers, 'arms': [a, b],
                          **compare(streams[a], streams[b])}), flush=True)
    # The first 12 tokens of three requests in every arm, to read how the
    # streams part.
    print(json.dumps({name: [t[:12] for t in tokens[:3]]
                      for name, tokens in streams.items()}), flush=True)
    gaps = np.asarray(first_token_gaps(cfg, params, prompts))
    print(json.dumps({
        'card': card, 'layers': args.layers, 'first_token_logit_gap': {
            'median': float(np.median(gaps)), 'min': float(gaps.min()),
            'share_below_0.01': float((gaps < 0.01).mean()),
            'share_below_0.1': float((gaps < 0.1).mean()),
        }}), flush=True)


if __name__ == '__main__':
    main()
