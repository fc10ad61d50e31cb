"""Semantic protein search over a prebuilt embedding index (the counterpart
of the JAX package's ``examples/protein_search.py``, with its arguments):
FASTA queries embed through the port's ESM-2 / ESM-C encoders and hit the
port's exact inner-product index (``rag.search``); one JSON line a query,
``{"query_tag": ..., "hits": [{"score": ..., "tag": ...}, ...]}``. The
index is built beforehand by the embed pipeline and ``merge``, e.g.::

    python -m distllm_tpu_torch.distributed_embedding \\
        --config examples/embed/esm2.fasta.workstation.yaml

Then::

    python -m distllm_tpu_torch.protein_search \\
        --dataset_dir /results/esm2_embeddings/merged \\
        --encoder esm2 --checkpoint /checkpoints/esm2_t33_650M_UR50D \\
        --fasta queries.fasta --top_k 5 [--device cpu]

Without ``--device`` the encoder and the index run on CUDA.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset_dir', type=Path, required=True,
                        help='Merged embedding dataset (build via embed + merge).')
    parser.add_argument('--fasta', type=Path, required=True,
                        help='FASTA file of query sequences.')
    parser.add_argument('--encoder', choices=['esm2', 'esmc', 'fake'], default='esm2',
                        help="'fake' runs checkpoint-free.")
    parser.add_argument('--checkpoint', default=None,
                        help='Local encoder checkpoint directory '
                        '(required unless --encoder fake).')
    parser.add_argument('--top_k', type=int, default=5)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--precision', choices=['float32', 'ubinary'], default='float32')
    parser.add_argument('--output', type=Path, default=None,
                        help='Write JSONL results here (default: stdout).')
    parser.add_argument('--fake_embedding_size', type=int, default=16,
                        help='Embedding size for --encoder fake.')
    parser.add_argument('--device', default=None,
                        help="device of the encoder and the index (default: cuda; 'cpu' "
                        'only when asked)')
    return parser


def search(args: argparse.Namespace) -> list[dict]:
    """One result a FASTA record: its tag and its top-k hits' scores and
    tags."""
    from distllm_tpu_torch.embed.datasets.fasta import read_fasta
    from distllm_tpu_torch.rag.search import RetrieverConfig

    retriever = RetrieverConfig(
        faiss_config={
            'name': 'tpu_index_v2',
            'dataset_dir': str(args.dataset_dir),
            'precision': args.precision,
        },
        encoder_config=(
            {'name': 'fake', 'embedding_size': args.fake_embedding_size}
            if args.encoder == 'fake'
            else {'name': args.encoder, 'pretrained_model_name_or_path': args.checkpoint}
        ),
        pooler_config={'name': 'mean'},
        batch_size=args.batch_size,
    ).get_retriever(device=args.device)

    sequences = read_fasta(args.fasta)
    results, _ = retriever.search([seq.sequence for seq in sequences], top_k=args.top_k)
    return [
        {
            'query_tag': seq.tag,
            'hits': [
                {'score': float(score), 'tag': tag}
                for score, tag in zip(scores, retriever.get(list(indices), 'tags'))
            ],
        }
        for seq, scores, indices in zip(
            sequences, results.total_scores, results.total_indices
        )
    ]


def main(argv: list[str] | None = None) -> None:
    from distllm_tpu_torch.observability.instruments import log_event

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.encoder != 'fake' and not args.checkpoint:
        parser.error('--checkpoint is required unless --encoder fake')
    lines = [json.dumps(result) for result in search(args)]
    if args.output is None:
        for line in lines:
            log_event(line, component='protein_search')
        return
    args.output.write_text(''.join(line + '\n' for line in lines))
    log_event(f'wrote {len(lines)} query results to {args.output}',
              component='protein_search')


if __name__ == '__main__':
    main()
