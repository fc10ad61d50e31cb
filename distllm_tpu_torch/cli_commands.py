"""The CLI's subcommands (counterpart of ``distllm_tpu.cli_commands``):
the JAX CLI's arguments and defaults; ``embed`` and ``generate`` add
``--device``. Each defers its heavy imports to run time."""

from __future__ import annotations

import argparse

from distllm_tpu_torch.cli import subcommand
from distllm_tpu_torch.observability.instruments import log_event


_DEVICE_HELP = "device to run on (default: cuda; 'cpu' only when asked)"


@subcommand('version', 'Print the distllm-tpu-torch version.')
def _version(parser: argparse.ArgumentParser):
    def run(args: argparse.Namespace) -> int:
        import distllm_tpu_torch

        log_event(distllm_tpu_torch.__version__, component='cli')
        return 0

    return run


@subcommand('embed', 'Embed input files on this host (single-process loop).')
def _embed(parser: argparse.ArgumentParser):
    """The single-host embed loop (``distributed_embedding``)."""
    parser.add_argument('--input_dir', required=True)
    parser.add_argument('--output_dir', required=True)
    parser.add_argument('--glob_patterns', nargs='+', default=['*'])
    parser.add_argument('--encoder_name', default='auto')
    parser.add_argument('--pretrained_model_name_or_path', default=None)
    parser.add_argument('--dataset_name', default='jsonl_chunk')
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--pooler_name', default='mean')
    parser.add_argument('--embedder_name', default='full_sequence')
    parser.add_argument('--writer_name', default='huggingface')
    parser.add_argument('--normalize_embeddings', action='store_true')
    parser.add_argument('--device', default=None, help=_DEVICE_HELP)

    def run(args: argparse.Namespace) -> int:
        from distllm_tpu_torch.distributed_embedding import Config, run_embedding

        encoder_kwargs = {'name': args.encoder_name}
        if args.pretrained_model_name_or_path:
            encoder_kwargs['pretrained_model_name_or_path'] = (
                args.pretrained_model_name_or_path
            )
        config = Config(
            input_dir=args.input_dir,
            output_dir=args.output_dir,
            glob_patterns=args.glob_patterns,
            dataset_config={
                'name': args.dataset_name,
                'batch_size': args.batch_size,
            },
            encoder_config=encoder_kwargs,
            pooler_config={'name': args.pooler_name},
            embedder_config={
                'name': args.embedder_name,
                'normalize_embeddings': args.normalize_embeddings,
            },
            writer_config={'name': args.writer_name},
        )
        return run_embedding(config, device=args.device)

    return run


@subcommand('merge', 'Merge embedding shards into one dataset.')
def _merge(parser: argparse.ArgumentParser):
    """The reduce of the map-reduce: every shard directory into one dataset."""
    parser.add_argument('--dataset_dir', required=True, help='Dir of shards.')
    parser.add_argument('--output_dir', required=True)
    parser.add_argument('--writer_name', default='huggingface')
    parser.add_argument('--num_proc', type=int, default=None)

    def run(args: argparse.Namespace) -> int:
        from pathlib import Path

        from distllm_tpu_torch.embed import get_writer

        writer_kwargs = {'name': args.writer_name}
        if args.writer_name == 'huggingface' and args.num_proc:
            writer_kwargs['num_proc'] = args.num_proc
        writer = get_writer(writer_kwargs)
        shards = sorted(
            p for p in Path(args.dataset_dir).iterdir() if p.is_dir()
        )
        if not shards:
            log_event(f'No shard dirs in {args.dataset_dir}', component='cli')
            return 1
        writer.merge(shards, args.output_dir)
        log_event(
            f'Merged {len(shards)} shards -> {args.output_dir}',
            component='cli',
        )
        return 0

    return run


@subcommand('generate', 'Generate responses for input files on this host.')
def _generate(parser: argparse.ArgumentParser):
    """The single-host generation job (``distributed_generation``);
    ``--generator_name tpu`` builds the port's engine."""
    parser.add_argument('--input_dir', required=True)
    parser.add_argument('--output_dir', required=True)
    parser.add_argument('--glob_patterns', nargs='+', default=['*'])
    parser.add_argument('--reader_name', default='jsonl')
    parser.add_argument('--prompt_name', default='identity')
    parser.add_argument('--generator_name', default='tpu')
    parser.add_argument('--pretrained_model_name_or_path', default=None)
    parser.add_argument('--temperature', type=float, default=0.5)
    parser.add_argument('--max_tokens', type=int, default=2000)
    parser.add_argument('--writer_name', default='huggingface')
    parser.add_argument('--device', default=None, help=_DEVICE_HELP)

    def run(args: argparse.Namespace) -> int:
        from distllm_tpu_torch.distributed_generation import Config, run_generation

        generator_kwargs = {'name': args.generator_name}
        if args.pretrained_model_name_or_path:
            generator_kwargs['pretrained_model_name_or_path'] = (
                args.pretrained_model_name_or_path
            )
        if args.generator_name in ('tpu', 'vllm', 'api', 'langchain'):
            generator_kwargs['temperature'] = args.temperature
            generator_kwargs['max_tokens'] = args.max_tokens
        config = Config(
            input_dir=args.input_dir,
            output_dir=args.output_dir,
            glob_patterns=args.glob_patterns,
            reader_config={'name': args.reader_name},
            prompt_config={'name': args.prompt_name},
            generator_config=generator_kwargs,
            writer_config={'name': args.writer_name},
        )
        return run_generation(config, device=args.device)

    return run


@subcommand('tokenize', 'Tokenize jsonl files into HF datasets.')
def _tokenize(parser: argparse.ArgumentParser):
    """The tokenization job (``distributed_tokenization``)."""
    parser.add_argument('--input_dir', required=True)
    parser.add_argument('--output_dir', required=True)
    parser.add_argument('--glob_patterns', nargs='+', default=['*.jsonl'])
    parser.add_argument('--tokenizer_name_or_path', required=True)
    parser.add_argument('--text_field', default='text')
    parser.add_argument('--max_length', type=int, default=2048)
    parser.add_argument('--return_labels', action='store_true')

    def run(args: argparse.Namespace) -> int:
        from distllm_tpu_torch.distributed_tokenization import (
            Config,
            run_tokenization,
        )

        config = Config(
            input_dir=args.input_dir,
            output_dir=args.output_dir,
            glob_patterns=args.glob_patterns,
            tokenizer_config={
                'tokenizer_name_or_path': args.tokenizer_name_or_path,
                'text_field': args.text_field,
                'max_length': args.max_length,
                'return_labels': args.return_labels,
            },
        )
        return run_tokenization(config)

    return run


@subcommand('chunk_fasta_file', 'Split a FASTA file into N shard files.')
def _chunk_fasta(parser: argparse.ArgumentParser):
    """``num_chunks`` FASTA files of consecutive records."""
    parser.add_argument('--fasta_file', required=True)
    parser.add_argument('--output_dir', required=True)
    parser.add_argument('--num_chunks', type=int, required=True)

    def run(args: argparse.Namespace) -> int:
        from pathlib import Path

        from distllm_tpu_torch.embed.datasets.fasta import read_fasta, write_fasta

        sequences = read_fasta(args.fasta_file)
        if not sequences:
            log_event(f'No sequences found in {args.fasta_file}', component='cli')
            return 1
        out = Path(args.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        n = max(1, args.num_chunks)
        per = (len(sequences) + n - 1) // n
        stem = Path(args.fasta_file).stem
        for i in range(0, len(sequences), per):
            write_fasta(
                sequences[i : i + per], out / f'{stem}.chunk{i // per:04d}.fasta'
            )
        log_event(
            f'Wrote {(len(sequences) + per - 1) // per} chunks to {out}',
            component='cli',
        )
        return 0

    return run
