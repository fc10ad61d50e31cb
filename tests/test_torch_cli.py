"""The port's ``distllm`` CLI against ``distllm_tpu.cli``.

- Every subcommand takes the JAX CLI's arguments with its defaults
  (``embed`` and ``generate`` add ``--device``), and ``version`` prints
  the version.
- ``chunk_fasta_file`` writes byte-identical files.
- ``tokenize`` over a tokenizer written from a seed gives equal datasets,
  and so does the tokenization job run from a JAX YAML.
- ``embed`` over a tiny BERT checkpoint (fp32: the runs are wrapped to set
  ``half_precision: False``, which the CLI has no flag for) gives
  embeddings within 1e-5 of the JAX CLI's, and ``merge`` of each
  package's shards gives equal datasets.
- ``generate --generator_name tpu`` on a tiny fp32 checkpoint with
  ``--device cpu`` gives the JAX CLI's texts (the JAX side builds its
  ``TpuGenerator`` from the same kwargs at a small capacity).
"""

import json
from pathlib import Path

import numpy as np
import pytest

import distllm_tpu.cli as jax_cli
import distllm_tpu.distributed_embedding as jax_embedding
import distllm_tpu.generate
import distllm_tpu_torch.cli as port_cli
import distllm_tpu_torch.distributed_embedding as port_embedding
from test_torch_checkpoint_serve import write_checkpoint
from test_torch_search import _bert_checkpoint

ATOL = 1e-5
SUBCOMMANDS = ['chunk_fasta_file', 'embed', 'generate', 'merge', 'tokenize', 'version']


def _actions(parser):
    """subcommand -> {dest: (option strings, default, required, nargs,
    type, action class)}."""
    sub = next(a for a in parser._actions if a.dest == 'command')
    return {
        name: {
            a.dest: (tuple(a.option_strings), a.default, a.required, a.nargs,
                     getattr(a.type, '__name__', a.type), type(a).__name__)
            for a in p._actions if a.dest != 'help'
        }
        for name, p in sub.choices.items()
    }


def test_arguments_and_defaults_match():
    ref, port = _actions(jax_cli._build_parser()), _actions(port_cli.build_parser())
    assert sorted(port) == sorted(ref) == SUBCOMMANDS
    for name in SUBCOMMANDS:
        extra = {'device'} if name in ('embed', 'generate') else set()
        assert set(port[name]) - set(ref[name]) == extra, name
        for dest, spec in ref[name].items():
            assert port[name][dest] == spec, (name, dest)
    assert port_cli.main([]) == 2


def test_version(capsys):
    import distllm_tpu_torch

    assert port_cli.main(['version']) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == distllm_tpu_torch.__version__


def test_chunk_fasta_file_is_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    fasta = tmp_path / 'seqs.fasta'
    fasta.write_text(''.join(
        f'>seq{i} tag\n' + ''.join(rng.choice(list('acdefghik'), size=int(rng.integers(5, 90))))
        + '\n' for i in range(23)
    ))
    for name, cli in (('jax', jax_cli), ('port', port_cli)):
        assert cli.main(['chunk_fasta_file', '--fasta_file', str(fasta), '--output_dir',
                         str(tmp_path / name), '--num_chunks', '5']) == 0
    names = sorted(p.name for p in (tmp_path / 'jax').iterdir())
    assert names == sorted(p.name for p in (tmp_path / 'port').iterdir()) and len(names) == 5
    for n in names:
        assert (tmp_path / 'port' / n).read_bytes() == (tmp_path / 'jax' / n).read_bytes()
    empty = tmp_path / 'empty.fasta'
    empty.write_text('')
    assert port_cli.main(['chunk_fasta_file', '--fasta_file', str(empty), '--output_dir',
                          str(tmp_path / 'e'), '--num_chunks', '2']) == 1


def _write_jsonl(root: Path, files: int, rows: int, seed: int, field='text'):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for f in range(files):
        with open(root / f'part{f}.jsonl', 'w') as fh:
            for i in range(rows):
                words = rng.integers(0, 120, size=int(rng.integers(3, 20)))
                fh.write(json.dumps({field: ' '.join(f'w{w}' for w in words),
                                     'path': f'doc{f}-{i}.txt'}) + '\n')
    return root


def _datasets(root: Path):
    """Every HF dataset under ``root``, as sorted row tuples."""
    from datasets import load_from_disk

    rows = []
    for shard in sorted(p for p in root.iterdir() if p.is_dir()):
        ds = load_from_disk(str(shard))
        rows.extend(tuple(json.dumps(row[c], sort_keys=True) for c in ds.column_names)
                    for row in ds)
    return sorted(rows)


def test_tokenize_gives_equal_datasets(tmp_path):
    tok = write_checkpoint(tmp_path / 'tok')
    inputs = _write_jsonl(tmp_path / 'in', files=2, rows=5, seed=4, field='body')
    for name, cli in (('jax', jax_cli), ('port', port_cli)):
        assert cli.main(['tokenize', '--input_dir', str(inputs), '--output_dir',
                         str(tmp_path / name), '--tokenizer_name_or_path', str(tok),
                         '--text_field', 'body', '--max_length', '8',
                         '--return_labels']) == 0
    port_rows = _datasets(tmp_path / 'port' / 'tokenized')
    assert port_rows == _datasets(tmp_path / 'jax' / 'tokenized') and len(port_rows) == 10


def test_the_tokenization_job_reads_the_jax_yaml(tmp_path):
    """``python -m distllm_tpu_torch.distributed_tokenization --config``
    on a JAX YAML: the same datasets as the JAX job, an audit copy the JAX
    ``Config`` reads back, the same refusals; a ``slurm`` compute config
    without ``account`` and ``queue`` is refused as the JAX config refuses
    it."""
    import yaml

    import distllm_tpu.distributed_tokenization as jax_tok
    import distllm_tpu_torch.distributed_tokenization as port_tok

    tok = write_checkpoint(tmp_path / 'tok')
    inputs = _write_jsonl(tmp_path / 'in', files=2, rows=4, seed=7)
    for name, module in (('jax', jax_tok), ('port', port_tok)):
        path = tmp_path / f'{name}.yaml'
        path.write_text(yaml.safe_dump({
            'input_dir': str(inputs), 'output_dir': str(tmp_path / name),
            'tokenizer_config': {'tokenizer_name_or_path': str(tok), 'max_length': '6',
                                 'padding': 'max_length', 'truncation': True},
            'compute_config': {'name': 'local'},
        }))
        assert module.main(['--config', str(path)]) == 0
    port_rows = _datasets(tmp_path / 'port' / 'tokenized')
    assert port_rows == _datasets(tmp_path / 'jax' / 'tokenized') and len(port_rows) == 8
    audit = jax_tok.Config.from_yaml(tmp_path / 'port' / 'config.yaml')
    assert audit.tokenizer_config == port_tok.Config.from_yaml(
        tmp_path / 'port.yaml').tokenizer_config
    for bad in ({}, {'tokenizer_name_or_path': 'x', 'max_length': 'long'},
                {'tokenizer_name_or_path': 'x', 'padding': 3}):
        with pytest.raises(ValueError):
            jax_tok.TokenizerConfig(**bad)
        with pytest.raises(ValueError):
            port_tok.TokenizerConfig.from_dict(bad)
    with pytest.raises(ValueError):
        jax_tok.Config(input_dir='x', output_dir='y', tokenizer_config={},
                       compute_config={'name': 'slurm'})
    with pytest.raises(ValueError, match='missing keys'):
        port_tok.Config(input_dir='x', output_dir='y', tokenizer_config={},
                        compute_config={'name': 'slurm'})
    empty = port_tok.Config(input_dir=str(tmp_path / 'in'), output_dir=str(tmp_path / 'none'),
                            glob_patterns=['*.none'], tokenizer_config={})
    assert port_tok.run_tokenization(empty) == 1


@pytest.fixture(scope='module')
def bert(tmp_path_factory):
    return _bert_checkpoint(tmp_path_factory.mktemp('cli_bert'))


def test_embed_and_merge_match_jax(tmp_path, bert, monkeypatch):
    inputs = _write_jsonl(tmp_path / 'in', files=2, rows=6, seed=5)

    def fp32(module):
        run = module.run_embedding

        def wrapped(config, *args, **kwargs):
            config.encoder_config = {**config.encoder_config, 'half_precision': False}
            return run(config, *args, **kwargs)

        monkeypatch.setattr(module, 'run_embedding', wrapped)

    fp32(jax_embedding)
    fp32(port_embedding)
    args = ['--input_dir', str(inputs), '--glob_patterns', '*.jsonl',
            '--pretrained_model_name_or_path', str(bert), '--batch_size', '4',
            '--dataset_name', 'jsonl',
            '--normalize_embeddings']
    assert jax_cli.main(['embed', '--output_dir', str(tmp_path / 'jax'), *args]) == 0
    assert port_cli.main(['embed', '--output_dir', str(tmp_path / 'port'), *args,
                          '--device', 'cpu']) == 0
    for name, cli in (('jax', jax_cli), ('port', port_cli)):
        assert cli.main(['merge', '--dataset_dir', str(tmp_path / name / 'embeddings'),
                         '--output_dir', str(tmp_path / name / 'merged')]) == 0
    from datasets import load_from_disk

    ref = load_from_disk(str(tmp_path / 'jax' / 'merged'))
    port = load_from_disk(str(tmp_path / 'port' / 'merged'))
    assert len(port) == len(ref) == 12 and port.column_names == ref.column_names
    order = lambda ds: np.argsort(ds['text'], kind='stable')  # noqa: E731  (shard order is by uuid)
    ref_emb = np.asarray(ref['embeddings'], np.float32)[order(ref)]
    port_emb = np.asarray(port['embeddings'], np.float32)[order(port)]
    np.testing.assert_allclose(port_emb, ref_emb, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(port_emb, axis=1), 1.0, atol=1e-5)
    for column in ref.column_names:
        if column != 'embeddings':
            assert [port[column][i] for i in order(port)] == [ref[column][i] for i in order(ref)]
    assert port_cli.main(['merge', '--dataset_dir', str(tmp_path / 'in'),
                          '--output_dir', str(tmp_path / 'none')]) == 1


def test_generate_matches_the_jax_cli(tmp_path, monkeypatch):
    from distllm_tpu.generate.generators.tpu_backend import TpuGenerator, TpuGeneratorConfig

    ckpt = write_checkpoint(tmp_path / 'ckpt')
    inputs = _write_jsonl(tmp_path / 'in', files=2, rows=3, seed=6)
    seen = {}

    def jax_get_generator(kwargs, register=False):
        seen.update(kwargs)
        return TpuGenerator(TpuGeneratorConfig(
            **{k: v for k, v in kwargs.items() if k != 'name'}, block_size=4, num_blocks=64,
            max_num_seqs=4, max_model_len=64, attn_backend='xla'))

    monkeypatch.setattr(distllm_tpu.generate, 'get_generator', jax_get_generator, raising=False)
    args = ['--input_dir', str(inputs), '--glob_patterns', '*.jsonl', '--generator_name', 'tpu',
            '--pretrained_model_name_or_path', str(ckpt), '--temperature', '0',
            '--max_tokens', '6']
    assert jax_cli.main(['generate', '--output_dir', str(tmp_path / 'jax'), *args]) == 0
    assert port_cli.main(['generate', '--output_dir', str(tmp_path / 'port'), *args,
                          '--device', 'cpu']) == 0
    assert seen == {'name': 'tpu', 'pretrained_model_name_or_path': str(ckpt),
                    'temperature': 0.0, 'max_tokens': 6}
    port_rows = _datasets(tmp_path / 'port' / 'generations')
    assert port_rows == _datasets(tmp_path / 'jax' / 'generations') and len(port_rows) == 6
    # The clobber guard: a second run into the same directory is refused.
    assert port_cli.main(['generate', '--output_dir', str(tmp_path / 'port'), *args,
                          '--device', 'cpu']) == 1
