"""``python -m distllm_tpu_torch.protein_search`` against the JAX package's
``examples/protein_search.py``.

A tiny ESM-2 checkpoint is written from a seed
(``test_torch_esm._esm2_hf_checkpoint``); 24 FASTA records are embedded
and merged by the JAX embed pipeline into one dataset, which each side
indexes from its own copy. Both scripts search it with 6 queries (three
records from the index, three mutated) and write JSON lines: the same
query tags and hit tags in the same order, scores within 1e-5. The
queries embed in fp32 on both sides (``get_retriever`` is wrapped to set
``half_precision: False``, which the scripts have no flag for).
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

import distllm_tpu.rag.search as jax_search
import distllm_tpu_torch.rag.search as port_search
from distllm_tpu.distributed_embedding import Config, run_embedding
from distllm_tpu.embed import get_writer
from distllm_tpu_torch import protein_search
from test_torch_esm import _esm2_hf_checkpoint

EXAMPLE = Path(__file__).resolve().parents[1] / 'examples' / 'protein_search.py'
RESIDUES = 'ACDEFGHIKLMNPQRSTVWY'


def _fasta(path: Path, seqs: dict) -> Path:
    path.write_text(''.join(f'>{tag}\n{seq}\n' for tag, seq in seqs.items()))
    return path


@pytest.fixture(scope='module')
def index(tmp_path_factory):
    root = tmp_path_factory.mktemp('protein_search')
    (root / 'esm2').mkdir()
    ckpt = _esm2_hf_checkpoint(root / 'esm2')
    rng = np.random.default_rng(12)
    seqs = {f'prot{i}': ''.join(rng.choice(list(RESIDUES), size=int(rng.integers(8, 40))))
            for i in range(24)}
    (root / 'in').mkdir()
    _fasta(root / 'in' / 'corpus.fasta', seqs)
    assert run_embedding(Config(
        input_dir=root / 'in', output_dir=root / 'embed', glob_patterns=['*.fasta'],
        dataset_config={'name': 'fasta', 'batch_size': 8},
        encoder_config={'name': 'esm2', 'pretrained_model_name_or_path': str(ckpt),
                        'half_precision': False},
        pooler_config={'name': 'mean'}, embedder_config={'name': 'full_sequence'},
        writer_config={'name': 'huggingface'},
    )) == 0
    get_writer({'name': 'huggingface'}).merge(
        sorted((root / 'embed' / 'embeddings').iterdir()), root / 'merged')
    mutated = {f'mut{i}': seqs[f'prot{i}'][:-3] + 'WWW' for i in (4, 9, 20)}
    queries = _fasta(root / 'queries.fasta', {**{t: seqs[t] for t in ('prot1', 'prot7', 'prot23')},
                                              **mutated})
    return root, ckpt, queries


def _fp32_queries(monkeypatch):
    for module in (jax_search, port_search):
        get = module.RetrieverConfig.get_retriever

        def wrapped(self, *args, _get=get, **kwargs):
            self.encoder_config = {**self.encoder_config, 'half_precision': False}
            return _get(self, *args, **kwargs)

        monkeypatch.setattr(module.RetrieverConfig, 'get_retriever', wrapped)


@pytest.mark.parametrize('precision', ['float32', 'ubinary'])
def test_the_same_hits_as_the_jax_example(index, tmp_path, monkeypatch, precision):
    root, ckpt, queries = index
    _fp32_queries(monkeypatch)
    results = {}
    for name in ('jax', 'port'):
        data = tmp_path / name / 'merged'
        shutil.copytree(root / 'merged', data)
        args = ['--dataset_dir', str(data), '--fasta', str(queries), '--encoder', 'esm2',
                '--checkpoint', str(ckpt), '--top_k', '4', '--batch_size', '2',
                '--precision', precision, '--output', str(tmp_path / f'{name}.jsonl')]
        if name == 'jax':
            spec = importlib.util.spec_from_file_location('protein_search_example', EXAMPLE)
            example = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(example)
            monkeypatch.setattr(sys, 'argv', ['protein_search.py', *args])
            example.main()
        else:
            protein_search.main([*args, '--device', 'cpu'])
        results[name] = [json.loads(line) for line in
                         (tmp_path / f'{name}.jsonl').read_text().splitlines()]
    got, want = results['port'], results['jax']
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g['query_tag'] == w['query_tag']
        assert [h['tag'] for h in g['hits']] == [h['tag'] for h in w['hits']]
        np.testing.assert_allclose([h['score'] for h in g['hits']],
                                   [h['score'] for h in w['hits']], atol=1e-5)
    assert [r['hits'][0]['tag'] for r in got[:3]] == ['prot1', 'prot7', 'prot23']


def test_the_arguments_are_the_example_s():
    parser = protein_search.build_parser()
    dests = {a.dest: (a.default, a.required) for a in parser._actions if a.dest != 'help'}
    text = EXAMPLE.read_text()
    for dest in dests:
        if dest != 'device':
            assert f"'--{dest}'" in text, dest
    assert dests['top_k'] == (5, False) and dests['encoder'] == ('esm2', False)
    with pytest.raises(SystemExit):
        protein_search.main(['--dataset_dir', 'x', '--fasta', 'y'])  # no --checkpoint
