"""The embed strategies ported with the protein path, against the JAX
package's, on the CPU.

The ``fasta``, ``sequence_per_line``, ``jsonl_chunk`` and ``huggingface``
datasets read the same files to the same corpora; ``semantic_chunk``
gives the same chunk texts and metadata and, on the same tiny BERT
weights, embeddings within ``atol 1e-5``; the ``huggingface`` writer's
``write`` and ``merge`` give the same columns and values; the ``auto``
encoder serves ``esm`` and ``modernbert`` checkpoints written from a seed
as JAX does, in fp32 and with ``quantization: int8`` (pooled embeddings
within ``1e-5``); the ``fake`` encoder keeps JAX's shapes, dtype and
per-seed determinism; the ``workstation`` compute config runs, and the
pod configs raise naming ROADMAP A11. Last, ``run_embedding`` on
``examples/embed/esm2.fasta.workstation.yaml``, its paths and checkpoint
replaced by tiny local ones and ``half_precision: false``, gives JAX's
embeddings in both packages' ``huggingface`` shards within ``1e-5``.
"""

import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from distllm_tpu import distributed_embedding as jax_embedding
from distllm_tpu.embed import datasets as jax_datasets
from distllm_tpu.embed import embedders as jax_embedders
from distllm_tpu.embed import encoders as jax_encoders
from distllm_tpu.embed import get_dataset as jax_get_dataset
from distllm_tpu.embed import get_embedder as jax_get_embedder
from distllm_tpu.embed import get_encoder as jax_get_encoder
from distllm_tpu.embed import get_pooler as jax_get_pooler
from distllm_tpu.embed import get_writer as jax_get_writer
from distllm_tpu.embed import poolers as jax_poolers
from distllm_tpu.embed import writers as jax_writers
from distllm_tpu.embed.embedders import full_sequence as jax_full_sequence
from distllm_tpu.embed.embedders.base import EmbedderResult as JaxEmbedderResult
from distllm_tpu.embed.encoders.base import JaxEncoder
from distllm_tpu.models import bert as jax_bert
from distllm_tpu.models import tokenizer as jax_tokenizer
from distllm_tpu.parallel import launcher as jax_launcher
from distllm_tpu_torch import distributed_embedding as port_embedding
from distllm_tpu_torch.embed import datasets, embedders, encoders, poolers, writers
from distllm_tpu_torch.embed import get_dataset, get_embedder, get_encoder, get_pooler, get_writer
from distllm_tpu_torch.embed.embedders.base import EmbedderResult
from distllm_tpu_torch.embed.embedders.full_sequence import compute_embeddings
from distllm_tpu_torch.embed.encoders.base import TorchEncoder
from distllm_tpu_torch.models import bert, esm2, modernbert
from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer
from distllm_tpu_torch.ops import quantization as tq
from distllm_tpu_torch.parallel import launcher
from tests.test_torch_esm import _esm2_hf_checkpoint
from tests.test_torch_modernbert import hf_config, hf_state

ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize('family,port,ref', [
    ('dataset', datasets, jax_datasets), ('encoder', encoders, jax_encoders),
    ('pooler', poolers, jax_poolers), ('embedder', embedders, jax_embedders),
    ('writer', writers, jax_writers),
])
def test_every_jax_strategy_is_ported(family, port, ref):
    assert sorted(port.STRATEGIES) == sorted(ref.STRATEGIES), family


# ------------------------------------------------------------ datasets
FASTA = """>sp|P1|first protein
MKTAYIAKQR
qisfvkshfs

>sp|P2|second
ACDEFGHIKL
>empty record
>third
mnpqrstvwy
"""


def _same_corpus(port, ref):
    assert port.texts == ref.texts
    assert port.metadata == ref.metadata


def test_fasta_dataset_reads_as_jax(tmp_path):
    path = tmp_path / 'seqs.fasta'
    path.write_text(FASTA)
    port = get_dataset({'name': 'fasta', 'batch_size': 64})
    ref = jax_get_dataset({'name': 'fasta', 'batch_size': 64})
    assert port.config.batch_size == ref.config.batch_size == 64
    _same_corpus(port.read(path), ref.read(path))
    corpus = port.read(path)
    assert corpus.texts == ['MKTAYIAKQRQISFVKSHFS', 'ACDEFGHIKL', 'MNPQRSTVWY']
    assert corpus.metadata[0] == {'tags': 'sp|P1|first protein', 'paths': str(path)}
    # write_fasta round-trips the records the reader made.
    from distllm_tpu.embed.datasets.fasta import read_fasta as jax_read_fasta
    from distllm_tpu_torch.embed.datasets.fasta import read_fasta, write_fasta

    out = tmp_path / 'out.fasta'
    write_fasta(read_fasta(path), out)
    assert [(s.sequence, s.tag) for s in read_fasta(out)] == [
        (s.sequence, s.tag) for s in jax_read_fasta(path)]


@pytest.mark.parametrize('header_lines', [0, 1])
def test_sequence_per_line_dataset_reads_as_jax(tmp_path, header_lines):
    path = tmp_path / 'seqs.txt'
    path.write_text('sequence\nMKTAYIAKQR\n\n  ACDEF  \nmnpq\n')
    kwargs = {'name': 'sequence_per_line', 'header_lines': header_lines}
    _same_corpus(get_dataset(kwargs).read(path), jax_get_dataset(kwargs).read(path))


def _documents(rng, n_docs, n_sentences):
    words = [f'w{i}' for i in range(60)]
    docs = []
    for d in range(n_docs):
        sentences = [
            ' '.join(rng.choice(words, size=int(rng.integers(3, 12)))).capitalize() + '.'
            for _ in range(n_sentences)
        ]
        docs.append({'text': '  '.join(sentences), 'path': f'doc{d}.txt', 'id': d})
    return docs


@pytest.fixture(scope='module')
def chunk_file(tmp_path_factory):
    path = tmp_path_factory.mktemp('chunks') / 'docs.jsonl'
    rng = np.random.default_rng(0)
    docs = _documents(rng, 3, 14) + [{'text': 'Short.', 'path': 'doc3.txt', 'id': 3}]
    path.write_text(''.join(json.dumps(d) + '\n' for d in docs))
    return path


@pytest.mark.parametrize('buffer_size,min_len', [(1, 20), (2, 120), (0, 0)])
def test_jsonl_chunk_dataset_reads_as_jax(chunk_file, buffer_size, min_len):
    kwargs = {'name': 'jsonl_chunk', 'buffer_size': buffer_size,
              'min_buffer_length': min_len}
    port = get_dataset(kwargs).read(chunk_file)
    _same_corpus(port, jax_get_dataset(kwargs).read(chunk_file))
    assert port.texts and all('sentence' in m and 'path' in m for m in port.metadata)


def test_huggingface_dataset_reads_as_jax(tmp_path):
    from datasets import Dataset

    Dataset.from_dict({
        'text': ['alpha beta', 'gamma', 'delta epsilon zeta'],
        'source': ['a', 'b', 'c'], 'year': [2001, 2002, 2003],
    }).save_to_disk(str(tmp_path / 'ds'))
    for fields in ([], ['source', 'year']):
        kwargs = {'name': 'huggingface', 'metadata_fields': fields}
        _same_corpus(get_dataset(kwargs).read(tmp_path / 'ds'),
                     jax_get_dataset(kwargs).read(tmp_path / 'ds'))


def test_importing_the_datasets_needs_neither_nltk_nor_datasets():
    import subprocess
    import sys

    probe = (
        'import sys; import distllm_tpu_torch.embed, distllm_tpu_torch.distributed_embedding; '
        "print(sorted(m for m in ('nltk', 'datasets') if m in sys.modules))"
    )
    out = subprocess.run([sys.executable, '-c', probe], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'


# ------------------------------------------------------ semantic_chunk
TINY_BERT = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64, max_position_embeddings=128, dtype='float32')


@pytest.fixture(scope='module')
def bert_encoders():
    jcfg = jax_bert.BertConfig(**TINY_BERT)
    tree = jax.tree.map(np.asarray, jax_bert.init(jax.random.PRNGKey(1), jcfg))
    tcfg = bert.BertConfig(**TINY_BERT)
    jax_enc = JaxEncoder(
        config=None, apply_fn=jax_bert.apply, model_cfg=jcfg, params=tree,
        tokenizer=jax_tokenizer.WhitespaceTokenizer(vocab_size=256, model_max_length=128),
        embedding_size=32,
    )
    port_enc = TorchEncoder(
        config=None, apply_fn=bert.apply, model_cfg=tcfg,
        params=bert.params_from_jax(tree, tcfg, device='cpu'),
        tokenizer=WhitespaceTokenizer(vocab_size=256, model_max_length=128),
        embedding_size=32, device='cpu',
    )
    return jax_enc, port_enc


@pytest.mark.parametrize('percentile,normalize', [(90, False), (50, True)])
def test_semantic_chunk_matches_jax(chunk_file, bert_encoders, percentile, normalize):
    jax_enc, port_enc = bert_encoders
    corpus_kwargs = {'name': 'jsonl_chunk', 'min_buffer_length': 20, 'batch_size': 4}
    embed_kwargs = {'name': 'semantic_chunk', 'breakpoint_percentile_threshold': percentile,
                    'chunk_batch_size': 3, 'min_chunk_length': 40,
                    'normalize_embeddings': normalize}
    want = jax_get_embedder(embed_kwargs).embed(
        jax_get_dataset(corpus_kwargs).read(chunk_file), jax_enc,
        jax_get_pooler({'name': 'mean'}), 4)
    got = get_embedder(embed_kwargs).embed(
        get_dataset(corpus_kwargs).read(chunk_file), port_enc,
        get_pooler({'name': 'mean'}), 4)
    assert got.text == want.text and got.metadata == want.metadata
    assert len(got.text) > 3 and all('sentence' not in m for m in got.metadata)
    assert got.embeddings.dtype == np.float32
    np.testing.assert_allclose(got.embeddings, want.embeddings, atol=ATOL)


def test_semantic_chunk_needs_path_metadata(bert_encoders):
    from distllm_tpu_torch.embed.datasets.base import TextCorpus

    _, port_enc = bert_encoders
    embedder = get_embedder({'name': 'semantic_chunk'})
    pooler = get_pooler({'name': 'mean'})
    with pytest.raises(ValueError, match='Metadata is required'):
        embedder.embed(TextCorpus(['a b']), port_enc, pooler, 2)
    with pytest.raises(ValueError, match='Metadata path is required'):
        embedder.embed(TextCorpus(['a b'], [{'x': 1}]), port_enc, pooler, 2)


# ---------------------------------------------------- huggingface writer
def _read_hf(path):
    from datasets import load_from_disk

    ds = load_from_disk(str(path))
    return {col: list(ds[col]) for col in ds.column_names}


def test_huggingface_writer_writes_and_merges_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    results = [
        dict(embeddings=rng.standard_normal((3, 4)).astype(np.float32),
             text=[f't{i}{j}' for j in range(3)],
             metadata=[{'tags': f'p{i}{j}', 'paths': f'f{i}'} for j in range(3)])
        for i in range(2)
    ] + [dict(embeddings=np.ones((1, 4), np.float32), text=['lone'], metadata=None)]
    for name, writer, result_cls in (
        ('port', get_writer({'name': 'huggingface'}), EmbedderResult),
        ('jax', jax_get_writer({'name': 'huggingface'}), JaxEmbedderResult),
    ):
        for i, result in enumerate(results[:2]):
            writer.write(tmp_path / name / f's{i}', result_cls(**result))
        writer.write(tmp_path / name / 'plain', result_cls(**results[2]))
        (tmp_path / name / 'broken').mkdir()
        writer.merge([tmp_path / name / 's0', tmp_path / name / 'broken',
                      tmp_path / name / 's1'], tmp_path / name / 'merged')
    for shard in ('s0', 's1', 'plain', 'merged'):
        got, want = _read_hf(tmp_path / 'port' / shard), _read_hf(tmp_path / 'jax' / shard)
        assert list(got) == list(want)
        for col in want:
            if col == 'embeddings':
                np.testing.assert_array_equal(np.asarray(got[col]), np.asarray(want[col]))
            else:
                assert got[col] == want[col], col
    assert len(_read_hf(tmp_path / 'port' / 'merged')['text']) == 6
    with pytest.raises(ValueError, match='no readable shards'):
        get_writer({'name': 'huggingface'}).merge([tmp_path / 'port' / 'broken'],
                                                  tmp_path / 'none')


# ------------------------------------------------------- auto encoder
def _word_tokenizer(root):
    """A WordLevel fast tokenizer (``w0`` .. ``w99``) saved to ``root``."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {'[UNK]': 0, '[PAD]': 1, **{f'w{i}': i + 2 for i in range(100)}}
    tok = Tokenizer(WordLevel(vocab, unk_token='[UNK]'))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(root / 'tokenizer.json'))
    (root / 'tokenizer_config.json').write_text(json.dumps({
        'tokenizer_class': 'PreTrainedTokenizerFast', 'pad_token': '[PAD]',
        'unk_token': '[UNK]', 'model_max_length': 64}))


@pytest.fixture(scope='module')
def modernbert_checkpoint(tmp_path_factory):
    from safetensors.torch import save_file

    root = tmp_path_factory.mktemp('modernbert_tiny')
    hf = hf_config(num_hidden_layers=3)
    (root / 'config.json').write_text(json.dumps(hf))
    save_file(hf_state(hf, 7), str(root / 'model.safetensors'))
    _word_tokenizer(root)
    return root


@pytest.fixture(scope='module')
def esm_checkpoint(tmp_path_factory):
    return _esm2_hf_checkpoint(tmp_path_factory.mktemp('esm_auto'))


def _texts(n, seed, words=100):
    rng = np.random.default_rng(seed)
    return [' '.join(f'w{i}' for i in rng.integers(0, words, size=int(rng.integers(1, 40))))
            for _ in range(n)]


def _proteins(n, seed):
    rng = np.random.default_rng(seed)
    residues = np.array(list('ACDEFGHIKLMNPQRSTVWY'))
    return [''.join(rng.choice(residues, size=int(rng.integers(1, 40)))) for _ in range(n)]


@pytest.mark.parametrize('quantization', [False, 'int8'], ids=['fp32', 'int8'])
@pytest.mark.parametrize('family', ['esm', 'modernbert'])
def test_auto_encoder_serves_esm_and_modernbert_as_jax(
        family, quantization, esm_checkpoint, modernbert_checkpoint):
    ckpt, module, texts = {
        'esm': (esm_checkpoint, esm2, _proteins(7, 1)),
        'modernbert': (modernbert_checkpoint, modernbert, _texts(7, 2)),
    }[family]
    kwargs = {'name': 'auto', 'pretrained_model_name_or_path': str(ckpt),
              'half_precision': False, 'quantization': quantization}
    jax_enc = jax_get_encoder(kwargs)
    want = jax_full_sequence.compute_embeddings(
        texts, jax_enc, jax_get_pooler({'name': 'mean'}), 3, normalize=True)
    encoder = get_encoder(kwargs, device='cpu')
    assert encoder._apply_fn is module.apply
    assert type(encoder.model_cfg).__name__ == type(jax_enc.model_cfg).__name__
    q_leaves = [leaf for leaf in tq.leaves(encoder.params) if isinstance(leaf, tq.QTensor)]
    assert bool(q_leaves) == bool(quantization)
    got = compute_embeddings(texts, encoder, get_pooler({'name': 'mean'}), 3,
                             normalize=True, device='cpu')
    np.testing.assert_allclose(got, want, atol=ATOL)


# ------------------------------------------------------- fake encoder
def test_fake_encoder_keeps_the_jax_shapes_dtype_and_determinism():
    kwargs = {'name': 'fake', 'embedding_size': 16, 'vocab_size': 128,
              'model_max_length': 32, 'seed': 3}
    port, ref = get_encoder(kwargs, device='cpu'), jax_get_encoder(kwargs)
    texts = _texts(5, 4)
    batch, jax_batch = port.tokenizer(texts), ref.tokenizer(texts)
    np.testing.assert_array_equal(batch.input_ids, jax_batch.input_ids)
    hidden = port.forward(batch)
    assert hidden.shape == tuple(np.asarray(ref.forward(jax_batch)).shape) == (5, batch.shape[1], 16)
    assert hidden.dtype == torch.float32
    again = get_encoder(kwargs, device='cpu').forward(batch)
    other = get_encoder({**kwargs, 'seed': 4}, device='cpu').forward(batch)
    assert torch.equal(hidden, again) and not torch.equal(hidden, other)
    # A token's vector does not depend on its neighbours.
    assert torch.equal(hidden[0, 0], hidden[1, 0])
    pooled = compute_embeddings(texts, port, get_pooler({'name': 'mean'}), 2, device='cpu')
    assert pooled.shape == (5, 16) and pooled.dtype == np.float32


# ---------------------------------------------------- compute configs
def test_workstation_config_runs_as_jax(tmp_path):
    port = launcher.get_compute_config({'name': 'workstation', 'max_workers': 2})
    ref = jax_launcher.get_compute_config({'name': 'workstation', 'max_workers': 2})
    assert port.max_workers == ref.max_workers == 2
    assert launcher.get_compute_config({'name': 'workstation'}).max_workers == (
        jax_launcher.WorkstationConfig().max_workers)
    items = [-3.0, 4.0, -5.0]
    assert port.get_executor(tmp_path / 'run').map(abs, items) == [3.0, 4.0, 5.0]
    assert (tmp_path / 'run').is_dir()
    inline = launcher.WorkstationConfig(max_workers=1).get_executor(tmp_path / 'one')
    assert inline.map(math.sqrt, [4.0, 9.0]) == [2.0, 3.0]
    assert launcher.get_compute_config({}).get_executor(tmp_path / 'l').map(abs, [-1]) == [1]
    with pytest.raises(ValueError, match='Unknown compute config'):
        launcher.get_compute_config({'name': 'cluster'})


@pytest.mark.parametrize('name', ['pod', 'pbspro', 'slurm'])
def test_pod_configs_raise_naming_a11(tmp_path, name):
    """The pod configs are ported (ROADMAP A11b): the embedding config
    takes each as JAX's does, and the scheduler configs raise, as JAX's
    pydantic models do, when ``account`` and ``queue`` are missing."""
    required = {} if name == 'pod' else {'account': 'a', 'queue': 'q'}
    kwargs = dict(input_dir=tmp_path, output_dir=tmp_path, dataset_config={},
                  encoder_config={}, pooler_config={}, embedder_config={},
                  writer_config={})
    config = port_embedding.Config(**kwargs, compute_config={'name': name, **required})
    assert launcher.get_compute_config(config.compute_config).name == name
    assert (launcher.get_compute_config(config.compute_config).to_dict()
            == jax_launcher.get_compute_config({'name': name, **required}).model_dump())
    if name != 'pod':
        with pytest.raises(ValueError):
            jax_launcher.get_compute_config({'name': name})
        with pytest.raises(ValueError, match='missing keys'):
            port_embedding.Config(**kwargs, compute_config={'name': name})


# ------------------------------------- run_embedding on the ESM-2 example
def _example_config(tmp_path, checkpoint, name):
    """``examples/embed/esm2.fasta.workstation.yaml`` with its input,
    output and checkpoint paths replaced by tiny local ones, in fp32."""
    config = yaml.safe_load((REPO / 'examples/embed/esm2.fasta.workstation.yaml').read_text())
    assert config['compute_config'] == {'name': 'workstation', 'max_workers': 1}
    assert config['writer_config'] == {'name': 'huggingface'}
    config['input_dir'] = str(tmp_path / 'shards')
    config['output_dir'] = str(tmp_path / name)
    config['encoder_config'].update(
        pretrained_model_name_or_path=str(checkpoint), half_precision=False)
    path = tmp_path / f'{name}.yaml'
    path.write_text(yaml.safe_dump(config))
    return path


def test_run_embedding_on_the_esm2_example_matches_jax(tmp_path, esm_checkpoint):
    shards = tmp_path / 'shards'
    shards.mkdir()
    proteins = _proteins(70, 5)  # batch 64: one full batch and a partial one
    for part, rows in enumerate((proteins[:45], proteins[45:])):
        (shards / f'part{part}.fasta').write_text(
            ''.join(f'>p{part}_{i} protein {i}\n{seq}\n' for i, seq in enumerate(rows)))
    (shards / 'notes.txt').write_text('not matched by *.fasta')
    assert jax_embedding.run_embedding(
        jax_embedding.Config.from_yaml(_example_config(tmp_path, esm_checkpoint, 'jax'))) == 0
    port_config = port_embedding.Config.from_yaml(
        _example_config(tmp_path, esm_checkpoint, 'port'))
    assert port_embedding.run_embedding(port_config, device='cpu') == 0

    def shards_of(name):
        out = {}
        for shard in (tmp_path / name / 'embeddings').iterdir():
            data = _read_hf(shard)
            out[data['tags'][0]] = data
        return out

    jax_out, port_out = shards_of('jax'), shards_of('port')
    assert sorted(port_out) == sorted(jax_out) == ['p0_0 protein 0', 'p1_0 protein 0']
    for key, got in port_out.items():
        want = jax_out[key]
        assert list(got) == list(want) == ['text', 'embeddings', 'tags', 'paths']
        assert got['text'] == want['text'] and got['tags'] == want['tags']
        assert got['paths'] == want['paths']
        emb = np.asarray(got['embeddings'], np.float32)
        assert emb.shape == (len(got['text']), 64) and np.isfinite(emb).all()
        np.testing.assert_allclose(emb, np.asarray(want['embeddings']), atol=ATOL)
    assert (tmp_path / 'port' / 'run').is_dir()
