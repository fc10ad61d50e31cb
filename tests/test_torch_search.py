"""The port's retrieval index and ``Retriever`` against ``distllm_tpu.rag.search``.

An HF embeddings dataset written from a seed (planted duplicate rows, so
ties decide the order; part files of 128 rows and scan groups of 128
rows, so the build and the search cross several of each) goes through
both packages on every tier (``float32``, ``int8``, ``ubinary``):

- results identical (indices equal, scores within 1e-6), with and
  without the score-threshold filter;
- the index directory is the JAX package's file format: the ``.npy``
  parts and the meta file bytewise equal, each ``.npz`` part holding
  byte-identical members (the zip headers carry write times), and each
  package loads the other's index without rebuilding it;
- a directory of UUID shard subdirectories is concatenated; an index
  whose row count moved is rebuilt; the V1 surface warns;
- ``Retriever`` / ``RetrieverConfig`` over a tiny BERT checkpoint and a
  ``BertTokenizerFast`` written from a seed: the same embeddings within
  1e-5, the same hits and texts;
- what both refuse (a bad precision, a missing field, the retriever keys
  of ``examples/chat/chat_server.rag.yaml``, a mesh whose fixed axes do
  not divide the devices). The data-sharded index is held to JAX's in
  ``test_torch_topk_sharded.py``.
"""

import json
import warnings
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from distllm_tpu.models import bert as jax_bert
from distllm_tpu.rag import search as jsearch
from distllm_tpu_torch.rag import search as tsearch

N, H = 300, 32
RAG_YAML = Path(__file__).resolve().parents[1] / 'examples' / 'chat' / 'chat_server.rag.yaml'
WORDS = [f'w{i}' for i in range(200)]


def _rows(n=N, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, H)).astype(np.float32)
    for dst in (130, 131, min(260, n - 2), n - 1):
        emb[dst] = 2.0 * emb[5]  # the same direction: ties after normalising
    emb[140] = emb[17]
    texts = [' '.join(rng.choice(WORDS, size=int(rng.integers(3, 12)))) for _ in range(n)]
    return emb, texts


def _save(path, emb, texts, offset=0):
    from datasets import Dataset

    Dataset.from_dict({
        'text': texts, 'embeddings': list(emb),
        'path': [f'doc{(offset + i) % 4}' for i in range(len(texts))],
    }).save_to_disk(str(path))
    return path


@pytest.fixture(autouse=True)
def small_parts(monkeypatch):
    """Part files and scan groups of 128 rows in both packages."""
    for mod in (jsearch, tsearch):
        monkeypatch.setattr(mod.TpuIndexV2, '_CHUNK_ROWS', 128)
        monkeypatch.setattr(mod, 'SCAN_CHUNK_INT8', 128)
        monkeypatch.setattr(mod, 'SCAN_CHUNK_BITS', 128)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    emb, texts = _rows()
    return _save(tmp_path_factory.mktemp('emb') / 'ds', emb, texts), emb, texts


def _queries(emb, seed=1):
    rng = np.random.default_rng(seed)
    q = np.concatenate([emb[[5, 17, 40]], rng.normal(size=(3, H)).astype(np.float32)])
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _pair(dataset_dir, tmp_path, precision, **extra):
    jidx = jsearch.TpuIndexV2(jsearch.TpuIndexV2Config(
        dataset_dir=dataset_dir, index_dir=tmp_path / 'jax_index', precision=precision,
        **extra))
    tidx = tsearch.TpuIndexV2Config.from_dict(dict(
        dataset_dir=str(dataset_dir), index_dir=str(tmp_path / 'port_index'),
        precision=precision, **extra)).get_index(device='cpu')
    return jidx, tidx


def _same_results(got, want):
    assert got.total_indices == want.total_indices
    for g, w in zip(got.total_scores, want.total_scores):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize('precision', ['float32', 'int8', 'ubinary'])
def test_every_tier_matches_jax(dataset, tmp_path, precision):
    dataset_dir, emb, _ = dataset
    jidx, tidx = _pair(dataset_dir, tmp_path, precision, rescore_multiplier=3)
    queries = _queries(emb)
    for top_k, threshold in ((7, -1.0), (12, 0.2), (1, 0.0)):
        want = jidx.search(queries, top_k=top_k, score_threshold=threshold)
        got = tidx.search(queries, top_k=top_k, score_threshold=threshold)
        _same_results(got, want)
    # Planted ties: row 5 and its four copies, in index order.
    assert got.total_indices[0] == [5]  # top_k 1 at threshold 0
    full = tidx.search(queries, top_k=7, score_threshold=-1.0)
    assert full.total_indices[0][:5] == [5, 130, 131, 260, N - 1]
    filtered = tidx.search(queries, top_k=12, score_threshold=0.2)
    assert all(s >= 0.2 for row in filtered.total_scores for s in row)
    assert tidx.get([3, 1], 'text') == jidx.get([3, 1], 'text')
    assert len(tidx) == len(jidx) == N and tidx.device_bytes > 0


def _npz_members(path):
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in sorted(zf.namelist())}


@pytest.mark.parametrize('precision', ['float32', 'int8', 'ubinary'])
def test_index_files_are_the_jax_format_and_load_across(dataset, tmp_path, precision):
    dataset_dir, emb, _ = dataset
    jidx, tidx = _pair(dataset_dir, tmp_path, precision)
    jdir, tdir = tmp_path / 'jax_index', tmp_path / 'port_index'
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    assert len(names) == 4  # three parts of <= 128 rows and the meta file
    for name in names:
        if name.endswith('.npz'):
            assert _npz_members(tdir / name) == _npz_members(jdir / name), name
        else:
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    stamps = {p.name: p.stat().st_mtime_ns for p in [*jdir.iterdir(), *tdir.iterdir()]}
    # Each package loads the other's directory as it is.
    port_on_jax = tsearch.TpuIndexV2(tsearch.TpuIndexV2Config(
        dataset_dir=dataset_dir, index_dir=jdir, precision=precision), device='cpu')
    jax_on_port = jsearch.TpuIndexV2(jsearch.TpuIndexV2Config(
        dataset_dir=dataset_dir, index_dir=tdir, precision=precision))
    assert stamps == {p.name: p.stat().st_mtime_ns for p in [*jdir.iterdir(), *tdir.iterdir()]}
    queries = _queries(emb)
    want = jidx.search(queries, top_k=6, score_threshold=-1.0)
    _same_results(port_on_jax.search(queries, top_k=6, score_threshold=-1.0), want)
    _same_results(jax_on_port.search(queries, top_k=6, score_threshold=-1.0), want)


def test_default_index_dir_and_shard_subdirectories(tmp_path):
    """An unmerged embedding run (UUID shard subdirectories) is one
    dataset, in sorted shard order; the index lands in dataset_dir/tpu_index."""
    emb, texts = _rows(n=200, seed=3)
    root = tmp_path / 'run'
    _save(root / 'b1f0', emb[:90], texts[:90])
    _save(root / 'a7c2', emb[90:], texts[90:], offset=90)
    jds, tds = jsearch._load_embeddings_dataset(root), tsearch._load_embeddings_dataset(root)
    assert len(tds) == len(jds) == 200 and tds['text'] == jds['text']
    tidx = tsearch.TpuIndexV2Config.from_dict({'dataset_dir': str(root)}).get_index(device='cpu')
    assert (root / 'tpu_index' / 'index_float32.meta.json').exists()
    jidx = jsearch.TpuIndexV2(jsearch.TpuIndexV2Config(dataset_dir=root))
    queries = _queries(np.asarray(jds['embeddings'], np.float32))
    _same_results(tidx.search(queries, top_k=5, score_threshold=-1.0),
                  jidx.search(queries, top_k=5, score_threshold=-1.0))


@pytest.mark.parametrize('precision', ['float32', 'ubinary'])
def test_a_stale_index_is_rebuilt(tmp_path, precision):
    emb, texts = _rows(n=250, seed=4)
    ds_dir = _save(tmp_path / 'ds', emb, texts)
    config = {'dataset_dir': str(ds_dir), 'precision': precision}
    tsearch.TpuIndexV2Config.from_dict(config).get_index(device='cpu')
    meta = ds_dir / 'tpu_index' / f'index_{precision}.meta.json'
    assert json.loads(meta.read_text())['num_rows'] == 250
    # Re-embedded with fewer rows: the row count moved, the index rebuilds.
    emb2, texts2 = _rows(n=180, seed=5)
    ds2 = _save(tmp_path / 'ds2', emb2, texts2)
    (ds2 / 'tpu_index').symlink_to(ds_dir / 'tpu_index', target_is_directory=True)
    tidx = tsearch.TpuIndexV2Config.from_dict({**config, 'dataset_dir': str(ds2)}).get_index(
        device='cpu')
    assert json.loads(meta.read_text())['num_rows'] == 180
    jidx = jsearch.TpuIndexV2(jsearch.TpuIndexV2Config(dataset_dir=ds2, precision=precision))
    queries = _queries(emb2)
    _same_results(tidx.search(queries, top_k=5, score_threshold=-1.0),
                  jidx.search(queries, top_k=5, score_threshold=-1.0))


def test_the_v1_surface_warns_and_serves_the_v2_index(dataset):
    dataset_dir, emb, _ = dataset
    with pytest.warns(DeprecationWarning, match='deprecated'):
        tidx = tsearch.TpuIndexV1Config(
            dataset_dir=dataset_dir, name='faiss_index_v1').get_index(device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        jidx = jsearch.TpuIndexV1Config(dataset_dir=dataset_dir).get_index()
    queries = _queries(emb)
    _same_results(tidx.search(queries, top_k=4), jidx.search(queries, top_k=4))


# --------------------------------------------------------- the retriever
def _bert_checkpoint(root):
    """A tiny BERT checkpoint (safetensors, HF ``BertModel`` key names) and
    a ``BertTokenizerFast`` saved from a generated vocabulary."""
    from safetensors.numpy import save_file
    from transformers import BertTokenizerFast

    vocab = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]'] + WORDS
    (root / 'vocab.txt').write_text('\n'.join(vocab) + '\n')
    BertTokenizerFast(vocab_file=str(root / 'vocab.txt')).save_pretrained(root)
    hf = {'model_type': 'bert', 'vocab_size': len(vocab), 'hidden_size': H,
          'num_hidden_layers': 2, 'num_attention_heads': 4, 'intermediate_size': 64,
          'max_position_embeddings': 128, 'type_vocab_size': 2, 'layer_norm_eps': 1e-12,
          'hidden_act': 'gelu'}
    (root / 'config.json').write_text(json.dumps(hf))
    tree = jax.tree.map(np.asarray, jax_bert.init(
        jax.random.PRNGKey(2), jax_bert.BertConfig.from_hf_config(hf)))
    emb, layers = tree['embeddings'], tree['layers']
    state = {
        'embeddings.word_embeddings.weight': emb['word'],
        'embeddings.position_embeddings.weight': emb['position'],
        'embeddings.token_type_embeddings.weight': emb['token_type'],
        'embeddings.LayerNorm.weight': emb['ln']['scale'],
        'embeddings.LayerNorm.bias': emb['ln']['bias'],
    }
    names = {'q': 'attention.self.query', 'k': 'attention.self.key',
             'v': 'attention.self.value', 'o': 'attention.output.dense',
             'up': 'intermediate.dense', 'down': 'output.dense'}
    for li in range(2):
        p = f'encoder.layer.{li}'
        for ours, theirs in names.items():
            state[f'{p}.{theirs}.weight'] = layers[ours]['kernel'][li].T
            state[f'{p}.{theirs}.bias'] = layers[ours]['bias'][li]
        for ours, theirs in (('attn_ln', 'attention.output.LayerNorm'),
                             ('mlp_ln', 'output.LayerNorm')):
            state[f'{p}.{theirs}.weight'] = layers[ours]['scale'][li]
            state[f'{p}.{theirs}.bias'] = layers[ours]['bias'][li]
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in state.items()},
              str(root / 'model.safetensors'))
    return root


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    return _bert_checkpoint(tmp_path_factory.mktemp('tiny_bert'))


def retriever_config(checkpoint, dataset_dir, precision='float32'):
    """A retriever_config mapping: the keys of the JAX RetrieverConfig."""
    return {
        'faiss_config': {'name': 'faiss_index_v2', 'dataset_dir': str(dataset_dir),
                         'precision': precision},
        'encoder_config': {'name': 'auto', 'pretrained_model_name_or_path': str(checkpoint),
                           'half_precision': False},
        'pooler_config': {'name': 'mean'},
        'batch_size': 4,
    }


@pytest.mark.parametrize('precision', ['float32', 'int8'])
def test_retriever_matches_jax(dataset, checkpoint, precision):
    dataset_dir, _, texts = dataset
    raw = retriever_config(checkpoint, dataset_dir, precision)
    jret = jsearch.RetrieverConfig(**raw).get_retriever()
    tret = tsearch.RetrieverConfig.from_dict(raw).get_retriever(device='cpu')
    queries = texts[:5] + ['w1 w2 w3 w4 w5 w6 w7 w8 w9 w10 w11', 'w7']
    jres, jemb = jret.search(queries, top_k=6, score_threshold=-1.0)
    tres, temb = tret.search(queries, top_k=6, score_threshold=-1.0)
    np.testing.assert_allclose(temb, jemb, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(temb, axis=1), 1.0, atol=1e-6)
    assert tres.total_indices == jres.total_indices
    for g, w in zip(tres.total_scores, jres.total_scores):
        np.testing.assert_allclose(g, w, atol=1e-5)
    indices = tres.total_indices[0]
    assert tret.get_texts(indices) == jret.get_texts(indices)
    assert tret.get(indices, 'path') == jret.get(indices, 'path')
    one, _ = tret.search('w3 w4', top_k=2)
    assert len(one.total_indices) == 1


def test_refused_as_in_jax(dataset, tmp_path):
    dataset_dir, _, _ = dataset
    for bad in ({'dataset_dir': str(dataset_dir), 'precision': 'int4'},
                {'dataset_dir': str(dataset_dir), 'metric': 'l2'},
                {'precision': 'float32'},
                {'dataset_dir': str(dataset_dir), 'faiss_index_path': 'x.idx'}):
        with pytest.raises(ValueError):
            jsearch.TpuIndexV2Config(**bad)
        with pytest.raises(ValueError):
            tsearch.TpuIndexV2Config.from_dict(bad)
    rag = yaml.safe_load(RAG_YAML.read_text())['retriever_config']
    with pytest.raises(ValueError):
        jsearch.RetrieverConfig(**rag)
    with pytest.raises(ValueError):
        tsearch.RetrieverConfig.from_dict(rag)
    # A mesh whose fixed axes do not divide the devices (JAX: its 8 virtual
    # devices over model=3; the port: the one CPU device).
    mesh = {'data': -1, 'model': 3}
    with pytest.raises(ValueError, match='not divisible by fixed axes'):
        jsearch.TpuIndexV2Config(dataset_dir=dataset_dir, index_dir=tmp_path / 'j',
                                 mesh=mesh).get_index()
    with pytest.raises(ValueError, match='not divisible by fixed axes'):
        tsearch.TpuIndexV2Config.from_dict(
            {'dataset_dir': str(dataset_dir), 'index_dir': str(tmp_path / 'i'),
             'mesh': mesh}).get_index(device='cpu')
