"""The data-sharded top-k and retrieval index of the port against the JAX
package's on its 8-device virtual CPU mesh (``tests/conftest.py``).

- ``topk_inner_product`` and ``int8_topk`` at ``data`` 8 (and 2, 4) with
  planted ties across shards: indices identical to JAX's ``shard_map``
  path, scores within 1e-6 (int8 bitwise); the port's sharded result is
  its unsharded one, scores bitwise.
- ``TpuIndexV2`` with ``mesh`` against the JAX index with the same mesh
  (the twins of ``tests/test_search.py``'s sharded cases: float32 and
  int8 over 64 rows, 61 rows on 8 shards with no duplicate, and the
  300-row dataset of ``test_torch_search.py``, whose padded rows take
  top-k slots in JAX's float32 tier and are dropped), shards placed one
  a device, JAX's fill values; ``ubinary`` under a mesh is its
  single-device result.
- ``data_shards``: ``-1`` is every visible card over the other axes.
- What JAX refuses: grouped codes with a data mesh (its message).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu.ops import topk as jtopk
from distllm_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from distllm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from distllm_tpu.rag import search as jsearch
from distllm_tpu_torch.ops import topk as ttopk
from distllm_tpu_torch.rag import search as tsearch
from test_torch_search import _rows, _save
from test_torch_topk import _corpus, _np, _port, _same

N8 = 704  # 88 rows a shard at data 8


def _jax_mesh(data):
    return jax_make_mesh(JaxMeshSpec(data=data, model=1), devices=jax.devices()[:data])


@pytest.mark.parametrize('data', [2, 8])
@pytest.mark.parametrize('k', [9, 100])
def test_topk_inner_product_sharded_matches_jax(data, k):
    corpus, queries = _corpus(n=N8)
    want = _np(jtopk.topk_inner_product(jnp.asarray(queries), jnp.asarray(corpus), k,
                                        mesh=_jax_mesh(data)))
    tq, tc = torch.from_numpy(queries), torch.from_numpy(corpus)
    got = _port(ttopk.topk_inner_product(tq, tc, k, mesh={'data': data, 'model': 1}))
    _same(got, want)
    one = _port(ttopk.topk_inner_product(tq, tc, k))
    _same(got, one, exact=True)
    # A list of shards is the same search (the index's placement).
    shards = list(tc.split(N8 // data))
    _same(_port(ttopk.topk_inner_product(tq, shards, k)), got, exact=True)
    if k == 9:  # the planted ties cross shards, in index order
        assert list(got[1][1][:6]) == [3, 150, 151, 333, 334, 699]


@pytest.mark.parametrize('data', [4, 8])
@pytest.mark.parametrize('k', [1, 100])
def test_int8_topk_sharded_matches_jax(data, k):
    corpus, queries = _corpus(n=N8)
    codes, scales = jtopk.quantize_int8_rows(corpus)
    want = _np(jtopk.int8_topk(jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(scales),
                               k, mesh=_jax_mesh(data), n_valid=N8))
    tq, tc, ts = (torch.from_numpy(a) for a in (queries, codes, scales))
    got = _port(ttopk.int8_topk(tq, tc, ts, k, mesh={'data': data}, n_valid=N8,
                                chunk_size=32))
    _same(got, want, exact=True)
    _same(got, _port(ttopk.int8_topk(tq, tc, ts, k)), exact=True)


def test_grouped_codes_refuse_a_data_mesh_with_jaxs_message():
    corpus, queries = _corpus(n=N8)
    codes, scales = jtopk.quantize_int8_rows(corpus)
    g_codes, g_scales = jtopk.group_rows(codes, 256), jtopk.group_rows(scales, 256)
    with pytest.raises(ValueError) as jax_err:
        jtopk.int8_topk(jnp.asarray(queries), jnp.asarray(g_codes), jnp.asarray(g_scales), 3,
                        mesh=_jax_mesh(8), n_valid=N8)
    with pytest.raises(ValueError) as port_err:
        ttopk.int8_topk(torch.from_numpy(queries), torch.from_numpy(g_codes),
                        torch.from_numpy(g_scales), 3, mesh={'data': 8}, n_valid=N8)
    assert str(port_err.value) == str(jax_err.value)


def test_data_shards_resolves_as_the_jax_meshspec(monkeypatch):
    assert ttopk.data_shards(None) == 1
    assert ttopk.data_shards({'data': 4, 'model': 2}) == 4
    assert ttopk.data_shards({'model': 2}) == 1
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert ttopk.data_shards({'data': -1}) == 1  # no card: one device
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert ttopk.data_shards({'data': -1, 'model': 1}) == 4
    assert ttopk.data_shards({'data': -1, 'model': 2}) == 2
    assert ttopk.data_shards({'data': -1, 'model': 2}) == JaxMeshSpec(data=-1, model=2).resolve(
        4)['data']
    with pytest.raises(ValueError, match='not divisible'):
        ttopk.data_shards({'data': -1, 'model': 3})
    with pytest.raises(ValueError, match='positive int'):
        ttopk.data_shards({'data': 0})


def _indexes(tmp_path, dataset_dir, precision, data):
    """The JAX index over its ``data``-wide mesh and the port's CPU index
    with ``mesh: {'data': data}``."""
    jidx = jsearch.TpuIndexV2Config(
        dataset_dir=dataset_dir, index_dir=tmp_path / f'jax_{precision}', precision=precision,
        mesh={'data': data, 'model': 1}).get_index()
    tidx = tsearch.TpuIndexV2Config.from_dict(dict(
        dataset_dir=str(dataset_dir), index_dir=str(tmp_path / f'port_{precision}'),
        precision=precision, mesh={'data': data, 'model': 1})).get_index(device='cpu')
    return jidx, tidx


def _same_results(got, want, exact=False):
    assert got.total_indices == want.total_indices
    for g, w in zip(got.total_scores, want.total_scores):
        if exact:
            assert g == w
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


@pytest.fixture(scope='module')
def embeddings(tmp_path_factory):
    """test_search.py's fixture: 64 rows x 32, seed 0."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(64, 32)).astype(np.float32)
    from datasets import Dataset

    path = tmp_path_factory.mktemp('emb64') / 'ds'
    Dataset.from_dict({'text': [f'document number {i}' for i in range(64)],
                       'embeddings': list(emb)}).save_to_disk(str(path))
    return path, emb / np.linalg.norm(emb, axis=1, keepdims=True)


@pytest.mark.parametrize('precision', ['float32', 'int8'])
def test_sharded_index_matches_jax_and_one_shard(embeddings, tmp_path, precision):
    dataset_dir, normalized = embeddings
    jidx, tidx = _indexes(tmp_path, dataset_dir, precision, 8)
    assert tidx.num_shards == 8 and tidx.shard_devices == [torch.device('cpu')] * 8
    got = tidx.search(normalized[:3], top_k=5, score_threshold=-10.0)
    _same_results(got, jidx.search(normalized[:3], top_k=5, score_threshold=-10.0))
    single = tsearch.TpuIndexV2Config.from_dict(dict(
        dataset_dir=str(dataset_dir), index_dir=str(tmp_path / 'single'),
        precision=precision)).get_index(device='cpu')
    _same_results(got, single.search(normalized[:3], top_k=5, score_threshold=-10.0),
                  exact=True)


@pytest.mark.parametrize('precision', ['float32', 'int8'])
def test_sharded_padding_is_dropped_never_duplicated(tmp_path, precision):
    """61 rows on 8 shards pad to 64 (rows and codes 0, scales 1, as JAX
    pads): a padded candidate is dropped, never clamped onto a real row."""
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(61, 32)).astype(np.float32)
    path = _save(tmp_path / 'ds', emb, [str(i) for i in range(61)])
    normalized = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    jidx, tidx = _indexes(tmp_path, path, precision, 8)
    shard = tidx._corpus[7] if precision == 'float32' else tidx._int8[7]
    if precision == 'float32':
        assert shard.shape == (8, 32) and not shard[5:].any()
    else:
        assert shard[0].shape == (8, 32) and not shard[0][5:].any()
        assert torch.equal(shard[1][5:], torch.ones(3))
    got = tidx.search(normalized[60:], top_k=5, score_threshold=-10.0)
    row = got.total_indices[0]
    assert row[0] == 60 and len(row) == len(set(row)) and all(i < 61 for i in row)
    _same_results(got, jidx.search(normalized[60:], top_k=5, score_threshold=-10.0))


@pytest.mark.parametrize('precision', ['float32', 'int8', 'ubinary'])
def test_sharded_300_rows_match_jax(tmp_path, precision, monkeypatch):
    """The 300-row dataset with planted ties at data 8 (300 pads to 304):
    JAX's results, ties and dropped padded slots included. ``ubinary``
    ignores the mesh in both packages."""
    for mod in (jsearch, tsearch):
        monkeypatch.setattr(mod.TpuIndexV2, '_CHUNK_ROWS', 128)
    emb, texts = _rows()
    path = _save(tmp_path / 'ds', emb, texts)
    rng = np.random.default_rng(1)
    queries = np.concatenate([emb[[5, 17, 40]], rng.normal(size=(3, emb.shape[1]))])
    queries = (queries / np.linalg.norm(queries, axis=1, keepdims=True)).astype(np.float32)
    jidx, tidx = _indexes(tmp_path, path, precision, 8)
    _same_results(tidx.search(queries, top_k=12, score_threshold=0.0),
                  jidx.search(queries, top_k=12, score_threshold=0.0))
    if precision == 'float32':
        # JAX's zero padding scores 0 and takes slots it then drops: fewer
        # than top_k results where one shard returns all (ROADMAP C).
        got = tidx.search(queries, top_k=160, score_threshold=-10.0)
        _same_results(got, jidx.search(queries, top_k=160, score_threshold=-10.0))
        assert min(len(r) for r in got.total_indices) < 160
    if precision == 'ubinary':
        assert tidx.num_shards == 8 and isinstance(tidx._packed, torch.Tensor)
        single = tsearch.TpuIndexV2Config.from_dict(dict(
            dataset_dir=str(path), index_dir=str(tmp_path / 'single'),
            precision=precision)).get_index(device='cpu')
        _same_results(tidx.search(queries, top_k=12, score_threshold=-10.0),
                      single.search(queries, top_k=12, score_threshold=-10.0), exact=True)
