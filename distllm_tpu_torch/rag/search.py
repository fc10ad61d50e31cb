"""Semantic similarity search: the retrieval index and the ``Retriever``
(the PyTorch counterpart of ``distllm_tpu.rag.search``, which stands in
for the reference's FAISS stack).

- :class:`TpuIndexV2` (config ``name`` ``tpu_index_v2`` or
  ``faiss_index_v2``) builds its index from an embeddings dataset if it is
  missing, keeps it on disk, and serves three precisions: ``float32``
  (exact inner product), ``int8`` (per-row int8 codes, exact int32
  scores) and ``ubinary`` (sign bits, Hamming distance); the two
  quantized tiers oversample ``top_k * rescore_multiplier`` candidates
  and rescore them in fp32 against rows gathered from the dataset.
  Results under ``score_threshold`` are dropped. ``index_type`` takes the
  reference's HNSW names and serves them exactly.
- **The index directory is the JAX package's file format**: chunked
  ``index_{precision}.partNNNNN.npy`` (``.npz`` with ``codes`` and
  ``scales`` for int8) and ``index_{precision}.meta.json``, under
  ``dataset_dir/tpu_index`` by default, written with the same numpy calls,
  so each package loads an index the other built. An index whose row
  count no longer matches the dataset is rebuilt.
- **A data-sharded index** (``mesh: {'data': n}``; ``-1`` is every
  visible card): the float32 rows and the flat int8 codes and scales are
  padded to a row count ``n`` divides (0 for rows and codes, 1 for
  scales, as JAX pads) and split into ``n`` shards, shard ``i`` on
  ``cuda:<i % cards>`` (every shard on the CPU for a CPU index). One
  process serves them, as the JAX index is one program over its host's
  chips: each shard scores on its device and only its ``[B, k]``
  candidates cross to the first (``ops.topk``). Padded indices are dropped
  by the search and pinned to -inf in the rescore, as in JAX. ``ubinary``
  keeps one unsharded packed corpus whatever the mesh, as JAX does, and
  the mesh's other axes change nothing.
- :class:`TpuIndexV1Config` is the deprecated V1 surface (a
  ``DeprecationWarning``, the same index underneath).
- :class:`Retriever` encodes queries (batched, length-sorted), pools them,
  L2-normalises them and searches the index.

The index's dataset is an HF embeddings dataset at ``dataset_dir``
(``datasets`` is imported to load it; a directory of UUID shard
subdirectories is concatenated), or any table passed as ``dataset``: an
object with ``__len__`` whose row slices and index lists give
``['embeddings']`` and ``['text']``. The index and its searches live on
the device the caller names (``None`` = CUDA).
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from distllm_tpu_torch.ops.topk import (
    SCAN_CHUNK_BITS,
    SCAN_CHUNK_INT8,
    data_shards,
    group_rows,
    hamming_topk,
    int8_topk,
    pack_sign_bits,
    quantize_int8_rows,
    topk_inner_product,
)
from distllm_tpu_torch.utils import BaseConfig, lax_int, resolve_device

PRECISIONS = ('float32', 'int8', 'ubinary')


@dataclasses.dataclass
class BatchedSearchResults:
    """Per query: the kept indices and their scores."""

    total_indices: list[list[int]]
    total_scores: list[list[float]]


def _tensors(held) -> list[torch.Tensor]:
    """The tensors in ``held``: a tensor, ``None``, or a sequence of them
    (shards, ``(codes, scales)`` pairs)."""
    if held is None:
        return []
    if isinstance(held, torch.Tensor):
        return [held]
    return [t for part in held for t in _tensors(part)]


def _load_embeddings_dataset(dataset_dir: 'str | Path'):
    """Load an embeddings dataset; a directory of UUID shard subdirectories
    (the embedding job's output layout) is concatenated, so an index
    builds straight from an unmerged run."""
    from datasets import concatenate_datasets, load_from_disk

    dataset_dir = Path(dataset_dir)
    if not (dataset_dir / 'dataset_info.json').exists():
        shards = sorted(
            p for p in dataset_dir.iterdir()
            if p.is_dir() and (p / 'dataset_info.json').exists()
        )
        if shards:
            return concatenate_datasets([load_from_disk(str(p)) for p in shards])
    return load_from_disk(str(dataset_dir))


@dataclasses.dataclass(kw_only=True)
class TpuIndexV2Config(BaseConfig):
    name: str = 'tpu_index_v2'
    dataset_dir: Path
    # Where the index files live; None = dataset_dir/tpu_index.
    index_dir: Path | None = None
    # 'flat' (exact); the reference's 'hnsw*' names are served exactly too.
    index_type: str = 'flat'
    precision: str = 'float32'
    # int8 / ubinary: the oversampling factor before the fp32 rescore.
    rescore_multiplier: int = 4
    metric: str = 'inner_product'
    normalize: bool = True  # L2-normalise the corpus rows (cosine / IP)
    # Mesh axis sizes ({'data': n}, {'data': -1}: every visible card): the
    # float32 and int8 tiers row-shard the corpus, one shard a device.
    mesh: dict | None = None

    def validate(self) -> None:
        if self.name not in ('tpu_index_v2', 'faiss_index_v2'):
            raise ValueError(f'index name must be tpu_index_v2 or faiss_index_v2, got {self.name!r}')
        if self.precision not in PRECISIONS:
            raise ValueError(f'precision must be one of {PRECISIONS}, got {self.precision!r}')
        if self.metric != 'inner_product':
            raise ValueError(f"metric must be 'inner_product', got {self.metric!r}")
        if not isinstance(self.normalize, bool):
            raise ValueError('normalize must be a bool')
        if self.mesh is not None and not isinstance(self.mesh, dict):
            raise ValueError('mesh must be a mapping of axis sizes or null')
        self.rescore_multiplier = lax_int('rescore_multiplier', self.rescore_multiplier)
        self.dataset_dir = Path(self.dataset_dir)
        if self.index_dir is not None:
            self.index_dir = Path(self.index_dir)

    def get_index(self, dataset=None, device: 'str | torch.device | None' = None):
        return TpuIndexV2(self, mesh=self.mesh, dataset=dataset, device=device)


class TpuIndexV2:
    # Rows per build chunk (and index part file): host memory stays
    # O(chunk) while the index is built.
    _CHUNK_ROWS = 65536

    def __init__(
        self,
        config: TpuIndexV2Config,
        mesh=None,
        dataset=None,
        device: 'str | torch.device | None' = None,
    ) -> None:
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.num_shards = data_shards(mesh)
        # Shard i lives on cuda:<i % cards> (every shard on the CPU for a
        # CPU index); the first is where queries and results live.
        if self.device.type == 'cuda':
            cards = torch.cuda.device_count()
            self.shard_devices = [torch.device('cuda', i % cards) for i in range(self.num_shards)]
        else:
            self.shard_devices = [self.device] * self.num_shards
        self.dataset = (
            _load_embeddings_dataset(config.dataset_dir) if dataset is None else dataset
        )
        index_dir = config.index_dir or (Path(config.dataset_dir) / 'tpu_index')
        self._index_file = Path(index_dir) / f'index_{config.precision}.npz'
        self._meta_file = self._index_file.with_suffix('.meta.json')
        self._build_or_load()

    # ------------------------------------------------------------ building
    def _chunk(self, lo: int) -> np.ndarray:
        hi = min(lo + self._CHUNK_ROWS, len(self.dataset))
        rows = np.asarray(self.dataset[lo:hi]['embeddings'], dtype=np.float32)
        if self.config.normalize:
            norms = np.linalg.norm(rows, axis=1, keepdims=True)
            rows = rows / np.clip(norms, 1e-12, None)
        return rows

    def _build_shards(self) -> None:
        """Stream the corpus into per-chunk part files (read, normalised
        and quantized or packed in a thread pool: numpy releases the GIL),
        then write the meta file."""
        shard_dir = self._index_file.parent
        shard_dir.mkdir(parents=True, exist_ok=True)
        offsets = list(range(0, len(self.dataset), self._CHUNK_ROWS))
        stem = self._index_file.stem

        def build_one(part: int) -> str:
            rows = self._chunk(offsets[part])
            if self.config.precision == 'ubinary':
                rows = pack_sign_bits(rows)
            elif self.config.precision == 'int8':
                codes, scales = quantize_int8_rows(rows)
                name = f'{stem}.part{part:05d}.npz'
                np.savez(shard_dir / name, codes=codes, scales=scales)
                return name
            name = f'{stem}.part{part:05d}.npy'
            np.save(shard_dir / name, rows)
            return name

        with ThreadPoolExecutor(max_workers=8) as pool:
            parts = list(pool.map(build_one, range(len(offsets))))
        meta = {'num_rows': len(self.dataset), 'parts': parts}
        self._meta_file.write_text(json.dumps(meta))

    def _iter_stored_chunks(self):
        """The stored index chunks: memory-mapped part files, or the legacy
        single ``.npz``."""
        if self._meta_file.exists():
            meta = json.loads(self._meta_file.read_text())
            for name in meta['parts']:
                yield np.load(self._index_file.parent / name, mmap_mode='r')
        else:
            yield np.load(self._index_file)['embeddings']

    def _build_or_load(self) -> None:
        if self._meta_file.exists():
            # A stale index (the dataset re-embedded since the build) would
            # mis-align rows: rebuilt when the row count moved.
            meta = json.loads(self._meta_file.read_text())
            if meta.get('num_rows') != len(self.dataset):
                self._build_shards()
        elif not self._index_file.exists():
            self._build_shards()
        self._num_real = len(self.dataset)
        self._corpus = self._int8 = self._packed = None

        if self.config.precision == 'ubinary':
            # Packed bits are corpus/32 bytes: assembled on the host and
            # grouped [G, chunk, H/8] for the scan. No fp32 copy: rescore
            # candidates are gathered from the dataset per query batch.
            bits = np.concatenate([np.asarray(c) for c in self._iter_stored_chunks()])
            self._packed = torch.from_numpy(group_rows(bits, SCAN_CHUNK_BITS)).to(self.device)
            return
        if self.config.precision == 'int8':
            parts = list(self._iter_stored_chunks())
            codes = np.concatenate([np.asarray(p['codes']) for p in parts])
            scales = np.concatenate([np.asarray(p['scales']) for p in parts])
            if self.num_shards > 1:
                self._int8 = self._put_row_sharded((codes, 0), (scales, 1))
                return
            self._int8 = (
                torch.from_numpy(group_rows(codes, SCAN_CHUNK_INT8)).to(self.device),
                torch.from_numpy(group_rows(scales, SCAN_CHUNK_INT8)).to(self.device),
            )
            return
        if self.num_shards > 1:
            # Assembled on the host and padded to a shardable row count;
            # padded indices (>= _num_real) are dropped by the search.
            rows = np.concatenate([np.asarray(c) for c in self._iter_stored_chunks()])
            self._corpus = [shard for (shard,) in self._put_row_sharded((rows, 0))]
            return
        # float32: assembled on the device chunk by chunk, so host memory
        # stays O(chunk).
        buf, lo = None, 0
        for chunk in self._iter_stored_chunks():
            part = torch.from_numpy(np.array(chunk, dtype=np.float32))
            if buf is None:
                buf = torch.empty(
                    (self._num_real, part.shape[1]), dtype=torch.float32, device=self.device
                )
            buf[lo:lo + part.shape[0]].copy_(part)
            lo += part.shape[0]
        self._corpus = buf

    def _put_row_sharded(self, *arrays_with_fill) -> list[tuple[torch.Tensor, ...]]:
        """Pad each host array to a row count the shards divide (with the
        JAX fill values: 0 for rows and codes, 1 for scales) and place
        shard ``i`` of each on ``shard_devices[i]``; returns one tuple of
        tensors a shard."""
        n = self.num_shards
        shards: list[list[torch.Tensor]] = [[] for _ in range(n)]
        for arr, fill in arrays_with_fill:
            pad = (-arr.shape[0]) % n
            if pad:
                arr = np.concatenate([arr, np.full((pad, *arr.shape[1:]), fill, arr.dtype)])
            size = arr.shape[0] // n
            for i, device in enumerate(self.shard_devices):
                shards[i].append(torch.from_numpy(np.ascontiguousarray(
                    arr[i * size:(i + 1) * size])).to(device))
        return [tuple(parts) for parts in shards]

    def __len__(self) -> int:
        return len(self.dataset)

    @property
    def device_bytes(self) -> int:
        """Bytes the index holds on its devices (every shard's)."""
        return sum(t.numel() * t.element_size()
                   for t in _tensors((self._corpus, self._packed, self._int8)))

    # ------------------------------------------------------------- search
    def search(
        self,
        query_embeddings: np.ndarray,  # [B, H] fp32 (normalised by the Retriever)
        top_k: int = 1,
        score_threshold: float = 0.0,
    ) -> BatchedSearchResults:
        if self.config.precision == 'ubinary':
            scores, indices = self._search_ubinary(query_embeddings, top_k)
        elif self.config.precision == 'int8':
            scores, indices = self._search_int8(query_embeddings, top_k)
        else:
            queries = torch.from_numpy(np.asarray(query_embeddings, dtype=np.float32))
            scores, indices = topk_inner_product(queries.to(self.device), self._corpus, top_k)
            scores, indices = scores.cpu().numpy(), indices.cpu().numpy()
        total_indices, total_scores = [], []
        for row_scores, row_idx in zip(scores, indices):
            keep = (row_scores >= score_threshold) & (row_idx < self._num_real)
            total_indices.append([int(i) for i in row_idx[keep]])
            total_scores.append([float(s) for s in row_scores[keep]])
        return BatchedSearchResults(total_indices, total_scores)

    def _oversample(self, top_k: int) -> int:
        return min(top_k * self.config.rescore_multiplier, len(self.dataset))

    def _search_ubinary(self, queries: np.ndarray, top_k: int):
        query_bits = torch.from_numpy(pack_sign_bits(queries)).to(self.device)
        _, cand = hamming_topk(
            query_bits, self._packed, self._oversample(top_k), n_valid=self._num_real
        )
        return self._rescore(queries, cand.cpu().numpy(), top_k)

    def _search_int8(self, queries: np.ndarray, top_k: int):
        q = torch.from_numpy(np.asarray(queries, dtype=np.float32)).to(self.device)
        # A list of (codes, scales) shards, or the grouped codes and scales.
        codes, scales = (self._int8, None) if self.num_shards > 1 else self._int8
        _, cand = int8_topk(q, codes, scales, self._oversample(top_k), n_valid=self._num_real)
        return self._rescore(queries, cand.cpu().numpy(), top_k)

    def _rescore(self, queries: np.ndarray, cand: np.ndarray, top_k: int):
        """fp32 rescore of quantized-tier candidates against the
        full-precision queries, on the host: the candidate rows are
        gathered from the dataset in sorted order (the index keeps no fp32
        copy), normalised, scored and re-ranked; a candidate past the real
        rows keeps its index and scores -inf."""
        valid = cand < self._num_real
        flat = np.minimum(cand, self._num_real - 1).reshape(-1)
        order_back = np.argsort(np.argsort(flat))
        gathered = np.asarray(
            self.dataset[np.sort(flat).tolist()]['embeddings'], dtype=np.float32
        )[order_back]
        cand_vectors = gathered.reshape(*cand.shape, -1)
        if self.config.normalize:
            norms = np.linalg.norm(cand_vectors, axis=-1, keepdims=True)
            cand_vectors = cand_vectors / np.clip(norms, 1e-12, None)
        rescored = np.einsum('bh,boh->bo', queries.astype(np.float32), cand_vectors)
        rescored = np.where(valid, rescored, -np.inf)
        order = np.argsort(-rescored, axis=1)[:, :top_k]
        indices = np.take_along_axis(cand, order, axis=1)
        scores = np.take_along_axis(rescored, order, axis=1)
        return scores, indices

    # ---------------------------------------------------------- row access
    def get(self, indices: list[int], key: str) -> list[Any]:
        rows = self.dataset[indices]
        return list(rows[key])


@dataclasses.dataclass(kw_only=True)
class TpuIndexV1Config(BaseConfig):
    """The deprecated V1 surface: a ``DeprecationWarning`` and a V2 index."""

    name: str = 'tpu_index_v1'
    dataset_dir: Path
    metric: str = 'inner_product'

    def validate(self) -> None:
        if self.name not in ('tpu_index_v1', 'faiss_index_v1'):
            raise ValueError(f'index name must be tpu_index_v1 or faiss_index_v1, got {self.name!r}')
        if self.metric not in ('inner_product', 'l2'):
            raise ValueError(f"metric must be 'inner_product' or 'l2', got {self.metric!r}")

    def get_index(self, dataset=None, device: 'str | torch.device | None' = None):
        warnings.warn(
            'TpuIndexV1 is deprecated; use TpuIndexV2.', DeprecationWarning, stacklevel=2
        )
        return TpuIndexV2(
            TpuIndexV2Config(dataset_dir=self.dataset_dir), dataset=dataset, device=device
        )


@dataclasses.dataclass(kw_only=True)
class RetrieverConfig(BaseConfig):
    """The index (``faiss_config``), the query encoder and its pooler."""

    faiss_config: dict[str, Any]
    encoder_config: dict[str, Any]
    pooler_config: dict[str, Any]
    batch_size: int = 8

    def validate(self) -> None:
        for key in ('faiss_config', 'encoder_config', 'pooler_config'):
            if not isinstance(getattr(self, key), dict):
                raise ValueError(f'{key} must be a mapping')
        self.batch_size = lax_int('batch_size', self.batch_size)

    def get_retriever(
        self,
        register: bool = False,
        device: 'str | torch.device | None' = None,
    ) -> 'Retriever':
        """The index on ``device``, the encoder (warm-started through the
        registry with ``register``) and the pooler."""
        from distllm_tpu_torch.embed import get_encoder, get_pooler

        index_config = dict(self.faiss_config)
        index_config.pop('name', None)
        index = TpuIndexV2Config.from_dict(index_config).get_index(device=device)
        encoder = get_encoder(self.encoder_config, register=register, device=device)
        pooler = get_pooler(self.pooler_config)
        return Retriever(index, encoder, pooler, self.batch_size)


class Retriever:
    """Query encoding and index search."""

    def __init__(self, index: TpuIndexV2, encoder, pooler, batch_size: int = 8) -> None:
        self.index = index
        self.encoder = encoder
        self.pooler = pooler
        self.batch_size = batch_size

    def get_pooled_embeddings(self, queries: list[str]) -> np.ndarray:
        """Length-sorted batches -> encode -> pool -> L2-normalise, in the
        queries' order."""
        from distllm_tpu_torch.embed.embedders.full_sequence import compute_embeddings

        embeddings = compute_embeddings(
            queries, self.encoder, self.pooler, self.batch_size, normalize=False,
            device=self.encoder.device,
        )
        norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
        return embeddings / np.clip(norms, 1e-12, None)

    def search(
        self,
        query: 'str | list[str]',
        top_k: int = 1,
        score_threshold: float = 0.0,
    ) -> tuple[BatchedSearchResults, np.ndarray]:
        """(results, query embeddings)."""
        queries = [query] if isinstance(query, str) else list(query)
        embeddings = self.get_pooled_embeddings(queries)
        return self.index.search(embeddings, top_k, score_threshold), embeddings

    def get(self, indices: list[int], key: str) -> list[Any]:
        return self.index.get(indices, key)

    def get_texts(self, indices: list[int]) -> list[str]:
        return self.index.get(indices, 'text')
