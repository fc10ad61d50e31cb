"""Exact top-k by inner product and by Hamming distance over a corpus on
one device (the PyTorch counterpart of ``distllm_tpu.ops.topk``, the
search core of the retrieval index).

The JAX module is XLA (no ``pallas_call``): matrix products and
``lax.top_k``. The port keeps its results, index for index:

- **Ties.** ``lax.top_k`` orders equal scores by the lower index, and the
  JAX scans merge chunk candidates in chunk order, so every result is the
  top k by (score descending, index ascending). ``torch.topk`` keeps no
  such order, so each selection here runs on one int64 key per candidate:
  the score's float32 bits mapped to an order-preserving int32 (the total
  order ``lax.top_k`` uses, in which -0.0 sorts below +0.0) in the high
  half, and ``2**32 - 1 - index`` in the low half. Keys are unique, and
  their order is JAX's.
- **Exact integer scores.** The int8 tier scores int8 x int8 products in
  int32 (``torch._int_mm``; on CUDA its rows padded to at least 32 and a
  multiple of 8, the corpus slab a multiple of 8), then applies the scales
  in the JAX order, ``raw.float() * qscale[:, None] * scales[None, :]``.
  Hamming distances are ``|a| + |b| - 2 a.b`` over unpacked 0/1 vectors,
  the same exact product. fp32 would not hold int8 sums at H = 1280.
- **Query quantization** divides by a 0-d tensor of 127: a division by a
  Python scalar becomes a multiplication by its reciprocal on CUDA, one
  rounding off JAX.
- **fp32 scores stay fp32**: the float32 tier's products run with the
  float32 matmul precision at ``'highest'`` whatever the caller set, so
  TF32 never enters (the oracle is JAX on the CPU).
- **Selection is exact at every size.** The JAX quantized tiers switch to
  the TPU's ``approx_max_k`` from 2**20 rows (exact on the CPU); the port
  never approximates.
- **Memory.** Every tier scores the corpus in row slabs with a running
  top-k, so peak memory is ``O(B * slab)``, never ``[B, N]``.

``quantize_int8_rows``, ``pack_sign_bits`` and ``group_rows`` are the JAX
module's host numpy functions, copied, so codes and layouts are bitwise
equal.

**Data-sharded corpora** (the JAX ``_sharded_topk``). A ``mesh`` whose
``data`` axis is ``n > 1`` (a mapping of axis sizes, or an object with a
``shape`` mapping; other axes only replicate in JAX and change nothing
here) row-shards the corpus into ``n`` equal shards: a tensor is split
into ``n`` row views (the row count must divide), or the caller passes
the list of shards, each on its own device (the index's placement). Each
shard is scored on its device with a local top ``min(k, rows)``, its
indices offset by the shard's start; only the ``[B, k]`` candidates cross
to the queries' device, where they are concatenated in shard order and
one final selection takes the top ``k``. Shard order is index order, so
the result is JAX's, ties included. The flat int8 tier shards the same
way (its padded rows are not masked, as in JAX); grouped codes refuse a
data mesh, and ``hamming_topk`` takes none.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# Slab sizes of the grouped corpus layout (rows per group), the JAX
# module's: the index groups its quantized tiers by them at build.
SCAN_CHUNK_BITS = 1 << 18
SCAN_CHUNK_INT8 = 1 << 19
# Rows per slab of the float32 tier: [B, slab] fp32 scores at a time.
FLOAT_CHUNK = 1 << 18

_LOW = (1 << 32) - 1


def data_shards(mesh) -> int:
    """The number of row shards ``mesh`` asks for: ``None`` is 1; else its
    ``data`` axis (a mapping of axis sizes, or an object with a ``shape``
    mapping). ``-1`` is every visible card over the other axes' product
    (at least one card: the CPU counts as one device), as the JAX
    ``MeshSpec`` fills its ``-1`` axis."""
    if mesh is None:
        return 1
    shape = mesh if isinstance(mesh, dict) else getattr(mesh, 'shape', {})
    data = shape.get('data', 1)
    if data == -1:
        others = 1
        for axis, size in shape.items():
            if axis != 'data':
                others *= size
        cards = max(1, torch.cuda.device_count() if torch.cuda.is_available() else 0)
        if others < 1 or cards % others:
            raise ValueError(f'{cards} device(s) not divisible by fixed axes {others}')
        data = cards // others
    if not isinstance(data, int) or data < 1:
        raise ValueError(f'mesh data axis must be a positive int or -1, got {data!r}')
    return data


def _row_shards(corpus, n: int, *more) -> list[tuple[torch.Tensor, ...]]:
    """``corpus`` (and ``more`` tensors of the same rows) as ``n`` row
    shards: a list of shards is taken as it is, a tensor split into ``n``
    equal row views. Returns one tuple per shard."""
    if isinstance(corpus, (list, tuple)):
        parts = [tuple(p) if isinstance(p, (list, tuple)) else (p,) for p in corpus]
        if len(parts) != n or len({p[0].shape[0] for p in parts}) != 1:
            raise ValueError(
                f'{len(parts)} corpus shards of rows {[p[0].shape[0] for p in parts]} for a '
                f'data axis of {n}: the shards must be equal'
            )
        return parts
    rows = corpus.shape[0]
    if rows % n:
        raise ValueError(
            f'{rows} corpus rows do not split evenly over the data axis ({n} shards)'
        )
    size = rows // n
    return [
        tuple(t[i * size:(i + 1) * size] for t in (corpus, *more)) for i in range(n)
    ]


@contextlib.contextmanager
def _highest_fp32_matmul():
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


def _order_keys(scores: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 keys whose descending order is (score descending in float32
    total order, index ascending); ``index`` broadcasts against
    ``scores`` and is below 2**32."""
    bits = scores.contiguous().view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    return ordered * (1 << 32) + (_LOW - index.to(torch.int64))


def _select(scores: torch.Tensor, index: torch.Tensor, k: int):
    """The top ``k`` of each row of ``scores`` [B, C] by JAX's order, with
    their indices (``index`` [B, C] or [C])."""
    index = index.expand_as(scores)
    _, pos = torch.topk(_order_keys(scores, index), k, dim=1)
    return torch.gather(scores, 1, pos), torch.gather(index, 1, pos)


def _merge(best, cand, k: int):
    """Running top-k: ``best`` (scores, indices) merged with ``cand``,
    ``k`` bounded by the candidates there are."""
    if best is None:
        return cand
    scores = torch.cat([best[0], cand[0]], dim=1)
    return _select(scores, torch.cat([best[1], cand[1]], dim=1), min(k, scores.shape[1]))


def _shard_count(corpus, mesh) -> int:
    """Shards of a search: a list of shards without a mesh is its length;
    otherwise the mesh's ``data`` axis (:func:`data_shards`)."""
    if isinstance(corpus, (list, tuple)) and mesh is None:
        return len(corpus)
    return data_shards(mesh)


def _sharded_topk(local, shards, k: int, device):
    """The JAX ``_sharded_topk``: ``local(*shard, local_k)`` gives each
    shard's top ``local_k = min(k, rows)`` (scores, shard-local indices)
    on the shard's device; the indices are offset by the shard's start,
    the candidates moved to ``device`` and concatenated in shard order,
    and one selection takes the top ``k`` (bounded by the rows)."""
    rows = shards[0][0].shape[0]
    k = min(k, rows * len(shards))
    local_k = min(k, rows)
    found = [local(*shard, local_k) for shard in shards]
    scores = torch.cat([s.to(device) for s, _ in found], dim=1)
    index = torch.cat([(i + j * rows).to(device) for j, (_, i) in enumerate(found)], dim=1)
    return _select(scores, index, k)


def _float_topk(queries, corpus, k: int, chunk_size: int):
    """One device's exact top-k by inner product, in row slabs."""
    n = corpus.shape[0]
    best = None
    with _highest_fp32_matmul():
        for lo in range(0, n, chunk_size):
            part = corpus[lo:lo + chunk_size]
            scores = queries @ part.T
            index = torch.arange(lo, lo + part.shape[0], device=corpus.device)
            best = _merge(best, _select(scores, index, min(k, part.shape[0])), k)
    return best


def topk_inner_product(
    queries: torch.Tensor,  # [B, H] fp32
    corpus,  # [N, H] fp32, or a list of row shards
    k: int,
    mesh=None,
    chunk_size: int = FLOAT_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by inner product. Returns (scores [B, k] fp32, indices
    [B, k] int64) on the queries' device. With a data-sharded ``mesh``
    (or a list of shards) each shard scores on its own device and the
    candidates merge as in JAX."""
    n_shards = _shard_count(corpus, mesh)
    if n_shards == 1:
        if isinstance(corpus, (list, tuple)):
            (corpus,) = _row_shards(corpus, 1)[0]
        return _float_topk(queries, corpus, min(k, corpus.shape[0]), chunk_size)

    def local(part, local_k):
        return _float_topk(queries.to(part.device), part, local_k, chunk_size)

    return _sharded_topk(local, _row_shards(corpus, n_shards), k, queries.device)


def quantize_int8_rows(embeddings: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """fp32 ``[N, H]`` -> (``int8`` codes ``[N, H]``, fp32 scales ``[N]``):
    symmetric per-row absmax quantization (host numpy, the JAX function's
    code)."""
    absmax = np.abs(embeddings).max(axis=1)
    scales = np.where(absmax == 0, 1.0, absmax / 127.0).astype(np.float32)
    codes = np.clip(np.round(embeddings / scales[:, None]), -127, 127).astype(np.int8)
    return codes, scales


def pack_sign_bits(embeddings: np.ndarray) -> np.ndarray:
    """fp32 ``[N, H]`` -> uint8 ``[N, H/8]``: bit 1 where the value is > 0,
    big-endian within each byte (sentence-transformers' ``ubinary``)."""
    if embeddings.shape[1] % 8 != 0:
        raise ValueError(f'embedding dim {embeddings.shape[1]} not divisible by 8')
    bits = (embeddings > 0).astype(np.uint8)
    return np.packbits(bits, axis=1)


def group_rows(arr: np.ndarray, chunk: int) -> np.ndarray:
    """Host side: pad ``[N, ...]`` with zeros to a multiple of ``chunk``
    rows and reshape to ``[G, chunk, ...]``, the grouped layout."""
    n = arr.shape[0]
    pad = (-n) % chunk
    if pad:
        arr = np.concatenate([arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)])
    return arr.reshape(arr.shape[0] // chunk, chunk, *arr.shape[1:])


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b.T`` of int8 ``a`` [M, H] and ``b`` [C, H] in int32.
    On CUDA ``torch._int_mm`` needs more than 16 rows and multiples of 8:
    ``a``'s rows are padded to a multiple of 8 and at least 32, ``b``'s to
    a multiple of 8, and the padding is cut from the result."""
    m, c = a.shape[0], b.shape[0]
    if a.device.type == 'cuda':
        rows = max(32, -(-m // 8) * 8)
        if rows != m:
            a = torch.cat([a, a.new_zeros(rows - m, a.shape[1])])
        if c % 8:
            b = torch.cat([b, b.new_zeros(8 - c % 8, b.shape[1])])
    return torch._int_mm(a.contiguous(), b.contiguous().T)[:m, :c]


def quantize_queries(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 codes and fp32 scales of fp32 queries, as the JAX
    function quantizes them on the fly."""
    qmax = queries.abs().amax(dim=1)
    div = torch.tensor(127.0, dtype=queries.dtype, device=queries.device)
    qscale = torch.where(qmax == 0, torch.ones_like(qmax), qmax / div)
    qi = torch.clamp(torch.round(queries / qscale[:, None]), -127, 127).to(torch.int8)
    return qi, qscale


def _score_int8(qi, qscale, codes_part, scales_part):
    """int8 x int8 -> int32 scores with the true scales reapplied in the
    JAX order."""
    raw = _int_dot(qi, codes_part)
    return raw.float() * qscale[:, None] * scales_part[None, :]


def _unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., H/8]`` -> 0/1 int8 ``[..., H]`` (big-endian, as
    :func:`pack_sign_bits` packs)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.to(torch.int8).reshape(*packed.shape[:-1], -1)


def _score_hamming(qu, q_pop, chunk_bits):
    """Negated Hamming distances as fp32 (higher = closer):
    ``|a| + |b| - 2 a.b`` over the unpacked 0/1 vectors."""
    cu = _unpack_bits(chunk_bits)
    dots = _int_dot(qu, cu)
    c_pop = cu.sum(dim=1, dtype=torch.int32)
    return -(q_pop[:, None] + c_pop[None, :] - 2 * dots).float()


def _scan(score_fn, parts, k: int, n_valid: int | None):
    """Running top-k over corpus slabs: ``parts`` yields (row offset,
    slab tensors); rows at or past ``n_valid`` score -inf."""
    best = None
    for lo, slab in parts:
        scores = score_fn(*slab)
        index = torch.arange(lo, lo + scores.shape[1], device=scores.device)
        if n_valid is not None and lo + scores.shape[1] > n_valid:
            scores = scores.masked_fill(index[None, :] >= n_valid, float('-inf'))
        best = _merge(best, _select(scores, index, min(k, scores.shape[1])), k)
    return best


def int8_topk(
    queries: torch.Tensor,  # [B, H] fp32
    codes,  # [N, H] int8, grouped [G, C, H] (group_rows), or a list of row shards
    scales,  # [N] fp32 ([G, C] when grouped; None with a list of (codes, scales) shards)
    k: int,
    mesh=None,
    chunk_size: int = SCAN_CHUNK_INT8,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner product against an int8-quantized corpus: the queries
    quantized per row on the fly, exact int32 products, the true scales
    reapplied before selection. Flat codes are scanned in ``chunk_size``
    slabs; grouped codes ``[G, C, H]`` (with ``scales [G, C]`` and
    ``n_valid``, the real row count) a group at a time, padded rows
    masked. With a data-sharded ``mesh`` (or a list of ``(codes,
    scales)`` shards) flat codes are scored shard by shard, each on its
    device, and merged as in JAX, which masks no padded row there.
    Returns (approximate scores [B, k], indices [B, k])."""
    sharded = isinstance(codes, (list, tuple))
    n_shards = _shard_count(codes, mesh)
    if not sharded and codes.ndim == 3:
        if n_valid is None:
            # group_rows zero-pads the last slab; without the real row
            # count those rows would rank as neighbours.
            raise ValueError('grouped codes [G, C, H] require n_valid')
        if n_shards > 1:
            raise ValueError(
                'grouped codes [G, C, H] cannot combine with a data-sharded '
                'mesh; pass flat [N, H] codes for the sharded path'
            )
        n = n_valid
        c = codes.shape[1]
        parts = ((g * c, (codes[g], scales[g])) for g in range(codes.shape[0]))
        qi, qscale = quantize_queries(queries)
        return _scan(
            lambda codes_part, scales_part: _score_int8(qi, qscale, codes_part, scales_part),
            parts, min(k, n), n_valid,
        )
    qi, qscale = quantize_queries(queries)

    def local(codes_part, scales_part, local_k):
        q, s = qi.to(codes_part.device), qscale.to(codes_part.device)
        rows = codes_part.shape[0]
        slabs = (
            (lo, (codes_part[lo:lo + chunk_size], scales_part[lo:lo + chunk_size]))
            for lo in range(0, rows, chunk_size)
        )
        return _scan(
            lambda c_part, s_part: _score_int8(q, s, c_part, s_part), slabs, local_k, None,
        )

    shards = _row_shards(codes, n_shards, *(() if sharded else (scales,)))
    if n_shards == 1:
        codes_part, scales_part = shards[0]
        return local(codes_part, scales_part, min(k, codes_part.shape[0]))
    return _sharded_topk(local, shards, k, queries.device)


# The largest fp32 value strictly under INT32_MAX: the grouped Hamming scan
# reports a padded row's -inf as this distance, as the JAX scan does.
_NO_NEIGHBOUR = -2147483520.0


def hamming_topk(
    query_bits: torch.Tensor,  # [B, H/8] uint8
    corpus_bits: torch.Tensor,  # [N, H/8] uint8, or grouped [G, C, H/8]
    k: int,
    chunk_size: int = SCAN_CHUNK_BITS,
    n_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by smallest Hamming distance. Returns (distances [B, k]
    int32, indices [B, k]). Flat bits are scanned in ``chunk_size`` slabs;
    grouped bits ``[G, C, H/8]`` (with ``n_valid``) a group at a time,
    padded rows masked."""
    qu = _unpack_bits(query_bits)
    q_pop = qu.sum(dim=1, dtype=torch.int32)
    if corpus_bits.ndim == 3:
        if n_valid is None:
            raise ValueError('grouped corpus [G, C, H/8] requires n_valid')
        n = n_valid
        c = corpus_bits.shape[1]
        parts = ((g * c, (corpus_bits[g],)) for g in range(corpus_bits.shape[0]))
    else:
        n = corpus_bits.shape[0]
        parts = (
            (lo, (corpus_bits[lo:lo + chunk_size],)) for lo in range(0, n, chunk_size)
        )
    k = min(k, n)
    neg, idx = _scan(
        lambda chunk: _score_hamming(qu, q_pop, chunk),
        parts, k, n_valid if corpus_bits.ndim == 3 else None,
    )
    if corpus_bits.ndim == 3:
        neg = torch.clamp(neg, min=_NO_NEIGHBOUR)
    return (-neg).to(torch.int32), idx
