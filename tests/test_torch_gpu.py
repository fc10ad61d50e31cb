"""The CUDA kernels against the port's plain versions, on the card: the
ragged paged-attention kernel (K1), the int8 weight-only matmul (K2) and
the encoder-attention kernel (K3).
Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is false. The file imports no JAX, so it
runs on a machine without it::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

K1 is held on valid rows to ``paged_attention.comparison_tolerance`` of
the route that served it (asserted by ``launches_by_route``): fp32 ``1e-5``
(summation order only); bf16 on the CUDA cores one bf16 step of out,
``2**-7 * |ref| + 1e-5`` (both sides round one fp32 result to bf16); bf16
on the tensor cores adds ``2**-8 * (P @ |V|)`` (each unnormalised p_j is
rounded to bf16 before P @ V, as on the TPU), and so does bf16 on the
split-KV route (decode rows), held at the split plan's edges, with
windows inside, across and below splits, and held to launch bitwise
alike twice. Pad queries must be exact
zeros. K1's int8-KV mode (``QuantizedKV`` pools) is held on every route
to the same bound plus its INT8 term, with NaN in the trash block's codes
and scales leaving outputs bitwise unchanged. K1's mixed mode (a full-precision pool of the other dtype than q: fp32 q
over bf16 on the CUDA cores, bf16 q over fp32 on the tensor-core and
split-KV routes) is held to each route's bound plus its MIXED term, with
NaN in the trash block leaving outputs bitwise unchanged; an fp32 engine
over a bf16 pool gives the plain op's greedy tokens. The prefix cache's
pool writes stay in place under captured decode graphs: after a
copy-on-write hit, a spill and a promotion, every decode window replayed
from the graphs is bitwise the eager ``decode_loop`` on the same pool (a
mutant that rebinds the pool instead fails it), and the promoted blocks'
bytes, bf16 codes or int8 codes and scales, are bitwise the bytes they had
before their spill. A promotion's copy (9 MiB from the host tier) is
queued on a side stream with no host wait: the request that promoted and
one that arrives while the copy is queued, borrowing its blocks, give the
cache-off engine's greedy tokens (fp32). The speculative verify window,
replayed from its captured graph, gives the eager ``mistral.spec_window``'s
packed result and pool writes bitwise (bf16, int8 weights, an int8 pool,
fp32; greedy and sampled rows; a span that fills tensor-core tiles and one
on the split-KV route); after windows whose drafts are all rejected the
tokens and every pool byte below each row's ``num_tokens`` equal a
never-drafted engine's (fp32), and the scheduler's block rows and free
list equal a ``draft_k=0`` engine's, which a mutant that skips
``sched.trim`` fails.
K3 is held to its own elementwise bound
(``encoder_attention.comparison_tolerance``: in bf16 one step of out
plus one bf16 step of one p_j * v_j) on both of its routes, on every row,
fully masked included, at the protein and ModernBERT shapes (ESM-2 650M,
ESM-C 600M, ModernBERT-base with its window bias) and on strided thirds of
one fused product; ESM-2, ESM-C and ModernBERT reach it on every layer.
K2 is held to ``quantized_matmul.comparison_tolerance`` of the route that
served it (asserted by ``launches_by_route``: bf16 on the tensor cores,
fp32 on the CUDA cores): in bf16 one step of out, and in both dtypes an
fp32 summation-order term that scales with ``scale * (|x| @ |q|)``, to
which the tensor-core route adds the measured truncation of its
accumulator, a term that follows the partial sums; quantizing on the card
gives the CPU's codes bitwise. ``run_loadgen`` over a small fp32 engine
gives the plain op's tokens with every share of the roofline in
(0, 1.05], with attribution off and under a recovered fault alike.
The pipelined loop (depth 2 and 3, and ``defer_prefill``) replays windows
that are each bitwise the eager ``decode_loop`` on their inputs and pool,
its device-side carry merges as the host asked, and one slot at any depth
gives depth 1's tokens; the native scheduler builds with g++ on the card
machine and makes the Python twin's decisions; a ``ProfilerCapture``
stops itself and its trace holds K1's launches. Mixtral's ``moe_mlp`` on
the card gives its CPU run (fp32 within 1e-5, ties to the lower expert),
a 4-D expert bank's int8 codes and scales quantized on the card are the
CPU's bitwise, and a 2-layer fp32 Mixtral engine gives the plain ops'
greedy tokens on K1, and on K1 + K2 with int8 weights.
"""

import functools

import numpy as np
import pytest
import torch

from distllm_tpu_torch.ops import encoder_attention as tea
from distllm_tpu_torch.ops import paged_attention as tpa
from distllm_tpu_torch.ops import quantization as tq
from distllm_tpu_torch.ops import quantized_matmul as tqm

pytestmark = pytest.mark.gpu

# K2's launch count in a captured step's counter delta (the decode graph
# module's COUNTERS order: K1's counters, then K2's, then K3's).
_K2_LAUNCHES = next(
    i for i, (fn, name) in enumerate(tpa.COUNTERS + tqm.COUNTERS)
    if fn is tqm.int8_matmul and name == 'launches'
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with CUDA')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _case(seed, *, nh, nkv, hd, dtype, ctxs, q_lens, span, bs=16, trash=1e4):
    rng = np.random.default_rng(seed)
    ctxs, q_lens = np.asarray(ctxs), np.asarray(q_lens)
    pages = -(-ctxs // bs)
    nb = int(pages.sum()) + 1
    perm = rng.permutation(np.arange(1, nb))
    bt = np.zeros((len(ctxs), int(pages.max())), np.int32)
    at = 0
    for row, n in enumerate(pages):
        bt[row, :n] = perm[at:at + n]
        at += n
    dt = getattr(torch, dtype)
    k = torch.from_numpy(rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(nb, bs, nkv, hd)).astype(np.float32))
    k[0], v[0] = trash, -trash  # trash block garbage (finite for the plain op)
    q = torch.from_numpy(
        rng.normal(size=(len(ctxs), span, nh, hd)).astype(np.float32)
    )
    pos = (ctxs - q_lens)[:, None] + np.arange(span)[None, :]
    dev = 'cuda'
    return {
        'args': (q.to(dev, dt), k.to(dev, dt), v.to(dev, dt),
                 torch.from_numpy(bt).to(dev),
                 torch.tensor(ctxs, dtype=torch.int32, device=dev),
                 torch.tensor(pos, dtype=torch.int32, device=dev)),
        'q_lens': torch.tensor(q_lens, dtype=torch.int32, device=dev),
        'np_q_lens': q_lens,
        'span': span,
    }


def _kv_mode(case):
    q, pool = case['args'][:2]
    return ('int8' if isinstance(pool, tpa.QuantizedKV)
            else 'mixed' if pool.dtype != q.dtype else 'model')


def _route(case):
    q, k = case['args'][:2]
    data = tpa._kv_data(k)
    return tpa.kernel_route(q.dtype, q.shape[1], q.shape[2] // data.shape[2],
                            kv_mode=_kv_mode(case), block_size=data.shape[1])


def _int8_case(seed, **kw):
    """``_case`` with its pools quantized on the card, one scale per block
    and KV head (``quantize_kv_rows`` at absmax / 127), times a magnitude
    per block and head in [0.25, 4] so that pages differ in scale; the
    trash block keeps large codes and a large scale."""
    case = _case(seed, **kw)
    q, k, v, *rest = case['args']
    gen = torch.Generator(device='cuda').manual_seed(seed)

    def quantize(x):
        x = x.float()
        x = x * (0.25 + 3.75 * torch.rand(
            (x.shape[0], 1, x.shape[2], 1), generator=gen, device='cuda'))
        scale = x.abs().amax((1, 3)) / tpa.KV_QUANT_MAX
        return tpa.QuantizedKV(tpa.quantize_kv_rows(x, scale[:, None]), scale)

    case['args'] = (q, quantize(k), quantize(v), *rest)
    return case


def _check(case, dtype, route=None, force=False, **kw):
    """One launch on the expected route (``route``, else the wrapper's
    choice; ``force`` launches ``route`` whatever the wrapper would
    choose, the A/B of the routes), held to that route's tolerance on
    valid rows."""
    route = route or _route(case)
    assert force or _route(case) == route
    q_dtype = case['args'][0].dtype
    assert q_dtype == getattr(torch, dtype)
    calls = tpa.ragged_paged_attention_reference.launches
    launches = tpa.ragged_paged_attention.launches
    by_route = dict(tpa.ragged_paged_attention.launches_by_route)
    by_kv = dict(tpa.ragged_paged_attention.launches_by_kv)
    kv_mode = _kv_mode(case)
    if force:
        out = tpa.ragged_paged_attention_cuda(
            *case['args'], q_lens=case['q_lens'], route=route, **kw
        )
    else:
        out = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'], **kw)
    assert tpa.ragged_paged_attention.launches == launches + 1
    assert tpa.ragged_paged_attention.launches_by_route[route] == by_route[route] + 1
    assert tpa.ragged_paged_attention.launches_by_kv[kv_mode] == by_kv[kv_mode] + 1
    assert tpa.ragged_paged_attention_reference.launches == calls
    ref = tpa.ragged_paged_attention_reference(
        *case['args'], q_lens=case['q_lens'], **kw
    )
    tol = tpa.comparison_tolerance(
        ref, *case['args'], q_lens=case['q_lens'], route=route, **kw
    )
    torch.cuda.synchronize()
    valid = torch.from_numpy(
        np.arange(case['span'])[None, :] < case['np_q_lens'][:, None]
    ).cuda()
    assert torch.isfinite(out.float()).all()
    assert (out[~valid] == 0).all()
    err = ((out.float() - ref.float()).abs() / tol)[valid].max().item()
    assert err <= 1.0, err
    return out


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('hd', [64, 128])
@pytest.mark.parametrize('nh,nkv', [(4, 4), (8, 2), (32, 8)])
@pytest.mark.parametrize('window', [None, 0, 40])
def test_decode_rows(cuda, dtype, hd, nh, nkv, window):
    case = _case(1, nh=nh, nkv=nkv, hd=hd, dtype=dtype,
                 ctxs=[1, 17, 100, 33, 200], q_lens=[1] * 5, span=1)
    _check(case, dtype, sliding_window=window)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('nh,nkv', [(4, 2), (32, 8), (8, 8)])
@pytest.mark.parametrize('window', [None, 30])
def test_chunk_rows_multi_tile(cuda, dtype, nh, nkv, window):
    """Spans of up to 70 (several query tiles at every GQA group) over
    prefixes, with q_lens padding and a fully padded row."""
    case = _case(2, nh=nh, nkv=nkv, hd=128, dtype=dtype,
                 ctxs=[70, 150, 300, 9], q_lens=[70, 40, 3, 0], span=70)
    _check(case, dtype, sliding_window=window)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_softcap_and_scale(cuda, dtype):
    case = _case(3, nh=8, nkv=2, hd=128, dtype=dtype,
                 ctxs=[64, 130], q_lens=[64, 1], span=64)
    _check(case, dtype, sliding_window=50, scale=0.05, logit_softcap=30.0)


@pytest.mark.parametrize('route', ['tensor_cores', 'wgmma'])
@pytest.mark.parametrize('nh,nkv', [(8, 8), (32, 8), (64, 8)])
@pytest.mark.parametrize('hd', [64, 128])
@pytest.mark.parametrize('span', [17, 64, 300, 1024])
@pytest.mark.parametrize('window', [None, 100])
def test_tensor_core_route_matrix(cuda, route, nh, nkv, hd, span, window):
    """bf16 spans on each tensor-core route (mma.sync tiles of 64 rows,
    wgmma tiles of 128) at GQA groups 1 / 4 / 8: a fresh prefill, a chunk
    over a prefix that starts off a 64-key tile, a short tail of a padded
    span and a fully padded row."""
    ctxs = [span, span + 37, 5 + 200, 9]
    case = _case(span + hd + nh, nh=nh, nkv=nkv, hd=hd, dtype='bfloat16',
                 ctxs=ctxs, q_lens=[span, span, 5, 0], span=span)
    _check(case, 'bfloat16', route=route, force=True, sliding_window=window)


@pytest.mark.parametrize('route', ['tensor_cores', 'wgmma'])
@pytest.mark.parametrize('nh,nkv,hd', [(8, 8, 128), (32, 8, 128), (16, 8, 256)])
def test_tensor_core_route_softcap_and_scale(cuda, route, nh, nkv, hd):
    """Gemma's knobs on each tensor-core route, Gemma-2's head dim 256 and
    group of 2 included."""
    case = _case(6, nh=nh, nkv=nkv, hd=hd, dtype='bfloat16',
                 ctxs=[300, 130], q_lens=[300, 1], span=300)
    _check(case, 'bfloat16', route=route, force=True, sliding_window=64,
           scale=0.05, logit_softcap=30.0)


@pytest.mark.parametrize('nh,nkv,hd', [(8, 8, 64), (32, 8, 128), (16, 8, 256)])
def test_wgmma_route_launches_bitwise_alike(cuda, nh, nkv, hd):
    """Two launches of the wgmma route give the same bits (no atomics, the
    same order), at head dims 64, 128 and 256."""
    case = _case(12, nh=nh, nkv=nkv, hd=hd, dtype='bfloat16',
                 ctxs=[700, 333], q_lens=[700, 200], span=700)
    first = _check(case, 'bfloat16', route='wgmma', sliding_window=256, logit_softcap=50.0)
    again = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'],
                                       sliding_window=256, logit_softcap=50.0)
    assert torch.equal(first, again)


def test_wgmma_route_refuses_what_it_does_not_take(cuda):
    """The wgmma route takes bf16 q over a bf16 pool of 16-token pages
    and no more than 128 rows: anything else raises, never served by
    another route."""
    case = _case(13, nh=32, nkv=8, hd=128, dtype='bfloat16',
                 ctxs=[200], q_lens=[200], span=200)
    q, k, v, bt, ctx, pos = case['args']
    with pytest.raises(RuntimeError, match='wgmma route'):
        tpa.ragged_paged_attention_cuda(q.float(), k.float(), v.float(), bt, ctx, pos,
                                        route='wgmma')
    with pytest.raises(RuntimeError, match='wgmma route'):
        tpa.ragged_paged_attention_cuda(q, k.float(), v.float(), bt, ctx, pos, route='wgmma')
    wide = _case(13, nh=32, nkv=8, hd=128, dtype='bfloat16', ctxs=[200], q_lens=[200],
                 span=200, bs=32)
    with pytest.raises(RuntimeError, match='wgmma route'):
        tpa.ragged_paged_attention_cuda(*wide['args'], route='wgmma')
    with pytest.raises(ValueError, match='route must be one of'):
        tpa.ragged_paged_attention_cuda(*case['args'], route='tma')


def test_nan_trash_block_never_reaches_a_decode_output(cuda):
    """As below, on the CUDA-core route (fp32 decode rows at group 4; the
    bf16 twin on the split-KV route is further down)."""
    case = _case(7, nh=32, nkv=8, hd=128, dtype='float32',
                 ctxs=[1, 16, 17, 500], q_lens=[1] * 4, span=1)
    assert _route(case) == 'cuda_cores'
    clean = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    case['args'][1][0] = float('nan')
    case['args'][2][0] = float('nan')
    poisoned = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    assert torch.equal(clean, poisoned)


@pytest.mark.parametrize('route,hd,window', [
    ('tensor_cores', 128, None), ('wgmma', 128, None), ('wgmma', 128, 37),
    ('wgmma', 64, 37), ('wgmma', 256, 37),
])
def test_nan_trash_block_never_reaches_an_output(cuda, route, hd, window):
    """Block 0 and block-table padding hold NaN: the kernel skips keys
    outside each row's range (on the tensor-core route the copy
    zero-fills them; on the wgmma route pages wholly outside are not
    loaded and the rest of a live page is zeroed in shared memory before
    wgmma reads it), so outputs are bitwise those of a clean trash block."""
    case = _case(4, nh=32, nkv=8, hd=hd, dtype='bfloat16',
                 ctxs=[1, 16, 17, 500], q_lens=[1, 16, 5, 100], span=100)
    launch = functools.partial(tpa.ragged_paged_attention_cuda, *case['args'],
                               q_lens=case['q_lens'], route=route, sliding_window=window)
    clean = launch()
    case['args'][1][0] = float('nan')
    case['args'][2][0] = float('nan')
    poisoned = launch()
    assert torch.equal(clean, poisoned)


def test_kernel_refuses_what_it_does_not_take(cuda):
    case = _case(5, nh=4, nkv=2, hd=128, dtype='float32',
                 ctxs=[10], q_lens=[1], span=1)
    q, k, v, bt, ctx, pos = case['args']
    with pytest.raises(TypeError, match='fp32 or bf16 alike'):
        tpa.ragged_paged_attention(q, k.bfloat16(), v, bt, ctx, pos)
    with pytest.raises(TypeError, match='fp32 or bf16 alike'):
        tpa.ragged_paged_attention(q, k.half(), v.half(), bt, ctx, pos)
    with pytest.raises(TypeError, match='dtypes'):
        tpa.ragged_paged_attention(q.half(), k.half(), v.half(), bt, ctx, pos)
    with pytest.raises(ValueError, match='head dims'):
        tpa.ragged_paged_attention(
            q[..., :32], k[..., :32].contiguous(), v[..., :32].contiguous(),
            bt, ctx, pos,
        )


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('hd', [64, 128])
@pytest.mark.parametrize('nh,nkv', [(4, 4), (32, 8)])
@pytest.mark.parametrize('window,softcap', [(None, None), (40, 30.0)])
def test_int8_kv_decode_rows(cuda, dtype, hd, nh, nkv, window, softcap):
    """fp32 decode rows on the CUDA cores, bf16 ones on the split-KV route."""
    case = _int8_case(11, nh=nh, nkv=nkv, hd=hd, dtype=dtype,
                      ctxs=[1, 17, 100, 33, 300], q_lens=[1] * 5, span=1)
    _check(case, dtype, route='cuda_cores' if dtype == 'float32' else 'split_kv',
           sliding_window=window, logit_softcap=softcap)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('nh,nkv', [(4, 2), (32, 8)])
def test_int8_kv_chunk_rows(cuda, dtype, nh, nkv):
    """Spans of up to 70 over prefixes (the CUDA-core route for fp32 and
    for bf16 tiles under 16 rows, the tensor cores for the rest)."""
    case = _int8_case(12, nh=nh, nkv=nkv, hd=128, dtype=dtype,
                      ctxs=[70, 150, 300, 9], q_lens=[70, 40, 3, 0], span=70)
    _check(case, dtype, sliding_window=30)


@pytest.mark.parametrize('nh,nkv', [(8, 8), (32, 8), (64, 8)])
@pytest.mark.parametrize('hd', [64, 128])
@pytest.mark.parametrize('span,bs', [(17, 16), (300, 16), (300, 32), (1024, 16)])
@pytest.mark.parametrize('window,softcap', [(None, None), (100, 30.0)])
def test_int8_kv_tensor_core_route(cuda, nh, nkv, hd, span, bs, window, softcap):
    """bf16 spans on the tensor-core route over an int8 pool: a fresh
    prefill, a chunk over a prefix that starts off a 64-key tile, a short
    tail of a padded span and a fully padded row; block sizes 16 and 32."""
    case = _int8_case(span + hd + nh + bs, nh=nh, nkv=nkv, hd=hd, dtype='bfloat16',
                      ctxs=[span, span + 37, 5 + 200, 9], q_lens=[span, span, 5, 0],
                      span=span, bs=bs)
    _check(case, 'bfloat16', route='tensor_cores', sliding_window=window,
           logit_softcap=softcap)


@pytest.mark.parametrize('span,route,dtype', [
    (1, 'cuda_cores', 'float32'), (1, 'split_kv', 'bfloat16'), (100, 'tensor_cores', 'bfloat16'),
])
@pytest.mark.parametrize('poison', ['data', 'scale'])
def test_int8_kv_nan_trash_block_never_reaches_an_output(cuda, span, route, dtype, poison):
    """Garbage in the trash block (block 0, also block-table padding):
    codes the quantizer never writes (-128; int8 has no NaN) or a NaN
    scale. Keys outside each row's range read neither their codes nor
    their scale, so the outputs are bitwise those of a clean trash
    block, on every route."""
    case = _int8_case(13, nh=32, nkv=8, hd=128, dtype=dtype,
                      ctxs=[1, 16, 17, 500], q_lens=[min(span, n) for n in (1, 16, 5, 100)],
                      span=span)
    assert _route(case) == route
    clean = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    for pool in case['args'][1:3]:
        if poison == 'data':
            pool.data[0] = -128
        else:
            pool.scale[0] = float('nan')
    poisoned = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    assert torch.equal(clean, poisoned)


def test_int8_kv_kernel_refuses_what_it_does_not_take(cuda):
    case = _int8_case(14, nh=4, nkv=2, hd=128, dtype='bfloat16',
                      ctxs=[10], q_lens=[1], span=1)
    q, k, v, bt, ctx, pos = case['args']
    with pytest.raises(TypeError, match='both be QuantizedKV'):
        tpa.ragged_paged_attention(q, k, v.data.bfloat16(), bt, ctx, pos)
    with pytest.raises(TypeError, match='fp32 or bf16 alike'):
        tpa.ragged_paged_attention(q, k.data, v.data, bt, ctx, pos)  # scales missing
    with pytest.raises(TypeError, match='fp32 scales'):
        tpa.ragged_paged_attention(
            q, k, tpa.QuantizedKV(v.data, v.scale.bfloat16()), bt, ctx, pos
        )
    with pytest.raises(ValueError, match='does not match data'):
        tpa.ragged_paged_attention(
            q, k, tpa.QuantizedKV(v.data, v.scale[:-1]), bt, ctx, pos
        )
    with pytest.raises(ValueError, match='contiguous'):
        strided = tpa.QuantizedKV(
            torch.cat([v.data, v.data], -1)[..., :128], v.scale
        )
        tpa.ragged_paged_attention(q, k, strided, bt, ctx, pos)
    with pytest.raises(ValueError, match='scales must be contiguous'):
        strided = tpa.QuantizedKV(v.data, torch.cat([v.scale, v.scale], -1)[:, ::2])
        tpa.ragged_paged_attention(q, k, strided, bt, ctx, pos)


# ----------------------------------------------- K1 route 2, split-KV
def _split_keys(nkv, bs, rows=6, max_keys=4096):
    """The split length the wrapper plans for ``rows`` rows of up to
    ``max_keys`` keys on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return tpa.split_plan(max_keys, rows, nkv, sms, bs)[1]


def _split_case(seed, *, nh, nkv, hd, span, bs=16, int8=False, dtype='bfloat16'):
    """Rows at the split-KV plan's edges: contexts 1, a split's length - 1,
    exactly one split, one split + 1 and 4096, and a row of 300 keys with
    ``q_lens = 0``."""
    sk = _split_keys(nkv, bs)
    ctxs = [1, sk - 1, sk, sk + 1, 4096, 300]
    q_lens = [min(span, n) for n in ctxs[:-1]] + [0]
    make = _int8_case if int8 else _case
    return make(seed, nh=nh, nkv=nkv, hd=hd, dtype=dtype, ctxs=ctxs, q_lens=q_lens,
                span=span, bs=bs), sk


# (query heads, KV heads, span): groups 1, 4 and 8 at every span under 16 rows.
SPLIT_SHAPES = [(8, 8, 1), (8, 8, 3), (32, 8, 1), (32, 8, 2), (32, 8, 3), (64, 8, 1)]


@pytest.mark.parametrize('nh,nkv,span', SPLIT_SHAPES)
@pytest.mark.parametrize('hd', [64, 128])
@pytest.mark.parametrize('window', [None, 'inside', 'across', 'dead'])
@pytest.mark.parametrize('bs', [16, 32])
@pytest.mark.parametrize('int8', [False, True], ids=['bf16_pool', 'int8_pool'])
def test_split_kv_route_matrix(cuda, nh, nkv, span, hd, window, bs, int8):
    """bf16 tiles under 16 rows on the split-KV route, over bf16 and int8
    pools and block sizes 16 and 32, at the plan's split edges; windows
    that lie inside one split (37), cross a split edge (a split + 50) or
    leave whole splits dead below them (1500 at 4096 keys)."""
    case, sk = _split_case(nh + hd + span + bs, nh=nh, nkv=nkv, hd=hd, span=span, bs=bs,
                           int8=int8)
    win = {None: None, 'inside': 37, 'across': sk + 50, 'dead': 1500}[window]
    _check(case, 'bfloat16', route='split_kv', sliding_window=win)


@pytest.mark.parametrize('nh,nkv,span', [(8, 8, 3), (32, 8, 1), (64, 8, 1)])
@pytest.mark.parametrize('int8', [False, True], ids=['bf16_pool', 'int8_pool'])
def test_split_kv_route_softcap_and_scale(cuda, nh, nkv, span, int8):
    case, sk = _split_case(40 + nh, nh=nh, nkv=nkv, hd=128, span=span, int8=int8)
    _check(case, 'bfloat16', route='split_kv', sliding_window=sk + 50, scale=0.05,
           logit_softcap=30.0)


def test_split_kv_rows_whose_keys_sit_in_the_last_split(cuda):
    """Rows whose only live keys, under a window, lie in their last split,
    and rows of one key, beside a 4096-key row that sets the plan."""
    sk = _split_keys(8, 16)
    ctxs = [4096, 3 * sk + 5, 2 * sk + 1, 1, 1000]
    case = _case(51, nh=32, nkv=8, hd=128, dtype='bfloat16', ctxs=ctxs, q_lens=[1] * 5, span=1)
    _check(case, 'bfloat16', route='split_kv', sliding_window=4)


@pytest.mark.parametrize('int8', [False, True], ids=['bf16_pool', 'int8_pool'])
def test_split_kv_launches_are_bitwise_reproducible(cuda, int8):
    """The merge adds the splits' partials in split order, never by
    floating-point atomics: two launches on the same inputs are equal
    bitwise, and so is a third after another shape's launch."""
    case, _ = _split_case(52, nh=32, nkv=8, hd=128, span=1, int8=int8)
    first = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    second = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    other, _ = _split_case(53, nh=32, nkv=8, hd=128, span=3, int8=int8)
    tpa.ragged_paged_attention(*other['args'], q_lens=other['q_lens'])
    third = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    assert torch.equal(first, second) and torch.equal(first, third)


def test_nan_trash_block_never_reaches_a_split_kv_output(cuda):
    """The bf16 twin of the CUDA-core route's check: NaN in block 0 and
    the block-table padding leaves route 2's outputs bitwise unchanged."""
    case, _ = _split_case(54, nh=32, nkv=8, hd=128, span=1)
    assert _route(case) == 'split_kv'
    clean = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    case['args'][1][0] = float('nan')
    case['args'][2][0] = float('nan')
    poisoned = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    assert torch.equal(clean, poisoned)


@pytest.mark.parametrize('span,dtype,route', [
    (1, 'float32', 'cuda_cores'), (3, 'bfloat16', 'split_kv'), (100, 'bfloat16', 'tensor_cores'),
    (100, 'bfloat16', 'wgmma'),
])
def test_no_q_lens_is_every_row_full_on_every_route(cuda, span, dtype, route):
    """Without ``q_lens`` the C entry gets a null pointer (the wrapper
    launches nothing else) and reads every row as ``span`` queries long."""
    case = _case(55, nh=32, nkv=8, hd=128, dtype=dtype, ctxs=[300, 250, 1000],
                 q_lens=[span] * 3, span=span)
    launch = functools.partial(tpa.ragged_paged_attention_cuda, *case['args'], route=route)
    assert torch.equal(launch(), launch(q_lens=case['q_lens']))


def test_split_kv_entry_refuses_what_it_does_not_take(cuda):
    """The C entry refuses route 2 (cudaErrorInvalidValue, 1) for fp32, a
    tile of 16 rows, head dim 32, a missing workspace or tickets and a
    plan that does not cover the block table; the same call with the
    wrapper's arguments launches."""
    case = _case(56, nh=32, nkv=8, hd=128, dtype='bfloat16', ctxs=[300], q_lens=[1], span=1)
    q, k, v, bt, ctx, pos = case['args']
    splits, keys = tpa.split_plan(bt.shape[1] * 16, 1, 8, 132, 16)
    ws = torch.empty(8 * splits * 4 * 130, dtype=torch.float32, device='cuda')
    tickets = torch.zeros(8, dtype=torch.int32, device='cuda')
    out = torch.empty_like(q)
    _, fn = tpa._kernel()
    stream = torch.cuda.current_stream().cuda_stream
    start = pos[:, 0].contiguous()

    def launch(dtype=1, span_tile=1, head_dim=128, workspace=ws.data_ptr(),
               ticket_ptr=tickets.data_ptr(), n_splits=splits, split_keys=keys):
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, bt.data_ptr(),
                  ctx.data_ptr(), start.data_ptr(), None, out.data_ptr(),
                  1, 1, 32, 8, head_dim, 16, bt.shape[1], span_tile, 0, 0.088, 0.0,
                  dtype, 0, 2, workspace, ticket_ptr, n_splits, split_keys, stream)

    assert launch() == 0
    for bad in ({'dtype': 0}, {'span_tile': 4}, {'head_dim': 32}, {'workspace': None},
                {'ticket_ptr': None}, {'n_splits': 0}, {'split_keys': 48},
                {'n_splits': 1, 'split_keys': 64}):
        assert launch(**bad) == 1, bad
    torch.cuda.synchronize()


def test_int8_kv_engine_on_the_kernel_matches_the_plain_op(cuda):
    """A small fp32 model with an int8 KV pool served end to end on the
    card: greedy tokens on K1's int8 mode equal those on the plain op."""
    from distllm_tpu_torch.generate.engine import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
    )
    from distllm_tpu_torch.models import mistral

    cfg = mistral.MistralConfig(
        vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=512, dtype='float32',
    )
    params = mistral.init(cfg, torch.Generator(device='cuda').manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [
        [int(t) for t in rng.integers(4, 256, size=n)] for n in (5, 40, 17, 90, 3)
    ]
    outs = {}
    for backend in ('auto', 'reference'):
        engine = LLMEngine(
            cfg, params, None,
            EngineConfig(num_blocks=64, max_num_seqs=3, max_model_len=256,
                         kv_cache_dtype='int8'),
            attn_backend=backend,
        )
        engine.warmup()  # its eager trash-block steps launch too
        int8_launches = tpa.ragged_paged_attention.launches_by_kv['int8']
        outs[backend] = engine.generate_ids(
            prompts, SamplingParams(temperature=0.0, max_tokens=12)
        )
        passes = engine.telemetry['forward_passes']
        expected = cfg.num_layers * passes if backend == 'auto' else 0
        assert tpa.ragged_paged_attention.launches_by_kv['int8'] - int8_launches == expected
        assert engine.telemetry['kv_cache_dtype'] == 'int8'
    assert outs['auto'] == outs['reference']


def test_int8_kv_writes_on_the_card_equal_the_cpu_bitwise(cuda):
    """write_chunk_kv (fresh and mid-block spans) then write_token_kv
    (appends that grow the absmax, a reset at offset 0) on the card leave
    the codes and scales the same ops leave on the CPU."""
    gen = torch.Generator().manual_seed(15)
    pools = {}
    for dev in ('cpu', 'cuda'):
        pools[dev] = [
            tpa.QuantizedKV(torch.zeros((20, 16, 8, 128), dtype=torch.int8, device=dev),
                            torch.zeros((20, 8), device=dev))
            for _ in range(2)
        ]
    bt = torch.tensor([[3, 7, 1, 9], [12, 4, 18, 2]], dtype=torch.int32)
    steps = []
    for start, lens in (([0, 0], [21, 9]), ([21, 9], [20, 30])):
        pos = torch.tensor(start)[:, None] + torch.arange(30)[None]
        valid = torch.arange(30)[None] < torch.tensor(lens)[:, None]
        steps.append(('chunk', torch.randn((2, 30, 8, 128), generator=gen) * 3,
                      torch.randn((2, 30, 8, 128), generator=gen), pos.int(), valid))
    for i in range(20):  # positions 41..60 / 39..58: offset 0 at 48
        steps.append(('token', torch.randn((2, 8, 128), generator=gen) * (1 + i / 4),
                      torch.randn((2, 8, 128), generator=gen),
                      torch.tensor([41 + i, 39 + i], dtype=torch.int32), None))
    for kind, nk, nv, pos, valid in steps:
        for dev, (k, v) in pools.items():
            args = (nk.to(dev), nv.to(dev), bt.to(dev), pos.to(dev))
            if kind == 'chunk':
                tpa.write_chunk_kv(k, v, *args, valid.to(dev))
            else:
                tpa.write_token_kv(k, v, *args)
    for host, card in zip(pools['cpu'], pools['cuda']):
        assert torch.equal(host.data[1:], card.data[1:].cpu())
        assert torch.equal(host.scale[1:], card.scale[1:].cpu())


def test_engine_on_the_kernel_matches_the_plain_op(cuda):
    """A small fp32 model served end to end on the card (default device):
    greedy tokens on the kernel equal those on the plain op, and every
    layer of every forward pass launched the kernel once."""
    from distllm_tpu_torch.generate.engine import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
    )
    from distllm_tpu_torch.models import mistral

    cfg = mistral.MistralConfig(
        vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=512, dtype='float32',
    )
    params = mistral.init(cfg, torch.Generator(device='cuda').manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [
        [int(t) for t in rng.integers(4, 256, size=n)] for n in (5, 40, 17, 90, 3)
    ]
    outs = {}
    for backend in ('auto', 'reference'):
        engine = LLMEngine(
            cfg, params, None,
            EngineConfig(num_blocks=64, max_num_seqs=3, max_model_len=256),
            attn_backend=backend,
        )
        engine.warmup()  # its eager trash-block steps launch too
        launches = tpa.ragged_paged_attention.launches
        outs[backend] = engine.generate_ids(
            prompts, SamplingParams(temperature=0.0, max_tokens=12)
        )
        passes = engine.telemetry['forward_passes']
        expected = cfg.num_layers * passes if backend == 'auto' else 0
        assert tpa.ragged_paged_attention.launches - launches == expected
    assert outs['auto'] == outs['reference']


# ------------------------------------------------------------------ K3
def _k3_inputs(seed, b, s, heads, hd, dtype, lens=None, window=None):
    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.from_numpy(rng.normal(size=(b, s, heads * hd)).astype(np.float32))
        .to('cuda', getattr(torch, dtype))
        for _ in range(3)
    )
    lens = rng.integers(1, s + 1, size=b) if lens is None else np.asarray(lens)
    mask = torch.from_numpy(
        (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    ).cuda()
    bias = None
    if window is not None:
        dist = np.abs(np.arange(s)[:, None] - np.arange(s)[None, :])
        bias = torch.from_numpy(np.where(dist <= window, 0.0, -1e9).astype(np.float32)).cuda()
    return (q, k, v, mask, heads), bias


def _k3_check(args, bias, route=None):
    """One launch on ``route`` (else the wrapper's choice), held to K3's
    tolerance on every row."""
    q, heads = args[0], args[4]
    hd = q.shape[-1] // heads
    auto = tea.kernel_route(q.dtype, hd, q.shape[1], bias is not None)
    if q.dtype != torch.bfloat16 or hd % 16:
        assert auto == 'cuda_cores'
    else:
        assert auto in ('tensor_cores', 'wgmma')
    route = route or auto
    plain = tea.encoder_attention_reference.launches
    launches = tea.encoder_attention.launches
    by_route = dict(tea.encoder_attention.launches_by_route)
    out = tea.encoder_attention_cuda(*args, bias=bias, route=route)
    assert tea.encoder_attention.launches == launches + 1
    assert tea.encoder_attention.launches_by_route[route] == by_route[route] + 1
    assert tea.encoder_attention_reference.launches == plain
    ref = tea.encoder_attention_reference(*args, bias=bias)
    tol = tea.comparison_tolerance(ref, *args, bias=bias)
    torch.cuda.synchronize()
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    assert torch.isfinite(out.float()).all()
    err = ((out.float() - ref.float()).abs() / tol).max().item()
    assert err <= 1.0, err
    return out


@pytest.mark.parametrize('dtype,hd,heads', [
    (dtype, hd, heads) for dtype in ('float32', 'bfloat16', 'wgmma')
    for hd, heads in ((32, 4), (64, 12), (128, 2), (24, 3))
    if dtype != 'wgmma' or hd in tea.WGMMA_HEAD_DIMS
])
@pytest.mark.parametrize('s', [16, 37, 64, 130])
def test_k3_matrix(cuda, dtype, hd, heads, s):
    """Partial masks and one fully masked row (its output is the uniform
    average of V, finite), head dims compiled fixed (32/64/128) and read
    at run time (24), S below, at and across the 64-key tile; bf16 also
    on the wgmma route ('wgmma': 128-query tiles, at head dims 32, 64 and
    128)."""
    lens = np.concatenate([np.random.default_rng(s).integers(1, s + 1, size=3), [0, s]])
    args, bias = _k3_inputs(s + hd, 5, s, heads, hd,
                            'bfloat16' if dtype == 'wgmma' else dtype, lens=lens)
    _k3_check(args, bias, 'wgmma' if dtype == 'wgmma' else None)


@pytest.mark.parametrize('hd,heads', [(16, 8), (48, 4), (80, 2), (112, 2)])
@pytest.mark.parametrize('s', [37, 130, 513])
def test_k3_tensor_core_head_dims_read_at_run_time(cuda, hd, heads, s):
    """bf16 head dims that are multiples of 16 other than 32/64/128 run on
    the tensor-core route with the head dim read at run time; S past 512
    runs on the same two-pass design."""
    lens = np.concatenate([np.random.default_rng(s).integers(1, s + 1, size=2), [0, s]])
    args, bias = _k3_inputs(s + hd, 4, s, heads, hd, 'bfloat16', lens=lens)
    _k3_check(args, bias)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'wgmma'])
@pytest.mark.parametrize('s,window', [(64, 8), (200, 32), (37, 0), (600, 64)])
def test_k3_window_bias(cuda, dtype, s, window):
    """The [S, S] window bias on every route; on the wgmma route key tiles
    whose every p is 0 are skipped (S = 600: ten key tiles, most dead)."""
    args, bias = _k3_inputs(s, 4, s, 12, 64, 'bfloat16' if dtype == 'wgmma' else dtype,
                            window=window)
    _k3_check(args, bias, 'wgmma' if dtype == 'wgmma' else None)


@pytest.mark.parametrize('route', ['tensor_cores', 'wgmma'])
@pytest.mark.parametrize('b,s,heads,window', [
    (64, 1024, 20, None),   # ESM-2 650M's protein batches
    (8, 2048, 18, None),    # ESM-C 600M at its 2048-token cap
    (128, 512, 12, 64),     # ModernBERT-base's local layers (window 128)
], ids=['esm2_650m', 'esmc_600m', 'modernbert_base'])
def test_k3_at_the_protein_and_modernbert_shapes(cuda, route, b, s, heads, window):
    lens = np.random.default_rng(s).integers(min(s, 50), s + 1, size=b)
    lens[0] = s
    args, bias = _k3_inputs(b + s, b, s, heads, 64, 'bfloat16', lens=lens, window=window)
    first = _k3_check(args, bias, route)
    if route == 'wgmma':  # two launches give the same bits
        assert torch.equal(first, tea.encoder_attention_cuda(*args, bias=bias, route=route))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_k3_takes_thirds_of_one_fused_product(cuda, dtype):
    """ESM-C's q, k and v are strided thirds of one ``[B, S, 3H]`` product:
    the wrapper copies each to a contiguous tensor, and the result equals
    the kernel on contiguous copies bitwise."""
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(rng.normal(size=(4, 200, 3 * 18 * 64)).astype(np.float32)).to(
        'cuda', getattr(torch, dtype))
    q, k, v = qkv.chunk(3, dim=-1)
    assert not v.is_contiguous()
    mask = torch.from_numpy((np.arange(200)[None] < np.array([[200], [150], [1], [0]]))
                            .astype(np.int32)).cuda()
    _k3_check((q, k, v, mask, 18), None)
    strided = tea.encoder_attention(q, k, v, mask, 18)
    packed = tea.encoder_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask, 18)
    assert torch.equal(strided, packed)


@pytest.mark.parametrize('family', ['esm2', 'esmc', 'modernbert'])
def test_protein_and_modernbert_models_reach_k3_and_match_the_plain_version(cuda, family):
    """Each new encoder family at a small fp32 config on the card: every
    layer launches K3 once (ModernBERT's local layers with the window
    bias), nothing runs the plain version, and the output equals the
    plain version's within fp32 summation noise (``1e-4 |ref| + 1e-5``)."""
    from distllm_tpu_torch.models import esm2, esmc, modernbert

    module, cfg = {
        'esm2': (esm2, esm2.Esm2Config(hidden_size=128, num_layers=3, num_heads=2,
                                       intermediate_size=256, dtype='float32')),
        'esmc': (esmc, esmc.EsmcConfig(hidden_size=128, num_layers=3, num_heads=2,
                                       dtype='float32')),
        'modernbert': (modernbert, modernbert.ModernBertConfig(
            vocab_size=512, hidden_size=128, num_layers=3, num_heads=2,
            intermediate_size=192, local_attention=32, dtype='float32')),
    }[family]
    params = module.init(cfg, torch.Generator(device='cuda').manual_seed(0))
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(4, 29, size=(3, 150)).astype(np.int32)).cuda()
    mask = torch.from_numpy((np.arange(150)[None] < np.array([[150], [70], [0]]))
                            .astype(np.int32)).cuda()
    launches = tea.encoder_attention.launches
    plain = tea.encoder_attention_reference.launches
    out = module.apply(params, cfg, ids, mask)
    torch.cuda.synchronize()
    assert tea.encoder_attention.launches - launches == cfg.num_layers
    assert tea.encoder_attention_reference.launches == plain
    ref = module.apply(params, cfg, ids, mask, attn_impl='reference')
    valid = mask.bool()
    torch.testing.assert_close(out.float()[valid], ref.float()[valid], rtol=1e-4, atol=1e-5)


def test_k3_fully_masked_rows_are_the_uniform_average(cuda):
    args, _ = _k3_inputs(9, 3, 100, 12, 64, 'float32', lens=[0, 0, 0])
    out = tea.encoder_attention(*args)
    torch.testing.assert_close(
        out, args[2].mean(dim=1, keepdim=True).expand_as(out), rtol=0, atol=1e-5
    )
    # the wgmma route in bf16: every row the uniform average, within K3's
    # bf16 bound, over one and several key tiles
    for s in (100, 700):
        args, _ = _k3_inputs(9, 2, s, 12, 64, 'bfloat16', lens=[0, 0])
        out = tea.encoder_attention_cuda(*args, route='wgmma')
        ref = tea.encoder_attention_reference(*args)
        tol = tea.comparison_tolerance(ref, *args)
        uniform = args[2].float().mean(dim=1, keepdim=True).expand_as(out)
        assert ((out.float() - uniform).abs() <= tol).all()


def test_k3_refuses_what_it_does_not_take(cuda):
    (q, k, v, mask, heads), _ = _k3_inputs(10, 2, 16, 4, 32, 'float32')
    with pytest.raises(TypeError, match='share a dtype'):
        tea.encoder_attention(q, k.bfloat16(), v, mask, heads)
    with pytest.raises(TypeError, match='dtypes'):
        tea.encoder_attention(q.half(), k.half(), v.half(), mask, heads)
    with pytest.raises(ValueError, match='head dims'):
        tea.encoder_attention(q, k, v, mask, 32)  # head dim 4
    with pytest.raises(ValueError, match='head dims'):
        wide = torch.zeros((2, 16, 2 * 136), device='cuda')
        tea.encoder_attention(wide, wide, wide, mask, 2)  # head dim 136
    with pytest.raises(ValueError, match='mask must be'):
        tea.encoder_attention(q, k, v, mask[:, :8], heads)
    with pytest.raises(ValueError, match='bias must be'):
        tea.encoder_attention(q, k, v, mask, heads, bias=torch.zeros((8, 8), device='cuda'))
    with pytest.raises(ValueError, match='one CUDA device'):
        tea.encoder_attention(q, k.cpu(), v, mask, heads)
    # the wgmma route: bf16 at head dims 32, 64 and 128 only, never served
    # by another route
    with pytest.raises(RuntimeError, match='wgmma route'):
        tea.encoder_attention_cuda(q, k, v, mask, heads, route='wgmma')  # fp32
    (q80, k80, v80, mask80, heads80), _ = _k3_inputs(10, 2, 16, 2, 80, 'bfloat16')
    with pytest.raises(RuntimeError, match='wgmma route'):
        tea.encoder_attention_cuda(q80, k80, v80, mask80, heads80, route='wgmma')
    with pytest.raises(ValueError, match='route must be one of'):
        tea.encoder_attention_cuda(q, k, v, mask, heads, route='tma')


def test_bert_through_the_embedder_on_the_kernel_matches_the_plain_version(cuda):
    """A small fp32 BERT embedded end to end on the card (default device):
    pooled embeddings through K3 equal those through its plain version
    within fp32 summation noise, and every layer of every batch launched
    the kernel once."""
    import functools

    from distllm_tpu_torch.embed import get_pooler
    from distllm_tpu_torch.embed.embedders.full_sequence import compute_embeddings
    from distllm_tpu_torch.embed.encoders.base import TorchEncoder
    from distllm_tpu_torch.models import bert
    from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer

    cfg = bert.BertConfig(
        vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
        intermediate_size=256, dtype='float32',
    )
    params = bert.init(cfg, torch.Generator(device='cuda').manual_seed(0))
    rng = np.random.default_rng(0)
    texts = [
        ' '.join(f'w{i}' for i in rng.integers(0, 400, size=n))
        for n in rng.integers(1, 300, size=21)
    ]
    outs = {}
    for impl in ('auto', 'reference'):
        encoder = TorchEncoder(
            None, functools.partial(bert.apply, attn_impl=impl), cfg, params,
            WhitespaceTokenizer(vocab_size=512, model_max_length=512), 128,
        )
        launches = tea.encoder_attention.launches
        stats = {}
        outs[impl] = compute_embeddings(
            texts, encoder, get_pooler({'name': 'mean'}), 8, stats=stats
        )
        batches = sum(stats['bucket_batches'].values())
        expected = cfg.num_layers * batches if impl == 'auto' else 0
        assert tea.encoder_attention.launches - launches == expected
    np.testing.assert_allclose(outs['auto'], outs['reference'], rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ K2
def _k2_inputs(seed, m, k, n, dtype, zero_column=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((0.02 * rng.normal(size=(k, n))).astype(np.float32))
    if zero_column:
        w[:, 3] = 0.0
    qt = tq.quantize_int8(w.cuda(), dtype)
    return x.to('cuda', getattr(torch, dtype)), qt.q, qt.scale


def _k2_check(x, q, scale):
    plain = tqm.int8_matmul_reference.launches
    launches = tqm.int8_matmul.launches
    route = tqm.kernel_route(*x.shape, q.shape[1], x.dtype)
    by_route = dict(tqm.int8_matmul.launches_by_route)
    out = tqm.int8_dense(x, q, scale)
    assert tqm.int8_matmul.launches == launches + 1
    assert tqm.int8_matmul.launches_by_route[route] == by_route[route] + 1
    assert tqm.int8_matmul_reference.launches == plain
    ref = tqm.int8_matmul_reference(x, q, scale)
    tol = tqm.comparison_tolerance(x, q, scale)
    torch.cuda.synchronize()
    assert out.dtype == x.dtype and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    err = ((out.float() - ref.float()).abs() / tol).max().item()
    assert err <= 1.0, err
    return out


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('m', [1, 5, 16, 17, 130])
@pytest.mark.parametrize('k,n', [(16, 16), (48, 144), (512, 384), (4096, 1024), (1040, 4096)])
def test_k2_matrix(cuda, dtype, m, k, n):
    """Rows below, at and across the 16- and 64-row tiles; N off the
    128-wide tile; K off the 32-deep step; split-K (deep K, few tiles)."""
    _k2_check(*_k2_inputs(m * k + n, m, k, n, dtype))


@pytest.mark.parametrize('m', [1, 5, 8, 16, 17, 64, 1000, 1040])
@pytest.mark.parametrize('k,n', [(768, 768), (768, 3072), (3072, 768), (4096, 1024),
                                 (4096, 14336), (14336, 4096), (768, 784)])
def test_k2_tensor_core_route_matrix(cuda, m, k, n):
    """bf16 on the tensor cores at every Mistral-7B and BERT-base
    projection shape (and N = 784, off the 128-column tile): rows on the
    16-row configuration, across it, and on the 128-row tiles, M off the
    tile; split-K where the tiles cannot fill the card."""
    assert tqm.kernel_route(m, k, n, torch.bfloat16) == 'tensor_cores'
    _k2_check(*_k2_inputs(m + k + n, m, k, n, 'bfloat16'))


def test_k2_launches_by_route_follow_kernel_route(cuda):
    """Each launch counts once, on the route ``kernel_route`` names: fp32
    on the CUDA cores, bf16 on the tensor cores, at small and large M."""
    for dtype, m in (('float32', 8), ('bfloat16', 8), ('bfloat16', 300), ('float32', 300)):
        x, q, scale = _k2_inputs(m, m, 256, 256, dtype)
        route = tqm.kernel_route(m, 256, 256, x.dtype)
        assert route == ('tensor_cores' if dtype == 'bfloat16' else 'cuda_cores')
        before = dict(tqm.int8_matmul.launches_by_route)
        tqm.int8_matmul(x, q, scale)
        after = tqm.int8_matmul.launches_by_route
        assert {r: after[r] - before[r] for r in tqm.ROUTES} == {
            r: int(r == route) for r in tqm.ROUTES
        }


def test_k2_zero_column_stacked_slice_and_leading_dims(cuda):
    x, q, scale = _k2_inputs(1, 8, 256, 128, 'bfloat16', zero_column=True)
    out = _k2_check(x, q, scale)
    assert (out[:, 3] == 0).all()
    w = torch.randn((3, 256, 128), device='cuda') * 0.02
    qt = tq.quantize_int8(w, 'bfloat16')
    layer = qt[1]  # codes [256, 128], scale [1, 128]
    _k2_check(x, layer.q, layer.scale)
    lead = tqm.int8_dense(x.reshape(2, 4, 256), layer.q, layer.scale)
    torch.testing.assert_close(
        lead.reshape(8, 128), tqm.int8_dense(x, layer.q, layer.scale), rtol=0, atol=0
    )


def test_k2_refuses_what_it_does_not_take(cuda):
    """On both routes: the fp32 inputs go to the CUDA cores, the bf16 ones
    to the tensor cores; each refusal is raised before any launch."""
    for dtype in ('float32', 'bfloat16'):
        x, q, scale = _k2_inputs(2, 4, 64, 32, dtype)
        launches = tqm.int8_matmul.launches
        with pytest.raises(TypeError, match='activation dtypes'):
            tqm.int8_dense(x.half(), q, scale)
        with pytest.raises(TypeError, match='int8 codes'):
            tqm.int8_dense(x, q.to(torch.uint8), scale)
        with pytest.raises(TypeError, match='scales are fp32'):
            tqm.int8_dense(x, q, scale.bfloat16())
        with pytest.raises(ValueError, match='multiples of 16'):
            tqm.int8_dense(x[:, :40], q[:40].contiguous(), scale)
        with pytest.raises(ValueError, match='multiples of 16'):
            tqm.int8_dense(x, q[:, :24].contiguous(), scale[..., :24].contiguous())
        with pytest.raises(ValueError, match='contiguous'):
            tqm.int8_matmul_cuda(x, q.t().contiguous().t(), scale.reshape(-1))
        with pytest.raises(ValueError, match='one CUDA device'):
            tqm.int8_dense(x, q.cpu(), scale)
        with pytest.raises(ValueError, match='M >= 1'):
            tqm.int8_dense(x[:0], q, scale)
        with pytest.raises(ValueError, match='16-byte boundary'):
            tqm.int8_matmul_cuda(x.reshape(-1)[1:1 + 3 * 64].reshape(3, 64), q,
                                 scale.reshape(-1))
        assert tqm.int8_matmul.launches == launches
    # The C entry itself takes fp32 only on the CUDA cores and bf16 only on
    # the tensor cores.
    lib, fn = tqm._kernel()
    for dtype, route in (('bfloat16', 'cuda_cores'), ('float32', 'tensor_cores')):
        x, q, scale = _k2_inputs(2, 4, 64, 32, dtype)
        out = torch.empty((4, 32), dtype=x.dtype, device='cuda')
        rows = tqm.tile_config(route, 4)[0]
        err = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), None, 4, 64, 32,
                 rows, 1, 64, tqm.KERNEL_DTYPES[x.dtype], tqm.ROUTES[route],
                 torch.cuda.current_stream().cuda_stream)
        assert lib.distllm_qmm_error_string(err) == b'invalid argument', (dtype, route, err)


def test_k2_partial_sums_that_cancel_late_need_the_truncation_term(cuda):
    """Partial sums that stay near their peak and cancel exactly at the
    end, in one split (128-row tiles that fill the card): the tensor cores'
    truncation stays within the route's bound, and exceeds the CUDA-core
    route's bound, which lacks the truncation term."""
    import chip_smoke

    m, k, n = 2048, 14336, 4096
    xs, codes = chip_smoke.late_cancelling(np.random.default_rng(5), m, k, n)
    x = torch.from_numpy(xs).to('cuda', torch.bfloat16)
    q = torch.from_numpy(codes).cuda()
    scale = torch.full((1, n), 2.0 ** -10, device='cuda')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert tqm.launch_shape(m, k, n, sms, 'tensor_cores')[1] == 1
    _k2_check(x, q, scale)
    out = tqm.int8_dense(x, q, scale)
    diff = (out.float() - tqm.int8_matmul_reference(x, q, scale).float()).abs()
    bare = tqm.comparison_tolerance(x, q, scale, route='cuda_cores')
    assert (diff / bare).max().item() > 1.0


@pytest.mark.parametrize('mode', ['int8', 'nf4'])
def test_quantizing_on_the_card_equals_the_cpu_bitwise(cuda, mode):
    w = torch.randn((2, 512, 384), generator=torch.Generator().manual_seed(3)) * 0.02
    w[:, :, 7] = 0.0
    fn = tq.quantize_int8 if mode == 'int8' else tq.quantize_nf4
    card, host = fn(w.cuda().bfloat16()), fn(w.bfloat16())
    assert torch.equal(card.q.cpu(), host.q)
    assert torch.equal(card.scale.cpu(), host.scale)


def test_quantized_engine_on_k2_matches_the_plain_version(cuda):
    """A small fp32 int8 model served end to end on the card: greedy
    tokens through K2 equal those through its plain version, and every
    projection of every forward pass launched K2 once."""
    from distllm_tpu_torch.generate.engine import (
        EngineConfig,
        LLMEngine,
        SamplingParams,
    )
    from distllm_tpu_torch.models import mistral

    cfg = mistral.MistralConfig(
        vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=512, dtype='float32',
    )
    params = mistral.init(cfg, torch.Generator(device='cuda').manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [
        [int(t) for t in rng.integers(4, 256, size=n)] for n in (5, 40, 17, 90, 3)
    ]
    outs = {}
    for backend in ('auto', 'reference'):
        engine = LLMEngine(
            cfg, params, None,
            EngineConfig(num_blocks=64, max_num_seqs=3, max_model_len=256,
                         quantization='int8'),
            qmm_backend=backend,
        )
        engine.warmup()  # its eager trash-block steps launch too
        launches = tqm.int8_matmul.launches
        outs[backend] = engine.generate_ids(
            prompts, SamplingParams(temperature=0.0, max_tokens=12)
        )
        passes = engine.telemetry['forward_passes']
        expected = 7 * cfg.num_layers * passes if backend == 'auto' else 0
        assert tqm.int8_matmul.launches - launches == expected
    assert outs['auto'] == outs['reference']


# ------------------------------------------------- decode graphs (the engine)
GRAPH_CFG = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                 num_kv_heads=2, intermediate_size=512)
# (model dtype, weight quantization, KV pool dtype): the serving
# configurations chip_smoke.py runs, and nf4 weights (dequantized per
# layer inside the graph).
GRAPH_CASES = {
    'bf16': ('bfloat16', None, 'auto'),
    'int8_weights': ('bfloat16', 'int8', 'auto'),
    'int8_pool': ('bfloat16', None, 'int8'),
    'fp32': ('float32', None, 'auto'),
    'nf4_weights': ('bfloat16', 'nf4', 'auto'),
}


def _graph_engine(case, num_blocks=64, seed=0, **engine):
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine
    from distllm_tpu_torch.models import mistral

    dtype, quantization, kv = GRAPH_CASES[case]
    cfg = mistral.MistralConfig(**GRAPH_CFG, dtype=dtype)
    params = mistral.init(cfg, torch.Generator(device='cuda').manual_seed(seed))
    return LLMEngine(cfg, params, None, EngineConfig(**{
        'num_blocks': num_blocks, 'max_num_seqs': 4, 'max_model_len': 256,
        'decode_steps': 8, 'quantization': quantization, 'kv_cache_dtype': kv,
        **engine}))


def _pool_tensors(engine):
    kv = engine.kv
    return [x for pair in (kv.k, kv.v) for x in pair] if kv.quantized else [kv.k, kv.v]


def _window_against_eager(engine):
    """Dispatch one window through the engine (graph replays) and run the
    eager ``mistral.decode_loop`` on a copy of the pool before it with the
    window's inputs: live tokens and every pool block but the trash block
    0 must be bitwise equal. Returns the window, or None."""
    from distllm_tpu_torch.models import mistral

    before = [x.clone() for x in _pool_tensors(engine)]
    replays = engine.stats['decode_graph_replays']
    window = engine._dispatch_window()
    if window is None:
        return None
    runner = engine._decode
    num_steps = window['tokens'].shape[0]
    assert engine.stats['decode_graph_replays'] - replays == num_steps
    h = {name: torch.from_numpy(view.copy()).cuda()
         for name, view in runner._host_views.items()}
    pools = before
    if engine.kv.quantized:
        pools = [tpa.QuantizedKV(*before[:2]), tpa.QuantizedKV(*before[2:])]
    eager = mistral.decode_loop(
        engine.params, engine.model_cfg, h['ids'], h['positions'], *pools,
        h['block_tables'], h['context_lens'], h['steps_left'], h['temperature'],
        h['top_p'], h['min_p'], h['top_k'], h['seeds'], num_steps=num_steps,
        attn_backend=engine.attn_backend, max_table_positions=engine.config.max_model_len,
        all_greedy=bool((h['temperature'] <= 0).all()),
    )[0]
    graph_tokens = window['tokens'].clone()
    for slot, _, steps in window['plan']:
        assert torch.equal(graph_tokens[:steps, slot], eager[:steps, slot]), slot
    for card, ref in zip(_pool_tensors(engine), before):
        assert torch.equal(card[:, 1:], ref[:, 1:])
    return window


def _serve_against_eager(engine, prompts, sampling):
    """``LLMEngine.step`` by hand, every window held against the eager
    loop; returns the finished outputs."""
    rids = [engine.add_request(p, sp) for p, sp in zip(prompts, sampling)]
    windows = 0
    while engine.has_unfinished:
        engine._admit()
        if engine.sched.num_running == 0:
            continue
        window = _window_against_eager(engine)
        if window is not None:
            engine._process_window(window)
            windows += 1
    assert windows > 0
    return [engine._finished.pop(rid).output_ids for rid in rids]


def _graph_prompts(seed, lengths=(5, 40, 17, 90, 3, 33)):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(4, 512, size=n)] for n in lengths]


@pytest.mark.parametrize('sampled', [False, True])
@pytest.mark.parametrize('case', sorted(GRAPH_CASES))
def test_decode_graph_windows_equal_the_eager_loop_bitwise(cuda, case, sampled):
    """Every window of a served batch, replayed as CUDA graphs, gives the
    eager ``decode_loop``'s tokens and pool writes bitwise (the same
    kernels in the same order), greedy and sampled rows alike."""
    from distllm_tpu_torch.generate.engine import SamplingParams

    engine = _graph_engine(case)
    engine.warmup()
    assert engine.stats['decode_graph_captures'] == 2
    assert engine.stats['decode_graph_capture_s'] > 0
    assert engine.graph_pool_bytes > 0
    prompts = _graph_prompts(1)
    sampling = [SamplingParams(temperature=0.0, max_tokens=n)
                for n in (12, 5, 20, 9, 16, 7)]
    if sampled:
        sampling[1] = SamplingParams(temperature=0.9, top_p=0.9, max_tokens=11, seed=3)
        sampling[4] = SamplingParams(temperature=0.7, top_k=20, max_tokens=14, seed=4)
    outs = _serve_against_eager(engine, prompts, sampling)
    assert [len(o) for o in outs] == [sp.max_tokens for sp in sampling]
    assert engine.stats['decode_graph_captures'] == 2  # no capture per window
    engine.shutdown()


def test_decode_graph_replays_follow_block_tables_after_preemption(cuda):
    """A pool too small for the batch: windows preempt and re-prefill, the
    block tables change under the same captured graph, and every window
    still equals the eager loop bitwise."""
    from distllm_tpu_torch.generate.engine import SamplingParams

    engine = _graph_engine('bf16', num_blocks=14)
    engine.warmup()
    prompts = _graph_prompts(2, (30, 41, 25, 37))
    _serve_against_eager(
        engine, prompts, [SamplingParams(temperature=0.0, max_tokens=24)] * 4
    )
    assert engine.stats['preemptions'] > 0
    assert engine.sched.num_free_blocks == 14 - 1


def test_two_engines_one_after_the_other(cuda):
    """A second engine on the same device captures its own graphs after
    the first one's shutdown released its pool, and serves the same
    tokens."""
    from distllm_tpu_torch.generate.engine import SamplingParams

    prompts = _graph_prompts(3, (12, 50, 7))
    greedy = SamplingParams(temperature=0.0, max_tokens=10)
    outs, left = [], []
    for _ in range(2):
        engine = _graph_engine('bf16')
        outs.append(engine.generate_ids(prompts, greedy))
        assert engine.stats['decode_graph_captures'] == 2
        assert engine.stats['decode_graph_replays'] == engine.stats['forward_passes'] - (
            engine.stats['prefill_dispatches'])
        assert engine.graph_pool_bytes > 0
        engine.shutdown()
        del engine
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        left.append((torch.cuda.memory_allocated(), torch.cuda.memory_reserved()))
    assert outs[0] == outs[1]
    # Nothing of an engine, its graph pool included, outlives its shutdown.
    assert left[1][0] <= left[0][0] and left[1][1] <= left[0][1]


def _block_state(ptr):
    """The caching allocator's state of the block at device address
    ``ptr`` ('active_allocated' while a tensor holds it), or None."""
    for segment in torch.cuda.memory_snapshot():
        at = segment['address']
        for block in segment['blocks']:
            if block.get('address', at) == ptr:
                return block['state']
            at += block['size']
    return None


def test_replays_after_the_split_tickets_grow_equal_the_eager_loop(cuda):
    """An engine captures its graphs; then a K1 launch with more rows x KV
    heads than the tickets hold grows them. The tickets the graphs hold
    must stay allocated (and at zero, whatever is made next: memory made
    afterwards on the serving and the capture streams is filled with -1),
    so the engine's windows still equal the eager loop bitwise."""
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.generate.engine import decode_graph

    engine = _graph_engine('bf16')
    engine.warmup()
    dev = torch.device('cuda', torch.cuda.current_device())  # the tickets' key
    held = tpa._tickets(dev, 1)
    held_ptr, held_size = held.data_ptr(), held.numel()
    del held
    rows = held_size // 8 + 1
    case = _case(55, nh=32, nkv=8, hd=128, dtype='bfloat16', ctxs=[40] * rows,
                 q_lens=[1] * rows, span=1)
    assert _route(case) == 'split_kv'
    tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    assert tpa._tickets(dev, 1).numel() > held_size
    torch.cuda.synchronize()
    assert _block_state(held_ptr) == 'active_allocated'
    junk = []
    for stream in (torch.cuda.current_stream(), decode_graph._capture_stream(dev)):
        with torch.cuda.stream(stream):
            junk += [torch.full((held_size,), -1, dtype=torch.int32, device=dev)
                     for _ in range(16)]
    torch.cuda.synchronize()
    assert all(j.data_ptr() != held_ptr for j in junk)
    prompts = _graph_prompts(5, (21, 60, 9, 33))
    _serve_against_eager(
        engine, prompts, [SamplingParams(temperature=0.0, max_tokens=18)] * 4
    )
    engine.shutdown()


@pytest.mark.parametrize('case', ['bf16', 'int8_weights', 'int8_pool', 'fp32'])
def test_launch_counts_after_replays_are_the_captured_counts(cuda, case):
    engine = _graph_engine(case)
    engine.warmup()
    runner = engine._decode
    layers = GRAPH_CFG['num_layers']
    route = 'cuda_cores' if case == 'fp32' else 'split_kv'
    delta = runner.graphs[True].delta
    assert delta[0] == layers and delta[1][route] == layers
    assert delta[2]['int8' if case == 'int8_pool' else 'model'] == layers
    assert delta[_K2_LAUNCHES] == (7 * layers if case == 'int8_weights' else 0)
    tpa.ragged_paged_attention.launches = 0
    tpa.ragged_paged_attention.launches_by_route = dict.fromkeys(tpa.ROUTES, 0)
    tqm.int8_matmul.launches_by_route = dict.fromkeys(tqm.ROUTES, 0)
    plain = tpa.ragged_paged_attention_reference.launches
    runner._load_trash()
    for all_greedy, n in ((True, 5), (False, 3)):
        runner.run(n, all_greedy)
    torch.cuda.synchronize()
    assert tpa.ragged_paged_attention.launches == 8 * layers
    assert tpa.ragged_paged_attention.launches_by_route[route] == 8 * layers
    qmm_route = tqm.int8_matmul.launches_by_route['tensor_cores']
    assert qmm_route == (8 * 7 * layers if case == 'int8_weights' else 0)
    assert tpa.ragged_paged_attention_reference.launches == plain
    engine.shutdown()


def test_a_failed_capture_raises_and_never_decodes_eagerly(cuda, monkeypatch):
    """K1's split tickets would have to be made inside the capture: the
    capture raises, no graph is kept, and the engine's next window raises
    again instead of running the eager loop."""
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.models import mistral

    class Forgetful(dict):
        def get(self, key, default=None):
            if torch.cuda.is_current_stream_capturing():
                return None
            return super().get(key, default)

    monkeypatch.setattr(tpa, '_split_tickets', Forgetful(tpa._split_tickets))

    def not_called(*args, **kwargs):
        raise AssertionError('the engine must never decode eagerly on CUDA')

    monkeypatch.setattr(mistral, 'decode_loop', not_called)
    engine = _graph_engine('bf16')
    with pytest.raises(RuntimeError, match='inside a CUDA graph capture'):
        engine.warmup()
    assert not engine._decode.graphs and not engine._decode.ready
    with pytest.raises(RuntimeError, match='inside a CUDA graph capture'):
        engine.generate_ids(_graph_prompts(4, (9,)),
                            SamplingParams(temperature=0.0, max_tokens=4))
    assert engine.stats['decode_graph_replays'] == 0
    assert engine.stats['decode_windows'] == 0
    with pytest.raises(RuntimeError, match='warmup'):
        engine._decode.run(1, True)


# ----------------------------------------------------------- K1 mixed mode
def _mixed_case(seed, q_dtype, kv_dtype, **kw):
    """``_case`` with its pools stored in ``kv_dtype`` (K1's mixed mode)."""
    case = _case(seed, dtype=q_dtype, **kw)
    q, k, v, *rest = case['args']
    dt = getattr(torch, kv_dtype)
    case['args'] = (q, k.float().to(dt), v.float().to(dt), *rest)
    return case


MIXED_ROUTES = [
    # (q dtype, pool dtype, span, q_lens, route)
    ('float32', 'bfloat16', 1, [1] * 5, 'cuda_cores'),
    ('float32', 'bfloat16', 40, [40, 17, 1, 0, 40], 'cuda_cores'),
    ('bfloat16', 'float32', 1, [1] * 5, 'split_kv'),
    ('bfloat16', 'float32', 3, [3, 2, 1, 0, 3], 'split_kv'),
    ('bfloat16', 'float32', 300, [300, 120, 17, 0, 300], 'tensor_cores'),
]


@pytest.mark.parametrize('q_dtype,kv_dtype,span,q_lens,route', MIXED_ROUTES)
@pytest.mark.parametrize('hd', [64, 128])
@pytest.mark.parametrize('nh,nkv', [(4, 2), (32, 8)])
@pytest.mark.parametrize('window,softcap', [(None, None), (100, 30.0)])
def test_mixed_kv_on_every_route(cuda, q_dtype, kv_dtype, span, q_lens, route, hd, nh, nkv,
                                 window, softcap):
    ctxs = [span + 700, span + 5, 1100, 64, 2048]
    case = _mixed_case(30, q_dtype, kv_dtype, nh=nh, nkv=nkv, hd=hd, ctxs=ctxs,
                       q_lens=q_lens, span=span)
    _check(case, q_dtype, route=route, sliding_window=window, logit_softcap=softcap)


@pytest.mark.parametrize('q_dtype,kv_dtype,span,q_lens,route', MIXED_ROUTES[::2])
def test_mixed_kv_nan_trash_block_never_reaches_an_output(cuda, q_dtype, kv_dtype, span,
                                                          q_lens, route):
    case = _mixed_case(31, q_dtype, kv_dtype, nh=32, nkv=8, hd=128,
                       ctxs=[span + 700, span + 5, 1100, 64, 2048], q_lens=q_lens, span=span)
    assert _route(case) == route
    q, k, v, *rest = case['args']
    clean = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    k[0], v[0] = float('nan'), float('nan')
    poisoned = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    assert torch.equal(clean, poisoned)


def test_fp32_engine_over_bf16_pool_matches_the_plain_op(cuda):
    """A small fp32 model over a bf16 KV pool on the card: greedy tokens on
    K1's mixed mode equal those on the plain op."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import mistral

    cfg = mistral.MistralConfig(
        vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=512, dtype='float32',
    )
    params = mistral.init(cfg, torch.Generator(device='cuda').manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(4, 256, size=n)] for n in (5, 40, 17, 90, 3)]
    outs = {}
    for backend in ('auto', 'reference'):
        engine = LLMEngine(cfg, params, None, EngineConfig(
            num_blocks=64, max_num_seqs=3, max_model_len=256, kv_cache_dtype='bf16',
        ), attn_backend=backend)
        engine.warmup()
        mixed = tpa.ragged_paged_attention.launches_by_kv['mixed']
        outs[backend] = engine.generate_ids(prompts, SamplingParams(temperature=0.0, max_tokens=12))
        passes = engine.telemetry['forward_passes']
        expected = cfg.num_layers * passes if backend == 'auto' else 0
        assert tpa.ragged_paged_attention.launches_by_kv['mixed'] - mixed == expected
        assert engine.kv.k.dtype == torch.bfloat16
    assert outs['auto'] == outs['reference']


# ------------------------------------------- prefix cache under the graphs
PREFIX_CFG = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
                  num_kv_heads=2, intermediate_size=512, dtype='bfloat16')


def _prefix_engine(kv, tmp_path):
    """A small bf16 model, block 16, a pool of 7 usable blocks (a 64-token
    prompt and its 8 new tokens take 5), the prefix cache and a host tier
    writing through to ``tmp_path``; warmed up (graphs captured)."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine
    from distllm_tpu_torch.models import mistral

    cfg = mistral.MistralConfig(**PREFIX_CFG)
    params = mistral.init(cfg, torch.Generator(device='cuda').manual_seed(0))
    engine = LLMEngine(cfg, params, None, EngineConfig(
        num_blocks=8, max_num_seqs=2, max_model_len=256, decode_steps=8,
        kv_cache_dtype=kv, enable_prefix_cache=True, host_kv_tier_bytes=1 << 28,
        disk_kv_tier_dir=str(tmp_path),
    ))
    engine.warmup()
    return engine


def _pools(engine, planes):
    if engine.kv.quantized:
        return tpa.QuantizedKV(planes[0], planes[2]), tpa.QuantizedKV(planes[1], planes[3])
    return planes[0], planes[1]


def _record_windows(engine):
    """Keep every window's inputs, the carry of last ids its load merged,
    the pool before it, its graph tokens and the pool after it (clones
    ordered on the stream, so a pipelined run's windows in flight keep
    what each saw)."""
    runner = engine._decode
    windows = []
    load, run = runner.load, runner.run

    def recording_load(*host, **kw):
        windows.append({'host': [np.array(h, copy=True) for h in host],
                        'before': [p.clone() for p in engine._pool_planes()]})
        load(*host, **kw)
        windows[-1]['ids'] = runner.ids.clone()

    def recording_run(num_steps, all_greedy):
        tokens = run(num_steps, all_greedy)
        windows[-1].update(tokens=tokens.clone(), steps=num_steps, greedy=all_greedy,
                           after=[p.clone() for p in engine._pool_planes()])
        return tokens

    runner.load, runner.run = recording_load, recording_run
    return windows


def _windows_equal_the_eager_loop(engine, windows) -> bool:
    from distllm_tpu_torch.models import mistral

    for w in windows:
        dev = [torch.from_numpy(np.asarray(x)).cuda() for x in w['host']]
        k, v = _pools(engine, w['before'])
        eager = mistral.decode_loop(
            engine.params, engine.model_cfg, w['ids'], dev[1], k, v, dev[3], dev[2], *dev[4:],
            num_steps=w['steps'], max_table_positions=engine.config.max_model_len,
            all_greedy=w['greedy'],
        )[0]
        for row, n in enumerate(np.minimum(w['host'][4], w['steps'])):
            if not torch.equal(w['tokens'][:n, row], eager[:n, row]):
                return False
        # The eager loop wrote its window into the 'before' copies.
        if not all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(w['after'], w['before'])):
            return False
    return True


PROMPT = list(range(10, 74))  # 64 tokens: four full blocks
OTHER = list(range(100, 164))
TAIL = list(range(200, 220))


def _cow_spill_promotion(engine):
    """A prompt, its exact repeat (copy-on-write), another prompt whose
    admission evicts and spills the first one's leading blocks, then the
    first plus a tail (promotion). Returns the snapshot of the first
    prompt's cached blocks and the digests the tier held before the
    promotion."""
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.generate.engine.kv_cache import block_digests

    sampling = SamplingParams(temperature=0.0, max_tokens=8)
    digests = block_digests(PROMPT, 16)
    engine.generate_ids([PROMPT], sampling)
    planes = engine._pool_planes()
    blocks = engine.prefix_cache.match(digests)
    snapshot = {d: [p[:, b].clone() for p in planes] for d, b in zip(digests, blocks)}
    engine.generate_ids([PROMPT], sampling)
    engine.generate_ids([OTHER], sampling)
    in_tier = [d for d in digests if engine.kv_tier.get(d) is not None]
    engine.generate_ids([PROMPT + TAIL], sampling)
    assert engine.stats['prefix_cow_copies'] == 1
    assert engine.stats['tier_spills'] > 0 and engine.stats['tier_promotions'] > 0
    return snapshot, in_tier


@pytest.mark.parametrize('kv', ['auto', 'int8'])
def test_cow_and_promotion_under_captured_graphs_equal_the_eager_loop(cuda, tmp_path, kv):
    engine = _prefix_engine(kv, tmp_path)
    k_before = engine._pool_planes()[0]
    windows = _record_windows(engine)
    _cow_spill_promotion(engine)
    assert engine._pool_planes()[0] is k_before
    assert len(windows) >= 4 and engine.stats['decode_graph_replays'] > 0
    assert _windows_equal_the_eager_loop(engine, windows)


@pytest.mark.parametrize('kv', ['auto', 'int8'])
def test_spill_and_promotion_are_bitwise_on_the_card(cuda, tmp_path, kv):
    engine = _prefix_engine(kv, tmp_path)
    snapshot, in_tier = _cow_spill_promotion(engine)
    assert in_tier
    planes = engine._pool_planes()
    cached = dict(zip(snapshot, engine.prefix_cache.match(list(snapshot))))
    for digest in in_tier:
        tier_copy = engine.kv_tier.get(digest)
        assert all(torch.equal(t, s.cpu()) for t, s in zip(tier_copy, snapshot[digest]))
        assert all(torch.equal(p[:, cached[digest]], s) for p, s in zip(planes, snapshot[digest]))
    assert engine.tier_summary()['payload_mismatches'] == 0


def test_a_pool_rebinding_mutant_fails_the_window_check(cuda, tmp_path, monkeypatch):
    """The check above catches a copy-on-write that rebinds the pool (a new
    tensor, as the JAX engine's functional update does) instead of writing
    it in place: the captured graphs keep reading the old tensor."""
    from distllm_tpu_torch.generate.engine import LLMEngine

    def rebinding_cow(self, requests):
        if not requests:
            return
        dsts = [self.sched.block_row(r.request_id)[r.num_borrowed_blocks] for r in requests]
        srcs = [r.cow_src_block for r in requests]
        for r in requests:
            r.cow_src_block = None
        src = torch.as_tensor(srcs, device=self.device)
        dst = torch.as_tensor(dsts, device=self.device)
        self.kv.k = self.kv.k.index_copy(1, dst, self.kv.k.index_select(1, src))
        self.kv.v = self.kv.v.index_copy(1, dst, self.kv.v.index_select(1, src))
        self.stats['prefix_cow_copies'] += len(srcs)

    monkeypatch.setattr(LLMEngine, '_resolve_cow', rebinding_cow)
    engine = _prefix_engine('auto', tmp_path)
    windows = _record_windows(engine)
    _cow_spill_promotion(engine)
    assert not _windows_equal_the_eager_loop(engine, windows)


def test_requests_over_a_promotion_in_flight_match_the_cache_off_engine(cuda):
    """fp32, 4 layers of 8 KV heads x 128, block 16: a 512-token prefix is
    32 blocks of 512 KiB, and a 47-block pool promotes the 18 of them
    that a second 512-token prompt evicted (9 MiB). The request that promotes it
    prefills its tail at once, and a request with the same prefix added
    the moment the copy is queued (before the host has waited on anything)
    borrows the promoted blocks; both read them only after the copy on the
    device, so both give the cache-off engine's greedy tokens."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import mistral

    cfg = mistral.MistralConfig(vocab_size=512, hidden_size=1024, num_layers=4, num_heads=8,
                                num_kv_heads=8, intermediate_size=2048, dtype='float32')
    params = mistral.init(cfg, torch.Generator(device='cuda').manual_seed(0))

    def engine(**kw):
        return LLMEngine(cfg, params, None, EngineConfig(
            num_blocks=48, max_num_seqs=2, max_model_len=1024, decode_steps=8, **kw))

    rng = np.random.default_rng(3)
    prefix, other = ([int(t) for t in rng.integers(4, 512, size=512)] for _ in range(2))
    first, arrival = prefix + [7, 8, 9], prefix + [10, 11, 12, 13, 14]
    sampling = SamplingParams(temperature=0.0, max_tokens=12)
    on = engine(enable_prefix_cache=True, host_kv_tier_bytes=1 << 30)
    on.generate_ids([prefix], sampling)
    on.generate_ids([other], sampling)  # evicts and spills the prefix's blocks
    added, borrowed = [], []
    promote = on._promote

    def promote_then_add(request):
        promote(request)
        if not added:
            added.append(on.add_request(arrival, sampling))
            borrowed.extend((request.num_borrowed_blocks,
                             on._requests[added[0]].num_borrowed_blocks))

    on._promote = promote_then_add
    got = [on.generate_ids([first], sampling)[0], on._finished.pop(added[0]).output_ids]
    assert borrowed[0] == borrowed[1] >= 16  # 8 MiB or more, borrowed in flight
    assert on.tier_summary()['promote_copy_s'] > 0
    assert got == engine().generate_ids([first, arrival], sampling)


# ------------------------------------------------ speculative verify graphs
def _spec_prompts(seed, lengths=(40, 17, 90, 33, 25, 60)):
    """Prompts that tile a short motif with noise, so the prompt-lookup
    drafter proposes on most windows."""
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        motif = [int(t) for t in rng.integers(4, 512, size=int(rng.integers(3, 7)))]
        row = []
        while len(row) < n:
            row += motif if rng.random() < 0.7 else [int(rng.integers(4, 512))]
        out.append(row[:n])
    return out


def _spec_window_against_eager(engine):
    """Dispatch one verify window through the engine (one graph replay)
    and run the eager ``mistral.spec_window`` on a copy of the pool from
    before it with the window's staged inputs: every planned row's packed
    result and every pool block but the trash block 0 must be bitwise
    equal. Returns the window, or None."""
    from distllm_tpu_torch.models import mistral

    before = [x.clone() for x in _pool_tensors(engine)]
    replays = engine.stats['verify_graph_replays']
    window = engine._dispatch_window()
    if window is None or window['tokens'] is None:
        return window
    assert engine.stats['verify_graph_replays'] - replays == 1
    h = {name: torch.from_numpy(view.copy()).cuda()
         for name, view in engine._verify._host_views.items()}
    pools = before
    if engine.kv.quantized:
        pools = [tpa.QuantizedKV(*before[:2]), tpa.QuantizedKV(*before[2:])]
    eager = mistral.spec_window(
        engine.params, engine.model_cfg, h['ids'], h['positions'], *pools,
        h['block_tables'], h['context_lens'], h['span_lens'], h['temperature'],
        h['top_p'], h['min_p'], h['top_k'], h['seeds'],
        max_table_positions=engine.config.max_model_len,
        sampling_top_window=engine.config.sampling_top_window,
        attn_backend=engine.attn_backend,
        all_greedy=bool((h['temperature'] <= 0).all()),
    )[0]
    graph = window['tokens'].clone()
    for slot, _, _ in window['plan']:
        assert torch.equal(graph[slot], eager[slot]), slot
    for card, ref in zip(_pool_tensors(engine), before):
        assert torch.equal(card[:, 1:], ref[:, 1:])
    return window


@pytest.mark.parametrize('sampled', [False, True])
@pytest.mark.parametrize('case,draft_k', [
    ('bf16', 4), ('bf16', 8), ('int8_weights', 4), ('int8_pool', 4), ('fp32', 4),
])
def test_verify_graph_windows_equal_the_eager_spec_window_bitwise(cuda, case, draft_k, sampled):
    """At GQA group 2, spans of 5 are 10-row tiles (the split-KV route)
    and spans of 9 are 18-row tiles (the tensor cores)."""
    from distllm_tpu_torch.generate.engine import SamplingParams

    engine = _graph_engine(case, draft_k=draft_k, sampling_top_window=16)
    engine.warmup()
    assert engine.stats['verify_graph_captures'] == 2
    layers = GRAPH_CFG['num_layers']
    delta = engine._verify.graphs[True].delta
    route = 'cuda_cores' if case == 'fp32' else tpa.kernel_route(
        torch.bfloat16, 1 + draft_k, GRAPH_CFG['num_heads'] // GRAPH_CFG['num_kv_heads'])
    assert delta[0] == layers and delta[1][route] == layers
    assert delta[_K2_LAUNCHES] == (7 * layers if case == 'int8_weights' else 0)
    prompts = _spec_prompts(1)
    sampling = [SamplingParams(temperature=0.0, max_tokens=n) for n in (12, 5, 20, 9, 16, 7)]
    if sampled:
        sampling[1] = SamplingParams(temperature=0.9, top_p=0.9, max_tokens=11, seed=3)
        sampling[4] = SamplingParams(temperature=0.7, top_k=20, max_tokens=14, seed=4)
    rids = [engine.add_request(p, sp) for p, sp in zip(prompts, sampling)]
    windows = 0
    while engine.has_unfinished:
        engine._admit()
        if engine.sched.num_running == 0:
            continue
        window = _spec_window_against_eager(engine)
        if window is not None:
            engine._process_window(window)
            windows += 1
    outs = [engine._finished.pop(rid).output_ids for rid in rids]
    assert windows > 0 and engine.stats['spec_draft_tokens'] > 0
    assert [len(o) for o in outs] == [sp.max_tokens for sp in sampling]
    assert engine.stats['verify_graph_captures'] == 2  # none per window
    engine.shutdown()


class _WrongDrafter:
    """Always-rejected proposals: a token no greedy row emits here."""

    def draft(self, history, k):
        return [1] * k


def _pool_rows(engine, rid):
    """Each pool plane's bytes at the positions below the request's
    num_tokens (the live KV), in position order."""
    request = engine._requests[rid]
    bs = engine.config.block_size
    pos = torch.arange(request.num_tokens - 1)  # the last token's K/V is not written yet
    blocks = torch.as_tensor(engine.sched.block_row(rid))[pos // bs].cuda()
    offsets = (pos % bs).cuda()
    return [plane[:, blocks, offsets].clone() for plane in _pool_tensors(engine)]


def _rollback_holds(mutant_skips_trim: bool) -> bool:
    """fp32, one request: two engines with ``draft_k=4`` (one's drafts
    always rejected, the other never drafting) and one with ``draft_k=0``,
    stepped in lockstep (each window emits one token in all three). After
    every window the tokens and the live pool bytes must equal the
    never-drafted engine's. Returns whether the block row and the free
    list (content and order) equal the ``draft_k=0`` engine's after every
    window that leaves ``num_tokens`` inside a block: ``sched.trim`` keeps
    room for the next token, which the plain engine reserves only at its
    next window, so at a block boundary the two differ by that one block
    for one window (as in the JAX engine)."""
    from distllm_tpu_torch.generate.engine import SamplingParams

    wrong = _graph_engine('fp32', draft_k=4, decode_steps=1)
    if mutant_skips_trim:
        wrong.sched.trim = lambda rid: 0
    none = _graph_engine('fp32', draft_k=4, decode_steps=1, spec_draft_source='none')
    base = _graph_engine('fp32', decode_steps=1)
    greedy = SamplingParams(temperature=0.0, max_tokens=20)
    prompt = _spec_prompts(6, (47,))[0]
    a, b, c = (e.add_request(prompt, greedy) for e in (wrong, none, base))
    wrong._requests[a].drafter = _WrongDrafter()
    holds = True
    for _ in range(18):  # the 19th window would finish the request
        for e in (wrong, none, base):
            e.step()
        ra, rb, rc = wrong._requests[a], none._requests[b], base._requests[c]
        assert ra.output_ids == rb.output_ids == rc.output_ids
        assert all(torch.equal(x, y) for x, y in zip(_pool_rows(wrong, a), _pool_rows(none, b)))
        if ra.num_tokens % wrong.config.block_size:
            holds &= wrong.sched.block_row(a) == base.sched.block_row(c)
            holds &= wrong.sched.free_list() == base.sched.free_list()
    assert wrong.stats['spec_draft_tokens'] > 0 and wrong.stats['spec_accepted_tokens'] == 0
    for e in (wrong, none, base):
        e.shutdown()
    return holds


def test_spec_rejected_drafts_leave_tokens_pool_and_blocks_as_never_drafted(cuda):
    assert _rollback_holds(mutant_skips_trim=False)


def test_spec_rollback_check_catches_a_missing_trim(cuda):
    assert not _rollback_holds(mutant_skips_trim=True)


# ------------------------------------------------- K1 at head dim 256
# Gemma-2-9B's attention geometry: 16 query heads over 8 KV heads.
HD256 = dict(nh=16, nkv=8, hd=256)
HD256_ROUTES = [
    # (q dtype, span, route): decode rows and spans of 3 (tiles of 2 and
    # 6 rows) on the split-KV route, spans of 300 on the tensor cores, fp32
    # on the CUDA cores.
    ('bfloat16', 1, 'split_kv'),
    ('bfloat16', 3, 'split_kv'),
    ('bfloat16', 300, 'tensor_cores'),
    ('float32', 1, 'cuda_cores'),
    ('float32', 70, 'cuda_cores'),
    ('bfloat16', 300, 'wgmma'),  # over a bf16 pool only; the others refuse it
]


def _hd256_case(seed, q_dtype, span, kv):
    """Rows at the head-dim-256 split plan's edges (contexts 1, a split's
    length - 1, one split, one split + 1, 4096) and a ``q_lens = 0`` row,
    over a pool of q's dtype, int8 codes, or the other full-precision
    dtype (the mixed mode)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sk = tpa.split_plan(4096, 6, HD256['nkv'], sms, 16, HD256['hd'])[1]
    ctxs = [1, sk - 1, sk, sk + 1, 4096, 300]
    ctxs = [max(n, span) for n in ctxs[:-1]] + [300]
    q_lens = [span] * 5 + [0]
    if kv == 'int8':
        return _int8_case(seed, dtype=q_dtype, ctxs=ctxs, q_lens=q_lens, span=span, **HD256)
    if kv == 'mixed':
        other = 'float32' if q_dtype == 'bfloat16' else 'bfloat16'
        return _mixed_case(seed, q_dtype, other, ctxs=ctxs, q_lens=q_lens, span=span, **HD256)
    return _case(seed, dtype=q_dtype, ctxs=ctxs, q_lens=q_lens, span=span, **HD256)


@pytest.mark.parametrize('q_dtype,span,route', HD256_ROUTES)
@pytest.mark.parametrize('kv', ['model', 'int8', 'mixed'])
@pytest.mark.parametrize('window,softcap,scale', [
    (None, None, None), (100, 50.0, 256 ** -0.5), (4096, 50.0, 0.05),
])
def test_head_dim_256_on_every_route_and_kv_mode(cuda, q_dtype, span, route, kv, window,
                                                 softcap, scale):
    """Head dim 256 on every route and KV mode, within the route's
    tolerance: Gemma-2's softcap 50 and query scale, windows inside a
    split and at Gemma-2's 4096."""
    case = _hd256_case(60 + span, q_dtype, span, kv)
    if route == 'wgmma' and kv != 'model':
        with pytest.raises(RuntimeError, match='wgmma route'):
            tpa.ragged_paged_attention_cuda(*case['args'], q_lens=case['q_lens'], route=route)
        return
    _check(case, q_dtype, route=route, force=True, sliding_window=window,
           logit_softcap=softcap, scale=scale)
    assert tpa.ragged_paged_attention.launches_by_head_dim[256] > 0


@pytest.mark.parametrize('q_dtype,span,route', HD256_ROUTES[::2] + HD256_ROUTES[-1:])
@pytest.mark.parametrize('kv', ['model', 'mixed'])
def test_head_dim_256_nan_trash_block_never_reaches_an_output(cuda, q_dtype, span, route, kv):
    case = _hd256_case(61, q_dtype, span, kv)
    if route == 'wgmma' and kv != 'model':
        with pytest.raises(RuntimeError, match='wgmma route'):
            tpa.ragged_paged_attention_cuda(*case['args'], q_lens=case['q_lens'], route=route)
        return
    launch = functools.partial(tpa.ragged_paged_attention_cuda, *case['args'],
                               q_lens=case['q_lens'], route=route)
    clean = launch()
    case['args'][1][0] = float('nan')
    case['args'][2][0] = float('nan')
    poisoned = launch()
    assert torch.equal(clean, poisoned)


def test_head_dim_256_split_kv_launches_are_bitwise_reproducible(cuda):
    case = _hd256_case(62, 'bfloat16', 1, 'mixed')  # the one-deep rings
    first = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    second = tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    assert torch.equal(first, second)


def test_a_configuration_that_does_not_fit_raises(cuda):
    """fp32 at head dim 256 with 128 query heads over one KV head: route
    0's 128-row tile needs more shared memory than a block may have. The
    launch refuses it, naming both sizes; nothing launches, and the plain
    version does not serve it either."""
    case = _case(63, nh=128, nkv=1, hd=256, dtype='float32', ctxs=[40], q_lens=[1], span=1)
    launches = tpa.ragged_paged_attention.launches
    plain = tpa.ragged_paged_attention_reference.launches
    with pytest.raises(ValueError, match=r'needs \d+ bytes of shared memory a block; the '
                                         r'device allows \d+'):
        tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
    assert tpa.ragged_paged_attention.launches == launches
    assert tpa.ragged_paged_attention_reference.launches == plain
    # The same heads at head dim 128 fit (a 128-row tile of 128 wide).
    small = _case(63, nh=128, nkv=1, hd=128, dtype='float32', ctxs=[40], q_lens=[1], span=1)
    _check(small, 'float32', route='cuda_cores')


def test_gemma2_engine_on_the_kernel_matches_the_plain_op(cuda):
    """A gemma2-shaped fp32 model at depth 2 (head dim 256, layer 0 with a
    window of 24, layer 1 global, softcaps, sandwich norms) served on the
    card: greedy tokens on K1 equal those on the plain op, past the
    window, with and without speculation and mixed windows."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import gemma

    cfg = gemma.GemmaConfig(
        name='gemma2', vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=256, intermediate_size=512, dtype='float32',
        activation='gelu_new', embedding_multiplier=16.0, norm_plus_one=True,
        post_norms=True, query_scale=256 ** -0.5, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, sliding_window=24, sliding_window_pattern='alternating',
        tie_word_embeddings=True, rms_norm_eps=1e-6,
    )
    params = gemma.init(cfg, torch.Generator(device='cuda').manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(4, 512, size=n)] for n in (5, 40, 17, 90, 3)]
    for knobs in ({}, {'draft_k': 4, 'spec_draft_source': 'none'},
                  {'enable_mixed_batching': True, 'prefill_chunk_tokens': 16}):
        outs = {}
        for backend in ('auto', 'reference'):
            engine = LLMEngine(cfg, params, None, EngineConfig(
                num_blocks=96, max_num_seqs=3, max_model_len=256, **knobs,
            ), attn_backend=backend)
            assert engine.attn_backend == backend
            engine.warmup()
            at_256 = tpa.ragged_paged_attention.launches_by_head_dim[256]
            outs[backend] = engine.generate_ids(
                prompts, SamplingParams(temperature=0.0, max_tokens=30))
            passes = engine.telemetry['forward_passes']
            expected = cfg.num_layers * passes if backend == 'auto' else 0
            assert tpa.ragged_paged_attention.launches_by_head_dim[256] - at_256 == expected
            engine.shutdown()
        assert outs['auto'] == outs['reference'], knobs


# ------------------------------------------------------ top-k and retrieval
# ops/topk and the retrieval index on the card against the same calls on
# the CPU: the int8 and Hamming tiers bitwise (exact int32 products through
# torch._int_mm, scales applied in one order), the float32 tier with equal
# indices and scores within 1e-5, ties broken by the lower index on both.
def _topk_corpus(n, h, b, seed=0):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, h)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    for dst in (n // 3, n // 3 + 1, n // 2, n - 1):  # ties across slabs
        corpus[dst] = corpus[3]
    queries = rng.normal(size=(b, h)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    queries[0] = corpus[3]
    return corpus, queries


def _both(fn, *arrays, **kw):
    cpu = fn(*(torch.from_numpy(a) for a in arrays), **kw)
    card = fn(*(torch.from_numpy(a).cuda() for a in arrays), **kw)
    return [t.numpy() for t in cpu], [t.cpu().numpy() for t in card]


@pytest.mark.parametrize('form', ['flat', 'grouped'])
@pytest.mark.parametrize('b', [1, 5, 64])
def test_topk_tiers_on_the_card_match_the_cpu(cuda, form, b):
    from distllm_tpu_torch.ops import topk

    n, h, k = 5000, 768, 40
    corpus, queries = _topk_corpus(n, h, b)
    cpu, card = _both(topk.topk_inner_product, queries, corpus, k=k, chunk_size=1024)
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_allclose(card[0], cpu[0], atol=1e-5, rtol=0)
    assert list(card[1][0][:5]) == [3, n // 3, n // 3 + 1, n // 2, n - 1]
    codes, scales = topk.quantize_int8_rows(corpus)
    bits, qbits = topk.pack_sign_bits(corpus), topk.pack_sign_bits(queries)
    if form == 'grouped':
        codes, scales = topk.group_rows(codes, 2048), topk.group_rows(scales, 2048)
        bits = topk.group_rows(bits, 2048)
        kw = dict(n_valid=n)
    else:
        kw = dict(chunk_size=1000)
    cpu, card = _both(topk.int8_topk, queries, codes, scales, k=k, **kw)
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_array_equal(card[0], cpu[0])
    cpu, card = _both(topk.hamming_topk, qbits, bits, k=k, **kw)
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_array_equal(card[0], cpu[0])


def test_topk_int8_on_the_card_is_exact_at_h1280(cuda):
    """ESM-2 650M's width: int8 x int8 sums pass 2**24, where fp32 would
    round; the card's int32 products equal the host's int64 ones."""
    from distllm_tpu_torch.ops import topk

    rng = np.random.default_rng(1)
    corpus = np.sign(rng.normal(size=(3000, 1280))).astype(np.float32)
    queries = corpus[[5, 6, 7]] + np.float32(1e-3) * rng.normal(size=(3, 1280)).astype(np.float32)
    codes, scales = topk.quantize_int8_rows(corpus)
    qi, qscale = topk.quantize_queries(torch.from_numpy(queries).cuda())
    cpu_qi, cpu_qscale = topk.quantize_queries(torch.from_numpy(queries))
    assert torch.equal(qi.cpu(), cpu_qi) and torch.equal(qscale.cpu(), cpu_qscale)
    raw = topk._int_dot(qi, torch.from_numpy(codes).cuda()).cpu().numpy()
    exact = cpu_qi.numpy().astype(np.int64) @ codes.astype(np.int64).T
    assert np.abs(exact).max() > 2 ** 24
    np.testing.assert_array_equal(raw, exact)
    cpu, card = _both(topk.int8_topk, queries, codes, scales, k=10, chunk_size=1000)
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_array_equal(card[0], cpu[0])


class _Table:
    """A numpy embeddings table with the dataset interface the index reads."""

    def __init__(self, embeddings, texts):
        self.embeddings, self.texts = embeddings, np.array(texts, dtype=object)

    def __len__(self):
        return len(self.embeddings)

    def __getitem__(self, key):
        return {'embeddings': self.embeddings[key], 'text': list(self.texts[key])}


@pytest.mark.parametrize('precision', ['float32', 'int8', 'ubinary'])
def test_retrieval_index_on_the_card_matches_the_cpu(cuda, tmp_path, precision):
    from distllm_tpu_torch.rag import search

    corpus, queries = _topk_corpus(9000, 768, 16, seed=2)
    table = _Table(corpus * 3.0, [f'doc {i}' for i in range(len(corpus))])
    results = {}
    for device in ('cpu', 'cuda'):
        config = search.TpuIndexV2Config(
            dataset_dir=tmp_path, index_dir=tmp_path / 'index', precision=precision)
        index = config.get_index(dataset=table, device=device)
        assert index.device_bytes > 0
        results[device] = index.search(queries, top_k=12, score_threshold=-1.0)
    assert results['cuda'].total_indices == results['cpu'].total_indices
    for a, b in zip(results['cuda'].total_scores, results['cpu'].total_scores):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert results['cuda'].total_indices[0][:5] == [3, 3000, 3001, 4500, 8999]


@pytest.mark.parametrize('precision', ['float32', 'int8', 'ubinary'])
def test_two_shard_index_on_the_card_matches_one_shard(cuda, tmp_path, precision):
    """``mesh: {'data': 2}`` on the card (both shards on ``cuda:<i %
    cards>``; 9001 rows pad to 9002): the one-shard index's indices, and
    its scores (bitwise for the quantized tiers, rescored on the host;
    float32's products here run at other slab widths, so within 1e-6;
    ``chip_smoke.py`` 22b holds them bitwise at equal slabs)."""
    from distllm_tpu_torch.rag import search

    corpus, queries = _topk_corpus(9001, 768, 16, seed=3)
    table = _Table(corpus * 3.0, [f'doc {i}' for i in range(len(corpus))])
    results = {}
    for data in (1, 2):
        config = search.TpuIndexV2Config(
            dataset_dir=tmp_path, index_dir=tmp_path / 'index', precision=precision,
            mesh={'data': data})
        index = config.get_index(dataset=table, device='cuda')
        cards = torch.cuda.device_count()
        assert index.shard_devices == [torch.device('cuda', i % cards) for i in range(data)]
        results[data] = index.search(queries, top_k=12, score_threshold=-1.0)
    assert results[2].total_indices == results[1].total_indices
    if precision == 'float32':
        for a, b in zip(results[2].total_scores, results[1].total_scores):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    else:
        assert results[2].total_scores == results[1].total_scores


# ------------------------------------------------------------ serving load
def test_run_loadgen_on_the_card(cuda):
    """``run_loadgen`` over a small fp32 engine on the card, every arrival
    at t = 0 (fixed batches): the tokens equal a burst through ``step()``
    on the plain op; every decode step is a graph replay; the roofline
    shares of every window kind lie in (0, 1.05] on the card's peaks;
    attribution off gives identical tokens; a recovered ``dispatch``
    fault leaves them unchanged."""
    import dataclasses

    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine
    from distllm_tpu_torch.generate.loadgen import LoadgenConfig, build_workload, run_loadgen
    from distllm_tpu_torch.models import mistral
    from distllm_tpu_torch.resilience.faults import get_fault_injector

    cfg = mistral.MistralConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                                num_kv_heads=2, intermediate_size=512, dtype='float32')
    params = mistral.init(cfg, torch.Generator(device='cuda').manual_seed(0))
    workload = [dataclasses.replace(a, at_s=0.0) for a in build_workload(LoadgenConfig(
        seed=5, num_requests=12, num_sessions=2, prefix_tokens=16, prompt_tokens=(4, 40),
        output_tokens=(3, 12), vocab_size=512))]
    engine_cfg = dict(num_blocks=128, max_num_seqs=16, max_model_len=128, decode_steps=4,
                      enable_prefix_cache=True, ttft_slo_s=30.0, max_dispatch_retries=3,
                      retry_backoff_s=0.0)
    reports = {}
    for backend in ('auto', 'reference'):
        engine = LLMEngine(cfg, params, None, EngineConfig(**engine_cfg), attn_backend=backend)
        engine.warmup()
        replays = engine.stats['decode_graph_replays']
        report = run_loadgen(engine, workload)
        passes = engine.stats['forward_passes'] - engine.stats['prefill_dispatches']
        assert engine.stats['decode_graph_replays'] - replays == passes
        for kind, stats in report.roofline.items():
            assert 0 < stats['mfu'] <= 1.05 and 0 < stats['bw_util'] <= 1.05, kind
        engine.attribution = False
        assert run_loadgen(engine, workload).tokens_by_request == report.tokens_by_request
        engine.attribution = True
        injector = get_fault_injector()
        injector.arm('dispatch', times=2, after=1)
        try:
            chaos = run_loadgen(engine, workload)
        finally:
            injector.disarm()
        assert chaos.tokens_by_request == report.tokens_by_request
        assert chaos.window_retries == 2 and chaos.failed_requests == 0
        reports[backend] = report
        engine.shutdown()
    assert reports['auto'].tokens_by_request == reports['reference'].tokens_by_request
    assert all(len(t) == a.max_tokens for t, a in zip(reports['auto'].tokens_by_request,
                                                       workload))


# ------------------------------------------------- the pipelined loop (A6b)
def _record_pipelined(engine):
    """Keep, for every window: the host inputs, the carry of last ids the
    load merged (cloned on the stream, after the merge), a copy of the
    pool before the window's replays and after them, and its tokens (all
    clones ordered on the stream, so they hold what the window saw even
    while later windows are queued); and, in order among them, every
    deferred prefill's scatter into the carry."""
    runner = engine._decode
    windows = []
    load, run = runner.load, runner.run

    def recording_load(*host, take_host=None):
        load(*host, take_host=take_host)
        windows.append({'host': [np.array(h, copy=True) for h in host],
                        'take_host': None if take_host is None else take_host.copy(),
                        'ids': runner.ids.clone(),
                        'before': [p.clone() for p in engine._pool_planes()]})

    def recording_run(num_steps, all_greedy):
        tokens = run(num_steps, all_greedy)
        windows[-1].update(tokens=tokens.clone(), steps=num_steps, greedy=all_greedy,
                           after=[p.clone() for p in engine._pool_planes()])
        return tokens

    def recording_scatter(slots, tokens):
        scatter(slots, tokens)
        windows.append({'scatter': (slots.cpu().tolist(), tokens.cpu().tolist())})

    scatter = runner.scatter_ids
    runner.load, runner.run, runner.scatter_ids = recording_load, recording_run, recording_scatter
    return windows


@pytest.mark.parametrize('depth,defer', [(2, False), (3, False), (2, True)])
def test_pipelined_graph_windows_equal_the_eager_loop_bitwise(cuda, depth, defer):
    """bf16, more prompts than slots, stop ids inside windows: every window
    the pipelined loop replays is bitwise the eager ``decode_loop`` on the
    same inputs and the same pool (its tokens and every pool byte but the
    trash block's); the carry a window starts from holds, for every row
    that kept it, the last token the previous window made for that slot
    (the device-side merge), and the host's id for every other row; and
    the tokens equal the depth-1 engine's, served in the same batches
    (one slot, so admission cannot react differently)."""
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.models import mistral

    rng = np.random.default_rng(31)
    prompts = [[int(t) for t in rng.integers(4, 512, size=n)] for n in (9, 30, 17, 44, 5, 23)]
    engine = _graph_engine('bf16', pipeline_depth=depth, defer_prefill=defer)
    engine.warmup()
    probe = engine.generate_ids(prompts, SamplingParams(temperature=0.0, max_tokens=20))
    stops = tuple({o[6] for o in probe if len(o) > 6})[:2]
    sampling = SamplingParams(temperature=0.0, max_tokens=20, stop_token_ids=stops)
    windows = _record_pipelined(engine)
    out = engine.generate_ids(prompts, sampling)
    assert engine.telemetry['overshoot_tokens'] > 0
    last = {}
    for w in windows:
        if 'scatter' in w:  # a deferred prefill's first tokens, into the carry
            last.update(zip(*w['scatter']))
            continue
        ids = w['ids'].cpu().numpy()
        host_ids = w['host'][0]
        take = np.ones_like(host_ids) if w['take_host'] is None else w['take_host']
        for row in range(len(ids)):
            if take[row]:
                assert ids[row] == host_ids[row]
            elif row in last:
                assert ids[row] == last[row]
        dev = [torch.from_numpy(np.asarray(x)).cuda() for x in w['host']]
        k, v = _pools(engine, w['before'])
        eager = mistral.decode_loop(
            engine.params, engine.model_cfg, w['ids'], dev[1], k, v, dev[3], dev[2], *dev[4:],
            num_steps=w['steps'], max_table_positions=engine.config.max_model_len,
            all_greedy=w['greedy'],
        )[0]
        steps_left = w['host'][4]
        for row, n in enumerate(np.minimum(steps_left, w['steps'])):
            assert torch.equal(w['tokens'][:n, row], eager[:n, row])
            if n:
                last[row] = int(w['tokens'][n - 1, row])
        assert all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(w['after'], w['before']))
    engine.shutdown()
    one = _graph_engine('bf16', max_num_seqs=1, pipeline_depth=1)
    deep = _graph_engine('bf16', max_num_seqs=1, pipeline_depth=depth, defer_prefill=defer)
    for e in (one, deep):
        e.warmup()
    assert deep.generate_ids(prompts, sampling) == one.generate_ids(prompts, sampling)
    assert len(out) == len(prompts)
    for e in (one, deep):
        e.shutdown()


def test_pipelined_windows_price_measured_shares_by_their_events(cuda, monkeypatch):
    """At depth 2 each decode window's measured MFU and bandwidth shares
    are priced over its own CUDA-event seconds (its dispatch-to-fetch
    span also holds the window ahead in flight), which lie inside that
    span; at depth 1 no window records events and the span prices it, as
    before."""
    from distllm_tpu_torch.generate.engine import SamplingParams
    from distllm_tpu_torch.generate.engine import engine as engine_module

    published = []
    publish = engine_module._op_cost.publish_measured

    def spy(kind, measured, seconds, *args, **kwargs):
        published.append((kind, seconds))
        return publish(kind, measured, seconds, *args, **kwargs)

    monkeypatch.setattr(engine_module._op_cost, 'publish_measured', spy)
    rng = np.random.default_rng(32)
    prompts = [[int(t) for t in rng.integers(4, 512, size=n)] for n in (9, 30, 17, 44, 5, 23)]
    for depth in (1, 2):
        engine = _graph_engine('bf16', pipeline_depth=depth)
        engine.warmup()
        timed, spans = [], []
        process = engine._process_window

        def watched(window, process=process, timed=timed):
            out = process(window)
            if 'events' in window:
                start, end = window['events']
                timed.append(start.elapsed_time(end) / 1e3)
            return out

        engine._process_window = watched
        published.clear()
        engine.flight.clear()  # the process's ring: this run's records only
        engine.generate_ids(prompts, SamplingParams(temperature=0.0, max_tokens=40))
        decode = [seconds for kind, seconds in published if kind == 'decode']
        spans = [r['duration_s'] for r in engine.flight.snapshot()
                 if r.get('kind') == 'decode' and 'mfu_measured' in r]
        assert decode and len(decode) == len(spans)
        if depth == 1:
            assert not timed and decode == pytest.approx(spans, abs=2e-6)
        else:
            assert decode == pytest.approx(timed)
            assert all(0 < t <= s + 1e-3 for t, s in zip(timed, spans))
        engine.shutdown()


def test_native_scheduler_builds_on_the_card_machine(cuda):
    """The host C++ scheduler builds with g++ here and makes the Python
    twin's decisions on a random operation sequence; an engine takes it."""
    from distllm_tpu_torch.generate.engine import (
        NativeScheduler,
        PyScheduler,
        SchedulerExhausted,
    )

    def drive(sched, seed):
        rng = np.random.default_rng(seed)
        trace, live, rid = [], set(), 0
        for _ in range(300):
            action = int(rng.integers(0, 4))
            if action == 0 or not live:
                n = int(rng.integers(1, 40))
                sched.add(rid, n)
                live.add(rid)
                trace.append(('add', rid, n))
                rid += 1
            elif action == 1:
                try:
                    admitted = []
                    while (got := sched.admit_next()) is not None:
                        admitted.append(got)
                except SchedulerExhausted:
                    admitted.append('exhausted')
                trace.append(('admit', tuple(admitted)))
            elif action == 2 and sched.num_running:
                try:
                    trace.append(('prepare', tuple(sched.prepare_decode(int(rng.integers(1, 6))))))
                except SchedulerExhausted as exc:
                    trace.append(('exhausted', tuple(exc.preempted)))
                for r in sorted(live):
                    if sched.slot(r) >= 0:
                        sched.append_token(r)
            else:
                running = [r for r in sorted(live) if sched.slot(r) >= 0]
                if running:
                    r = running[int(rng.integers(0, len(running)))]
                    sched.finish(r)
                    live.discard(r)
            trace.append((sched.num_free_blocks, sched.num_running, sched.num_waiting,
                          tuple(sched.free_list())))
        return trace

    for seed in range(3):
        assert drive(NativeScheduler(32, 4, 3), seed) == drive(PyScheduler(32, 4, 3), seed)
    engine = _graph_engine('bf16', prefer_native_allocator=True)
    assert engine.scheduler_kind == 'native' and engine.telemetry['scheduler'] == 'native'
    engine.shutdown()


def test_profiler_capture_stops_itself_and_traces_the_kernel(cuda, tmp_path):
    """A ``ProfilerCapture`` started for 0.5 s while K1 runs stops itself;
    its Chrome trace holds the kernel's launches."""
    import time

    from distllm_tpu_torch.observability.profiling import ProfilerCapture

    case = _case(3, nh=32, nkv=8, hd=128, dtype='bfloat16', ctxs=[300, 900], q_lens=[1, 1],
                 span=1)
    capture = ProfilerCapture()
    assert capture.start(tmp_path / 'trace', max_seconds=0.5)
    deadline = time.monotonic() + 30
    while capture.state()['active'] is not None and time.monotonic() < deadline:
        tpa.ragged_paged_attention(*case['args'], q_lens=case['q_lens'])
        torch.cuda.synchronize()
    assert capture.state()['active'] is None
    while capture.state()['captures_total'] < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    import json

    events = json.load(open(tmp_path / 'trace' / 'trace.json'))['traceEvents']
    assert any('ragged_paged_attention' in str(e.get('name', '')) for e in events)


# ------------------------------------------------------------- Mixtral
def _moe_inputs(seed, *, n=7, h=256, i=384, e=8, zero_router=False):
    gen = torch.Generator().manual_seed(seed)

    def w(*shape, scale=0.05):
        return torch.randn(shape, generator=gen) * scale

    router = torch.zeros(h, e) if zero_router else w(h, e, scale=0.2)
    return w(n, h, scale=1.0), router, w(e, h, i), w(e, h, i), w(e, i, h)


@pytest.mark.parametrize('zero_router', [False, True], ids=['routed', 'zero_router'])
def test_moe_mlp_on_the_card_matches_its_cpu_run(cuda, zero_router):
    from distllm_tpu_torch.models import mixtral

    x, router, gate, up, down = _moe_inputs(0, zero_router=zero_router)
    cpu = mixtral.moe_mlp(x, router, gate, up, down, 2)
    card = mixtral.moe_mlp(*(t.cuda() for t in (x, router, gate, up, down)), 2)
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), atol=1e-5, rtol=1e-5)
    if zero_router:  # ties: experts 0 and 1 on both, as lax.top_k picks
        probs = torch.softmax(x.cuda() @ router.cuda(), dim=-1)
        assert (mixtral._top_k(probs, 2)[1] == torch.tensor([0, 1], device='cuda')).all()
    banks = [tq.quantize_int8(t, out_dtype='float32') for t in (gate, up, down)]
    cpu_q = mixtral.moe_mlp(x, router, *banks, 2)
    card_banks = [tq.QTensor(b.q.cuda(), b.scale.cuda(), 'int8', b.shape, 'float32')
                  for b in banks]
    card_q = mixtral.moe_mlp(x.cuda(), router.cuda(), *card_banks, 2)
    np.testing.assert_allclose(card_q.cpu().numpy(), cpu_q.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_expert_bank_int8_codes_on_the_card_equal_the_cpus(cuda, dtype):
    gen = torch.Generator().manual_seed(1)
    bank = (torch.randn((2, 4, 256, 384), generator=gen) * 0.02).to(getattr(torch, dtype))
    bank[1, 3, :, 5] = 0  # a zero channel: scale 1
    cpu = tq.quantize_int8(bank)
    card = tq.quantize_int8(bank.cuda())
    assert torch.equal(card.q.cpu(), cpu.q) and torch.equal(card.scale.cpu(), cpu.scale)
    assert card.q.shape == (2, 4, 256, 384) and card.scale.shape == (2, 4, 1, 384)


def test_mixtral_engine_on_the_kernels_matches_the_plain_ops(cuda):
    """A 2-layer fp32 Mixtral (hidden 512, 4 / 2 heads of 128, 4 experts)
    served on the card: greedy tokens through K1 equal the plain op's,
    and with int8 weights through K1 + K2 (q / k / v / o on the CUDA-core
    route; the banks dequantized) equal the plain ops'."""
    from distllm_tpu_torch.generate.engine import EngineConfig, LLMEngine, SamplingParams
    from distllm_tpu_torch.models import mixtral

    cfg = mixtral.MixtralConfig(
        vocab_size=512, hidden_size=512, num_layers=2, num_heads=4, num_kv_heads=2,
        intermediate_size=384, num_experts=4, experts_per_token=2, dtype='float32',
    )
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(4, 512, size=n)] for n in (5, 40, 17, 90, 3)]
    for quantization in (None, 'int8'):
        params = mixtral.init(cfg, torch.Generator(device='cuda').manual_seed(0),
                              quantization=quantization)
        outs = {}
        for backend in ('auto', 'reference'):
            engine = LLMEngine(cfg, params, None, EngineConfig(
                num_blocks=96, max_num_seqs=3, max_model_len=256, quantization=quantization,
            ), attn_backend=backend, qmm_backend=backend)
            engine.warmup()
            k1, k2 = tpa.ragged_paged_attention.launches, tqm.int8_matmul.launches
            outs[backend] = engine.generate_ids(
                prompts, SamplingParams(temperature=0.0, max_tokens=24))
            passes = engine.telemetry['forward_passes']
            on_kernels = backend == 'auto'
            assert tpa.ragged_paged_attention.launches - k1 == (
                cfg.num_layers * passes if on_kernels else 0)
            assert tqm.int8_matmul.launches - k2 == (
                4 * cfg.num_layers * passes if on_kernels and quantization else 0)
            engine.shutdown()
        assert outs['auto'] == outs['reference'], quantization
