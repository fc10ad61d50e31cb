"""The port's embedding pipeline against the JAX package's, on the CPU.

Poolers, ``pad_batch_to``, ``compute_embeddings`` (same tiny BERT weights
bridged from ``distllm_tpu.models.bert.init``, same
``WhitespaceTokenizer``), the numpy writer, and ``run_embedding`` end to
end in both packages on one YAML config: a tiny BERT checkpoint written
from a seed (``config.json`` + ``pytorch_model.bin``) with a
``BertTokenizerFast`` saved from a generated ``vocab.txt``, the ``auto``
encoder in fp32, ``jsonl`` / ``mean`` / ``full_sequence`` / ``numpy`` /
``local``. fp32 embeddings agree within ``1e-5`` (same math, PyTorch vs
XLA summation order), with full-precision weights and with the encoder's
``quantization: int8`` on a checkpoint wide enough that every dense
kernel is quantized (both packages quantize the checkpoint's fp32
kernels to the same codes; the port's products run through
``int8_dense``). Last, device defaulting: without a GPU every entry
point raises unless the caller passes ``device='cpu'``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distllm_tpu import distributed_embedding as jax_embedding
from distllm_tpu.embed.embedders import full_sequence as jax_full_sequence
from distllm_tpu.embed.encoders.base import JaxEncoder
from distllm_tpu.embed.poolers import last_token as jax_last_token
from distllm_tpu.embed.poolers import mean as jax_mean
from distllm_tpu.models import bert as jax_bert
from distllm_tpu.models import tokenizer as jax_tokenizer
from distllm_tpu_torch import distributed_embedding as port_embedding
from distllm_tpu_torch.embed import get_encoder, get_pooler, get_writer
from distllm_tpu_torch.embed.embedders.base import EmbedderResult
from distllm_tpu_torch.embed.embedders.full_sequence import compute_embeddings
from distllm_tpu_torch.embed.encoders.base import TorchEncoder
from distllm_tpu_torch.embed.poolers.last_token import last_token_pool
from distllm_tpu_torch.embed.poolers.mean import average_pool
from distllm_tpu_torch.models import bert
from distllm_tpu_torch.models.tokenizer import TokenBatch, WhitespaceTokenizer
from distllm_tpu_torch.ops import encoder_attention as tea
from distllm_tpu_torch.ops import quantization as tq
from distllm_tpu_torch.ops import quantized_matmul as tqm

ATOL = 1e-5
TINY = dict(
    vocab_size=256, hidden_size=32, num_layers=2, num_heads=4,
    intermediate_size=64, max_position_embeddings=128, dtype='float32',
)


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is usable')


# ------------------------------------------------------------- poolers
POOL_MASKS = np.array([
    [1, 1, 1, 1, 1, 0, 0, 0],  # right padded
    [0, 0, 0, 0, 0, 0, 0, 0],  # zero length (a batch-padding row)
    [1, 0, 0, 0, 0, 0, 0, 0],  # start token only
    [1, 1, 0, 0, 0, 0, 0, 0],  # start + end, no interior
    [1, 1, 1, 1, 1, 1, 1, 1],  # full
], np.int32)
LEFT_PADDED = np.array([[0, 0, 1, 1, 1, 1, 1, 1], [0, 0, 0, 0, 0, 1, 1, 1]], np.int32)


@pytest.mark.parametrize('mask', [POOL_MASKS, LEFT_PADDED], ids=['right', 'left'])
def test_poolers_match_jax(mask):
    rng = np.random.default_rng(0)
    hidden = rng.normal(size=(*mask.shape, 16)).astype(np.float32)
    for port, ref in ((average_pool, jax_mean.average_pool),
                      (last_token_pool, jax_last_token.last_token_pool)):
        got = port(torch.from_numpy(hidden), torch.from_numpy(mask))
        want = np.asarray(ref(jnp.asarray(hidden), jnp.asarray(mask)))
        assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_pad_batch_to_matches_jax():
    ids = np.arange(6, dtype=np.int32).reshape(2, 3) + 1
    mask = np.ones((2, 3), np.int32)
    got = TokenBatch(ids, mask).pad_batch_to(5, pad_id=9)
    want = jax_tokenizer.TokenBatch(ids, mask).pad_batch_to(5, pad_id=9)
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    np.testing.assert_array_equal(got.attention_mask, want.attention_mask)
    same = TokenBatch(ids, mask)
    assert same.pad_batch_to(2) is same


# ------------------------------------------------------ compute_embeddings
@pytest.fixture(scope='module')
def encoders():
    jcfg = jax_bert.BertConfig(**TINY)
    tree = jax.tree.map(np.asarray, jax_bert.init(jax.random.PRNGKey(1), jcfg))
    tcfg = bert.BertConfig(**TINY)
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


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [f'w{i}' for i in range(300)]
    return [
        ' '.join(rng.choice(words, size=int(rng.integers(1, 70))))
        for _ in range(n)
    ]


@pytest.mark.parametrize('normalize', [False, True])
def test_compute_embeddings_matches_jax(encoders, normalize):
    jax_enc, port_enc = encoders
    texts = _texts(11)  # batch 4: a partial last batch of 3
    jax_stats, port_stats = {}, {}
    want = jax_full_sequence.compute_embeddings(
        texts, jax_enc, jax_mean.MeanPooler(jax_mean.MeanPoolerConfig()), 4,
        normalize=normalize, stats=jax_stats,
    )
    plain = tea.encoder_attention_reference.launches
    got = compute_embeddings(
        texts, port_enc, get_pooler({'name': 'mean'}), 4,
        normalize=normalize, stats=port_stats, device='cpu',
    )
    assert got.shape == (11, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert port_stats == jax_stats
    # 3 batches x 2 layers through the plain K3 on the CPU.
    assert tea.encoder_attention_reference.launches - plain == 6
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    # Original order restored: each row equals its text embedded alone.
    alone = compute_embeddings(
        [texts[5]], port_enc, get_pooler({'name': 'mean'}), 4,
        normalize=normalize, tokenize_ahead=0, device='cpu',
    )
    np.testing.assert_allclose(alone[0], got[5], atol=ATOL)


def test_numpy_writer_roundtrip_and_merge(tmp_path):
    writer = get_writer({'name': 'numpy'})
    for i in range(2):
        writer.write(tmp_path / f's{i}', EmbedderResult(
            embeddings=np.full((2, 3), i, np.float32), text=[f'a{i}', f'b{i}'],
            metadata=[{'i': i}, {'i': i + 10}],
        ))
    writer.merge([tmp_path / 's0', tmp_path / 's1'], tmp_path / 'merged')
    emb = np.load(tmp_path / 'merged' / 'embeddings.npy')
    text = np.load(tmp_path / 'merged' / 'text.npy', allow_pickle=True)
    meta = np.load(tmp_path / 'merged' / 'metadata.npy', allow_pickle=True)
    assert emb.shape == (4, 3) and emb[2:].tolist() == [[1, 1, 1]] * 2
    assert list(text) == ['a0', 'b0', 'a1', 'b1']
    assert [m['i'] for m in meta] == [0, 10, 1, 11]


# -------------------------------------------------- run_embedding, both
def _write_checkpoint(root, hidden, intermediate):
    """A tiny BERT checkpoint and its tokenizer, written from a seed."""
    from transformers import BertConfig, BertModel, BertTokenizerFast

    words = [f'w{i}' for i in range(300)]
    vocab = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]'] + words
    (root / 'vocab.txt').write_text('\n'.join(vocab) + '\n')
    BertTokenizerFast(vocab_file=str(root / 'vocab.txt')).save_pretrained(root)
    config = BertConfig(
        vocab_size=len(vocab), hidden_size=hidden, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=intermediate,
        max_position_embeddings=128,
    )
    with torch.random.fork_rng():  # seeded weights, the caller's RNG untouched
        torch.manual_seed(0)
        model = BertModel(config)
    config.save_pretrained(root)
    torch.save(model.state_dict(), root / 'pytorch_model.bin')
    return root


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    return _write_checkpoint(tmp_path_factory.mktemp('tiny_bert'), 32, 64)


@pytest.fixture(scope='module')
def checkpoint_q(tmp_path_factory):
    """Hidden 64, intermediate 128: every stacked dense kernel holds at
    least the quantizer's min_size of 4096 weights."""
    return _write_checkpoint(tmp_path_factory.mktemp('tiny_bert_q'), 64, 128)


def _run_config(tmp_path, checkpoint, name, **encoder):
    inputs = tmp_path / 'inputs'
    if not inputs.exists():
        inputs.mkdir()
        texts = _texts(13, seed=2)
        for part, rows in enumerate((texts[:6], texts[6:])):
            with open(inputs / f'part{part}.jsonl', 'w') as fh:
                for i, text in enumerate(rows):
                    fh.write(json.dumps({'text': text, 'id': f'{part}-{i}'}) + '\n')
    config = {
        'input_dir': str(inputs),
        'output_dir': str(tmp_path / name),
        'glob_patterns': ['*.jsonl'],
        'dataset_config': {'name': 'jsonl', 'batch_size': 4},
        'encoder_config': {
            'name': 'auto', 'half_precision': False,
            'pretrained_model_name_or_path': str(checkpoint), **encoder,
        },
        'pooler_config': {'name': 'mean'},
        'embedder_config': {'name': 'full_sequence'},
        'writer_config': {'name': 'numpy'},
        'compute_config': {'name': 'local'},
    }
    path = tmp_path / f'{name}.yaml'
    path.write_text(json.dumps(config))
    return path


def _shards(output_dir):
    """{first text: (embeddings, texts, metadata)} of every shard."""
    out = {}
    for shard in (output_dir / 'embeddings').iterdir():
        texts = list(np.load(shard / 'text.npy', allow_pickle=True))
        out[texts[0]] = (
            np.load(shard / 'embeddings.npy'),
            texts,
            list(np.load(shard / 'metadata.npy', allow_pickle=True)),
        )
    return out


def test_run_embedding_matches_jax_end_to_end(tmp_path, checkpoint, capsys):
    assert jax_embedding.run_embedding(
        jax_embedding.Config.from_yaml(_run_config(tmp_path, checkpoint, 'jax'))
    ) == 0
    port_config = port_embedding.Config.from_yaml(_run_config(tmp_path, checkpoint, 'port'))
    assert port_embedding.run_embedding(port_config, device='cpu') == 0
    jax_out, port_out = _shards(tmp_path / 'jax'), _shards(tmp_path / 'port')
    assert len(port_out) == len(jax_out) == 2
    for first, (emb, texts, meta) in port_out.items():
        want_emb, want_texts, want_meta = jax_out[first]
        assert emb.dtype == np.float32 and emb.shape == want_emb.shape
        np.testing.assert_allclose(emb, want_emb, atol=ATOL)
        assert texts == want_texts and meta == want_meta
    stages = [line for line in capsys.readouterr().out.splitlines()
              if line.startswith('[timer] tags=')]
    for tag in ('loaded-encoder', 'loaded-dataset', 'computed-embeddings',
                'wrote-embeddings'):
        assert sum(line.startswith(f'[timer] tags={tag},part') for line in stages) == 4
    # The port's audit copy is JSON, which both packages read as YAML.
    audit = tmp_path / 'port' / 'config.yaml'
    assert port_embedding.Config.from_yaml(audit) == port_config
    assert jax_embedding.Config.from_yaml(audit).encoder_config == port_config.encoder_config
    # The warm-started encoder served both files of the port's run.
    assert get_encoder(port_config.encoder_config, register=True, device='cpu') is (
        get_encoder(port_config.encoder_config, register=True, device='cpu')
    )


def test_int8_run_embedding_matches_jax_end_to_end(tmp_path, checkpoint_q):
    assert jax_embedding.run_embedding(jax_embedding.Config.from_yaml(
        _run_config(tmp_path, checkpoint_q, 'jax', quantization='int8')
    )) == 0
    port_config = port_embedding.Config.from_yaml(
        _run_config(tmp_path, checkpoint_q, 'port', quantization='int8')
    )
    products = tqm.int8_matmul_reference.launches
    attention = tea.encoder_attention_reference.launches
    assert port_embedding.run_embedding(port_config, device='cpu') == 0
    # 6 int8 products per layer beside each layer's one attention call.
    assert tqm.int8_matmul_reference.launches - products == 6 * (
        tea.encoder_attention_reference.launches - attention
    ) > 0
    encoder = get_encoder(port_config.encoder_config, register=True, device='cpu')
    assert isinstance(encoder.params['layers']['down']['kernel'], tq.QTensor)
    jax_out, port_out = _shards(tmp_path / 'jax'), _shards(tmp_path / 'port')
    assert len(port_out) == len(jax_out) == 2
    for first, (emb, texts, meta) in port_out.items():
        want_emb, want_texts, want_meta = jax_out[first]
        np.testing.assert_allclose(emb, want_emb, atol=ATOL)
        assert texts == want_texts and meta == want_meta


def test_unported_strategies_raise_naming_the_roadmap(tmp_path, checkpoint):
    """A bad quantization mode is a ValueError; the pod compute configs,
    refused until the fabric's slice (A11b), are taken as JAX's; a Mixtral
    checkpoint, refused until its slice, now embeds as JAX's."""
    with pytest.raises(ValueError, match='unknown quantization mode'):
        get_encoder({'name': 'auto', 'quantization': 'int4',
                     'pretrained_model_name_or_path': str(checkpoint)}, device='cpu')
    config = json.loads(_run_config(tmp_path, checkpoint, 'x').read_text())
    pod = {'name': 'pod', 'bind_address': 'tcp://*:6000', 'retries': 2}
    assert port_embedding.Config(**{**config, 'compute_config': pod}).compute_config == pod
    from distllm_tpu.parallel.launcher import get_compute_config as jax_compute_config
    from distllm_tpu_torch.parallel.launcher import get_compute_config

    assert get_compute_config(pod).to_dict() == jax_compute_config(pod).model_dump()
    # A Mixtral checkpoint is served since its slice (A10a): get_encoder
    # builds it in both packages, and the embeddings agree.
    from distllm_tpu.embed.encoders import get_encoder as jax_get_encoder
    from tests.test_torch_mixtral import write_numpy_checkpoint

    other = write_numpy_checkpoint(tmp_path / 'mixtral', seed=4)
    spec = {'name': 'auto', 'pretrained_model_name_or_path': str(other),
            'half_precision': False}
    port_enc = get_encoder(spec, device='cpu')
    jax_enc = jax_get_encoder(dict(spec))
    assert port_enc.model_cfg.name == 'mixtral' == jax_enc.model_cfg.name
    texts = ['w1 w2 w3', 'w4 w5 w6 w7 w8']
    got = port_enc.pooled_forward(get_pooler({'name': 'last_token'}))(port_enc.tokenizer(texts))
    want = jax_enc.pooled_forward(jax_last_token.LastTokenPooler(
        jax_last_token.LastTokenPoolerConfig()))(jax_enc.tokenizer(texts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)


# ---------------------------------------------------- device defaulting
def test_entry_points_default_to_cuda_and_raise_without_it(encoders, checkpoint):
    _no_gpu()
    _, port_enc = encoders
    cfg = bert.BertConfig(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_embeddings(['a b'], port_enc, get_pooler({'name': 'mean'}), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEncoder(None, bert.apply, cfg, {}, None, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_encoder({'name': 'auto', 'pretrained_model_name_or_path': str(checkpoint)})
    # On the CPU only when asked, and the parameters must already be there.
    assert port_enc.device == torch.device('cpu')
    meta = bert.init(cfg, device='cpu')
    meta['embeddings']['word'] = meta['embeddings']['word'].to('meta')
    with pytest.raises(ValueError, match='live on meta'):
        TorchEncoder(None, bert.apply, cfg, meta, None, 32, device='cpu')
