"""Serving from ``pretrained_model_name_or_path`` against the JAX
``TpuGenerator``.

A tiny Mistral checkpoint is written from a seed: safetensors in HF key
names, ``config.json``, a fast tokenizer built locally with ``tokenizers``
(``tokenizer.json`` + ``tokenizer_config.json``) and a
``generation_config.json`` with two EOS ids that the greedy streams emit.
The JAX ``TpuGenerator`` and the port's ``TorchGenerator`` (the ``tpu``
backend of ``get_generator``) serve it greedily in fp32, and with
``quantization: int8``: the same text, and the same stop ids — the first
EOS the tokenizer's when it has one and otherwise generation_config's,
the rest extra stop ids. ``tensor_parallel_size`` and its placement
fields read and are checked as config fields, and the load is a
``weight_load`` start-up phase.
"""

import json

import numpy as np
import pytest

from distllm_tpu.generate.generators.tpu_backend import TpuGenerator, TpuGeneratorConfig
from distllm_tpu_torch.generate import get_generator
from distllm_tpu_torch.generate.generators.torch_backend import (
    TorchGeneratorConfig,
    generation_config_eos,
)
from distllm_tpu_torch.observability.startup import get_compile_watcher
from tests.test_torch_gemma import HF_CONFIGS, _hf_state

WORDS = [f'w{i}' for i in range(300)]
PROMPTS = ['w1 w2 w3 w4 w5', 'w9 w10 w11', 'w20 w21 w22 w23 w24 w25 w26 w27 w28', 'w7']
SERVE = dict(temperature=0.0, max_tokens=12, block_size=4, num_blocks=64,
             max_num_seqs=2, max_model_len=64)


def write_checkpoint(root, *, eos_token=None, gen_eos=None, seed=5):
    """The checkpoint directory (see the module docstring)."""
    from safetensors.numpy import save_file
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    root.mkdir(parents=True, exist_ok=True)
    vocab = {'[UNK]': 0, '[PAD]': 1, '</s>': 2}
    vocab.update({w: i + 3 for i, w in enumerate(WORDS)})
    tok = Tokenizer(WordLevel(vocab, unk_token='[UNK]'))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(root / 'tokenizer.json'))
    tok_cfg = {'tokenizer_class': 'PreTrainedTokenizerFast', 'pad_token': '[PAD]',
               'unk_token': '[UNK]', 'model_max_length': 64}
    if eos_token:
        tok_cfg['eos_token'] = eos_token
    (root / 'tokenizer_config.json').write_text(json.dumps(tok_cfg))
    hf = {**HF_CONFIGS['mistral'], 'vocab_size': 320, 'sliding_window': None}
    (root / 'config.json').write_text(json.dumps(hf))
    state = _hf_state('mistral', seed=seed)
    state['model.embed_tokens.weight'] = np.random.default_rng(seed + 1).normal(
        scale=0.5, size=(320, hf['hidden_size'])).astype(np.float32)
    state['lm_head.weight'] = np.random.default_rng(seed + 2).normal(
        scale=0.5, size=(320, hf['hidden_size'])).astype(np.float32)
    save_file(state, str(root / 'model.safetensors'))
    if gen_eos is not None:
        (root / 'generation_config.json').write_text(json.dumps({'eos_token_id': gen_eos}))
    return root


def port_generator(path, **kw):
    return get_generator(
        {'name': 'tpu', 'pretrained_model_name_or_path': str(path), **SERVE, **kw},
        device='cpu',
    )


def jax_generator(path, **kw):
    return TpuGenerator(TpuGeneratorConfig(
        pretrained_model_name_or_path=str(path), attn_backend='xla', **SERVE, **kw,
    ))


@pytest.fixture(scope='module')
def stop_pair(tmp_path_factory):
    """Two ids the greedy streams of PROMPTS emit at their third position."""
    root = write_checkpoint(tmp_path_factory.mktemp('probe'))
    gen = port_generator(root)
    ids = gen.engine.generate_ids(
        [[int(t) for t in gen.tokenizer([p]).input_ids[0][:len(p.split())]] for p in PROMPTS],
        gen.sampling_params(),
    )
    picks = sorted({o[2] for o in ids if len(o) > 2})
    assert len(picks) >= 2
    return picks[:2]


@pytest.mark.parametrize('quantization', [None, 'int8'])
def test_the_checkpoint_serves_the_jax_text(tmp_path, stop_pair, quantization):
    root = write_checkpoint(tmp_path / 'ckpt', gen_eos=stop_pair)
    kw = {} if quantization is None else {'quantization': quantization}
    before = len(get_compile_watcher().state()['phases'])
    port, ref = port_generator(root, **kw), jax_generator(root, **kw)
    loads = [p for p in get_compile_watcher().state()['phases'][before:]
             if p['phase'] == 'weight_load']
    assert loads and loads[-1]['model_type'] == 'mistral'
    assert port.model_cfg.num_layers == 2 and port.model_cfg.vocab_size == 320
    # No eos_token in the tokenizer: generation_config's first id is the
    # EOS, the second an extra stop id.
    assert port.tokenizer.eos_id == ref.engine.tokenizer.eos_id == stop_pair[0]
    assert port.sampling_params().stop_token_ids == ref._sampling_params().stop_token_ids \
        == (stop_pair[1],)
    text = port.generate(PROMPTS)
    assert text == ref.generate(PROMPTS)
    assert any(len(t.split()) < SERVE['max_tokens'] for t in text)  # a stop id stopped one
    if quantization:
        assert port.engine.weight_bytes_quantized < port.engine.weight_bytes_float


def test_a_tokenizer_eos_and_two_generation_eos(tmp_path, stop_pair):
    root = write_checkpoint(tmp_path / 'ckpt', eos_token='</s>', gen_eos=[2, *stop_pair])
    assert generation_config_eos(str(root)) == (2, *stop_pair)
    port, ref = port_generator(root), jax_generator(root)
    assert port.tokenizer.eos_id == ref.engine.tokenizer.eos_id == 2
    assert port.sampling_params().stop_token_ids == ref._sampling_params().stop_token_ids \
        == tuple(stop_pair)
    assert port.generate(PROMPTS) == ref.generate(PROMPTS)


def test_generation_config_eos_as_jax(tmp_path):
    from distllm_tpu.generate.generators.tpu_backend import _generation_config_eos

    for body in ('{"eos_token_id": 7}', '{"eos_token_id": [3, null, 9]}', '{}', 'not json',
                 '{"eos_token_id": "x"}'):
        (tmp_path / 'generation_config.json').write_text(body)
        assert generation_config_eos(str(tmp_path)) == _generation_config_eos(str(tmp_path))
    assert generation_config_eos(str(tmp_path / 'missing')) == ()


def test_tensor_parallelism_waits_on_a10(tmp_path):
    # Ported (ROADMAP A10b): the config takes tensor_parallel_size and its
    # backend, and refuses what cannot place the ranks.
    config = TorchGeneratorConfig(
        pretrained_model_name_or_path=str(tmp_path), tensor_parallel_size=2,
    )
    assert config.tensor_parallel_size == 2 and config.tensor_parallel_backend is None
    with pytest.raises(ValueError, match='tensor_parallel_size'):
        TorchGeneratorConfig(tensor_parallel_size=0)
    with pytest.raises(ValueError, match='tensor_parallel_backend'):
        TorchGeneratorConfig(tensor_parallel_size=2, tensor_parallel_backend='mpi')
    # The ranks' devices follow the generator's: no field places them.
    with pytest.raises(TypeError, match='tensor_parallel_devices'):
        TorchGeneratorConfig(tensor_parallel_size=2, tensor_parallel_devices=['cpu'])
