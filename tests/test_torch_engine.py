"""The port's serving engine against the JAX ``LLMEngine``.

Same tiny fp32 model on both sides (``mistral.init(PRNGKey(0))`` bridged
with ``params_from_jax``), block_size 4, ``max_num_seqs=3`` and more
prompts than slots, so admission, retirement and slot reuse all run. The
JAX engine serves with ``attn_backend='xla'``; the port prefills fresh
prompts through ``prefill_paged`` and decodes through the ragged op. fp32
greedy tokens must be identical, and every block returns to the free list
when the requests finish. A pool too small for the batch forces recompute
preemption, which must not change a single token.

Weight-only quantization: with ``EngineConfig.quantization`` 'int8' or
'nf4' on both sides (every projection quantized at the widths used), the
port's greedy fp32 tokens equal the JAX engine's, and every int8
projection of every forward pass went through ``int8_dense``.

KV storage dtype: with ``EngineConfig(kv_cache_dtype='int8')`` on both
sides the port's greedy fp32 tokens equal the JAX engine's, on a pool
under half the fp32 pool's bytes; ``'auto'`` and the pin that equals the
model dtype are today's engine; unknown values are refused, and a
full-precision pin of the other dtype builds a pool of that dtype.
"""

import jax
import numpy as np
import pytest
import torch

from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig
from distllm_tpu.generate.engine import LLMEngine as JaxLLMEngine
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu_torch.generate.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.ops import paged_attention as tpa
from distllm_tpu_torch.ops import quantization as tq
from distllm_tpu_torch.ops import quantized_matmul as tqm

TINY = {
    'vocab_size': 128, 'hidden_size': 32, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 64, 'dtype': 'float32',
}
ENGINE = {
    'block_size': 4, 'max_num_seqs': 3, 'max_model_len': 64, 'decode_steps': 4,
}
MAX_TOKENS = 7


class _Tok:
    eos_id = None


@pytest.fixture(scope='module')
def weights():
    jcfg = jax_mistral.MistralConfig(**TINY)
    tree = jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, tree


@pytest.fixture(scope='module')
def prompts():
    rng = np.random.default_rng(3)
    return [
        [int(t) for t in rng.integers(4, 128, size=n)]
        for n in (3, 11, 6, 17, 9)
    ]


@pytest.fixture(scope='module')
def jax_tokens(weights, prompts):
    jcfg, tree = weights
    engine = JaxLLMEngine(
        jcfg, tree, _Tok(),
        JaxEngineConfig(
            num_blocks=48, attn_backend='xla', prefer_native_allocator=False,
            **ENGINE,
        ),
    )
    out = engine.generate_ids(
        prompts, JaxSamplingParams(temperature=0.0, max_tokens=MAX_TOKENS)
    )
    engine.shutdown()
    return out


def _port_engine(weights, num_blocks):
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(weights[1], tcfg, device='cpu')
    return LLMEngine(
        tcfg, params, _Tok(), EngineConfig(num_blocks=num_blocks, **ENGINE),
        device='cpu',
    )


def test_greedy_tokens_identical_to_jax_engine(weights, prompts, jax_tokens):
    engine = _port_engine(weights, num_blocks=48)
    calls = tpa.ragged_paged_attention_reference.launches
    out = engine.generate_ids(
        prompts, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS)
    )
    assert out == jax_tokens
    assert all(len(o) == MAX_TOKENS for o in out)
    assert engine.sched.num_free_blocks == 48 - 1  # all freed, trash kept
    assert not engine.has_unfinished
    assert engine.telemetry['prefill_dispatches'] >= 2  # slots were reused
    # Every layer of every forward pass attended once, through the plain op
    # (CPU tensors) — the count chip_smoke.py checks for the kernel.
    passes = engine.telemetry['forward_passes']
    assert tpa.ragged_paged_attention_reference.launches - calls == (
        TINY['num_layers'] * passes
    )
    assert engine.telemetry['generated_tokens'] == MAX_TOKENS * len(prompts)


def test_preemption_keeps_tokens_identical(weights, prompts, jax_tokens):
    """11 usable blocks for 3 slots of up to 24 tokens: decode windows run
    the pool dry and recompute-preempt the youngest request."""
    engine = _port_engine(weights, num_blocks=12)
    out = engine.generate_ids(
        prompts, SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS)
    )
    assert engine.stats['preemptions'] > 0
    assert out == jax_tokens
    assert engine.sched.num_free_blocks == 12 - 1


def test_sampled_requests_are_deterministic_per_seed(weights, prompts):
    engine = _port_engine(weights, num_blocks=48)
    params = [
        SamplingParams(temperature=0.9, top_p=0.9, max_tokens=5, seed=s)
        for s in (1, 2)
    ]
    first = engine.generate_ids(prompts[:2], params)
    second = engine.generate_ids(prompts[:2], params)
    assert first == second
    assert all(len(o) == 5 for o in first)


def test_stop_token_and_length_limits(weights, prompts, jax_tokens):
    engine = _port_engine(weights, num_blocks=48)
    stop = jax_tokens[1][2]
    out = engine.generate_ids(
        [prompts[1]],
        SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS, stop_token_ids=(stop,)),
    )
    assert out == [jax_tokens[1][:jax_tokens[1].index(stop)]]
    with pytest.raises(ValueError, match='empty prompt'):
        engine.add_request([])


def test_engine_refuses_params_on_another_device(weights):
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(weights[1], tcfg, device='meta')
    with pytest.raises(ValueError, match='params live on'):
        LLMEngine(tcfg, params, _Tok(), device='cpu')
    with pytest.raises(ValueError, match='unsupported device'):
        LLMEngine(tcfg, params, _Tok(), device=torch.device('meta'))


# Every projection quantized: each stacked kernel holds >= 4096 weights.
QTINY = {**TINY, 'hidden_size': 64, 'intermediate_size': 128}


@pytest.mark.parametrize('mode', ['int8', 'nf4'])
def test_quantized_greedy_tokens_identical_to_jax_engine(prompts, mode):
    jcfg = jax_mistral.MistralConfig(**QTINY)
    tree = jax.tree.map(np.asarray, jax_mistral.init(jax.random.PRNGKey(4), jcfg))
    jax_engine = JaxLLMEngine(
        jcfg, tree, _Tok(),
        JaxEngineConfig(
            num_blocks=48, attn_backend='xla', prefer_native_allocator=False,
            quantization=mode, **ENGINE,
        ),
    )
    greedy = dict(temperature=0.0, max_tokens=MAX_TOKENS)
    want = jax_engine.generate_ids(prompts, JaxSamplingParams(**greedy))
    jax_engine.shutdown()
    tcfg = mistral.MistralConfig(**QTINY)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    engine = LLMEngine(
        tcfg, params, _Tok(),
        EngineConfig(num_blocks=48, quantization=mode, **ENGINE),
        device='cpu', own_params=True,
    )
    plain = tqm.int8_matmul_reference.launches
    assert engine.generate_ids(prompts, SamplingParams(**greedy)) == want
    tele = engine.telemetry
    assert tele['quantization'] == mode and tele['qmm_backend'] == 'auto'
    assert (tele['weight_bytes_quantized'], tele['weight_bytes_float']) == (
        tq.quantized_nbytes(engine.params)
    )
    assert tele['weight_bytes_quantized'] > 0
    assert isinstance(engine.params['layers']['down']['kernel'], tq.QTensor)
    assert params['layers']['q']['kernel'] is None  # own_params: source dropped
    passes = tele['forward_passes']
    expected = 7 * QTINY['num_layers'] * passes if mode == 'int8' else 0
    assert tqm.int8_matmul_reference.launches - plain == expected


def test_generator_quantization_flag_and_qmm_backend_pin():
    from distllm_tpu_torch.generate.generators.torch_backend import (
        TorchGenerator,
        TorchGeneratorConfig,
    )

    config = TorchGeneratorConfig(
        model=mistral.MistralConfig(**QTINY), quantization=True, max_tokens=3,
        num_blocks=32, max_num_seqs=2, max_model_len=64, device='cpu',
    )
    generator = TorchGenerator(config, qmm_backend='reference')
    engine = generator.engine
    assert engine.config.quantization == 'nf4'  # True means nf4
    assert engine.model_cfg.qmm_backend == 'reference'
    assert engine.params['layers']['gate']['kernel'].kind == 'nf4'
    assert len(generator.generate(['a b c', 'd e'])) == 2
    with pytest.raises(ValueError, match='unknown quantization mode'):
        TorchGeneratorConfig(quantization='int4')
    with pytest.raises(ValueError, match='qmm_backend'):
        LLMEngine(
            mistral.MistralConfig(**QTINY), engine.params, None, device='cpu',
            qmm_backend='pallas',
        )


def test_int8_kv_greedy_tokens_identical_to_jax_engine(weights, prompts):
    jcfg, tree = weights
    jax_engine = JaxLLMEngine(
        jcfg, tree, _Tok(),
        JaxEngineConfig(
            num_blocks=48, attn_backend='xla', prefer_native_allocator=False,
            kv_cache_dtype='int8', **ENGINE,
        ),
    )
    greedy = dict(temperature=0.0, max_tokens=MAX_TOKENS)
    want = jax_engine.generate_ids(prompts, JaxSamplingParams(**greedy))
    jax_engine.shutdown()
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(tree, tcfg, device='cpu')
    engine = LLMEngine(
        tcfg, params, _Tok(),
        EngineConfig(num_blocks=48, kv_cache_dtype='int8', **ENGINE), device='cpu',
    )
    assert engine.telemetry['kv_cache_dtype'] == 'int8'
    calls = tpa.ragged_paged_attention_reference.launches
    assert engine.generate_ids(prompts, SamplingParams(**greedy)) == want
    assert engine.telemetry['kv_cache_dtype'] == 'int8'
    passes = engine.telemetry['forward_passes']
    assert tpa.ragged_paged_attention_reference.launches - calls == (
        TINY['num_layers'] * passes
    )
    kv = engine.kv
    assert kv.quantized and isinstance(kv.k, tpa.QuantizedKV)
    assert kv.k.data.dtype == torch.int8
    assert kv.k.scale.shape == (TINY['num_layers'], 48, TINY['num_kv_heads'])
    assert kv.k.scale.abs().sum() > 0  # the writes quantized into the pool
    fp32 = _port_engine(weights, num_blocks=48)
    assert kv.hbm_bytes / fp32.kv.hbm_bytes < 0.5


def test_kv_cache_dtype_auto_and_matching_pin_are_todays_engine(
    weights, prompts, jax_tokens
):
    greedy = SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS)
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(weights[1], tcfg, device='cpu')
    for pin in ('auto', 'fp32'):
        engine = LLMEngine(
            tcfg, params, _Tok(),
            EngineConfig(num_blocks=48, kv_cache_dtype=pin, **ENGINE), device='cpu',
        )
        assert engine.generate_ids(prompts, greedy) == jax_tokens
        assert engine.telemetry['kv_cache_dtype'] == 'float32'
        assert not engine.kv.quantized and engine.kv.k.dtype == torch.float32
        assert engine.kv.hbm_bytes == 2 * engine.kv.k.numel() * 4


def test_kv_cache_dtype_refusals(weights):
    """Unknown storage dtypes are refused; a full-precision pin of the
    other dtype is served (K1's mixed mode: tests/test_torch_kv_mixed.py
    holds its tokens to the JAX engine's)."""
    with pytest.raises(ValueError, match="kv_cache_dtype must be 'auto'"):
        EngineConfig(kv_cache_dtype='fp8')
    tcfg = mistral.MistralConfig(**TINY)
    params = mistral.params_from_jax(weights[1], tcfg, device='cpu')
    engine = LLMEngine(
        tcfg, params, _Tok(), EngineConfig(num_blocks=8, kv_cache_dtype='bf16'),
        device='cpu',
    )
    assert engine.kv.k.dtype == torch.bfloat16
    assert engine.telemetry['kv_cache_dtype'] == 'bfloat16'
