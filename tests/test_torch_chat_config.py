"""The port's chat app YAML against the JAX ``ChatAppConfig``.

One YAML must mean the same thing to both packages, or fail in the port
with the ROADMAP item that brings what it asks for:

- the prefix cache: an engine backend serves with it on unless the YAML
  says otherwise (the JAX ``build_generator`` default, read here from the
  kwargs it hands ``get_generator``);
- retrieval: ``retrieval_top_k``, ``retrieval_score_threshold`` and
  ``transcript_dir`` are read and validated as the JAX fields are, unknown
  keys are refused, and a ``retriever_config`` is checked as the JAX
  ``RetrieverConfig`` checks it: ``examples/chat/chat_server.rag.yaml``
  fails there and is refused here;
- the backend name: ``tpu``, ``vllm`` and ``torch`` build the engine,
  ``fake`` the fake generator, ``http`` the JAX app's OpenAI-compatible
  client config;
- ``decode_layer_unroll``: a YAML that sets it builds a generator in both
  packages (the port notes once that it has no effect);
- ``top_p`` with ``min_p``: both set is refused, as JAX refuses it; a set
  ``top_p`` alone turns ``min_p`` off;
- a ``model`` mapping picks its config class by ``name`` (``gemma2``,
  ``mixtral``).
"""

from pathlib import Path

import pytest
import yaml

import distllm_tpu.generate
from distllm_tpu.chat import ChatAppConfig as JaxChatAppConfig
from distllm_tpu.generate.generators.tpu_backend import TpuGeneratorConfig
from distllm_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from distllm_tpu_torch.chat import ChatAppConfig
from distllm_tpu_torch.chat_server import load_app_config
from distllm_tpu_torch.generate.generators.torch_backend import (
    FakeGeneratorConfig,
    TorchGenerator,
    TorchGeneratorConfig,
)
from distllm_tpu_torch.models.gemma import GemmaConfig
from distllm_tpu_torch.models.mistral import MistralConfig
from distllm_tpu_torch.models.mixtral import MixtralConfig

RAG_YAML = Path(__file__).resolve().parents[1] / 'examples' / 'chat' / 'chat_server.rag.yaml'
TINY_MODEL = {
    'vocab_size': 64, 'hidden_size': 32, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 64, 'dtype': 'float32',
}


def _engine_yaml(tmp_path, name='torch', **generator):
    raw = {
        'system_prompt': 'Be brief.',
        'generator_config': {
            'name': name, 'temperature': 0.0, 'max_tokens': 4, 'num_blocks': 32,
            'max_num_seqs': 2, 'max_model_len': 64, 'device': 'cpu',
            'model': dict(TINY_MODEL), **generator,
        },
    }
    path = tmp_path / 'app.yaml'
    path.write_text(yaml.safe_dump(raw))
    return path, raw


def _jax_backend_kwargs(raw, monkeypatch):
    """What the JAX app hands ``get_generator`` for this YAML."""
    seen = {}

    def fake_get_generator(kwargs, register=False):
        seen.update(kwargs)
        return None

    monkeypatch.setattr(distllm_tpu.generate, 'get_generator', fake_get_generator,
                        raising=False)
    JaxChatAppConfig(**raw).build_generator()
    return seen


@pytest.mark.parametrize('name', ['tpu', 'vllm', 'torch'])
def test_engine_backends_serve_with_the_prefix_cache_on(tmp_path, monkeypatch, name):
    path, raw = _engine_yaml(tmp_path, name=name)
    config, system_prompt = load_app_config(str(path))
    assert isinstance(config, TorchGeneratorConfig) and system_prompt == 'Be brief.'
    assert config.enable_prefix_cache is True
    assert config.engine_config().enable_prefix_cache
    if name != 'torch':  # the JAX app knows the JAX names only
        assert _jax_backend_kwargs(raw, monkeypatch)['enable_prefix_cache'] is True


def test_an_explicit_cache_setting_is_kept(tmp_path, monkeypatch):
    path, raw = _engine_yaml(tmp_path, name='tpu', enable_prefix_cache=False)
    config, _ = load_app_config(str(path))
    assert config.enable_prefix_cache is False
    assert _jax_backend_kwargs(raw, monkeypatch)['enable_prefix_cache'] is False


def test_the_yaml_serves_through_the_engine_with_the_cache(tmp_path):
    path, _ = _engine_yaml(tmp_path)
    config, _ = load_app_config(str(path))
    generator = TorchGenerator(config)
    assert generator.engine.prefix_cache is not None
    assert len(generator.generate(['a b c', 'a b c d'])) == 2
    generator.shutdown()


def test_the_rag_example_is_refused_until_retrieval_is_ported():
    """Retrieval is ported (A9); the example's retriever keys are refused
    as the JAX ``RetrieverConfig`` refuses them when its app builds the
    retriever (``dataset_dir`` / ``faiss_index_path`` / ``precision``
    where ``faiss_config`` / ``encoder_config`` / ``pooler_config`` are
    required)."""
    raw = yaml.safe_load(RAG_YAML.read_text())
    jax_app = JaxChatAppConfig(**raw)
    assert jax_app.retriever_config is not None and jax_app.retrieval_top_k == 20
    with pytest.raises(ValueError):
        jax_app.build_retriever()
    with pytest.raises(ValueError, match='RetrieverConfig'):
        load_app_config(str(RAG_YAML))


@pytest.mark.parametrize('fields', [
    {},
    {'retrieval_top_k': 7, 'retrieval_score_threshold': 0.25, 'transcript_dir': 'out/t'},
    {'retrieval_top_k': '12', 'retrieval_score_threshold': 1, 'transcript_dir': None},
    {'retrieval_top_k': 5.0, 'retrieval_score_threshold': '0.5', 'retriever_config': None},
    {'retrieval_top_k': True, 'system_prompt': ''},
], ids=['defaults', 'set', 'coerced', 'float_int', 'bool'])
def test_retrieval_keys_read_as_the_jax_fields(fields):
    raw = {'generator_config': {'name': 'torch'}, **fields}
    jax_app = JaxChatAppConfig(**raw)
    app = ChatAppConfig.from_dict(raw)
    for key in ('retrieval_top_k', 'retrieval_score_threshold', 'transcript_dir',
                'system_prompt', 'retriever_config', 'generator_config'):
        assert getattr(app, key) == getattr(jax_app, key), key
        assert type(getattr(app, key)) is type(getattr(jax_app, key)), key


@pytest.mark.parametrize('fields', [
    {'retrieval_top_k': 2.5},
    {'retrieval_top_k': 'x'},
    {'retrieval_top_k': None},
    {'retrieval_score_threshold': 'x'},
    {'transcript_dir': 3},
    {'system_prompt': None},
    {'generator_config': None},
    {'retriver_config': None},  # a misspelt key
], ids=['frac', 'str', 'none', 'thr', 'dir', 'prompt', 'gen', 'extra'])
def test_bad_app_fields_are_refused_as_in_jax(fields):
    with pytest.raises(ValueError):
        JaxChatAppConfig(**fields)
    with pytest.raises(ValueError):
        ChatAppConfig.from_dict(fields)


@pytest.mark.parametrize('name', ['fake', 'http'])
def test_fake_and_http_backends_wait_on_a11(tmp_path, name):
    """``http`` (ported in A11a) reads as the JAX app's ``make_http_generator``
    config; ``fake`` builds through the generator factory, as does a YAML
    with no ``generator_config`` (the JAX default backend is fake)."""
    path = tmp_path / 'app.yaml'
    fields = {'name': name}
    if name == 'http':
        fields.update(base_url='http://127.0.0.1:9/v1', model='m', max_tokens=7)
    path.write_text(yaml.safe_dump({'generator_config': fields}))
    if name == 'http':
        config, _ = load_app_config(str(path))
        want = JaxChatAppConfig(generator_config=fields).build_generator().config
        assert config.to_dict() == want.model_dump()
    else:
        config, _ = load_app_config(str(path))
        assert isinstance(config, FakeGeneratorConfig)
    path.write_text('system_prompt: hi\n')
    config, system_prompt = load_app_config(str(path))
    assert isinstance(config, FakeGeneratorConfig) and system_prompt == 'hi'


def test_jax_generator_fields_the_port_lacks_wait_on_a6(tmp_path, monkeypatch):
    """Serving from a checkpoint path (ROADMAP A6b, ported) builds the
    generator the JAX app builds: the same kwargs reach the backend and the
    same text comes out; ``tensor_parallel_size`` reads as the JAX field
    (ported: ROADMAP A10b, served in test_torch_engine_tp.py). The
    resilience fields read as the JAX app reads them, and an engine backend
    gets the JAX app's serving defaults (a 120 s deadline, 2 dispatch
    retries)."""
    from distllm_tpu.generate.generators.tpu_backend import TpuGenerator
    from tests.test_torch_checkpoint_serve import write_checkpoint

    ckpt = str(write_checkpoint(tmp_path / 'ckpt'))
    path, raw = _engine_yaml(tmp_path, name='tpu', pretrained_model_name_or_path=ckpt)
    del raw['generator_config']['model']
    path.write_text(yaml.safe_dump(raw))
    config, _ = load_app_config(str(path))
    jax_kwargs = _jax_backend_kwargs(raw, monkeypatch)
    assert config.pretrained_model_name_or_path == jax_kwargs['pretrained_model_name_or_path']
    port = TorchGenerator(config)
    ref = TpuGenerator(TpuGeneratorConfig(**{
        k: v for k, v in jax_kwargs.items() if k != 'device'
    }, attn_backend='xla'))
    assert port.model_cfg.vocab_size == ref.engine.model_cfg.vocab_size
    prompts = ['w1 w2 w3', 'w40 w41']
    assert port.generate(prompts) == ref.generate(prompts)
    raw['generator_config']['tensor_parallel_size'] = 2
    path.write_text(yaml.safe_dump(raw))
    assert load_app_config(str(path))[0].tensor_parallel_size == 2
    path, raw = _engine_yaml(tmp_path, name='tpu', request_deadline_s=30.0)
    config, _ = load_app_config(str(path))
    jax_kwargs = _jax_backend_kwargs(raw, monkeypatch)
    for key in ('request_deadline_s', 'max_dispatch_retries'):
        assert getattr(config, key) == jax_kwargs[key], key
        assert getattr(config.engine_config(), key) == jax_kwargs[key], key
    assert (config.request_deadline_s, config.max_dispatch_retries) == (30.0, 2)
    path, raw = _engine_yaml(tmp_path, name='tpu', ttft_slo_s=1.5, admission_control=True)
    config, _ = load_app_config(str(path))
    assert (config.request_deadline_s, config.max_dispatch_retries) == (120.0, 2)
    engine_cfg = config.engine_config()
    assert (engine_cfg.ttft_slo_s, engine_cfg.admission_control) == (1.5, True)
    path, _ = _engine_yaml(tmp_path, admission_control=True)
    with pytest.raises(ValueError, match='ttft_slo_s'):
        load_app_config(str(path))


def test_top_p_and_min_p_as_the_jax_config():
    ckpt = {'pretrained_model_name_or_path': '/nonexistent'}
    with pytest.raises(ValueError, match='Only one of top_p or min_p'):
        TpuGeneratorConfig(top_p=0.9, min_p=0.2, **ckpt)
    with pytest.raises(ValueError, match='Only one of top_p or min_p'):
        TorchGeneratorConfig(top_p=0.9, min_p=0.2)
    for fields in ({'top_p': 0.9}, {'min_p': 0.2}, {}, {'top_p': 0.0, 'min_p': 0.3}):
        jax_cfg = TpuGeneratorConfig(**fields, **ckpt)
        sp = TorchGenerator.sampling_params(
            type('G', (), {'config': TorchGeneratorConfig(**fields)})()
        )
        want_top_p = jax_cfg.top_p or 1.0
        assert (sp.top_p, sp.min_p) == pytest.approx((want_top_p, jax_cfg.min_p)), fields


def test_a_gemma2_model_is_named_in_the_yaml(tmp_path):
    model = {**TINY_MODEL, 'name': 'gemma2', 'head_dim': 8, 'sliding_window': 4,
             'sliding_window_pattern': 'alternating', 'post_norms': True,
             'norm_plus_one': True, 'activation': 'gelu_new'}
    path, _ = _engine_yaml(tmp_path, model=model)
    config, _ = load_app_config(str(path))
    assert type(config.model) is GemmaConfig and config.model.name == 'gemma2'
    for family in ('mistral', 'llama', 'qwen2'):
        path, _ = _engine_yaml(tmp_path, model={**TINY_MODEL, 'name': family})
        config, _ = load_app_config(str(path))
        assert type(config.model) is MistralConfig and config.model.name == 'mistral'
    # Mixtral (ROADMAP A10a) builds the JAX config's MixtralConfig.
    path, _ = _engine_yaml(tmp_path, model={**TINY_MODEL, 'name': 'mixtral', 'num_experts': 4})
    config, _ = load_app_config(str(path))
    assert type(config.model) is MixtralConfig and config.model.name == 'mixtral'
    want = JaxMixtralConfig(**{**TINY_MODEL, 'num_experts': 4})
    for field in ('vocab_size', 'hidden_size', 'num_layers', 'num_heads', 'num_kv_heads',
                  'intermediate_size', 'num_experts', 'experts_per_token', 'rope_theta',
                  'rms_norm_eps', 'sliding_window', 'tie_word_embeddings', 'dtype'):
        assert getattr(config.model, field) == getattr(want, field), field


def test_a_float_written_without_a_dot_reads_as_in_jax(tmp_path):
    """YAML loads ``1e-6`` (no dot) as a string; the JAX config's pydantic
    field takes it as a number, and so does the port's config."""
    from distllm_tpu.models.gemma import GemmaConfig as JaxGemmaConfig

    path = tmp_path / 'app.yaml'
    path.write_text(
        'generator_config:\n  name: torch\n  device: cpu\n'
        '  model: {name: gemma2, rms_norm_eps: 1e-6, rope_theta: 1e4, num_layers: 2}\n'
    )
    raw = yaml.safe_load(path.read_text())['generator_config']['model']
    assert raw['rms_norm_eps'] == '1e-6'
    config, _ = load_app_config(str(path))
    want = JaxGemmaConfig(**raw)
    assert config.model.rms_norm_eps == want.rms_norm_eps == 1e-6
    assert config.model.rope_theta == want.rope_theta == 1e4


@pytest.mark.parametrize('value', [True, False, 'yes', 0])
def test_decode_layer_unroll_reads_as_in_jax(tmp_path, monkeypatch, value, capsys):
    """A JAX chat YAML that sets ``decode_layer_unroll`` builds a generator
    in both packages; the JAX field's value reaches the port's config (a
    CUDA graph holds the port's decode step, so it changes nothing there,
    as one log line says), and a value JAX refuses is refused."""
    from distllm_tpu.generate.generators.tpu_backend import TpuGenerator
    from distllm_tpu_torch.generate.generators import torch_backend
    from tests.test_torch_checkpoint_serve import write_checkpoint

    monkeypatch.setattr(torch_backend, '_unroll_noted', False)
    ckpt = str(write_checkpoint(tmp_path / 'ckpt'))
    path, raw = _engine_yaml(tmp_path, name='tpu', pretrained_model_name_or_path=ckpt,
                             decode_layer_unroll=value)
    del raw['generator_config']['model']
    path.write_text(yaml.safe_dump(raw))
    config, _ = load_app_config(str(path))
    jax_kwargs = _jax_backend_kwargs(raw, monkeypatch)
    ref_cfg = TpuGeneratorConfig(**{k: v for k, v in jax_kwargs.items() if k != 'device'},
                                 attn_backend='xla')
    assert config.decode_layer_unroll is ref_cfg.decode_layer_unroll is bool(value)
    port, ref = TorchGenerator(config), TpuGenerator(ref_cfg)
    prompts = ['w1 w2 w3', 'w40 w41']
    assert port.generate(prompts) == ref.generate(prompts)
    port.shutdown()
    assert capsys.readouterr().out.count('decode_layer_unroll has no effect') == 1
    TorchGeneratorConfig(decode_layer_unroll=value, device='cpu')  # noted once only
    assert 'decode_layer_unroll' not in capsys.readouterr().out
    with pytest.raises(ValueError):
        TpuGeneratorConfig(pretrained_model_name_or_path=ckpt, decode_layer_unroll='maybe')
    with pytest.raises(ValueError):
        TorchGeneratorConfig(decode_layer_unroll='maybe')
