"""The port's ``huggingface`` generator against the JAX package's.

A tiny Mistral checkpoint is written from a seed (the safetensors, config
and fast tokenizer of ``test_torch_checkpoint_serve.write_checkpoint``,
the tokenizer's inputs limited to ids and mask as a causal LM's are).
Greedy (``do_sample=False``), the port's ``HuggingFaceGenerator`` on
``device='cpu'`` returns the JAX one's strings exactly, through the
factory too; without a device it asks for CUDA and raises here.
"""

import json
import os

# transformers imports TensorFlow's model classes when it can; these
# tests use its PyTorch classes only.
os.environ.setdefault('USE_TF', '0')

import pytest  # noqa: E402

import distllm_tpu.generate as jax_generate  # noqa: E402
from distllm_tpu.generate.generators.huggingface_backend import (  # noqa: E402
    HuggingFaceGenerator as JaxHuggingFaceGenerator,
)
from distllm_tpu.generate.generators.huggingface_backend import (  # noqa: E402
    HuggingFaceGeneratorConfig as JaxHuggingFaceGeneratorConfig,
)
from distllm_tpu_torch.generate.generators import get_generator  # noqa: E402
from distllm_tpu_torch.generate.generators.huggingface_backend import (  # noqa: E402
    HuggingFaceGenerator,
    HuggingFaceGeneratorConfig,
)
from test_torch_checkpoint_serve import write_checkpoint  # noqa: E402

PROMPTS = ['w1 w2 w3 w4 w5', 'w9 w10 w11', 'w20 w21 w22 w23 w24 w25 w26', 'w7', 'w8 w8']


def causal_lm_checkpoint(root):
    root = write_checkpoint(root, eos_token='</s>')
    path = root / 'tokenizer_config.json'
    cfg = json.loads(path.read_text())
    cfg['model_input_names'] = ['input_ids', 'attention_mask']
    path.write_text(json.dumps(cfg))
    return root


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    return causal_lm_checkpoint(tmp_path_factory.mktemp('hf') / 'ckpt')


@pytest.mark.parametrize('fields', [
    dict(do_sample=False, max_new_tokens=6, batch_size=2),
    dict(do_sample=False, max_new_tokens=4, batch_size=8, num_beams=2),
], ids=['greedy', 'beams'])
def test_greedy_strings_equal_the_jax_generator(checkpoint, fields):
    common = dict(pretrained_model_name_or_path=str(checkpoint), **fields)
    port = HuggingFaceGenerator(HuggingFaceGeneratorConfig(device='cpu', **common))
    ref = JaxHuggingFaceGenerator(JaxHuggingFaceGeneratorConfig(**common))
    got, want = port.generate(PROMPTS), ref.generate(PROMPTS)
    assert got == want and len(got) == len(PROMPTS)
    assert any(got)
    assert port.generate(PROMPTS[0]) == ref.generate(PROMPTS[0])
    assert port.device.type == 'cpu' and next(port.model.parameters()).device.type == 'cpu'
    port.shutdown()
    assert port.model is None


def test_the_factory_builds_it_on_the_device_asked(checkpoint):
    kwargs = {'name': 'huggingface', 'pretrained_model_name_or_path': str(checkpoint),
              'do_sample': 'false', 'max_new_tokens': 3}
    port = get_generator(kwargs, device='cpu')
    ref = jax_generate.get_generator(dict(kwargs))
    assert {k: v for k, v in port.config.to_dict().items() if k != 'device'} == (
        ref.config.model_dump())
    assert port.generate(PROMPTS) == ref.generate(PROMPTS)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        get_generator(kwargs)  # no device: the GPU, absent here
