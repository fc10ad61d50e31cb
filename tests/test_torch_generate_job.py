"""The port's generation job against ``distllm_tpu``'s, on the CPU.

- Every prompt template's ``preprocess`` and ``postprocess`` give the JAX
  strings character for character (with and without retrieved contexts,
  responses with and without a question, AMP responses that parse and
  that do not, keywords inline and from a file).
- The readers read the same (texts, paths); the writers write the same
  files (the ``huggingface`` rows, ``merge`` skipping a bad shard; the
  ``amp_jsonl`` lines and their merge).
- The generator factory: ``fake`` as JAX's, ``tpu`` / ``vllm`` / ``torch``
  build the engine, the network and ``transformers`` backends build and
  refuse as JAX's do, a checkpoint path read as JAX reads it and
  at tensor_parallel_size 2 too, the
  fake backend's `overload_every` shed signal as JAX's, an
  unknown name as JAX's; ``register=True`` reuses the warm instance.
- ``run_generation`` in both packages on
  ``examples/generate/question_chunk.fake.local.yaml`` (copied into a
  temporary directory): shards equal apart from their UUID names, the
  ``[timer]`` tags, the audit copy, the clobber guard; and on a tiny fp32
  ``tpu`` generator (random weights from the port's seed, the same tree
  behind a JAX ``LLMEngine`` through a monkeypatched
  ``distllm_tpu.generate.get_generator``): greedy responses identical.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import distllm_tpu.generate
from distllm_tpu import distributed_generation as jax_job
from distllm_tpu.generate import get_prompt_template as jax_prompt
from distllm_tpu.generate import get_reader as jax_reader
from distllm_tpu.generate import get_writer as jax_writer
from distllm_tpu.generate.engine import EngineConfig as JaxEngineConfig
from distllm_tpu.generate.engine import LLMEngine as JaxLLMEngine
from distllm_tpu.generate.engine import SamplingParams as JaxSamplingParams
from distllm_tpu.models import mistral as jax_mistral
from distllm_tpu.models.tokenizer import WhitespaceTokenizer as JaxWhitespaceTokenizer
from distllm_tpu.resilience import EngineOverloaded as JaxEngineOverloaded
from distllm_tpu_torch import distributed_generation as port_job
from distllm_tpu_torch.generate import (
    get_generator,
    get_prompt_template,
    get_reader,
    get_writer,
)
from distllm_tpu_torch.generate.generators import FakeGenerator, TorchGenerator
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.resilience import EngineOverloaded

EXAMPLE = Path(__file__).resolve().parents[1] / 'examples' / 'generate' / 'question_chunk.fake.local.yaml'
TINY = {
    'vocab_size': 96, 'hidden_size': 32, 'num_layers': 2, 'num_heads': 4,
    'num_kv_heads': 2, 'intermediate_size': 64, 'dtype': 'float32',
}

TEXTS = [
    'Proteins fold into shapes. Why do they fold? Nobody knows for sure.',
    'Dr. Smith measured 3.5 mg. of the sample... then what? It grew.',
    'No question here at all.',
    'What binds ATP? Kinases do. Is that all?',
]
RESPONSES = [
    'What drives folding? It is entropy.',
    'It is the U.S. dept. of energy. Why is that?',
    'no question mark',
    '1. Option A.',
    '2. The answer',
    'Yes.',
    '',
    '\n  Question: What does P1 do?\nA) binds B) cuts C) folds D) glows\nAnswer: B)',
    'Question: missing newline A) x B) y',
    '\nQuestion: no options here',
    '\nquestion: Which? A) one B) two C) three D) four Answer: D) extra words',
]
CONTEXTS = [['ctx a', 'ctx b'], ['only one'], [], ['x', 'y', 'z']]
SCORES = [[0.9, 0.5], [0.25], [], [1.0, -0.5, 0.123456789]]


def _template_kwargs(tmp_path):
    keyword_file = tmp_path / 'keywords.txt'
    keyword_file.write_text('radiation\nDNA repair\ndosimetry\n')
    return [
        {'name': 'identity'},
        {'name': 'question_chunk'},
        {'name': 'question_answer'},
        {'name': 'keyword_selection', 'keywords': ['alpha', 'beta']},
        {'name': 'keyword_selection', 'keywords': str(keyword_file)},
        {'name': 'amp_question'},
    ]


def test_every_prompt_template_gives_the_jax_strings(tmp_path):
    amp_texts = [json.dumps({'Protein_Name': f'P{i}', 'Function': t}) for i, t in enumerate(TEXTS)]
    for kwargs in _template_kwargs(tmp_path):
        port, ref = get_prompt_template(kwargs), jax_prompt(kwargs)
        texts = amp_texts if kwargs['name'] == 'amp_question' else TEXTS
        assert port.preprocess(texts) == ref.preprocess(texts), kwargs
        assert port.preprocess(texts[0]) == ref.preprocess(texts[0]), kwargs
        assert port.preprocess(texts, CONTEXTS, SCORES) == ref.preprocess(
            texts, CONTEXTS, SCORES), kwargs
        assert port.postprocess(list(RESPONSES)) == ref.postprocess(list(RESPONSES)), kwargs
    qa = get_prompt_template({'name': 'question_answer'})
    assert qa.postprocess(['1. Option A.', 'Maybe.']) == ['option a', 'maybe']
    with pytest.raises(ValueError, match='prompt template'):
        get_prompt_template({'name': 'nope'})


def test_readers_read_what_jax_reads(tmp_path):
    from datasets import Dataset

    jsonl = tmp_path / 'in.jsonl'
    jsonl.write_text('\n'.join([
        json.dumps({'text': 'hello', 'path': 'p1'}), '',
        json.dumps({'text': 'world', 'doc': 'p2'}),
        json.dumps({'text': 'third', 'path': 7}),
    ]) + '\n')
    Dataset.from_dict({'text': ['a', 'b'], 'path': ['x', 'y']}).save_to_disk(str(tmp_path / 'ds'))
    Dataset.from_dict({'body': ['c', 'd']}).save_to_disk(str(tmp_path / 'ds2'))
    amp = tmp_path / 'amp.json'
    amp.write_text(json.dumps({
        'groupA': [{'Protein_Name': 'P1', 'Function': 'binds'}],
        'groupB': [{'Protein_Name': 'P2', 'Function': 'cuts'}, {'Protein_Name': 'P3'}],
    }))
    cases = [
        ({'name': 'jsonl'}, jsonl),
        ({'name': 'jsonl', 'path_field': 'doc'}, jsonl),
        ({'name': 'huggingface'}, tmp_path / 'ds'),
        ({'name': 'huggingface', 'text_field': 'body'}, tmp_path / 'ds2'),
        ({'name': 'amp_json'}, amp),
    ]
    for kwargs, path in cases:
        assert get_reader(kwargs).read(path) == jax_reader(kwargs).read(path), kwargs
    with pytest.raises(ValueError, match='reader'):
        get_reader({'name': 'csv'})


def _rows(path):
    from datasets import load_from_disk

    return load_from_disk(str(path)).to_dict()


def test_writers_write_what_jax_writes(tmp_path):
    paths, texts = ['p0', 'p1', 'p2'], ['t0', 't1', 't2']
    responses = ['r0', 'r1', 'r2']
    for pkg, make in (('jax', jax_writer), ('port', get_writer)):
        writer = make({'name': 'huggingface'})
        writer.write(tmp_path / pkg / 's0', paths, texts, responses)
        writer.write(tmp_path / pkg / 's1', paths[:1], texts[:1], responses[:1])
        (tmp_path / pkg / 'bad').mkdir()
        writer.merge([tmp_path / pkg / d for d in ('s0', 'bad', 's1')], tmp_path / pkg / 'merged')
    for name in ('s0', 's1', 'merged'):
        assert _rows(tmp_path / 'port' / name) == _rows(tmp_path / 'jax' / name)
    assert _rows(tmp_path / 'port' / 'merged')['response'] == ['r0', 'r1', 'r2', 'r0']
    # amp_jsonl: the entry JSON in paths, the parsed response merged in.
    entries = [json.dumps({'Protein_Name': f'P{i}', 'Function': 'f'}) for i in range(3)]
    parsed = [json.dumps({'correct_answer': f'a{i}', 'distractors': []}) for i in range(3)]
    for pkg, make in (('jax', jax_writer), ('port', get_writer)):
        writer = make({'name': 'amp_jsonl', 'base_name': 'amp'})
        writer.write(tmp_path / f'{pkg}_amp' / 'a', entries[:2], entries[:2], parsed[:2])
        writer.write(tmp_path / f'{pkg}_amp' / 'a', entries[2:], entries[2:], parsed[2:])
        writer.merge([tmp_path / f'{pkg}_amp' / 'a'], tmp_path / f'{pkg}_amp' / 'm')
    for rel in ('a/amp_0.jsonl', 'a/amp_1.jsonl', 'm/amp_merged.jsonl'):
        assert (tmp_path / 'port_amp' / rel).read_bytes() == (tmp_path / 'jax_amp' / rel).read_bytes()
    with pytest.raises(ValueError, match='no readable shards'):
        get_writer({'name': 'huggingface'}).merge([tmp_path / 'port' / 'bad'], tmp_path / 'x')


# ------------------------------------------------------------ generators
def test_generator_factory_names():
    fake = {'name': 'fake', 'response_template': 'echo {prompt}', 'max_prompt_chars': 5}
    port, ref = get_generator(fake), distllm_tpu.generate.get_generator(fake)
    assert isinstance(port, FakeGenerator)
    prompts = ['abcdefgh', 'xy']
    assert port.generate(prompts) == ref.generate(prompts) == ['echo abcde', 'echo xy']
    assert port.generate('single') == ref.generate('single')
    assert get_generator(fake, register=True) is get_generator(fake, register=True)
    # The network and transformers backends build as JAX's do (A11a);
    # each refuses a config JAX refuses (an openai key, a checkpoint path).
    for name in ('api', 'langchain', 'argo'):
        assert type(get_generator({'name': name})).__name__ == type(
            distllm_tpu.generate.get_generator({'name': name})).__name__
    for kwargs in ({'name': 'huggingface'}, {'name': 'openai', 'api_key': ''}):
        with pytest.raises(ValueError):
            get_generator(dict(kwargs))
        with pytest.raises(ValueError):
            distllm_tpu.generate.get_generator(dict(kwargs))
    with pytest.raises(ValueError, match='Unknown generator name'):
        get_generator({'name': 'nope'})
    with pytest.raises(ValueError, match='Unknown generator name'):
        distllm_tpu.generate.get_generator({'name': 'nope'})
    # A checkpoint path is read as the JAX generator reads it (a missing
    # directory fails alike, at tensor_parallel_size 2 too, before any rank
    # starts).
    ckpt = {'name': 'tpu', 'pretrained_model_name_or_path': '/nonexistent-checkpoint'}
    with pytest.raises(FileNotFoundError):
        get_generator({**ckpt, 'device': 'cpu'})
    with pytest.raises(FileNotFoundError):
        distllm_tpu.generate.get_generator(ckpt)
    with pytest.raises(FileNotFoundError):
        get_generator({**ckpt, 'tensor_parallel_size': 2, 'device': 'cpu'})
    # overload_every: every second call raises the engine's shed signal, as
    # the JAX FakeGenerator does.
    overload = {'name': 'fake', 'overload_every': 2}
    port, ref = get_generator(overload), distllm_tpu.generate.get_generator(overload)
    for _ in range(2):
        assert port.generate('p') == ref.generate('p')
        with pytest.raises(EngineOverloaded) as port_exc:
            port.generate('p')
        with pytest.raises(JaxEngineOverloaded) as ref_exc:
            ref.generate('p')
        assert port_exc.value.retry_after_s == ref_exc.value.retry_after_s == 3.0
        assert str(port_exc.value) == str(ref_exc.value)


@pytest.mark.parametrize('name', ['tpu', 'vllm', 'torch'])
def test_engine_names_build_the_torch_generator(name):
    kwargs = {'name': name, 'model': dict(TINY), 'temperature': 0.0, 'max_tokens': 3,
              'num_blocks': 16, 'max_num_seqs': 2, 'max_model_len': 64}
    generator = get_generator(kwargs, device='cpu')
    assert isinstance(generator, TorchGenerator)
    assert generator.engine.device == torch.device('cpu')
    assert len(generator.generate(['a b c', 'd e'])) == 2
    generator.shutdown()


# ------------------------------------------------------- the job, both
def _example_config(tmp_path, pkg, **overrides):
    raw = yaml.safe_load(EXAMPLE.read_text())
    raw['input_dir'] = str(tmp_path / 'inputs')
    raw['output_dir'] = str(tmp_path / pkg)
    raw.update(overrides)
    path = tmp_path / f'{pkg}.yaml'
    path.write_text(yaml.safe_dump(raw))
    return path


def _write_inputs(tmp_path, n_files=2):
    inputs = tmp_path / 'inputs'
    inputs.mkdir(exist_ok=True)
    rng = np.random.default_rng(7)
    for f in range(n_files):
        with open(inputs / f'chunks{f}.jsonl', 'w') as fh:
            for i in range(5):
                words = ' '.join(f'w{int(x)}' for x in rng.integers(0, 50, size=8))
                ending = '?' if (i + f) % 2 else '.'
                fh.write(json.dumps({'text': f'{words}{ending} More text', 'path': f'{f}-{i}'}) + '\n')
    (inputs / 'notes.txt').write_text('not matched by the glob')


def _shards(output_dir):
    """Every shard's rows, keyed by its first path (UUID names differ)."""
    shards = {}
    for shard in sorted((output_dir / 'generations').iterdir()):
        rows = _rows(shard)
        shards[rows['path'][0] if rows['path'] else shard.name] = rows
    return shards


def test_the_fake_example_runs_as_in_jax(tmp_path, capsys):
    _write_inputs(tmp_path)
    fake = {'name': 'fake', 'response_template': 'Why {prompt}? Fine.', 'max_prompt_chars': 12}
    jax_path = _example_config(tmp_path, 'jax', generator_config=fake)
    port_path = _example_config(tmp_path, 'port', generator_config=fake)
    assert jax_job.run_generation(jax_job.Config.from_yaml(jax_path)) == 0
    config = port_job.Config.from_yaml(port_path)
    assert port_job.run_generation(config, device='cpu') == 0
    jax_out, port_out = _shards(tmp_path / 'jax'), _shards(tmp_path / 'port')
    assert len(port_out) == len(jax_out) == 2
    assert port_out == jax_out
    out = capsys.readouterr().out
    for tag in ('loaded-generator', 'read-input', 'generated-responses', 'wrote-responses'):
        assert sum(line.startswith(f'[timer] tags={tag},chunks') for line in out.splitlines()) == 4
    # The audit copy is JSON, which both packages read as YAML.
    audit = tmp_path / 'port' / 'config.yaml'
    assert port_job.Config.from_yaml(audit) == config
    assert jax_job.Config.from_yaml(audit).generator_config == config.generator_config
    # The clobber guard: a second run into the same output_dir is refused.
    assert port_job.run_generation(config, device='cpu') == 1
    assert jax_job.run_generation(jax_job.Config.from_yaml(jax_path)) == 1
    assert len(_shards(tmp_path / 'port')) == 2


def test_the_example_yaml_itself_loads_in_both():
    raw = yaml.safe_load(EXAMPLE.read_text())
    port = port_job.Config(**raw)
    assert port.generator_config == jax_job.Config(**raw).generator_config
    assert port.glob_patterns == ['*.jsonl'] and port.compute_config == {'name': 'local'}
    # The pod configs are ported (ROADMAP A11b): a slurm config without
    # account and queue is refused as the JAX config refuses it.
    with pytest.raises(ValueError):
        jax_job.Config(**{**raw, 'compute_config': {'name': 'slurm'}})
    with pytest.raises(ValueError, match='missing keys'):
        port_job.Config(**{**raw, 'compute_config': {'name': 'slurm'}})
    slurm = {'name': 'slurm', 'account': 'a', 'queue': 'q'}
    assert port_job.Config(**{**raw, 'compute_config': slurm}).compute_config == slurm
    no_match = port_job.Config(**{**raw, 'glob_patterns': ['*.none']})
    assert no_match.glob_patterns == ['*.none']


class _JaxEngineGenerator:
    """The JAX engine over the port's weights, behind the generator API."""

    def __init__(self, tree, max_tokens):
        jcfg = jax_mistral.MistralConfig(**TINY)
        self.engine = JaxLLMEngine(
            jcfg, tree, JaxWhitespaceTokenizer(vocab_size=TINY['vocab_size'], model_max_length=64),
            JaxEngineConfig(num_blocks=64, block_size=16, max_num_seqs=3, max_model_len=64,
                            attn_backend='xla', prefer_native_allocator=False),
        )
        self.max_tokens = max_tokens

    def generate(self, prompts):
        return self.engine.generate(
            prompts, JaxSamplingParams(temperature=0.0, max_tokens=self.max_tokens))


def test_greedy_tpu_generation_matches_jax(tmp_path, monkeypatch):
    _write_inputs(tmp_path, n_files=2)
    generator = {'name': 'tpu', 'model': dict(TINY), 'temperature': 0.0, 'max_tokens': 6,
                 'num_blocks': 64, 'max_num_seqs': 3, 'max_model_len': 64, 'seed': 0}
    common = dict(prompt_config={'name': 'identity'}, generator_config=generator)
    port_config = port_job.Config.from_yaml(_example_config(tmp_path, 'port', **common))
    assert port_job.run_generation(port_config, device='cpu') == 0
    # The same weights: the port's seeded init, handed to the JAX engine.
    params = mistral.init(mistral.MistralConfig(**TINY), torch.Generator().manual_seed(0),
                          device='cpu')
    tree = _to_numpy(params)
    jax_generator = _JaxEngineGenerator(tree, max_tokens=6)
    monkeypatch.setattr(distllm_tpu.generate, 'get_generator',
                        lambda kwargs, register=False: jax_generator, raising=False)
    jax_config = jax_job.Config.from_yaml(_example_config(tmp_path, 'jax', **common))
    assert jax_job.run_generation(jax_config) == 0
    port_out, jax_out = _shards(tmp_path / 'port'), _shards(tmp_path / 'jax')
    assert port_out == jax_out and len(port_out) == 2
    responses = [r for rows in port_out.values() for r in rows['response']]
    assert len(responses) == 10 and all(len(r.split()) == 6 for r in responses)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def test_the_job_refuses_what_jax_refuses(tmp_path):
    _write_inputs(tmp_path)
    config = port_job.Config.from_yaml(_example_config(tmp_path, 'port'))
    shutil.rmtree(tmp_path / 'inputs')
    (tmp_path / 'inputs').mkdir()
    assert port_job.run_generation(config, device='cpu') == 1  # no file matched
    with pytest.raises(TypeError):
        port_job.Config(input_dir='a', output_dir='b')
