"""The port's RAG layer against ``distllm_tpu.rag`` and ``distllm_tpu.chat``.

- ``RagGenerator`` with and without a retriever (a tiny BERT checkpoint
  over an embeddings dataset, both written from a seed): the prompts the
  generator receives and the postprocessed answers are the JAX strings.
- Every task (``litqa``, ``pubmedqa``, ``sciq``, ``protein_function_qa``,
  ``protein_interaction_qa``) renders the same questions from a local
  data file (``curl_download`` patched to fail in both packages) and
  scores the same accuracy and precision, abstentions included.
- ``run_eval_suite`` on ``examples/evaluate/eval.fake.local.yaml`` with a
  local pubmedqa file, and with a retriever added: the same results and
  the same results file.
- The chat app: ``examples/chat/chat.fake.yaml`` builds its ``fake``
  backend through the factory and answers as the JAX session does; a
  session with a retriever renders the JAX prompt; the chat server
  retrieves on the latest user message with the body's ``top_k`` and
  ``score_threshold`` (the config's by default); the retriever keys of
  ``examples/chat/chat_server.rag.yaml`` are refused in both packages.
"""

import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import yaml

import distllm_tpu.rag.tasks.litqa
import distllm_tpu.rag.tasks.protein_qa
import distllm_tpu.rag.tasks.pubmedqa
import distllm_tpu.rag.tasks.sciq
from distllm_tpu import chat as jax_chat
from distllm_tpu.rag import evaluate as jax_evaluate
from distllm_tpu.rag import search as jsearch
from distllm_tpu.rag.response_synthesizer import RagGenerator as JaxRagGenerator
from distllm_tpu.rag.tasks import get_task as jax_get_task
from distllm_tpu_torch import chat as port_chat
from distllm_tpu_torch.chat_server import ChatServer, load_app
from distllm_tpu_torch.generate import get_prompt_template
from distllm_tpu_torch.generate.generators import FakeGenerator
from distllm_tpu_torch.rag import evaluate as port_evaluate
from distllm_tpu_torch.rag import search as tsearch
from distllm_tpu_torch.rag.response_synthesizer import RagGenerator
from distllm_tpu_torch.rag.tasks import TASKS, get_task
from distllm_tpu_torch.rag.tasks import base as port_base
from distllm_tpu_torch.rag.tasks import litqa as port_litqa
from test_torch_search import _bert_checkpoint, _rows, _save, retriever_config

ROOT = Path(__file__).resolve().parents[1]
EVAL_YAML = ROOT / 'examples' / 'evaluate' / 'eval.fake.local.yaml'
CHAT_YAML = ROOT / 'examples' / 'chat' / 'chat.fake.yaml'
RAG_YAML = ROOT / 'examples' / 'chat' / 'chat_server.rag.yaml'
TASK_MODULES = {
    'litqa': 'litqa', 'pubmedqa': 'pubmedqa', 'sciq': 'sciq',
    'protein_function_qa': 'protein_qa', 'protein_interaction_qa': 'protein_qa',
}


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('rag')
    emb, texts = _rows(n=160, seed=11)
    return {
        'dataset': _save(root / 'ds', emb, texts),
        'checkpoint': _bert_checkpoint(root),
        'texts': texts,
    }


@pytest.fixture(autouse=True)
def no_downloads(monkeypatch):
    """A download attempt fails in both packages: every data file is local."""
    def refuse(url, output_path, timeout=600):
        if Path(output_path).exists():
            return Path(output_path)
        raise AssertionError(f'download attempted: {url}')

    import distllm_tpu_torch.rag.tasks as port_tasks
    for name in set(TASK_MODULES.values()):
        monkeypatch.setattr(getattr(port_tasks, name), 'curl_download', refuse)
        monkeypatch.setattr(getattr(distllm_tpu.rag.tasks, name), 'curl_download', refuse)


class Recorder:
    """A generator that keeps its prompts and answers from a list."""

    def __init__(self, answers):
        self.answers = list(answers)
        self.prompts = []

    def generate(self, prompts):
        self.prompts.extend(prompts)
        return [self.answers[i % len(self.answers)] for i in range(len(prompts))]


QUERIES = ['w1 w2 w3', 'w40 w41', 'w7 w8 w9 w10 w11 w12', 'w150']
ANSWERS = ['1. Yes.', 'I cannot answer.', 'maybe', 'No']


@pytest.mark.parametrize('with_retriever', [False, True], ids=['baseline', 'retriever'])
def test_rag_generator_prompts_match_jax(corpus, with_retriever):
    jret = tret = None
    if with_retriever:
        # The ubinary tier rescores on the host in numpy, and both retrievers
        # search with the JAX query embeddings: scores bitwise equal, so
        # their printed digits in the prompt are too (the encoders agree
        # within 1e-5, test_torch_search.py).
        raw = retriever_config(corpus['checkpoint'], corpus['dataset'], 'ubinary')
        jret = jsearch.RetrieverConfig(**raw).get_retriever()
        tret = tsearch.RetrieverConfig.from_dict(raw).get_retriever(device='cpu')
        np.testing.assert_allclose(tret.get_pooled_embeddings(QUERIES),
                                   jret.get_pooled_embeddings(QUERIES), atol=1e-5)
        tret.get_pooled_embeddings = jret.get_pooled_embeddings
    jrec, trec = Recorder(ANSWERS), Recorder(ANSWERS)
    template = {'name': 'question_answer'}
    from distllm_tpu.generate import get_prompt_template as jax_prompt

    want = JaxRagGenerator(jrec, jret).generate(
        QUERIES, jax_prompt(template), retrieval_top_k=3, retrieval_score_threshold=-1.0)
    got = RagGenerator(trec, tret).generate(
        QUERIES, get_prompt_template(template), retrieval_top_k=3,
        retrieval_score_threshold=-1.0)
    assert got == want == ['yes', 'i cannot answer', 'maybe', 'no']
    assert trec.prompts == jrec.prompts
    assert ('Context (with relevance scores)' in trec.prompts[0]) is with_retriever
    # A single text and the identity template by default.
    assert RagGenerator(Recorder(['x.'])).generate('q') == ['x.']


def _task_files(root):
    """A small data file per task, in the JAX tasks' formats."""
    qa = [
        {'id': str(i), 'question': f'Which protein {i} binds',
         'ideal': f'Kinase {i}', 'distractors': [f'D{i}a', f'D{i}b', f'D{i}c', f'D{i}d'][: 1 + i % 4],
         'sources': 'doi' if i % 2 else ['a', 'b']}
        for i in range(6)
    ]
    qa.append({'question': 'Long?', 'ideal': ' '.join(['word'] * 201), 'distractors': ['x']})
    pubmed = {
        str(100 + i): {'QUESTION': f'Does drug {i} help', 'CONTEXTS': [f'c{i}', f'd{i}'],
                       'final_decision': ['yes', 'no', 'maybe'][i % 3], 'LABELS': ['X']}
        for i in range(6)
    }
    sciq = [
        {'question': f'What is {i}?', 'distractor1': 'a', 'distractor2': 'b',
         'distractor3': 'c', 'correct_answer': f'Answer {i}', 'support': 's', 'extra': 1}
        for i in range(5)
    ]
    files = {
        'litqa': ('litqa.jsonl', '\n'.join(json.dumps(e) for e in qa)),
        'pubmedqa': ('pubmedQA.json', json.dumps(pubmed)),
        'sciq': ('sciq.json', json.dumps(sciq)),
        'protein_function_qa': ('functionQA.jsonl', '\n'.join(json.dumps(e) for e in qa)),
        'protein_interaction_qa': ('interactionQA.json', json.dumps(qa)),
    }
    for task, (name, text) in files.items():
        (root / task).mkdir(parents=True, exist_ok=True)
        (root / task / name).write_text(text)
    return root


@pytest.mark.parametrize('task_name', sorted(TASK_MODULES))
def test_every_task_renders_and_scores_as_jax(tmp_path, task_name):
    root = _task_files(tmp_path / 'downloads')
    port_task, jax_task = get_task(task_name, root), jax_get_task(task_name, root)
    port_task.download()
    jax_task.download()
    assert port_task.load_data() == jax_task.load_data()
    questions, truths = port_task.load_data()
    answers = [t.upper() + '.' if i % 3 == 0 else ('I cannot answer.' if i % 3 == 1 else 'wrong')
               for i, t in enumerate(truths)]
    got = port_task.evaluate(RagGenerator(Recorder(answers)))
    want = jax_task.evaluate(JaxRagGenerator(Recorder(answers)))
    assert got == want
    assert 0.0 < got['accuracy'] < got['precision'] <= 1.0


def test_metrics_and_normalization():
    assert port_base.ABSTAIN_ANSWER == 'I cannot answer.'
    assert port_base._normalize_answer('  I Cannot Answer. ') == 'i cannot answer'
    task = TASKS['sciq']
    truths, preds = ['a', 'b', 'c', 'd'], ['a', 'i cannot answer', 'c', 'x']
    assert task.compute_accuracy(truths, preds) == 0.5
    assert task.compute_precision(task, truths, preds) == pytest.approx(2 / 3)
    assert task.compute_accuracy([], []) == 0.0
    with pytest.raises(ValueError, match='Unknown task'):
        get_task('mmlu', Path('.'))
    with pytest.raises(ValueError, match='missing field'):
        port_litqa.QuestionAnswerEntry.from_dict({'question': 'q'})


def _eval_yaml(tmp_path, pkg, rag_configs=None):
    raw = yaml.safe_load(EVAL_YAML.read_text())
    raw['download_dir'] = str(tmp_path / 'downloads')
    raw['output_path'] = str(tmp_path / pkg / 'results.json')
    if rag_configs is not None:
        raw['rag_configs'] = rag_configs
    path = tmp_path / f'{pkg}.yaml'
    path.write_text(yaml.safe_dump(raw))
    return path


def test_eval_suite_on_the_example_yaml(tmp_path):
    _task_files(tmp_path / 'downloads')
    want = jax_evaluate.run_eval_suite(
        jax_evaluate.EvalSuiteConfig.from_yaml(_eval_yaml(tmp_path, 'jax')))
    got = port_evaluate.run_eval_suite(
        port_evaluate.EvalSuiteConfig.from_yaml(_eval_yaml(tmp_path, 'port')), device='cpu')
    assert got == want and set(got) == {'model_0'} and 'pubmedqa' in got['model_0']
    assert (tmp_path / 'port' / 'results.json').read_text() == (
        tmp_path / 'jax' / 'results.json').read_text()


def test_eval_suite_with_a_retriever(tmp_path, corpus):
    _task_files(tmp_path / 'downloads')
    rag = [
        {'generator_config': {'name': 'fake', 'response_template': 'I cannot answer.'}},
        {'generator_config': {'name': 'fake', 'response_template': 'maybe'},
         'retriever_config': retriever_config(corpus['checkpoint'], corpus['dataset']),
         'retrieval_top_k': 2},
    ]
    want = jax_evaluate.run_eval_suite(
        jax_evaluate.EvalSuiteConfig.from_yaml(_eval_yaml(tmp_path, 'jax', rag)))
    got = port_evaluate.run_eval_suite(
        port_evaluate.EvalSuiteConfig.from_yaml(_eval_yaml(tmp_path, 'port', rag)), device='cpu')
    assert got == want and got['model_0'] != got['model_1']


# ------------------------------------------------------------- the chat app
def test_the_fake_chat_yaml_builds_through_the_factory(tmp_path):
    raw = yaml.safe_load(CHAT_YAML.read_text())
    raw['transcript_dir'] = str(tmp_path / 'transcripts')
    port = port_chat.ChatSession(port_chat.ChatAppConfig.from_dict(raw), device='cpu')
    ref = jax_chat.ChatSession(jax_chat.ChatAppConfig(**raw))
    assert isinstance(port.generator, FakeGenerator) and port.retriever is None
    for message in ('hello there', 'and a second turn'):
        assert port.ask(message) == ref.ask(message)
    assert port.history == ref.history and port.inspect('x') == []
    assert json.loads(port.save_transcript().read_text()) == port.history
    lines = []
    inputs = iter(['hi', '', 'quit'])
    port_chat.chat_with_model(port_chat.ChatAppConfig.from_dict(raw),
                              input_fn=lambda _: next(inputs), echo=lines.append, device='cpu')
    assert lines[-1] == 'bye' and lines[1].startswith('assistant> echo: ')


def _rag_app(corpus, **extra):
    return {
        'generator_config': {'name': 'fake', 'response_template': '{prompt}',
                             'max_prompt_chars': 100000},
        'retriever_config': retriever_config(corpus['checkpoint'], corpus['dataset']),
        'system_prompt': 'Use the context.', 'retrieval_top_k': 4,
        'retrieval_score_threshold': -1.0, **extra,
    }


def test_a_session_retrieves_on_the_latest_message(corpus):
    raw = _rag_app(corpus)
    port = port_chat.ChatSession(port_chat.ChatAppConfig.from_dict(raw), device='cpu')
    ref = jax_chat.ChatSession(jax_chat.ChatAppConfig(**raw))
    for turn, message in enumerate((corpus['texts'][3], 'w5 w6 w7')):
        got, want = port.ask(message), ref.ask(message)
        # The echoed first answer carries the first turn's 4 contexts on.
        assert got == want and got.count('- (score ') == 4 * (turn + 1)
    got, want = port.inspect('w9'), ref.inspect('w9')
    assert [h['index'] for h in got] == [h['index'] for h in want]
    assert [h['text'] for h in got] == [h['text'] for h in want]


def _post(port, body):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}/v1/chat/completions', data=json.dumps(body).encode(),
        headers={'Content-Type': 'application/json'},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_the_chat_server_answers_with_retrieval(tmp_path, corpus):
    raw = _rag_app(corpus, retrieval_top_k=3, retrieval_score_threshold=0.05)
    (tmp_path / 'app.yaml').write_text(yaml.safe_dump(raw))
    app = load_app(str(tmp_path / 'app.yaml'))
    generator, retriever = app.build_generator(device='cpu'), app.build_retriever(device='cpu')
    jret = jsearch.RetrieverConfig(**raw['retriever_config']).get_retriever()
    template = jax_chat.ConversationPromptTemplate('Use the context.')
    messages = [{'role': 'user', 'content': 'first question'},
                {'role': 'assistant', 'content': 'first answer'},
                {'role': 'user', 'content': corpus['texts'][9]}]
    with ChatServer(generator, system_prompt=app.system_prompt, retriever=retriever,
                    retrieval_top_k=app.retrieval_top_k,
                    retrieval_score_threshold=app.retrieval_score_threshold) as server:
        for body, top_k, threshold in (({}, 3, 0.05),
                                       ({'top_k': 5, 'score_threshold': -1.0}, 5, -1.0)):
            status, payload = _post(server.port, {'messages': messages, **body})
            assert status == 200
            results, _ = jret.search(corpus['texts'][9], top_k=top_k, score_threshold=threshold)
            contexts = jret.get_texts(results.total_indices[0])
            want = template.render(messages, contexts, results.total_scores[0])
            assert payload['choices'][0]['message']['content'] == want
        assert [t['contexts'] for t in server.timings] == [
            len(jret.search(corpus['texts'][9], top_k=3, score_threshold=0.05)[0]
                .total_indices[0]), 5]


def test_the_rag_example_yaml_is_refused_in_both():
    raw = yaml.safe_load(RAG_YAML.read_text())
    with pytest.raises(ValueError):
        jax_chat.ChatAppConfig(**raw).build_retriever()
    with pytest.raises(ValueError, match='RetrieverConfig'):
        load_app(str(RAG_YAML))
    # The http backend needs its base_url in both packages.
    with pytest.raises(TypeError):
        jax_chat.ChatAppConfig(generator_config={'name': 'http'}).build_generator()
    with pytest.raises(TypeError):
        port_chat.ChatAppConfig.from_dict({'generator_config': {'name': 'http'}}).build_generator()
