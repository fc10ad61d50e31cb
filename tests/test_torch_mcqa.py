"""The port's MCQA harness against ``distllm_tpu.mcqa``.

- The 13 tests of ``tests/test_mcqa.py``, each run on both packages with
  the same inputs (batching, the grader's ladder, checkpoints, the
  servers registry, chunk ids, question loading, ``run_mcqa`` over a stub
  endpoint and its resume).
- The three YAMLs under ``examples/mcqa/`` load as equal configs with
  equal endpoints; bad configs are refused by both.
- Checkpoints resume across the packages in both directions.
- ``run_mcqa`` against one stub endpoint gives the same results file and
  summary in both packages (timing fields aside); ``retrieval_metrics``
  and ``prefix_hint`` batching agree.
- One ``LocalServerManager`` boot of the port's chat server on the CPU
  over a tiny fp32 checkpoint: its greedy answers equal the JAX engine's
  on the same checkpoint, and the process exits at ``stop()``.
"""

import json
import re
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest
import yaml

import distllm_tpu.mcqa.batching as jax_batching
import distllm_tpu.mcqa.checkpoint as jax_checkpoint
import distllm_tpu.mcqa.config as jax_config
import distllm_tpu.mcqa.grading as jax_grading
import distllm_tpu.mcqa.harness as jax_harness
import distllm_tpu_torch.mcqa.batching as port_batching
import distllm_tpu_torch.mcqa.checkpoint as port_checkpoint
import distllm_tpu_torch.mcqa.config as port_config
import distllm_tpu_torch.mcqa.grading as port_grading
import distllm_tpu_torch.mcqa.harness as port_harness
from test_torch_api_backends import local_only

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / 'examples' / 'mcqa'
PACKAGES = {
    'jax': (jax_batching, jax_checkpoint, jax_config, jax_grading, jax_harness),
    'port': (port_batching, port_checkpoint, port_config, port_grading, port_harness),
}
# Summary fields that depend on timing, not on the results.
TIMING = ('elapsed_s', 'throughput_qps', 'batches_sent')


@pytest.fixture(params=['jax', 'port'])
def pkg(request):
    batching, checkpoint, config, grading, harness = PACKAGES[request.param]
    return type('Pkg', (), dict(
        BatchingClient=batching.BatchingClient,
        CheckpointManager=checkpoint.CheckpointManager,
        MCQAConfig=config.MCQAConfig,
        load_model_servers=config.load_model_servers,
        GraderAuthError=grading.GraderAuthError,
        grade_answer=grading.grade_answer,
        parse_grader_json=grading.parse_grader_json,
        chunk_id=harness.chunk_id,
        load_questions=harness.load_questions,
        run_mcqa=harness.run_mcqa,
        make_config=staticmethod(
            (lambda **kw: config.MCQAConfig(**kw)) if request.param == 'jax'
            else (lambda **kw: config.MCQAConfig.from_dict(kw))),
    ))


# ------------------------------------------------ twins of tests/test_mcqa.py
def test_batching_client_batches_requests(pkg):
    batches = []

    def send(prompts):
        batches.append(list(prompts))
        return [f'r:{p}' for p in prompts]

    client = pkg.BatchingClient(send, batch_size=4, batch_timeout=0.2)
    results = {}

    def worker(i):
        results[i] = client.generate(f'p{i}', timeout=10)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    client.close()
    assert {results[i] for i in range(8)} == {f'r:p{i}' for i in range(8)}
    assert len(batches) <= 4
    assert any(len(b) > 1 for b in batches)


def test_batching_client_propagates_errors(pkg):
    def send(prompts):
        raise ConnectionError('backend down')

    client = pkg.BatchingClient(send, batch_size=2, batch_timeout=0.05)
    with pytest.raises(ConnectionError):
        client.generate('x', timeout=5)
    client.close()


def test_parse_grader_json(pkg):
    assert pkg.parse_grader_json('{"correct": true}')['correct'] is True
    assert pkg.parse_grader_json('blah {"correct": false, "reason": "no"} end')['reason'] == 'no'
    assert pkg.parse_grader_json('not json') is None
    assert pkg.parse_grader_json('{"correct": "yes"}') is None
    assert pkg.parse_grader_json('{"x": {"correct": true}} {"correct": false} }') == {
        'correct': True}  # the first object with a boolean 'correct', nested or not


def test_grade_answer_ladder_escalates(pkg):
    calls = []

    def grader(prompt):
        calls.append(prompt)
        if len(calls) < 2:
            return 'I think the answer is correct!'
        return '{"correct": true, "reason": "matches"}'

    verdict = pkg.grade_answer(grader, 'Q', 'ref', 'ans', max_tries_per_level=1)
    assert verdict['correct'] is True
    assert verdict['ladder_level'] == 1
    assert 'ONLY a JSON object' in calls[1]


def test_grade_answer_auth_gives_up(pkg):
    def grader(prompt):
        raise pkg.GraderAuthError('bad key')

    with pytest.raises(pkg.GraderAuthError):
        pkg.grade_answer(grader, 'Q', 'ref', 'ans')


def test_grade_answer_all_levels_fail(pkg):
    def grader(prompt):
        return 'gibberish'

    with pytest.raises(RuntimeError, match='no parseable JSON'):
        pkg.grade_answer(grader, 'Q', 'ref', 'ans', max_tries_per_level=1)


def test_checkpoint_save_resume(pkg, tmp_path):
    meta = {'model': 'm1', 'questions_file': 'q.json'}
    ckpt = pkg.CheckpointManager(tmp_path, meta, every=2)
    ckpt.record(0, {'correct': True})
    ckpt.record(1, {'correct': False})
    ckpt.record(2, {'correct': True})
    ckpt.save()
    fresh = pkg.CheckpointManager(tmp_path, meta, every=2)
    assert fresh.try_resume() == 3
    assert fresh.completed_indices == {0, 1, 2}


def test_checkpoint_rejects_mismatched_model(pkg, tmp_path):
    ckpt = pkg.CheckpointManager(tmp_path, {'model': 'm1', 'questions_file': 'q'}, every=1)
    ckpt.record(0, {'correct': True})
    other = pkg.CheckpointManager(tmp_path, {'model': 'OTHER', 'questions_file': 'q'})
    assert other.try_resume() == 0


def test_checkpoint_incremental(pkg, tmp_path):
    ckpt = pkg.CheckpointManager(tmp_path, {}, every=100, save_incremental=True)
    ckpt.record(0, {'correct': True})
    assert pkg.CheckpointManager.find_latest(tmp_path) is not None


def test_model_servers_registry(pkg, tmp_path):
    f = tmp_path / 'servers.yaml'
    f.write_text(
        'servers:\n'
        '  - shortname: llama\n'
        '    openai_api_base: http://h1:8000/v1\n'
        '    openai_model: meta/llama\n'
        '  - shortname: grader\n'
        '    openai_api_base: http://h2:8000/v1\n'
        '    openai_model: gpt-x\n'
        '    openai_api_key: sk-test\n'
    )
    registry = pkg.load_model_servers(f)
    assert registry['llama'].openai_api_base == 'http://h1:8000/v1'
    assert registry['grader'].openai_api_key == 'sk-test'


def test_chunk_id_stable(pkg):
    assert pkg.chunk_id('doc.pdf', 3) == pkg.chunk_id('doc.pdf', 3)
    assert pkg.chunk_id('doc.pdf', 3) != pkg.chunk_id('doc.pdf', 4)
    assert pkg.chunk_id('doc.pdf', 3).endswith('_0003')
    assert pkg.chunk_id('doc.pdf', 3) == jax_harness.chunk_id('doc.pdf', 3)


def test_load_questions(pkg, tmp_path):
    f = tmp_path / 'q.json'
    f.write_text(json.dumps([{'question': 'Q1?', 'answer': 'A'}]))
    assert pkg.load_questions(f)[0]['question'] == 'Q1?'
    jl = tmp_path / 'q.jsonl'
    jl.write_text('{"question": "Q2?", "answer": "B"}\n\n')
    assert pkg.load_questions(jl) == jax_harness.load_questions(jl)
    bad = tmp_path / 'bad.json'
    bad.write_text(json.dumps([{'question': 'no answer field'}]))
    with pytest.raises(ValueError):
        pkg.load_questions(bad)


class GraderStub:
    """OpenAI-compatible stub: the model answers 'paris' to everything; the
    grader says 'correct' when the model's answer holds the reference."""

    def __init__(self, model_answer='paris'):
        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers['Content-Length'])))
                prompt = body['messages'][0]['content']
                if ('grading a multiple-choice answer' in prompt or 'Grade the answer' in prompt
                        or 'minified JSON' in prompt):
                    ref = re.search(r'Reference(?: answer)?: (.*)', prompt).group(1)
                    ans = re.search(r'(?:Model answer|Answer): (.*)', prompt).group(1)
                    content = json.dumps({'correct': ref.strip().lower() in ans.strip().lower()})
                else:
                    content = model_answer
                data = json.dumps({'choices': [{'message': {
                    'role': 'assistant', 'content': content}}]}).encode()
                self.send_response(200)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(('127.0.0.1', 0), Handler)
        self.base = f'http://127.0.0.1:{self.server.server_address[1]}/v1'
        threading.Thread(target=self.server.serve_forever, args=(0.05,), daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def stub_openai_server(monkeypatch):
    local_only(monkeypatch)
    stub = GraderStub()
    yield stub.base
    stub.close()


QUESTIONS = [
    {'question': 'Capital of France?\n1. paris\n2. rome', 'answer': 'paris'},
    {'question': 'Capital of Italy?\n1. paris\n2. rome', 'answer': 'rome'},
]


def test_run_mcqa_end_to_end(pkg, tmp_path, stub_openai_server):
    qfile = tmp_path / 'questions.json'
    qfile.write_text(json.dumps(QUESTIONS))
    config = pkg.make_config(
        questions_file=qfile, output_dir=tmp_path / 'out', model_api_base=stub_openai_server,
        model_name='stub', grader_api_base=stub_openai_server, grader_model='stub-grader',
        parallel_workers=2, batch_size=2, batch_timeout=0.1, checkpoint_every=1,
    )
    summary = pkg.run_mcqa(config)
    assert summary['graded'] == 2
    assert summary['correct'] == 1
    assert summary['accuracy'] == 0.5
    results = json.loads((tmp_path / 'out' / 'results.json').read_text())
    assert results['summary']['model'] == 'stub'
    incorrect = json.loads((tmp_path / 'out' / 'incorrect_answers.json').read_text())
    assert len(incorrect) == 1
    summary2 = pkg.run_mcqa(config)
    assert summary2['graded'] == 2


# ------------------------------------------------------- configs and files
def _jax_dump(config):
    return json.loads(config.model_dump_json())


@pytest.mark.parametrize('name', ['mcqa.local.yaml', 'mcqa.boot-local-engine.yaml'])
def test_example_yamls_load_alike(name, monkeypatch):
    monkeypatch.chdir(REPO)  # model_servers_file is relative to the repo
    monkeypatch.setenv('OPENAI_API_KEY', 'sk-from-env')
    ref = jax_config.MCQAConfig.from_yaml(EXAMPLES / name)
    port = port_config.MCQAConfig.from_yaml(EXAMPLES / name)
    assert port.to_dict() == _jax_dump(ref)
    assert port.resolve_model_endpoint() == ref.resolve_model_endpoint()
    assert port.resolve_grader_endpoint() == ref.resolve_grader_endpoint()
    assert type(port.vllm_args).__name__ == 'VllmArgs'


def test_model_servers_example_loads_alike():
    ref = jax_config.load_model_servers(EXAMPLES / 'model_servers.yaml')
    port = port_config.load_model_servers(EXAMPLES / 'model_servers.yaml')
    assert sorted(port) == sorted(ref) == ['gpt-4o', 'grader', 'local-tpu']
    for key in ref:
        assert port[key].to_dict() == _jax_dump(ref[key])
    assert port['gpt-4o'].openai_api_key == '${env:OPENAI_API_KEY}'  # read as it is


@pytest.mark.parametrize('fields', [
    {},  # questions_file missing
    {'questions_file': 'q.json', 'vllm_args': {'max_model_len': 'long'}},
    {'questions_file': 'q.json', 'vllm_args': {'nope': 1}},
    {'questions_file': 'q.json', 'batch_size': 2.5},
    {'questions_file': 'q.json', 'resume': 'perhaps'},
    {'questions_file': 'q.json', 'model_name': 3},
    {'questions_file': 'q.json', 'retriever_config': 'x'},
    {'questions_file': 'q.json', 'grader_modle': 'typo'},
], ids=['missing', 'vllm_int', 'vllm_extra', 'frac', 'bool', 'str', 'retriever', 'extra'])
def test_bad_configs_are_refused_alike(fields):
    with pytest.raises(ValueError):
        jax_config.MCQAConfig(**fields)
    with pytest.raises(ValueError):
        port_config.MCQAConfig.from_dict(fields)


def test_lax_fields_read_alike():
    fields = {'questions_file': 'q.json', 'batch_size': '4', 'resume': 'no',
              'batch_timeout': 1, 'checkpoint_every': 3.0, 'vllm_args': {'num_blocks': '64'}}
    assert port_config.MCQAConfig.from_dict(fields).to_dict() == _jax_dump(
        jax_config.MCQAConfig(**fields))


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    meta = {'model': 'm', 'questions_file': 'q.json'}
    write_pkg, read_pkg = (jax_checkpoint, port_checkpoint) if writer == 'jax' else (
        port_checkpoint, jax_checkpoint)
    ckpt = write_pkg.CheckpointManager(tmp_path, meta, every=2)
    for i in range(5):
        ckpt.record(i, {'entry': {'question': f'q{i}'}, 'correct': i % 2 == 0, 'answer': 'x'})
    ckpt.save()
    reader = read_pkg.CheckpointManager(tmp_path, meta)
    assert reader.try_resume() == 5
    assert reader.results == ckpt.results
    assert len(list(tmp_path.glob('checkpoint_*.json'))) <= 3
    assert read_pkg.CheckpointManager(tmp_path, {**meta, 'model': 'other'}).try_resume() == 0


def test_run_mcqa_gives_the_same_results_in_both(tmp_path, stub_openai_server):
    qfile = tmp_path / 'questions.json'
    questions = [*QUESTIONS, {'question': 'Largest planet?', 'answer': 'jupiter',
                              'chunk_id': 'abc_0001'}]
    qfile.write_text(json.dumps(questions))
    out = {}
    for name, make in (('jax', lambda **kw: jax_config.MCQAConfig(**kw)),
                       ('port', lambda **kw: port_config.MCQAConfig.from_dict(kw))):
        config = make(
            questions_file=str(qfile), output_dir=str(tmp_path / name),
            model_api_base=stub_openai_server, model_name='stub',
            grader_api_base=stub_openai_server, grader_model='g', parallel_workers=3,
            batch_size=2, batch_timeout=0.05, checkpoint_every=2,
        )
        harness = jax_harness if name == 'jax' else port_harness
        summary = harness.run_mcqa(config)
        results = json.loads((tmp_path / name / 'results.json').read_text())
        incorrect = json.loads((tmp_path / name / 'incorrect_answers.json').read_text())
        out[name] = (summary, results, incorrect)
        assert yaml.safe_load((tmp_path / name / 'config.yaml').read_text())['model_name'] == 'stub'
    (js, jr, ji), (ps, pr, pi) = out['jax'], out['port']
    strip = lambda s: {k: v for k, v in s.items() if k not in TIMING and k != 'questions_file'}  # noqa: E731
    assert strip(ps) == strip(js) and strip(pr['summary']) == strip(jr['summary'])
    assert pr['results'] == jr['results'] and set(pr) == set(jr) == {'summary', 'results'}
    assert pi == ji and len(pi) == 2
    assert ps['source_chunk_retrieved_rate'] == 0.0


def test_retrieval_metrics_and_prefix_hints_agree():
    results = {
        0: {'entry': {'question': 'q0', 'chunk_id': 'c1'},
            'retrieval': [{'chunk_id': 'c1', 'question_hash': 'h'}]},
        1: {'entry': {'question': 'q1', 'chunk_id': 'c2'}, 'retrieval': []},
        2: {'entry': {'question': 'q2', 'question_hash': jax_harness.question_hash('q2')},
            'retrieval': [{'chunk_id': 'c9', 'question_hash': jax_harness.question_hash('q2')}]},
    }
    assert port_harness.retrieval_metrics(results) == jax_harness.retrieval_metrics(results)
    assert port_harness.question_hash(' a b ') == jax_harness.question_hash('a b')
    orders = []
    for batching in (jax_batching, port_batching):
        batches = []
        gate = threading.Event()

        def send(prompts, batches=batches):
            gate.wait(5)
            batches.append(list(prompts))
            return prompts

        client = batching.BatchingClient(send, batch_size=6, batch_timeout=0.5)
        threads = []
        for i, hint in enumerate(['b', '', 'a', 'b', '', 'a']):
            t = threading.Thread(target=client.generate, args=(f'p{i}',),
                                 kwargs={'timeout': 10, 'prefix_hint': hint})
            t.start()
            t.join(0.02)  # arrival order p0..p5
            threads.append(t)
        gate.set()
        for t in threads:
            t.join()
        client.close()
        orders.append(batches)
    assert orders[0] == orders[1] == [['p1', 'p4', 'p2', 'p5', 'p0', 'p3']]


# ------------------------------------------------------- one booted server
def test_local_server_boot_answers_as_the_jax_engine(tmp_path, monkeypatch):
    """The port's chat server booted by ``LocalServerManager`` on the CPU:
    answers equal to the JAX engine's greedy tokens on the same prompts
    (the server renders ``user: ...`` then ``assistant:``)."""
    from distllm_tpu.chat import ConversationPromptTemplate
    from distllm_tpu.generate.generators.tpu_backend import TpuGenerator, TpuGeneratorConfig
    from test_torch_checkpoint_serve import write_checkpoint

    local_only(monkeypatch)
    ckpt = write_checkpoint(tmp_path / 'ckpt')
    vllm_args = {'tensor_parallel_size': 1, 'max_model_len': 48, 'max_num_seqs': 4,
                 'block_size': 4, 'num_blocks': 64}
    grader = GraderStub()
    questions = [{'question': f'w{3 * i} w{3 * i + 1} w{i + 40} w7', 'answer': f'w{i}'}
                 for i in range(4)]
    qfile = tmp_path / 'questions.json'
    qfile.write_text(json.dumps(questions))
    handlers = {sig: signal.getsignal(sig) for sig in (signal.SIGINT, signal.SIGTERM)}
    stopped = []
    from distllm_tpu_torch.mcqa import server_boot

    real_stop = server_boot.LocalServerManager.stop

    def stop(self):
        process = self.process
        real_stop(self)
        if process is not None:
            stopped.append(process.returncode)

    monkeypatch.setattr(server_boot.LocalServerManager, 'stop', stop)
    try:
        config = port_config.MCQAConfig.from_dict(dict(
            questions_file=str(qfile), output_dir=str(tmp_path / 'out'),
            local_model_path=str(ckpt), vllm_args=vllm_args, grader_api_base=grader.base,
            grader_model='g', parallel_workers=4, batch_size=4, batch_timeout=0.2,
        ))
        summary = port_harness.run_mcqa(config, device='cpu')
    finally:
        grader.close()
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    assert summary['graded'] == 4 and summary['errors'] == []
    assert stopped and stopped[0] is not None  # the process exited at stop()
    written = yaml.safe_load((tmp_path / 'out' / 'server_logs' / 'server_config.yaml').read_text())
    assert written == {'generator_config': {
        'name': 'tpu', 'pretrained_model_name_or_path': str(ckpt), 'temperature': 0.0,
        'min_p': 0.0, **vllm_args}}
    results = json.loads((tmp_path / 'out' / 'results.json').read_text())['results']
    answers = [results[str(i)]['answer'] for i in range(4)]
    template = ConversationPromptTemplate('')
    prompts = [template.render([{'role': 'user', 'content': q['question']}]) for q in questions]
    ref = TpuGenerator(TpuGeneratorConfig(
        pretrained_model_name_or_path=str(ckpt), temperature=0.0, min_p=0.0,
        enable_prefix_cache=True, attn_backend='xla',
        **{k: v for k, v in vllm_args.items()},
    ))
    assert answers == ref.generate(prompts)
    assert all(answers)


def test_the_rag_arm_retrieves_and_logs_as_jax(tmp_path, monkeypatch):
    """``retriever_config`` (a tiny BERT checkpoint over an embeddings
    dataset written from a seed): both packages retrieve the same chunks
    for each question and log the same ranks, dataset indices, chunk ids,
    paths and previews (scores within 1e-5); the answers, the summary and
    the retrieval rates agree."""
    from test_torch_search import _bert_checkpoint, _rows, _save

    local_only(monkeypatch)
    ckpt = tmp_path / 'bert'
    ckpt.mkdir()
    _bert_checkpoint(ckpt)
    emb, texts = _rows(n=160, seed=3)
    questions = [{'question': texts[i], 'answer': 'paris',
                  'chunk_id': jax_harness.chunk_id(f'doc{i % 4}', i)} for i in (3, 40, 77)]
    qfile = tmp_path / 'questions.json'
    qfile.write_text(json.dumps(questions))
    stub = GraderStub()
    out = {}
    try:
        for name in ('jax', 'port'):
            data = _save(tmp_path / name / 'ds', emb, texts)
            fields = dict(
                questions_file=str(qfile), output_dir=str(tmp_path / name / 'out'),
                model_api_base=stub.base, model_name='stub', grader_api_base=stub.base,
                grader_model='g', retrieval_top_k=3, retrieval_score_threshold=-1.0,
                parallel_workers=2, batch_size=2, batch_timeout=0.05,
                retriever_config={
                    'faiss_config': {'name': 'faiss_index_v2', 'dataset_dir': str(data),
                                     'precision': 'float32'},
                    'encoder_config': {'name': 'auto', 'half_precision': False,
                                       'pretrained_model_name_or_path': str(ckpt)},
                    'pooler_config': {'name': 'mean'}, 'batch_size': 4,
                },
            )
            if name == 'jax':
                summary = jax_harness.run_mcqa(jax_config.MCQAConfig(**fields))
            else:
                summary = port_harness.run_mcqa(port_config.MCQAConfig.from_dict(fields),
                                                device='cpu')
            results = json.loads((tmp_path / name / 'out' / 'results.json').read_text())
            out[name] = (summary, results['results'])
    finally:
        stub.close()
    (js, jr), (ps, pr) = out['jax'], out['port']
    strip = lambda s: {k: v for k, v in s.items() if k not in TIMING and k != 'questions_file'}  # noqa: E731
    assert strip(ps) == strip(js) and 'source_chunk_retrieved_rate' in ps
    assert sorted(pr) == sorted(jr) and len(pr) == 3
    for key in jr:
        got, want = pr[key]['retrieval'], jr[key]['retrieval']
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert {k: v for k, v in g.items() if k != 'score'} == {
                k: v for k, v in w.items() if k != 'score'}
            assert g['score'] == pytest.approx(w['score'], abs=1e-5)
        assert {k: v for k, v in pr[key].items() if k != 'retrieval'} == {
            k: v for k, v in jr[key].items() if k != 'retrieval'}


def test_the_grader_ladder_is_jax_s_character_for_character():
    """The three prompts and what each level sends for the same inputs."""
    assert port_grading._PROMPT_LADDER == jax_grading._PROMPT_LADDER
    sent = {}
    for name, grading in (('jax', jax_grading), ('port', port_grading)):
        calls = sent.setdefault(name, [])

        def grader(prompt, calls=calls):
            calls.append(prompt)
            return '{"correct": false}' if len(calls) == 3 else 'not json {'

        verdict = grading.grade_answer(grader, 'Q?\n1. a\n2. b', 'a', 'b', max_tries_per_level=1)
        assert verdict == {'correct': False, 'reason': '', 'ladder_level': 2}
    assert sent['port'] == sent['jax'] and len(sent['port']) == 3


def test_a_poison_prompt_is_bisected_out_alike():
    """A batch that fails is retried prompt by prompt: the poison prompt
    gets the error, the healthy ones their answers, with the same sends in
    both packages (and, after two failures in a row, one retry of the
    untried rest as a batch)."""
    outcomes = []
    for batching in (jax_batching, port_batching):
        sends = []
        gate = threading.Event()

        def send(prompts, sends=sends):
            gate.wait(5)
            sends.append(list(prompts))
            if any(p.startswith('bad') for p in prompts):
                raise ValueError('poison')
            return [p.upper() for p in prompts]

        client = batching.BatchingClient(send, batch_size=6, batch_timeout=0.5)
        results = {}

        def ask(prompt, results=results, client=client):
            try:
                results[prompt] = client.generate(prompt, timeout=10)
            except ValueError as exc:
                results[prompt] = f'error: {exc}'

        threads = []
        for prompt in ('ok0', 'bad1', 'bad2', 'ok3', 'ok4', 'bad5'):
            t = threading.Thread(target=ask, args=(prompt,))
            t.start()
            t.join(0.02)  # arrival order as listed
            threads.append(t)
        gate.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        client.close()
        outcomes.append((results, sends))
    assert outcomes[0] == outcomes[1]
    results, sends = outcomes[1]
    assert results['ok0'] == 'OK0' and results['bad1'] == 'error: poison'
    assert len(sends) > 1
