"""The port's network generator backends against the JAX package's.

A stdlib ``http.server`` on localhost records every request and answers
from a script. The JAX backends speak through ``requests`` and the port's
through ``urllib.request``, to the same real socket, so nothing is
patched. For each backend — ``api`` on its three providers and its
``langchain`` alias, ``argo``, ``openai`` and the chat app's ``http`` —
the two packages send equal JSON bodies to the same paths with the same
headers (only ``User-Agent`` and ``Connection`` differ: ``urllib.request``
closes each connection), return equal strings, retry a 429 and a 5xx
alike, give up on a 401 without retrying, and handle an empty or a None
content alike. The factory builds every JAX name with equal configs, and
both refuse the same bad configs.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import distllm_tpu.chat as jax_chat
import distllm_tpu.generate as jax_generate
from distllm_tpu.generate.generators import api_backend as jax_api
from distllm_tpu_torch import chat as port_chat
from distllm_tpu_torch.generate.generators import api_backend as port_api
from distllm_tpu_torch.generate.generators import get_generator

# Transport headers that differ by client, not by backend.
TRANSPORT = {'user-agent', 'connection'}


class StubEndpoint:
    """Records ``(path, headers, body)`` of each POST and answers with the
    next scripted ``(status, payload)``, else :meth:`default`."""

    def __init__(self) -> None:
        self.requests: list[tuple[str, dict, dict]] = []
        self.script: list[tuple[int, object]] = []
        self.lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers['Content-Length'])))
                with stub.lock:
                    stub.requests.append((
                        self.path, {k.lower(): v for k, v in self.headers.items()}, body,
                    ))
                    status, payload = (
                        stub.script.pop(0) if stub.script else (200, stub.default(self.path, body))
                    )
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(('127.0.0.1', 0), Handler)
        self.base = f'http://127.0.0.1:{self.server.server_address[1]}'
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    @staticmethod
    def default(path, body):
        if path.endswith('/v1/messages'):
            return {'content': [{'type': 'text', 'text': 'claude says '},
                                {'type': 'text', 'text': body['messages'][0]['content']}]}
        if ':generateContent' in path:
            return {'candidates': [{'content': {'parts': [
                {'text': 'gemini says '}, {'text': body['contents'][0]['parts'][0]['text']}]}}]}
        prompt = body['messages'][-1]['content']
        return {'choices': [{'message': {'role': 'assistant', 'content': f'echo {prompt}'},
                             'finish_reason': 'stop'}]}

    def take(self):
        with self.lock:
            out, self.requests = self.requests, []
        return out

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def local_only(monkeypatch):
    """Local traffic never goes through a proxy, whatever the environment."""
    for key in ('NO_PROXY', 'no_proxy'):
        monkeypatch.setenv(key, '127.0.0.1,localhost')
    for key in ('HTTP_PROXY', 'http_proxy', 'HTTPS_PROXY', 'https_proxy', 'ALL_PROXY'):
        monkeypatch.delenv(key, raising=False)


@pytest.fixture(scope='module')
def endpoint():
    endpoint = StubEndpoint()
    yield endpoint
    endpoint.close()


@pytest.fixture
def stub(endpoint, monkeypatch):
    local_only(monkeypatch)
    # Backoff without waiting: both packages' retry helpers call time.sleep.
    monkeypatch.setattr(time, 'sleep', lambda s: None)
    endpoint.script, endpoint.requests = [], []
    return endpoint


def backends(base):
    """name -> (JAX generator factory, port generator factory), each over
    ``base``; the config keys are the JAX package's."""
    api = dict(api_key='sk-test', max_tries=3, concurrency=1)
    specs = {
        'api_openai': {'name': 'api', 'openai_api_base': f'{base}/v1', 'model': 'gpt-4o', **api},
        'api_anthropic': {'name': 'api', 'anthropic_api_base': base, 'model': 'claude-3-opus',
                          'extra_body': {'metadata': {'user_id': 'u1'}}, **api},
        'api_google': {'name': 'api', 'google_api_base': base, 'model': 'gemini-pro',
                       'extra_body': {'generationConfig': {'topK': 3}}, **api},
        'langchain': {'name': 'langchain', 'provider': 'openai', 'openai_api_base': base,
                      'model': 'llama', 'temperature': 0.3, **api},
        'argo': {'name': 'argo', 'base_url': base, 'model': 'argo:gpt-4o', 'user': 'tester',
                 'max_tokens': 64},
        'openai': {'name': 'openai', 'base_url': f'{base}/v1', 'api_key': 'sk-o',
                   'model': 'gpt-4.1', 'max_tokens': 32},
    }
    out = {
        name: (lambda s=spec: jax_generate.get_generator(dict(s)),
               lambda s=spec: get_generator(dict(s)))
        for name, spec in specs.items()
    }
    http = {'name': 'http', 'base_url': f'{base}/v1', 'model': 'served', 'api_key': 'k',
            'temperature': 0.1, 'max_tokens': 16, 'extra_body': {'user': 'x'}}
    out['http'] = (
        lambda: jax_chat.ChatAppConfig(generator_config=http).build_generator(),
        lambda: port_chat.ChatAppConfig.from_dict({'generator_config': http}).build_generator(),
    )
    return out


NAMES = ['api_openai', 'api_anthropic', 'api_google', 'langchain', 'argo', 'openai', 'http']
# Backends that return an 'Error: ...' string instead of raising.
RETURNS_ERRORS = ('argo', 'openai')


def _same_requests(jax_reqs, port_reqs):
    """Equal request for request (in body order: a backend with
    ``concurrency`` sends from threads)."""
    assert len(jax_reqs) == len(port_reqs) > 0
    jax_reqs, port_reqs = (sorted(reqs, key=lambda r: json.dumps(r[2], sort_keys=True))
                           for reqs in (jax_reqs, port_reqs))
    for (j_path, j_headers, j_body), (p_path, p_headers, p_body) in zip(jax_reqs, port_reqs):
        assert p_path == j_path
        assert p_body == j_body
        assert {k: v for k, v in p_headers.items() if k not in TRANSPORT} == {
            k: v for k, v in j_headers.items() if k not in TRANSPORT
        }


@pytest.mark.parametrize('name', NAMES)
def test_bodies_headers_and_strings_match(stub, name):
    make_jax, make_port = backends(stub.base)[name]
    prompts = ['What is 2 + 2?', 'Name a prime. ünïcode']
    want = make_jax().generate(prompts)
    jax_reqs = stub.take()
    got = make_port().generate(prompts)
    port_reqs = stub.take()
    assert got == want and len(got) == 2
    assert all(isinstance(text, str) and text for text in got)
    _same_requests(jax_reqs, port_reqs)
    if name in ('argo', 'openai'):  # the per-call overrides
        assert make_port().generate('x', temperature=0.7, max_tokens=5) == make_jax().generate(
            'x', temperature=0.7, max_tokens=5)
        j, p = stub.take()
        _same_requests([p], [j])


@pytest.mark.parametrize('name', NAMES)
@pytest.mark.parametrize('status', [429, 503])
def test_retries_match(stub, name, status):
    make_jax, make_port = backends(stub.base)[name]
    results = []
    for make in (make_jax, make_port):
        stub.script = [(status, {'error': 'busy'}), (status, {'error': 'busy'})]
        results.append(make().generate(['retry me']))
        results.append(len(stub.take()))
    assert results[0] == results[2] and results[1] == results[3] == 3
    # Every try fails: the same 'Error: ...' string, or an exception from both.
    outcomes = []
    for make in (make_jax, make_port):
        generator = make()
        stub.script = [(status, {'error': 'busy'})] * 8
        try:
            outcomes.append(('ok', generator.generate(['doomed'])))
        except Exception as exc:  # noqa: BLE001 - compared across packages
            outcomes.append(('raised', str(exc)))
        outcomes.append(len(stub.take()))
        assert outcomes[-1] == generator.config.max_tries
    assert outcomes[1] == outcomes[3]
    if name in RETURNS_ERRORS:
        assert outcomes[0] == outcomes[2]
        assert outcomes[0][1][0].startswith(f'Error: {status} ')
    else:
        assert outcomes[0][0] == outcomes[2][0] == 'raised'
        assert outcomes[0][1] == outcomes[2][1]


@pytest.mark.parametrize('name', NAMES)
def test_auth_failure_is_not_retried(stub, name):
    make_jax, make_port = backends(stub.base)[name]
    outcomes = []
    for make, auth_error in ((make_jax, jax_api.ApiAuthError), (make_port, port_api.ApiAuthError)):
        stub.script = [(401, {'error': 'bad key'})]
        try:
            outcomes.append(make().generate(['secret']))
        except auth_error as exc:
            outcomes.append(f'raised {exc}')
        outcomes.append(len(stub.take()))
    assert outcomes[1] == outcomes[3] == 1
    assert outcomes[0] == outcomes[2]
    if name in RETURNS_ERRORS:
        assert outcomes[0][0].startswith('Error: 401 from ')
    else:
        assert outcomes[0].startswith('raised 401 from ')


@pytest.mark.parametrize('name', ['api_openai', 'langchain', 'argo', 'openai', 'http'])
@pytest.mark.parametrize('content', ['', None])
def test_empty_or_none_content(stub, name, content):
    make_jax, make_port = backends(stub.base)[name]
    payload = {'choices': [{'message': {'role': 'assistant', 'content': content},
                            'finish_reason': 'length'}]}
    got = []
    for make in (make_jax, make_port):
        stub.script = [(200, payload)]
        got.append(make().generate(['q']))
    assert got[0] == got[1]
    if name == 'openai' and content is None:
        assert got[1] == ['[No content returned. Finish reason: length]']


@pytest.mark.parametrize('payload', [
    {'unexpected': True},
    {'candidates': [{'finishReason': 'SAFETY'}]},
    {'choices': []},
], ids=['keys', 'safety', 'empty_choices'])
def test_malformed_payloads_are_not_retried(stub, payload):
    name = 'api_google' if 'candidates' in payload else 'api_openai'
    make_jax, make_port = backends(stub.base)[name]
    messages = []
    for make, error in ((make_jax, jax_api.ApiResponseError),
                        (make_port, port_api.ApiResponseError)):
        stub.script = [(200, payload)]
        with pytest.raises(error) as info:
            make().generate(['q'])
        messages.append(str(info.value))
        assert len(stub.take()) == 1
    assert messages[0] == messages[1]


def test_factory_builds_every_jax_name_with_equal_configs(monkeypatch):
    for key, value in (('MODEL', 'argo:gpt-o3'), ('BASE_URL', 'http://127.0.0.1:9'),
                       ('USER', 'someone'), ('OPENAI_API_KEY', 'sk-env'),
                       ('OPENAI_MODEL', 'gpt-x')):
        monkeypatch.setenv(key, value)
    monkeypatch.delenv('OPENAI_BASE_URL', raising=False)
    for kwargs in ({'name': 'api'}, {'name': 'langchain', 'model': 'claude-3'},
                   {'name': 'api', 'model': 'gemini-pro', 'max_tokens': '64'},
                   {'name': 'api', 'model': 'claude-3', 'openai_api_base': 'http://proxy/v1'},
                   {'name': 'argo'}, {'name': 'openai'}, {'name': 'openai', 'base_url': 'http://b'}):
        ref, port = jax_generate.get_generator(dict(kwargs)), get_generator(dict(kwargs))
        assert type(port).__name__ == type(ref).__name__
        assert port.config.to_dict() == ref.config.model_dump(), kwargs
        assert getattr(port, 'provider', None) == getattr(ref, 'provider', None)
    monkeypatch.delenv('OPENAI_API_KEY')
    for kwargs in ({'name': 'openai'}, {'name': 'huggingface'}, {'name': 'api', 'provider': 'x'},
                   {'name': 'api', 'modle': 'typo'}, {'name': 'argo', 'max_tokens': 'many'},
                   {'name': 'api', 'extra_body': 'no'}, {'name': 'nope'}):
        with pytest.raises(ValueError):
            jax_generate.get_generator(dict(kwargs))
        with pytest.raises(ValueError):
            get_generator(dict(kwargs))
    # The chat app's http backend: the same ApiGeneratorConfig.
    http = {'name': 'http', 'base_url': 'http://h/v1', 'model': 'm', 'timeout': 5}
    ref = jax_chat.ChatAppConfig(generator_config=http).build_generator()
    port = port_chat.ChatAppConfig.from_dict({'generator_config': http}).build_generator()
    assert port.config.to_dict() == ref.config.model_dump()
    config, _ = port_chat.ChatAppConfig.from_dict({'generator_config': http}), None
    assert config.build_generator_config().to_dict() == ref.config.model_dump()
