"""The port's chat server: a tiny CPU model behind ``ChatServer`` on a
free localhost port. ``GET /health`` answers, three completions come back
in the JAX server's payload shape (served concurrently through the one
engine worker), and malformed requests get 4xx answers.

The serving routes against the JAX server (``distllm_tpu.chat_server``
booted on its aiohttp app over the fake generator): status codes, the
headers that carry meaning (CORS, ``X-Request-Id``, ``Retry-After``,
content types) and body keys of ``/health``, completions plain and
streamed, ``/loadinfo``, ``/metrics``, ``OPTIONS``, ``/drain`` (bad
inputs, the drain, the 503s after it) and the 429 of an overloaded
generator; the HTTP series and the engine's lifecycle record through the
port's server."""

import json
import threading
import urllib.error
import urllib.request

import pytest

from distllm_tpu_torch.chat_server import ChatServer
from distllm_tpu_torch.generate.generators.torch_backend import (
    TorchGenerator,
    TorchGeneratorConfig,
)
from distllm_tpu_torch.models.mistral import MistralConfig


@pytest.fixture(scope='module')
def server():
    generator = TorchGenerator(TorchGeneratorConfig(
        model=MistralConfig(
            vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=64, dtype='float32',
        ),
        temperature=0.0, max_tokens=6, block_size=4, num_blocks=64,
        max_num_seqs=4, max_model_len=128, device='cpu',
    ))
    with ChatServer(generator, system_prompt='You are terse.') as srv:
        yield srv
    generator.shutdown()


def _request(srv, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f'http://127.0.0.1:{srv.port}{path}', data=data,
        headers={'Content-Type': 'application/json', **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), json.loads(err.read())


def test_health(server):
    status, _, body = _request(server, '/health')
    assert status == 200
    assert body['status'] == 'ok' and body['ready'] is True


def test_three_concurrent_completions(server):
    results = [None] * 3

    def ask(i):
        results[i] = _request(
            server, '/v1/chat/completions',
            {'model': 'tiny', 'messages': [
                {'role': 'user', 'content': f'question number {i} about cells'}
            ]},
            {'X-Request-Id': f'test-{i}'},
        )

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for i, (status, headers, body) in enumerate(results):
        assert status == 200
        assert headers['X-Request-Id'] == f'test-{i}'
        assert body['object'] == 'chat.completion'
        assert body['model'] == 'tiny' and body['request_id'] == f'test-{i}'
        message = body['choices'][0]['message']
        assert message['role'] == 'assistant'
        assert isinstance(message['content'], str) and message['content']
        assert body['choices'][0]['finish_reason'] == 'stop'
        assert set(body['usage']) == {
            'prompt_tokens', 'completion_tokens', 'total_tokens'
        }
    assert server.requests_served >= 3


def test_bad_requests(server):
    status, _, body = _request(server, '/v1/chat/completions', {'messages': []})
    assert status == 400 and 'messages' in body['error']['message']
    status, _, _ = _request(server, '/nowhere')
    assert status == 404


# ------------------------------------------------- the serving routes vs JAX
def _call(base, method, path, body=None, headers=None):
    """``(status, headers, raw body)`` of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f'{base}{path}', data=data, method=method,
        headers={'Content-Type': 'application/json', **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


CORS = ('Access-Control-Allow-Origin', 'Access-Control-Allow-Headers',
        'Access-Control-Allow-Methods')
ASK = {'messages': [{'role': 'user', 'content': 'hello there'}]}


@pytest.fixture
def both_servers():
    """The JAX app and the port's server, each over its package's fake
    generator, on free localhost ports; yields ``(port_base, jax_base)``."""
    from test_chat import _start_chat_server

    from distllm_tpu.chat import ChatAppConfig as JaxChatAppConfig
    from distllm_tpu_torch.generate.generators.torch_backend import (
        FakeGenerator,
        FakeGeneratorConfig,
    )

    def start(**fake):
        jax_base, stop = _start_chat_server(
            JaxChatAppConfig(generator_config={'name': 'fake', **fake})
        )
        port = ChatServer(FakeGenerator(FakeGeneratorConfig(**fake))).start()
        started.append((port, stop))
        return f'http://127.0.0.1:{port.port}', jax_base

    started = []
    yield start
    for port, stop in started:
        port.close()
        stop()


def _same(port, ref, header_keys=()):
    """Status codes, the named headers and the JSON body keys alike."""
    assert port[0] == ref[0]
    for key in header_keys:
        assert port[1].get(key) == ref[1].get(key), key
    if port[1].get('Content-Type', '').startswith('application/json'):
        assert set(json.loads(port[2])) == set(json.loads(ref[2]))


def test_routes_match_the_jax_server(both_servers):
    port, ref = both_servers()
    for base in (port, ref):  # one served completion each before comparing
        assert _call(base, 'POST', '/v1/chat/completions', ASK)[0] == 200
    _same(_call(port, 'GET', '/health'), _call(ref, 'GET', '/health'), CORS)
    rid = {'X-Request-Id': 'route-1'}
    got, want = (_call(b, 'POST', '/v1/chat/completions', ASK, rid) for b in (port, ref))
    _same(got, want, ('X-Request-Id', *CORS))
    assert json.loads(got[2])['request_id'] == 'route-1'
    # stream: true is one SSE delta and [DONE].
    got, want = (_call(b, 'POST', '/v1/chat/completions', {**ASK, 'stream': True}, rid)
                 for b in (port, ref))
    _same(got, want, ('Content-Type', 'Cache-Control', 'X-Request-Id'))
    events = [e for e in got[2].decode().split('\n\n') if e]
    assert len(events) == 2 and events[1] == 'data: [DONE]'
    assert [e for e in want[2].decode().split('\n\n') if e][1] == 'data: [DONE]'
    chunk = json.loads(events[0].removeprefix('data: '))
    want_chunk = json.loads(want[2].decode().split('\n\n')[0].removeprefix('data: '))
    assert set(chunk) == set(want_chunk)
    assert chunk['object'] == 'chat.completion.chunk' and chunk['request_id'] == 'route-1'
    assert set(chunk['choices'][0]['delta']) == set(want_chunk['choices'][0]['delta'])
    _same(_call(port, 'GET', '/loadinfo'), _call(ref, 'GET', '/loadinfo'), CORS)
    got, want = _call(port, 'GET', '/metrics'), _call(ref, 'GET', '/metrics')
    _same(got, want, ('Content-Type',))
    for line in got[2].decode().splitlines():
        assert line.startswith('#') or len(line.rsplit(' ', 1)) == 2
    _same(_call(port, 'OPTIONS', '/v1/chat/completions'),
          _call(ref, 'OPTIONS', '/v1/chat/completions'), CORS)
    for bad in ('nan', 'abc', 'inf'):
        _same(_call(port, 'POST', f'/drain?seconds={bad}'),
              _call(ref, 'POST', f'/drain?seconds={bad}'))
    # An unknown path: 404 here; the JAX app's catch-all OPTIONS route makes
    # aiohttp answer 405 there.
    assert _call(port, 'GET', '/nowhere')[0] == 404
    assert _call(ref, 'GET', '/nowhere')[0] in (404, 405)
    # Drain: one-way; /health turns 503, completions 503 + Retry-After.
    got, want = (_call(b, 'POST', '/drain?seconds=0') for b in (port, ref))
    _same(got, want)
    assert json.loads(got[2]) == json.loads(want[2])
    got, want = _call(port, 'GET', '/health'), _call(ref, 'GET', '/health')
    _same(got, want)
    assert got[0] == 503 and json.loads(got[2])['ready'] is False
    got, want = (_call(b, 'POST', '/v1/chat/completions', ASK) for b in (port, ref))
    _same(got, want, ('Retry-After',))
    assert got[0] == 503 and json.loads(got[2])['error'] == json.loads(want[2])['error']
    assert json.loads(_call(port, 'GET', '/loadinfo')[2])['draining'] is True


def test_overload_answers_429_as_the_jax_server(both_servers):
    port, ref = both_servers(overload_every=2)
    for i in range(4):
        rid = {'X-Request-Id': f'shed-{i}'}
        got, want = (_call(b, 'POST', '/v1/chat/completions', ASK, rid) for b in (port, ref))
        _same(got, want, ('Retry-After', 'X-Request-Id'))
        assert got[0] == (429 if i % 2 else 200)
        if got[0] == 429:
            assert got[1]['Retry-After'] == '3'
            assert json.loads(got[2])['error'] == json.loads(want[2])['error']


def test_http_series_and_engine_lifecycle_through_the_server(server):
    """The middleware's series move per request; a completion's
    X-Request-Id reaches the engine's 'request' flight record; the TTFT
    histogram's count rises by one per completion."""
    from distllm_tpu_torch.observability import instruments

    before = instruments.HTTP_REQUESTS.labels(path='/v1/chat/completions', status='2xx').value
    ttft = instruments.REQUEST_TTFT.count
    ring = server.generator.engine.flight
    seen = ring.total_recorded
    status, headers, body = _request(server, '/v1/chat/completions', ASK,
                                     {'X-Request-Id': 'trace-me'})
    assert status == 200 and headers['Access-Control-Allow-Origin'] == '*'
    assert instruments.HTTP_REQUESTS.labels(
        path='/v1/chat/completions', status='2xx').value == before + 1
    assert instruments.REQUEST_TTFT.count == ttft + 1
    records = ring.snapshot()[-(ring.total_recorded - seen):]
    assert [r['trace_id'] for r in records if r['kind'] == 'request'] == ['trace-me']
    metrics = _call(f'http://127.0.0.1:{server.port}', 'GET', '/metrics')[2].decode()
    count = next(line for line in metrics.splitlines()
                 if line.startswith('distllm_request_ttft_seconds_count'))
    assert float(count.split()[-1]) == instruments.REQUEST_TTFT.count
    info = json.loads(_call(f'http://127.0.0.1:{server.port}', 'GET', '/loadinfo')[2])
    assert info == {'ready': True, 'draining': False, 'queue_depth': 0, 'running': 0,
                    'in_flight': 0, 'kv_occupancy': 0.0}


def test_completion_count_survives_concurrent_requests_and_a_drain():
    """More client threads than cores, a short switch interval and a drain
    racing them: every answer is a 200 or a draining 503, the in-flight
    count returns to zero, and the served count equals the 200s."""
    import sys
    import time

    from distllm_tpu_torch.generate.generators.torch_backend import (
        FakeGenerator,
        FakeGeneratorConfig,
    )

    statuses = []
    lock = threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ChatServer(FakeGenerator(FakeGeneratorConfig())) as srv:
            base = f'http://127.0.0.1:{srv.port}'

            def ask():
                status = _call(base, 'POST', '/v1/chat/completions', ASK)[0]
                with lock:
                    statuses.append(status)

            threads = [threading.Thread(target=ask) for _ in range(48)]
            for i, thread in enumerate(threads):
                thread.start()
                if i == 24:
                    drain = threading.Thread(
                        target=lambda: _call(base, 'POST', '/drain?seconds=30'))
                    drain.start()
            deadline = time.monotonic() + 60
            for thread in [*threads, drain]:
                thread.join(timeout=max(0.0, deadline - time.monotonic()))
            assert not any(t.is_alive() for t in [*threads, drain])
            assert set(statuses) <= {200, 503} and len(statuses) == 48
            assert srv.completions_in_flight == 0
            assert srv.requests_served == statuses.count(200)
    finally:
        sys.setswitchinterval(interval)
