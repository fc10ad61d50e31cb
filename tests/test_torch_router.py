"""The port's router (``distllm_tpu_torch.router``) against the JAX package's.

- ``prompt_prefix_bytes`` / ``prompt_prefix_digests`` equal JAX's on seeded
  message lists, and ``AffinityMap`` gives JAX's results under the same
  sequence of calls.
- The JAX aiohttp router and the port's router each stand in front of
  fresh standard-library stub replicas and get the same requests, in the
  cases of ``tests/test_router.py`` (rotation, affinity learning,
  least-loaded, one-way drain, retry once on a dead replica, 429 relayed,
  the health document) and three more (a 503 from a draining replica, no
  replica left, a corrupt learning header). Per request they must agree
  on the replica chosen, the decision label (the ``distllm_router_requests_
  total`` delta of each package), the retry marker and the status.
- The port's chat server sets the JAX server's digest headers, streamed
  or not, and the router relays its SSE answer.
- ``observability.aggregate`` names replicas in ``host_label`` and the
  combined Perfetto merge as the JAX module does.

Every wait on a server, socket or thread has its own timeout.
"""

from __future__ import annotations

import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

pytest.importorskip('aiohttp')

from distllm_tpu.observability import instruments as jax_instruments  # noqa: E402
from distllm_tpu.router import RouterConfig as JaxRouterConfig  # noqa: E402
from distllm_tpu.router import affinity as jax_affinity  # noqa: E402
from distllm_tpu.router import build_router_app  # noqa: E402
from distllm_tpu_torch.observability import instruments  # noqa: E402
from distllm_tpu_torch.router import RouterConfig, RouterServer, affinity  # noqa: E402
from test_router import _serve  # noqa: E402
from test_torch_server import _call, both_servers  # noqa: E402,F401

DECISIONS = ('affinity', 'least_loaded', 'round_robin')


# --------------------------------------------------------------- digests
def _seeded_messages(seed: int) -> list[dict]:
    rng = random.Random(seed)
    words = ['alpha', 'beta', 'γάμμα', 'δ', '\x1f', 'e' * 40, '🙂', '']
    out = []
    for _ in range(rng.randint(0, 6)):
        role = rng.choice(['system', 'user', 'assistant', ''])
        content = ' '.join(rng.choice(words) for _ in range(rng.randint(0, 30)))
        out.append({'role': role, 'content': content})
    return out


@pytest.mark.parametrize('block_bytes', [16, 64, 100])
def test_prefix_digests_equal_jax(block_bytes):
    for seed in range(40):
        messages = _seeded_messages(seed)
        assert affinity.prompt_prefix_bytes(messages) == jax_affinity.prompt_prefix_bytes(messages)
        assert (affinity.prompt_prefix_digests(messages, block_bytes)
                == jax_affinity.prompt_prefix_digests(messages, block_bytes))
    assert affinity.prompt_prefix_digests([{'role': 'user', 'content': 'x' * 300}]) == (
        jax_affinity.prompt_prefix_digests([{'role': 'user', 'content': 'x' * 300}]))
    for name in ('DEFAULT_BLOCK_BYTES', 'HEADER_DIGEST', 'HEADER_DEPTH', 'HEADER_RETRY',
                 'HEADER_REPLICA'):
        assert getattr(affinity, name) == getattr(jax_affinity, name)


def test_affinity_map_equals_jax_under_the_same_calls():
    rng = random.Random(3)
    chains = [affinity.prompt_prefix_digests(
        [{'role': 'user', 'content': f'session {i} ' + 'z' * rng.randint(10, 400)}])
        for i in range(12)]
    maps = (affinity.AffinityMap(8), jax_affinity.AffinityMap(8))
    for step in range(300):
        chain = rng.choice(chains)
        replica = rng.choice(['r0', 'r1', 'r2'])
        op = rng.choice(['learn', 'verify', 'score', 'drop'])
        if op == 'learn':
            part = chain[: rng.randint(0, len(chain))]
            out = [m.learn(replica, part) for m in maps]
        elif op == 'verify':
            depth = rng.randint(-1, len(chain) + 1)
            digest = rng.choice([chain[depth - 1].hex() if 0 < depth <= len(chain) else 'ff',
                                 'zz', '', None])
            text = rng.choice([str(depth), 'x', None])
            out = [m.verify_and_learn(replica, chain, digest, text) for m in maps]
        elif op == 'score':
            out = [m.score(replica, chain) for m in maps]
        else:
            out = [m.drop(replica) for m in maps]
        assert out[0] == out[1], (step, op)
        assert maps[0].entries() == maps[1].entries()


# ------------------------------------------------------------ stub replicas
class StubReplica:
    """A chat-server-shaped stub on the standard library: ``/health``,
    ``/loadinfo`` and completions with the digest headers a real replica
    sets. ``state`` drives health; ``reply_status`` 429 answers with
    ``Retry-After``, 503 as a draining server does; ``bad_digest`` sends a
    digest that does not verify."""

    def __init__(self, reply_status=200, retry_after='7', bad_digest=False):
        self.state = {'ready': True, 'draining': False,
                      'loadinfo': {'queue_depth': 0, 'in_flight': 0, 'kv_occupancy': 0.0}}
        self.calls: list[dict] = []
        self.health_probes = 0
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = 'HTTP/1.1'

            def log_message(self, *args):
                pass

            def _json(self, status, doc, headers=None):
                raw = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header('Content-Type', 'application/json')
                for key, value in (headers or {}).items():
                    self.send_header(key, value)
                self.send_header('Content-Length', str(len(raw)))
                # No keep-alive: a stopped stub must refuse every later
                # request, pooled connections included.
                self.send_header('Connection', 'close')
                self.close_connection = True
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):  # noqa: N802
                if self.path == '/health':
                    stub.health_probes += 1
                    self._json(200, {'ready': stub.state['ready'],
                                     'draining': stub.state['draining']})
                else:
                    self._json(200, stub.state['loadinfo'])

            def do_POST(self):  # noqa: N802
                body = json.loads(self.rfile.read(int(self.headers['Content-Length'])))
                stub.calls.append(body)
                if reply_status == 429:
                    self._json(429, {'error': {'message': 'queue full', 'type': 'overloaded'}},
                               {'Retry-After': retry_after})
                    return
                if reply_status == 503:
                    self._json(503, {'error': {'message': 'server is draining',
                                               'type': 'draining'}}, {'Retry-After': '5'})
                    return
                headers = {}
                chain = jax_affinity.prompt_prefix_digests(body.get('messages', []))
                if chain:
                    headers[affinity.HEADER_DIGEST] = (
                        'ab' * 32 if bad_digest else chain[-1].hex())
                    headers[affinity.HEADER_DEPTH] = str(len(chain))
                self._json(200, {'choices': [{'message': {'content': 'ok',
                                                          'role': 'assistant'}}]}, headers)

        self._httpd = ThreadingHTTPServer(('127.0.0.1', 0), Handler)
        self._httpd.daemon_threads = True
        self.url = f'http://127.0.0.1:{self._httpd.server_address[1]}'
        self._thread = threading.Thread(target=self._httpd.serve_forever, args=(0.05,),
                                        daemon=True)
        self._thread.start()
        self._stopped = False

    def probed(self, timeout=10.0):
        """Wait for the router's first ``/health`` probe (both routers
        probe at start), so a later stop is found on the proxy path."""
        deadline = time.monotonic() + timeout
        while not self.health_probes:
            assert time.monotonic() < deadline, 'the router never probed'
            time.sleep(0.01)

    def stop(self):
        if not self._stopped:
            self._stopped = True
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)


def _port_router(urls, policy, **overrides):
    config = RouterConfig(
        replicas=tuple(urls), policy=policy,
        loadinfo_ttl_s=overrides.pop('loadinfo_ttl_s', 0.01),
        health_interval_s=overrides.pop('health_interval_s', 30.0),
        request_timeout_s=10.0, **overrides,
    )
    server = RouterServer(config).start()
    return f'http://127.0.0.1:{server.port}', server.close, instruments


def _jax_router(urls, policy, **overrides):
    config = JaxRouterConfig(
        replicas=tuple(urls), policy=policy,
        loadinfo_ttl_s=overrides.pop('loadinfo_ttl_s', 0.01),
        health_interval_s=overrides.pop('health_interval_s', 30.0),
        request_timeout_s=10.0, **overrides,
    )
    url, stop = _serve(build_router_app(config))
    return url, stop, jax_instruments


class Scenario:
    """One router in front of fresh stubs; :meth:`post` records, per
    request, (stub index, decision label, retry marker, status)."""

    def __init__(self, make_router, stubs, policy, **overrides):
        self.stubs = stubs
        self.url, self._stop, self._metrics = make_router([s.url for s in stubs], policy,
                                                          **overrides)
        self.seen: list[tuple] = []

    def _decisions(self):
        return {d: self._metrics.ROUTER_REQUESTS.labels(decision=d).value for d in DECISIONS}

    def post(self, text, **body):
        before = self._decisions()
        status, headers, raw = _call(self.url, 'POST', '/v1/chat/completions',
                                     {'messages': [{'role': 'user', 'content': text}], **body})
        after = self._decisions()
        decision = [d for d in DECISIONS if after[d] != before[d]]
        name = headers.get(affinity.HEADER_REPLICA)
        index = next((i for i, s in enumerate(self.stubs) if s.url.endswith(f'//{name}')), None)
        self.seen.append((index, decision, headers.get(affinity.HEADER_RETRY), status))
        return status, headers, raw

    def health(self):
        status, _, raw = _call(self.url, 'GET', '/health')
        doc = json.loads(raw)
        return status, doc

    def close(self):
        self._stop()
        for stub in self.stubs:
            stub.stop()


def _round_robin(make):
    sc = Scenario(make, [StubReplica(), StubReplica()], 'round_robin')
    try:
        for i in range(4):
            assert sc.post(f'req {i}')[0] == 200
        assert [len(s.calls) for s in sc.stubs] == [2, 2]
        return sc.seen
    finally:
        sc.close()


def _prefix_affinity(make):
    sc = Scenario(make, [StubReplica(), StubReplica()], 'prefix_affinity')
    try:
        for session in ('alpha', 'beta'):
            text = f'session-{session} ' + 'p' * 150
            home = sc.post(text + ' turn 0')[1][affinity.HEADER_REPLICA]
            for turn in range(1, 4):
                assert sc.post(text + f' turn {turn}')[1][affinity.HEADER_REPLICA] == home
        assert sc.post('short')[0] == 200  # no full block: no affinity signal
        return sc.seen
    finally:
        sc.close()


def _least_loaded(make):
    stubs = [StubReplica(), StubReplica()]
    stubs[0].state['loadinfo'] = {'queue_depth': 5, 'in_flight': 3, 'kv_occupancy': 0.9}
    sc = Scenario(make, stubs, 'least_loaded')
    try:
        for i in range(3):
            assert sc.post(f'cold {i}')[0] == 200
        assert [len(s.calls) for s in stubs] == [0, 3]
        return sc.seen
    finally:
        sc.close()


def _drain(make):
    sc = Scenario(make, [StubReplica(), StubReplica()], 'round_robin', health_interval_s=0.05)
    try:
        sc.stubs[0].state['draining'] = True
        deadline = time.monotonic() + 5
        while 'draining' not in sc.health()[1]['replicas'].values():
            assert time.monotonic() < deadline, 'the router never observed the drain'
            time.sleep(0.05)
        for i in range(4):
            assert sc.post(f'r {i}')[0] == 200
        # One-way: ready again does not rejoin.
        sc.stubs[0].state.update(draining=False, ready=True)
        time.sleep(0.3)
        for i in range(3):
            assert sc.post(f's {i}')[0] == 200
        assert len(sc.stubs[0].calls) == 0
        assert 'draining' in sc.health()[1]['replicas'].values()
        return sc.seen
    finally:
        sc.close()


def _dead_retry(make):
    sc = Scenario(make, [StubReplica(), StubReplica()], 'round_robin')
    try:
        sc.stubs[0].probed()
        sc.stubs[0].stop()
        assert sc.post('failover me')[0] == 200
        assert sc.post('again')[0] == 200
        assert len(sc.stubs[1].calls) == 2
        return sc.seen
    finally:
        sc.close()


def _reject_429(make):
    sc = Scenario(make, [StubReplica(reply_status=429, retry_after='9'), StubReplica()],
                  'round_robin')
    try:
        rejected = [r for r in (sc.post(f'r {i}') for i in range(2)) if r[0] == 429]
        assert len(rejected) == 1 and rejected[0][1]['Retry-After'] == '9'
        assert json.loads(rejected[0][2])['error']['type'] == 'overloaded'
        assert [len(s.calls) for s in sc.stubs] == [1, 1]
        return sc.seen
    finally:
        sc.close()


def _draining_503(make):
    sc = Scenario(make, [StubReplica(reply_status=503), StubReplica()], 'round_robin')
    try:
        for i in range(3):
            assert sc.post(f'd {i}')[0] == 200
        assert len(sc.stubs[0].calls) == 1
        assert sc.health()[1]['replicas'][sc.stubs[0].url.split('//')[1]] == 'draining'
        return sc.seen
    finally:
        sc.close()


def _none_left(make):
    sc = Scenario(make, [StubReplica()], 'least_loaded')
    try:
        sc.stubs[0].probed()
        sc.stubs[0].stop()
        status, headers, raw = sc.post('nobody home')
        assert status == 503 and headers['Retry-After'] == '5'
        assert json.loads(raw)['error']['type'] == 'router_unavailable'
        status, doc = sc.health()
        assert status == 503 and doc['ready'] is False
        return sc.seen
    finally:
        sc.close()


def _corrupt_header(make):
    sc = Scenario(make, [StubReplica(bad_digest=True), StubReplica(bad_digest=True)],
                  'prefix_affinity')
    try:
        for turn in range(3):
            assert sc.post('session ' + 'q' * 150 + f' {turn}')[0] == 200
        assert sc.health()[1]['affinity_entries'] == 0
        return sc.seen
    finally:
        sc.close()


CASES = {
    'round_robin': _round_robin, 'prefix_affinity': _prefix_affinity,
    'least_loaded': _least_loaded, 'drain_one_way': _drain, 'dead_retry_once': _dead_retry,
    '429_relayed': _reject_429, 'draining_503_moved': _draining_503,
    'no_replica_left': _none_left, 'corrupt_header_dropped': _corrupt_header,
}


@pytest.mark.parametrize('case', list(CASES))
def test_routers_agree_in_front_of_the_same_stubs(case):
    port = CASES[case](_port_router)
    ref = CASES[case](_jax_router)
    assert port == ref
    assert len(port) >= 1


def test_router_health_reports_states():
    for make in (_port_router, _jax_router):
        sc = Scenario(make, [StubReplica()], 'prefix_affinity')
        try:
            status, doc = sc.health()
            assert status == 200 and doc['ready'] is True
            assert doc['policy'] == 'prefix_affinity'
            assert list(doc['replicas'].values()) == ['healthy']
            assert set(doc) == {'status', 'ready', 'policy', 'replicas', 'affinity_entries'}
        finally:
            sc.close()


def test_router_metrics_and_config():
    sc = Scenario(_port_router, [StubReplica()], 'round_robin')
    try:
        sc.post('count me')
        status, headers, raw = _call(sc.url, 'GET', '/metrics')
        assert status == 200 and headers['Content-Type'].startswith('text/plain')
        text = raw.decode()
        for series in ('distllm_router_requests_total', 'distllm_router_replicas',
                       'distllm_router_proxy_seconds', 'distllm_router_affinity_entries'):
            assert series in text
    finally:
        sc.close()
    assert RouterConfig().to_dict() == {
        k: (list(v) if isinstance(v, tuple) else v)
        for k, v in JaxRouterConfig().model_dump().items()} | {'replicas': ()}
    with pytest.raises(ValueError):
        RouterConfig(policy='random')


# ------------------------------------------------------- replica surface
def test_chat_server_digest_headers_equal_jax(both_servers):
    port, ref = both_servers()
    for messages in ([{'role': 'user', 'content': 'q' * 200}],
                     [{'role': 'system', 'content': 'be terse ' * 10},
                      {'role': 'user', 'content': 'hello ' * 30}],
                     [{'role': 'user', 'content': 'short'}]):
        chain = affinity.prompt_prefix_digests(messages)
        for stream in (False, True):
            got, want = (_call(b, 'POST', '/v1/chat/completions',
                               {'messages': messages, 'stream': stream}) for b in (port, ref))
            assert got[0] == want[0] == 200
            for key in (affinity.HEADER_DIGEST, affinity.HEADER_DEPTH):
                assert got[1].get(key) == want[1].get(key)
            if chain:
                assert got[1][affinity.HEADER_DIGEST] == chain[-1].hex()
                assert int(got[1][affinity.HEADER_DEPTH]) == len(chain)
            else:
                assert affinity.HEADER_DIGEST not in got[1]


def test_router_relays_the_chat_servers_sse(both_servers):
    port, _ = both_servers()
    server = RouterServer(RouterConfig(replicas=(port,), policy='prefix_affinity',
                                       health_interval_s=30.0, request_timeout_s=10.0)).start()
    try:
        base = f'http://127.0.0.1:{server.port}'
        messages = [{'role': 'user', 'content': 'stream ' * 40}]
        direct = _call(port, 'POST', '/v1/chat/completions',
                       {'messages': messages, 'stream': True})
        relayed = _call(base, 'POST', '/v1/chat/completions',
                        {'messages': messages, 'stream': True}, {'X-Request-Id': 'sse-1'})
        assert relayed[0] == 200
        assert relayed[1]['Content-Type'] == direct[1]['Content-Type'] == 'text/event-stream'
        events = [e for e in relayed[2].decode().split('\n\n') if e]
        assert len(events) == 2 and events[1] == 'data: [DONE]'
        chunk = json.loads(events[0].removeprefix('data: '))
        assert chunk['object'] == 'chat.completion.chunk' and chunk['request_id'] == 'sse-1'
        assert relayed[1]['X-Request-Id'] == 'sse-1'
        assert relayed[1][affinity.HEADER_DIGEST] == direct[1][affinity.HEADER_DIGEST]
        assert relayed[1][affinity.HEADER_REPLICA] == port.split('//')[1]
        # The digest verified: the next request on this prefix is affinity.
        assert server.router.affinity.entries() == len(
            affinity.prompt_prefix_digests(messages))
    finally:
        server.close()


# ------------------------------------------------- replica-aware merge
def test_host_label_and_merge_name_replicas_as_jax(tmp_path):
    from distllm_tpu.observability import aggregate as jax_aggregate
    from distllm_tpu_torch.observability import aggregate

    paths = ['bundle/replica-0/flight.jsonl', 'bundle/replica-1/spans.jsonl',
             'logs/capture-host3.jsonl', 'a/replica-0/flight.jsonl',
             'b/replica-0/flight.jsonl', 'c/replica-0/flight.jsonl']
    seen_port, seen_jax = set(), set()
    assert ([aggregate.host_label(p, seen_port) for p in paths]
            == [jax_aggregate.host_label(p, seen_jax) for p in paths])
    files = []
    for r in range(2):
        d = tmp_path / f'replica-{r}'
        d.mkdir()
        path = d / 'flight.jsonl'
        path.write_text('\n'.join(json.dumps(rec) for rec in (
            {'kind': 'prefill', 't_wall': 100.0 + r, 'duration_s': 0.05, 'batch': 1,
             'tokens': 32},
            {'kind': 'decode', 't_wall': 100.2 + r, 'duration_s': 0.02, 'batch': 1,
             'tokens': 4})) + '\n')
        files.append(path)
    names = {}
    for side, module in (('port', aggregate), ('jax', jax_aggregate)):
        out = tmp_path / f'{side}.json'
        assert module.write_combined_perfetto(files, out) == 2
        doc = json.loads(out.read_text())
        names[side] = {e['args']['name'] for e in doc['traceEvents']
                       if e['ph'] == 'M' and e['name'] == 'process_name'}
    assert names['port'] == names['jax'] == {'replica-0', 'replica-1'}
