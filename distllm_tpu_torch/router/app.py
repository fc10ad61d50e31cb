"""Prefix-affinity HTTP router for N chat-server replicas (counterpart of
``distllm_tpu.router.app``, on the standard library's HTTP server and
``http.client`` as the port's chat server is).

It balances the OpenAI surface (``POST /v1/chat/completions``) across
replicas, routing each request to the replica most likely to hold its KV
blocks already. Entry point: ``python -m distllm_tpu_torch.router``.

Policies (``RouterConfig.policy``), as in the JAX router:

- ``prefix_affinity`` (default): score every healthy replica by the longest
  prefix of the request's byte-level digest chain in its learned
  :class:`~distllm_tpu_torch.router.affinity.AffinityMap`; the deepest match
  wins (decision ``affinity``), and depth 0 everywhere falls back to
  least-loaded. A replica's response headers teach the map only after the
  advertised digest is verified against the router's own chain.
- ``least_loaded``: the lightest ``GET /loadinfo`` (queue depth, then in
  flight, then KV occupancy), each probe cached for ``loadinfo_ttl_s``.
- ``round_robin``: the baseline rotation.

Failures: a background thread probes each replica's ``/health`` every
``health_interval_s``; a refused connection or a non-ready answer takes it
out of rotation (``dead``), and it rejoins when probes recover.
``draining`` is one-way: a drained replica never rejoins and its affinity
map is forgotten. A request whose replica dies mid-proxy (or answers 503
while draining) is retried once on a healthy peer, and the response says
so with ``X-Distllm-Router-Retry: 1``; a 429 is relayed untouched, never
retried elsewhere (backpressure is the replica's call). Every proxied
response carries ``X-Distllm-Router-Replica``. A replica's SSE answer (the
chat server's single-delta stream) is relayed whole with its
``text/event-stream`` type, as the JAX router relays it.

``GET /health`` reports the rotation; ``GET /metrics`` the process registry
with the ``distllm_router_*`` series.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from distllm_tpu_torch.observability import instruments
from distllm_tpu_torch.observability.metrics import render_prometheus
from distllm_tpu_torch.router.affinity import (
    DEFAULT_BLOCK_BYTES,
    HEADER_DEPTH,
    HEADER_DIGEST,
    HEADER_REPLICA,
    HEADER_RETRY,
    AffinityMap,
    prompt_prefix_digests,
)
from distllm_tpu_torch.utils import BaseConfig, lax_float, lax_int, lax_str

POLICIES = ('prefix_affinity', 'least_loaded', 'round_robin')
# Response headers relayed from replica to client (with the router's own
# markers); hop-by-hop headers stay out.
_RELAY_HEADERS = ('Content-Type', 'Retry-After', 'X-Request-Id', HEADER_DIGEST, HEADER_DEPTH)
# What a failed connection, a timeout or a cut answer raises.
_UPSTREAM_ERRORS = (OSError, http.client.HTTPException)


@dataclass
class RouterConfig(BaseConfig):
    """The router's knobs (the JAX ``RouterConfig``'s fields)."""

    # Replica base URLs ('http://host:port'), the initial rotation.
    replicas: tuple[str, ...] = ()
    policy: str = 'prefix_affinity'
    # Digest-chain granularity in prompt-prefix bytes; must match what the
    # replicas hash into their response headers.
    affinity_block_bytes: int = DEFAULT_BLOCK_BYTES
    # Bound of each per-replica digest LRU map.
    affinity_map_size: int = 4096
    # How long a /loadinfo answer is reused.
    loadinfo_ttl_s: float = 0.25
    # Period of the background /health probes.
    health_interval_s: float = 2.0
    # One upstream completion's timeout.
    request_timeout_s: float = 300.0

    def validate(self) -> None:
        self.replicas = tuple(lax_str('replicas', r) for r in self.replicas)
        self.policy = lax_str('policy', self.policy, POLICIES)
        self.affinity_block_bytes = lax_int('affinity_block_bytes', self.affinity_block_bytes)
        self.affinity_map_size = lax_int('affinity_map_size', self.affinity_map_size)
        for key in ('loadinfo_ttl_s', 'health_interval_s', 'request_timeout_s'):
            setattr(self, key, lax_float(key, getattr(self, key)))


class Replica:
    """Rotation state of one replica (changed under the router's lock)."""

    def __init__(self, url: str) -> None:
        self.url = url.rstrip('/')
        # Short display name for headers and traces: 'host:port'.
        self.name = self.url.split('//', 1)[-1]
        parts = urllib.parse.urlsplit(self.url)
        self.host, self.port = parts.hostname, parts.port or 80
        self.state = 'healthy'  # healthy | dead | draining
        self.load: dict | None = None
        self.load_at = 0.0

    @property
    def in_rotation(self) -> bool:
        return self.state == 'healthy'

    def mark_dead(self) -> None:
        # Drain outranks dead: a draining replica that stops answering
        # stays drained and must not rejoin when probes recover.
        if self.state != 'draining':
            self.state = 'dead'

    def mark_draining(self) -> None:
        self.state = 'draining'

    def mark_healthy(self) -> None:
        # One-way drain: only dead recovers.
        if self.state == 'dead':
            self.state = 'healthy'


def _request(replica: Replica, method: str, path: str, timeout: float,
             body: bytes | None = None, headers: dict | None = None):
    """One HTTP exchange with a replica: ``(status, headers, body)``; a
    transport failure raises one of ``_UPSTREAM_ERRORS``. The body is read
    whole (an SSE answer until the replica closes it)."""
    conn = http.client.HTTPConnection(replica.host, replica.port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.headers, resp.read()
    finally:
        conn.close()


class Router:
    """The routing state and decisions, apart from the HTTP surface:
    :class:`RouterServer` calls :meth:`complete` per request. Thread-safe
    (one lock over the rotation, the affinity maps and the rotation
    index; none is held across an upstream call)."""

    def __init__(self, config: RouterConfig) -> None:
        self.config = config
        self.replicas = [Replica(url) for url in config.replicas]
        self.affinity = AffinityMap(config.affinity_map_size)
        self._lock = threading.Lock()
        self._rr_index = 0  # guarded by self._lock
        self._stop = threading.Event()
        self._health_thread: threading.Thread | None = None
        self.publish_states()

    # ------------------------------------------------------------ health
    def publish_states(self) -> None:
        with self._lock:
            counts = {label: sum(1 for r in self.replicas if r.state == label)
                      for label in instruments.ROUTER_REPLICA_STATE_LABELS}
            entries = self.affinity.entries()
        for label, count in counts.items():
            instruments.ROUTER_REPLICAS.labels(state=label).set(count)
        instruments.ROUTER_AFFINITY_ENTRIES.set(entries)

    def probe(self, replica: Replica) -> None:
        """One ``/health`` probe and the state change it implies."""
        try:
            _, _, raw = _request(
                replica, 'GET', '/health', max(1.0, self.config.health_interval_s))
            doc = json.loads(raw)
        except (*_UPSTREAM_ERRORS, ValueError):  # no answer: out of rotation
            doc = None
        if not isinstance(doc, dict):
            with self._lock:
                replica.mark_dead()
            return
        with self._lock:
            if doc.get('draining'):
                if replica.state != 'draining':
                    replica.mark_draining()
                    # Its cache dies with the process: re-learning after a
                    # restart beats routing warm traffic to a refusal.
                    self.affinity.drop(replica.name)
            elif doc.get('ready'):
                replica.mark_healthy()
            else:
                replica.mark_dead()

    def _health_loop(self) -> None:
        while not self._stop.is_set():
            threads = [threading.Thread(target=self.probe, args=(r,), daemon=True)
                       for r in self.replicas]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join()
            self.publish_states()
            self._stop.wait(self.config.health_interval_s)

    def start(self) -> None:
        self._health_thread = threading.Thread(
            target=self._health_loop, name='router-health', daemon=True)
        self._health_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=max(5.0, self.config.health_interval_s + 5.0))

    def health(self) -> tuple[int, dict]:
        with self._lock:
            healthy = sum(1 for r in self.replicas if r.in_rotation)
            doc = {
                'status': 'ok' if healthy else 'unavailable',
                'ready': healthy > 0,
                'policy': self.config.policy,
                'replicas': {r.name: r.state for r in self.replicas},
                'affinity_entries': self.affinity.entries(),
            }
        return (200 if healthy else 503), doc

    # ----------------------------------------------------------- routing
    def _loadinfo(self, replica: Replica) -> dict | None:
        now = time.monotonic()
        with self._lock:
            if replica.load is not None and now - replica.load_at < self.config.loadinfo_ttl_s:
                return replica.load
        try:
            _, _, raw = _request(
                replica, 'GET', '/loadinfo', max(1.0, self.config.loadinfo_ttl_s * 4))
            load = json.loads(raw)
        except (*_UPSTREAM_ERRORS, ValueError):  # a failed probe demotes it
            load = None
        if not isinstance(load, dict):
            with self._lock:
                replica.mark_dead()
            return None
        with self._lock:
            replica.load, replica.load_at = load, now
        return load

    def _pick_least_loaded(self, candidates: list[Replica]) -> Replica | None:
        loads = [self._loadinfo(r) for r in candidates]
        best = best_replica = None
        with self._lock:
            for replica, load in zip(candidates, loads):
                if load is None or not replica.in_rotation:
                    continue
                key = (int(load.get('queue_depth', 0)), int(load.get('in_flight', 0)),
                       float(load.get('kv_occupancy', 0.0)))
                if best is None or key < best:
                    best, best_replica = key, replica
        return best_replica

    def _pick_round_robin_locked(self, candidates: list[Replica]) -> Replica:
        pick = candidates[self._rr_index % len(candidates)]
        self._rr_index += 1
        return pick

    def pick(self, chain: list[bytes], exclude: Replica | None = None
             ) -> tuple[Replica | None, str]:
        """One routing decision: ``(replica, decision label)``."""
        with self._lock:
            candidates = [r for r in self.replicas if r.in_rotation and r is not exclude]
            if not candidates:
                return None, 'least_loaded'
            if self.config.policy == 'round_robin':
                return self._pick_round_robin_locked(candidates), 'round_robin'
            if self.config.policy == 'prefix_affinity' and chain:
                depth, _, best = max(
                    (self.affinity.score(r.name, chain), i, r)
                    for i, r in enumerate(candidates)
                )
                if depth > 0:
                    return best, 'affinity'
        picked = self._pick_least_loaded(candidates)
        if picked is None:
            with self._lock:
                # Every load probe failed this instant but candidates were
                # in rotation: rotate rather than refuse.
                alive = [r for r in candidates if r.in_rotation]
                if alive:
                    return self._pick_round_robin_locked(alive), 'round_robin'
        return picked, 'least_loaded'

    def _leave_rotation(self, replica: Replica, draining: bool) -> None:
        with self._lock:
            if draining:
                replica.mark_draining()
                self.affinity.drop(replica.name)
            else:
                replica.mark_dead()
        self.publish_states()

    def complete(self, body: bytes, request_id: str | None) -> tuple[int, dict, bytes]:
        """Route and proxy one completion: ``(status, headers, body)`` for
        the client."""
        t_start = time.perf_counter()
        try:
            doc = json.loads(body or b'{}')
        except ValueError:  # the replica's 400 to give: route it as is
            doc = {}
        messages = doc.get('messages', []) if isinstance(doc, dict) else []
        chain = (prompt_prefix_digests(messages, self.config.affinity_block_bytes)
                 if isinstance(messages, list) else [])
        fwd_headers = {'Content-Type': 'application/json'}
        if request_id:
            fwd_headers['X-Request-Id'] = request_id
        retried = False
        exclude: Replica | None = None
        for attempt in range(2):
            replica, decision = self.pick(chain, exclude=exclude)
            if replica is None:
                break
            try:
                status, up_headers, payload = _request(
                    replica, 'POST', '/v1/chat/completions', self.config.request_timeout_s,
                    body=body, headers=fwd_headers)
            except _UPSTREAM_ERRORS:
                # The replica died mid-proxy: out of rotation, and the
                # request is retried once on a healthy peer.
                self._leave_rotation(replica, draining=False)
                exclude = replica
                if attempt == 0:
                    retried = True
                    instruments.ROUTER_RETRIES.inc()
                continue
            if status == 503 and replica.state != 'draining':
                # Refused because it is going away (a drain racing the
                # probes): nothing was processed, so the request moves.
                self._leave_rotation(replica, draining=True)
                exclude = replica
                if attempt == 0:
                    retried = True
                    instruments.ROUTER_RETRIES.inc()
                    continue
            instruments.ROUTER_REQUESTS.labels(decision=decision).inc()
            if status == 429:
                # Admission control spoke: relayed untouched, never moved.
                instruments.ROUTER_UPSTREAM_REJECTIONS.inc()
            else:
                with self._lock:
                    learned = self.affinity.verify_and_learn(
                        replica.name, chain, up_headers.get(HEADER_DIGEST),
                        up_headers.get(HEADER_DEPTH))
                    entries = self.affinity.entries()
                if learned:
                    instruments.ROUTER_AFFINITY_ENTRIES.set(entries)
            out = {k: up_headers[k] for k in _RELAY_HEADERS if up_headers.get(k) is not None}
            out[HEADER_REPLICA] = replica.name
            if retried:
                out[HEADER_RETRY] = '1'
            instruments.ROUTER_PROXY_SECONDS.observe(time.perf_counter() - t_start)
            return status, out, payload
        instruments.ROUTER_FAILURES.inc()
        instruments.ROUTER_PROXY_SECONDS.observe(time.perf_counter() - t_start)
        error = {'error': {'message': 'no replica available', 'type': 'router_unavailable'}}
        return 503, {'Content-Type': 'application/json', 'Retry-After': '5'}, json.dumps(
            error).encode()


class _HTTPServer(ThreadingHTTPServer):
    request_queue_size = 128
    daemon_threads = True


def _make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'

        def log_message(self, format, *args) -> None:  # noqa: A002
            pass

        def _send(self, status: int, headers: dict, body: bytes) -> None:
            self.send_response(status)
            for key, value in headers.items():
                self.send_header(key, value)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, status: int, doc: dict) -> None:
            self._send(status, {'Content-Type': 'application/json'}, json.dumps(doc).encode())

        def do_GET(self) -> None:  # noqa: N802
            path = urllib.parse.urlsplit(self.path).path
            if path == '/health':
                self._send_json(*router.health())
            elif path == '/metrics':
                self._send(200, {'Content-Type': 'text/plain; version=0.0.4; charset=utf-8'},
                           render_prometheus().encode('utf-8'))
            else:
                self._send_json(404, {'error': {'message': 'not found'}})

        def do_POST(self) -> None:  # noqa: N802
            path = urllib.parse.urlsplit(self.path).path
            length = int(self.headers.get('Content-Length') or 0)
            body = self.rfile.read(length) if length else b''
            if path != '/v1/chat/completions':
                self._send_json(404, {'error': {'message': 'not found'}})
                return
            self._send(*router.complete(body, self.headers.get('X-Request-Id')))

    return Handler


class RouterServer:
    """A :class:`Router` behind a ``ThreadingHTTPServer``; ``port=0`` binds
    a free port (read it back from :attr:`port`). :meth:`start` starts the
    health probes and the server; :meth:`close` stops both."""

    def __init__(self, config: RouterConfig, host: str = '127.0.0.1', port: int = 0) -> None:
        self.router = Router(config)
        self._httpd = _HTTPServer((host, port), _make_handler(self.router))
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, args=(0.1,), name='router-http', daemon=True)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> 'RouterServer':
        self.router.start()
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(30.0)
        self._httpd.server_close()
        self.router.stop()

    def __enter__(self) -> 'RouterServer':
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
