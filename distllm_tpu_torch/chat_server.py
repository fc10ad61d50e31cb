"""OpenAI-compatible chat server on the standard library's HTTP server.

The counterpart of ``distllm_tpu.chat_server``, route for route with the
JAX server's status codes, headers and body keys:

- ``POST /v1/chat/completions`` — the JAX payload shape; ``stream: true``
  answers as single-delta SSE (one ``chat.completion.chunk`` event and
  ``data: [DONE]``, then the connection closes); an engine that sheds
  the request (``resilience.EngineOverloaded``, admission control on)
  answers 429 with ``Retry-After`` and ``predicted_ttft_s``; while the
  server drains, 503 with ``Retry-After: 5``. The ``X-Request-Id``
  header (one is made when absent) is bound around the request's work
  (``observability.request_scope``), so the engine's lifecycle record
  carries it, and is echoed back.
- ``GET /health`` — liveness, uptime, in-flight and served counts; 503
  with ``ready: false`` while draining.
- ``POST /drain?seconds=N`` — stop admitting completions, flip
  ``/health``, and wait (at most ``N``, default 30, bounded at 300 s)
  for the completions in flight; one-way per process.
- ``GET /loadinfo`` — queue depth, running slots, KV occupancy, drain
  state and completions in flight as a small JSON document.
- ``GET /metrics`` — the Prometheus text exposition of the process
  registry (``observability.instruments``).
- ``GET /debug/traces?limit=N`` (default 100) — the newest finished spans
  of the trace ring;
- ``GET /debug/flight?limit=N`` (200) — the newest flight records, the
  lifetime count and the ring's capacity;
- ``GET /debug/perfetto?limit=N`` (2000) — the flight and span rings and
  the metric history as one Perfetto / ``chrome://tracing`` document
  (``observability.perfetto``);
- ``GET /debug/history?limit=N&prefix=...`` (120) — the metric-history
  ring (``distllm-history/v1``), sampled every ``DISTLLM_HISTORY_S``
  seconds (default 1; 0 disables) by a thread the server starts and
  stops;
- ``GET /debug/slo`` — ``slo_status()`` (burn rates, ok / warn / page)
  and the regression sentinel's state (armed by ``DISTLLM_BASELINE``, an
  envelope file the user names);
- ``GET /debug/bundle`` — a debug bundle written under
  ``DISTLLM_DEBUG_DIR`` (default ``./debug_bundles``), and its paths;
- ``GET /debug/xprof?seconds=N`` (2, bounded to 0.1..60) — a blocking
  ``torch.profiler`` capture (``observability.profiling``; the JAX
  route's name, kept for its clients): 200 with the trace, 409 while
  another capture runs, 501 when the profiler fails, 400 for a
  non-finite ``seconds``.

A non-integer ``limit`` answers 400. With ``DISTLLM_WATCHDOG_S`` > 0 each
generation runs under a :class:`~distllm_tpu_torch.observability.flight.StallWatchdog`
that dumps a bundle when the engine's flight ring stops advancing.

Every response carries the JAX server's CORS headers (an ``OPTIONS``
preflight on any path answers 204), and every request is counted as the
JAX middleware counts it: ``distllm_http_in_flight``,
``distllm_http_request_duration_seconds{path}``,
``distllm_http_requests_total{path,status}`` and
``distllm_http_responses_total``. Every completion, streamed or not,
carries the prefix-affinity headers the router learns from, as the JAX
server sets them: ``X-Distllm-Prefix-Digest`` (hex of the deepest digest
of the messages' byte chain, ``router.affinity.prompt_prefix_digests``)
and ``X-Distllm-Prefix-Depth`` (its index + 1); a prompt shorter than one
64-byte block carries neither.

Messages render through :class:`~distllm_tpu_torch.chat.ConversationPromptTemplate`
and every request goes through ONE worker thread that owns the generator
and its engine — the engine's scheduler and KV pool are not thread-safe,
and concurrency comes from the engine's batching, not from threads. The
HTTP threads only parse, wait and answer. The generator captured its
decode graphs when it was built (``TorchGenerator`` warms its engine up
in the constructing thread, before this server's threads exist), so the
worker only replays them. With a retriever, the worker first retrieves on
the latest user message (the body's ``top_k`` and ``score_threshold``,
defaulting to the app config's ``retrieval_top_k`` and
``retrieval_score_threshold``) and renders the contexts and their scores
into the prompt, as the JAX server does.

Run (random-init Mistral weights on the GPU; ``--num-layers`` cuts depth)::

    python -m distllm_tpu_torch.chat_server --port 8000 --num-layers 32

``--quantization int8`` serves the weights int8-quantized on the GPU
(every projection through kernel K2); ``nf4`` dequantizes per layer.
``--config app.yaml`` reads the JAX chat app's YAML instead, as the JAX
``ChatAppConfig`` reads it (``load_app``): ``generator_config`` (a
mapping of ``TorchGeneratorConfig`` fields; its ``name`` an engine name,
``tpu``, ``vllm`` or ``torch``, or ``fake``; ``model`` a mapping of config
fields whose ``name`` picks the family, ``gemma2`` a ``GemmaConfig``; the
serving knobs ``draft_k``, ``enable_mixed_batching``,
``enable_prefix_cache`` (on by default, as in the JAX app) and the rest),
``retriever_config`` (the JAX ``RetrieverConfig``'s keys: the index, the
query encoder and pooler), ``system_prompt`` and the retrieval keys;
``--device`` applies to the engine and the retriever.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import queue
import re
import threading
import time
import urllib.parse
import uuid
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import distllm_tpu_torch
from distllm_tpu_torch.chat import ConversationPromptTemplate, retrieve
from distllm_tpu_torch.observability import instruments
from distllm_tpu_torch.observability.flight import (
    StallWatchdog,
    dump_debug_bundle,
    get_flight_recorder,
)
from distllm_tpu_torch.observability.history import HistorySampler, get_metrics_history
from distllm_tpu_torch.observability.metrics import render_prometheus
from distllm_tpu_torch.observability.perfetto import to_trace_events
from distllm_tpu_torch.observability.profiling import get_profiler_capture
from distllm_tpu_torch.observability.sentinel import install_regression_sentinel
from distllm_tpu_torch.observability.slo import install_slo_observer, slo_status
from distllm_tpu_torch.observability.tracing import (
    get_trace_buffer,
    request_scope,
    span,
)
from distllm_tpu_torch.resilience.admission import EngineOverloaded
from distllm_tpu_torch.router.affinity import (
    HEADER_DEPTH,
    HEADER_DIGEST,
    prompt_prefix_digests,
)

# Accepted inbound X-Request-Id shape; anything else gets a generated id.
_REQUEST_ID_RE = re.compile(r'^[A-Za-z0-9._:-]{1,128}$')
MODEL_NAME = 'distllm-tpu-torch'  # payload 'model' when the body names none
REQUEST_TIMEOUT_S = 600.0  # an HTTP thread's wait for the engine worker
# Routes whose latency series are labelled by path, pre-registered so the
# first scrape carries the schema: the JAX server's five. Every other path,
# the /debug/* routes (DEBUG_ROUTES) included, is labelled 'other'.
KNOWN_PATHS = (
    '/v1/chat/completions', '/health', '/metrics', '/drain', '/loadinfo',
)
DRAIN_MAX_S = 300.0  # the longest a POST /drain waits for in-flight work


def _debug_dir(kind: str) -> str:
    """Where on-demand debug dumps land (``DISTLLM_DEBUG_DIR`` or
    ``./debug_bundles``), one timestamped directory per dump."""
    base = os.environ.get('DISTLLM_DEBUG_DIR') or os.path.join(os.getcwd(), 'debug_bundles')
    stamp = time.strftime('%Y%m%d-%H%M%S')
    return os.path.join(base, f'{kind}_{stamp}_{os.getpid()}_{uuid.uuid4().hex[:6]}')


def _completion_payload(model: str, content: str, request_id: str) -> dict:
    return {
        'id': f'chatcmpl-{uuid.uuid4().hex[:24]}',
        'object': 'chat.completion',
        'created': int(time.time()),
        'model': model,
        'request_id': request_id,
        'choices': [
            {
                'index': 0,
                'message': {'role': 'assistant', 'content': content},
                'finish_reason': 'stop',
            }
        ],
        'usage': {
            'prompt_tokens': 0,
            'completion_tokens': 0,
            'total_tokens': 0,
        },
    }


class EngineWorker:
    """The single thread that owns the generator and the retriever: each
    request's work (a callable) queues up and runs one at a time."""

    def __init__(self) -> None:
        self._queue: queue.Queue = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name='distllm-torch-engine', daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def submit(self, work: Callable[[], str]) -> Future:
        future: Future = Future()
        self._queue.put((work, future))
        return future

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            work, future = item
            if not future.set_running_or_notify_cancel():
                continue
            try:
                future.set_result(work())
            except Exception as exc:  # the error is answered to the client
                future.set_exception(exc)

    def stop(self, timeout: float = 30.0) -> None:
        if self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout)


class _HTTPServer(ThreadingHTTPServer):
    # The listen backlog of the JAX server's aiohttp site (the standard
    # library's default of 5 resets connections under a burst of clients).
    request_queue_size = 128
    daemon_threads = True


class ChatServer:
    """``ThreadingHTTPServer`` + one :class:`EngineWorker`. ``port=0`` binds
    a free port (read it back from :attr:`port`). With a ``retriever``,
    each request retrieves ``top_k`` contexts (default
    ``retrieval_top_k``) scoring at least ``score_threshold`` (default
    ``retrieval_score_threshold``); :attr:`timings` keeps each answered
    request's retrieve and generate seconds. :meth:`drain` is what
    ``POST /drain`` runs."""

    def __init__(
        self,
        generator,
        host: str = '127.0.0.1',
        port: int = 0,
        system_prompt: str = '',
        retriever=None,
        retrieval_top_k: int = 20,
        retrieval_score_threshold: float = 0.1,
    ) -> None:
        self.generator = generator
        self.retriever = retriever
        self.retrieval_top_k = retrieval_top_k
        self.retrieval_score_threshold = retrieval_score_threshold
        self.template = ConversationPromptTemplate(system_prompt)
        self.worker = EngineWorker()
        self.timings: list[dict] = []  # appended by the worker thread only
        self.started_at = time.time()
        self._served = 0  # guarded by self._lock
        # Drain lifecycle: one-way; completions_in_flight counts completion
        # work only (not the /health polls a draining server invites).
        self.draining = False  # guarded by self._lock
        self._completions_in_flight = 0  # guarded by self._lock
        self._lock = threading.Lock()
        for path in KNOWN_PATHS:
            instruments.HTTP_LATENCY.labels(path=path)
        # Continuous telemetry: the process metric history, sampled every
        # DISTLLM_HISTORY_S seconds by a thread this server owns; the SLO
        # burn-rate observer, the regression sentinel and the uptime gauge
        # ride the same tick. Detached again in close().
        instruments.SERVER_UPTIME.set(0.0)
        self.history = get_metrics_history()
        self._slo_observer = install_slo_observer(self.history)
        self.sentinel = install_regression_sentinel(
            self.history, baseline_path=os.environ.get('DISTLLM_BASELINE') or None
        )
        self.history.add_observer(self._uptime_observer)
        interval = float(os.environ.get('DISTLLM_HISTORY_S', '1') or 0)
        self.sampler = HistorySampler(self.history, interval_s=interval) if interval > 0 else None
        self._httpd = _HTTPServer((host, port), _make_handler(self))
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name='distllm-torch-http',
            daemon=True,
        )

    def _uptime_observer(self, history, now) -> None:
        instruments.SERVER_UPTIME.set(max(0.0, now - self.started_at))

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def requests_served(self) -> int:
        with self._lock:
            return self._served

    def count_served(self) -> None:
        with self._lock:
            self._served += 1

    @property
    def completions_in_flight(self) -> int:
        with self._lock:
            return self._completions_in_flight

    def begin_completion(self) -> bool:
        """Count a completion in; False (nothing counted) while draining."""
        with self._lock:
            if self.draining:
                return False
            self._completions_in_flight += 1
            return True

    def end_completion(self) -> None:
        with self._lock:
            self._completions_in_flight -= 1

    def drain(self, wait_s: float) -> dict:
        """Stop admitting completions (one-way), then wait up to ``wait_s``
        seconds for the ones in flight; the ``POST /drain`` body."""
        with self._lock:
            self.draining = True
        instruments.SERVER_READY.set(0.0)
        get_flight_recorder().record('event', event='drain_started')
        deadline = time.monotonic() + wait_s
        while self.completions_in_flight > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        remaining = self.completions_in_flight
        get_flight_recorder().record(
            'event', event='drain_finished', in_flight_remaining=remaining,
        )
        return {'draining': True, 'drained': remaining == 0,
                'in_flight_remaining': remaining}

    def loadinfo(self) -> dict:
        """The ``GET /loadinfo`` body: this server's drain state and this
        engine's scheduler (zeros for a generator without an engine)."""
        engine = getattr(self.generator, 'engine', None)
        sched = getattr(engine, 'sched', None)
        queue_depth = running = 0
        kv_occupancy = 0.0
        if sched is not None:
            queue_depth = int(sched.num_waiting)
            running = int(sched.num_running)
            usable = max(1, int(engine.config.num_blocks) - 1)
            in_use = max(0, usable - int(sched.num_free_blocks))
            kv_occupancy = round(in_use / usable, 4)
        with self._lock:
            draining, in_flight = self.draining, self._completions_in_flight
        return {
            'ready': not draining,
            'draining': draining,
            'queue_depth': queue_depth,
            'running': running,
            'in_flight': in_flight,
            'kv_occupancy': kv_occupancy,
        }

    def answer(self, messages: list[dict], top_k: int, score_threshold: float,
               request_id: str | None = None) -> str:
        """One request on the worker thread, inside ``request_scope`` of
        its id: retrieval on the latest user message, the rendered prompt,
        one generation."""
        with request_scope(request_id):
            return self._answer_in_scope(messages, top_k, score_threshold)

    def _answer_in_scope(self, messages, top_k, score_threshold) -> str:
        latest = next(
            (m['content'] for m in reversed(messages) if m['role'] == 'user'), ''
        )
        t0 = time.perf_counter()
        contexts, scores = [], []
        if latest:
            with span('chat-retrieve', top_k=top_k):
                contexts, scores = retrieve(self.retriever, latest, top_k, score_threshold)
        t1 = time.perf_counter()
        prompt = self.template.render(list(messages), contexts, scores)
        watchdog_s = float(os.environ.get('DISTLLM_WATCHDOG_S', '0') or 0)
        with span('chat-generate'):
            if watchdog_s > 0:
                # Armed per request (an idle server is not a stall): if the
                # flight ring stops advancing mid-generation, a bundle is
                # dumped. It never kills the work.
                with StallWatchdog(
                    watchdog_s, bundle_dir=_debug_dir('watchdog'), name='chat-generate',
                ):
                    content = self.generator.generate([prompt])[0]
            else:
                content = self.generator.generate([prompt])[0]
        self.timings.append({
            'retrieve_s': t1 - t0, 'generate_s': time.perf_counter() - t1,
            'contexts': len(contexts),
        })
        return content

    def start(self) -> 'ChatServer':
        self.worker.start()
        if self.sampler is not None:
            self.sampler.start()
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(30.0)
        self._httpd.server_close()
        self.worker.stop()
        if self.sampler is not None and self.sampler.running:
            self.sampler.stop()
        self.history.remove_observer(self._uptime_observer)
        self.history.remove_observer(self._slo_observer)
        self.sentinel.uninstall()

    def __enter__(self) -> 'ChatServer':
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


# The GET /debug/* routes, each a handler method.
DEBUG_ROUTES = {
    '/debug/traces': '_debug_traces',
    '/debug/flight': '_debug_flight',
    '/debug/perfetto': '_debug_perfetto',
    '/debug/history': '_debug_history',
    '/debug/slo': '_debug_slo',
    '/debug/bundle': '_debug_bundle',
    '/debug/xprof': '_debug_xprof',
}


def _make_handler(server: ChatServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'
        # Responses up to 64 KiB buffer until the handler returns (the
        # server flushes then), so a completion's series are recorded
        # before its client sees the answer, as the JAX middleware records
        # them; an SSE answer flushes itself.
        wbufsize = 1 << 16

        def log_message(self, format, *args) -> None:  # noqa: A002
            pass  # one line per request on stderr would drown the server log

        def send_response(self, code, message=None) -> None:
            self._status = code
            super().send_response(code, message)

        def end_headers(self) -> None:
            # The JAX server's permissive CORS, on every response.
            self.send_header('Access-Control-Allow-Origin', '*')
            self.send_header('Access-Control-Allow-Headers', '*')
            self.send_header('Access-Control-Allow-Methods', 'GET, POST, OPTIONS')
            super().end_headers()

        def _send_json(self, status: int, body: dict, headers=None) -> None:
            raw = json.dumps(body).encode()
            self.send_response(status)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(raw)))
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(raw)

        def _observed(self, route) -> None:
            """The JAX middleware: in-flight gauge, latency by path,
            requests by path and status class, responses."""
            url = urllib.parse.urlsplit(self.path)
            label = url.path if url.path in KNOWN_PATHS else 'other'
            instruments.HTTP_IN_FLIGHT.inc()
            start = time.perf_counter()
            self._status = 500
            try:
                # Blank values kept: '?limit=' is a bad limit, as in JAX.
                route(url.path, urllib.parse.parse_qs(url.query, keep_blank_values=True))
            finally:
                instruments.HTTP_IN_FLIGHT.dec()
                instruments.HTTP_LATENCY.labels(path=label).observe(
                    time.perf_counter() - start
                )
                instruments.HTTP_REQUESTS.labels(
                    path=label, status=f'{self._status // 100}xx'
                ).inc()
                instruments.HTTP_RESPONSES.inc()

        def do_GET(self) -> None:  # noqa: N802
            self._observed(self._get)

        def do_POST(self) -> None:  # noqa: N802
            self._observed(self._post)

        def do_OPTIONS(self) -> None:  # noqa: N802
            self._observed(self._preflight)

        def _preflight(self, path, query) -> None:
            self.send_response(204)
            self.send_header('Content-Length', '0')
            self.end_headers()

        def _not_found(self) -> None:
            self._send_json(404, {'error': {'message': 'not found'}})

        def _get(self, path, query) -> None:
            if path == '/health':
                self._health()
            elif path == '/loadinfo':
                self._send_json(200, server.loadinfo())
            elif path == '/metrics':
                raw = render_prometheus().encode('utf-8')
                self.send_response(200)
                self.send_header('Content-Type', 'text/plain; version=0.0.4; charset=utf-8')
                self.send_header('Content-Length', str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)
            elif path.startswith('/debug/') and path in DEBUG_ROUTES:
                getattr(self, DEBUG_ROUTES[path])(query)
            else:
                self._not_found()

        def _limit(self, query, default: int) -> 'int | None':
            """The ``limit`` query parameter (at least 1), or None after
            answering 400."""
            try:
                return max(1, int(query.get('limit', [str(default)])[0]))
            except ValueError:
                self._send_json(400, {'error': {'message': 'limit must be an integer'}})
                return None

        def _debug_traces(self, query) -> None:
            limit = self._limit(query, 100)
            if limit is not None:
                spans = get_trace_buffer().snapshot(limit=limit)
                self._send_json(200, {
                    'spans': [s.to_dict() for s in spans if s.end_ns is not None]
                })

        def _debug_flight(self, query) -> None:
            limit = self._limit(query, 200)
            if limit is not None:
                recorder = get_flight_recorder()
                self._send_json(200, {
                    'records': recorder.snapshot(limit=limit),
                    'total_recorded': recorder.total_recorded,
                    'capacity': recorder.capacity,
                })

        def _debug_perfetto(self, query) -> None:
            limit = self._limit(query, 2000)
            if limit is not None:
                self._send_json(200, to_trace_events(
                    get_flight_recorder().snapshot(limit=limit),
                    [s.to_dict() for s in get_trace_buffer().snapshot(limit=limit)
                     if s.end_ns is not None],
                    history=server.history.snapshot(limit=limit),
                ))

        def _debug_history(self, query) -> None:
            limit = self._limit(query, 120)
            if limit is not None:
                prefix = query.get('prefix', [''])[0] or None
                doc = server.history.snapshot(limit=limit, prefix=prefix)
                doc['sampler_running'] = bool(
                    server.sampler is not None and server.sampler.running
                )
                self._send_json(200, doc)

        def _debug_slo(self, query) -> None:
            instruments.SERVER_UPTIME.set(max(0.0, time.time() - server.started_at))
            self._send_json(200, {
                **slo_status(server.history), 'sentinel': server.sentinel.status(),
            })

        def _debug_bundle(self, query) -> None:
            directory = _debug_dir('bundle')
            paths = dump_debug_bundle(directory, reason='GET /debug/bundle')
            self._send_json(200, {'bundle_dir': directory, 'paths': paths})

        def _debug_xprof(self, query) -> None:
            """A bounded, blocking profiler capture on this request's
            thread: 200, 409 while another runs, 501 when the profiler
            fails."""
            try:
                seconds = float(query.get('seconds', ['2'])[0])
            except ValueError:
                seconds = math.nan
            if not math.isfinite(seconds):
                self._send_json(400, {'error': {'message': 'seconds must be a finite number'}})
                return
            seconds = min(max(seconds, 0.1), 60.0)
            capture = get_profiler_capture()
            result = capture.capture(_debug_dir('xprof'), seconds)
            status = 200 if result['ok'] else 409 if result['rejected'] else 501
            self._send_json(
                status, {**result, 'seconds': seconds, 'state': capture.state()}
            )

        def _post(self, path, query) -> None:
            if path == '/v1/chat/completions':
                self._completion()
            elif path == '/drain':
                self._drain(query)
            else:
                self._not_found()

        def _health(self) -> None:
            # In flight includes this very request; report the others.
            in_flight = max(0, int(instruments.HTTP_IN_FLIGHT.value) - 1)
            draining = server.draining
            instruments.SERVER_UPTIME.set(max(0.0, time.time() - server.started_at))
            self._send_json(503 if draining else 200, {
                'status': 'draining' if draining else 'ok',
                'ready': not draining,
                'draining': draining,
                'version': distllm_tpu_torch.__version__,
                'uptime_s': round(time.time() - server.started_at, 3),
                'in_flight': in_flight,
                'requests_served': int(instruments.HTTP_RESPONSES.value),
            })

        def _drain(self, query) -> None:
            try:
                wait_s = float(query.get('seconds', ['30'])[0])
            except ValueError:
                self._send_json(400, {'error': {'message': 'seconds must be a number'}})
                return
            if not math.isfinite(wait_s):
                self._send_json(400, {'error': {'message': 'seconds must be finite'}})
                return
            self._send_json(200, server.drain(min(max(wait_s, 0.0), DRAIN_MAX_S)))

        def _completion(self) -> None:
            length = int(self.headers.get('Content-Length') or 0)
            raw = self.rfile.read(length) if length else b''
            if server.draining:
                # Stop admitting, finish what is in flight: 503, the client
                # should try another replica soon.
                instruments.RESILIENCE_SHED.labels(reason='draining').inc()
                get_flight_recorder().record('shed', reason='draining')
                self._send_json(
                    503, {'error': {'message': 'server is draining', 'type': 'draining'}},
                    {'Retry-After': '5'},
                )
                return
            try:
                body = json.loads(raw or b'{}')
            except json.JSONDecodeError:
                self._send_json(400, {'error': {'message': 'invalid JSON'}})
                return
            messages = body.get('messages') if isinstance(body, dict) else None
            if not messages:
                self._send_json(400, {'error': {'message': 'messages is required'}})
                return
            try:
                top_k = int(body.get('top_k', server.retrieval_top_k))
                score_threshold = float(
                    body.get('score_threshold', server.retrieval_score_threshold)
                )
            except (TypeError, ValueError):
                self._send_json(
                    400, {'error': {'message': 'top_k and score_threshold must be numbers'}}
                )
                return
            header = (self.headers.get('X-Request-Id') or '').strip()
            request_id = (
                header if _REQUEST_ID_RE.match(header)
                else f'req-{uuid.uuid4().hex[:16]}'
            )
            model = body.get('model', MODEL_NAME)
            if not server.begin_completion():  # a drain began meanwhile
                self._send_json(
                    503, {'error': {'message': 'server is draining', 'type': 'draining'}},
                    {'Retry-After': '5'},
                )
                return
            try:
                future = server.worker.submit(
                    lambda: server.answer(list(messages), top_k, score_threshold, request_id)
                )
                content = future.result(timeout=REQUEST_TIMEOUT_S)
            except EngineOverloaded as exc:
                # The engine predicted this request's TTFT would bust the
                # SLO and refused it at enqueue: the honest 429.
                self._send_json(
                    429,
                    {'error': {'message': str(exc), 'type': 'overloaded',
                               'predicted_ttft_s': round(exc.predicted_ttft_s, 3)},
                     'request_id': request_id},
                    {'Retry-After': str(max(1, math.ceil(exc.retry_after_s))),
                     'X-Request-Id': request_id},
                )
                return
            except Exception as exc:  # answered as a 500, never swallowed
                self._send_json(
                    500,
                    {'error': {'message': repr(exc)[:500], 'type': 'engine'},
                     'request_id': request_id},
                    {'X-Request-Id': request_id},
                )
                return
            finally:
                server.end_completion()
            server.count_served()
            # Affinity learning: having served the request, this replica
            # holds its whole prompt prefix; the router verifies the digest
            # against its own chain before it learns from it.
            headers = {'X-Request-Id': request_id}
            chain = prompt_prefix_digests(messages)
            if chain:
                headers[HEADER_DIGEST] = chain[-1].hex()
                headers[HEADER_DEPTH] = str(len(chain))
            if body.get('stream'):
                self._stream(model, content, request_id, headers)
                return
            self._send_json(200, _completion_payload(model, content, request_id), headers)

        def _stream(self, model: str, content: str, request_id: str, headers: dict) -> None:
            """Single-delta SSE: one chunk carrying the whole answer, then
            ``[DONE]``; no Content-Length, so the connection closes to
            mark the end."""
            chunk = {
                'id': f'chatcmpl-{uuid.uuid4().hex[:24]}',
                'object': 'chat.completion.chunk',
                'created': int(time.time()),
                'model': model,
                'request_id': request_id,
                'choices': [{
                    'index': 0,
                    'delta': {'role': 'assistant', 'content': content},
                    'finish_reason': 'stop',
                }],
            }
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.send_header('Cache-Control', 'no-cache')
            for key, value in headers.items():
                self.send_header(key, value)
            self.send_header('Connection', 'close')
            self.end_headers()
            self.wfile.write(f'data: {json.dumps(chunk)}\n\n'.encode())
            self.wfile.write(b'data: [DONE]\n\n')
            self.wfile.flush()
            self.close_connection = True

    return Handler


def shutdown_report(generator) -> dict:
    """What ``main`` logs when the server stops: every kernel counter of
    this process (``COUNTERS`` of the three kernel modules, each as
    ``<wrapper>.<attribute>``) and the engine's prefix-cache tokens, so a
    replica's launches and hit share are read from its log."""
    from distllm_tpu_torch.ops import encoder_attention, paged_attention, quantized_matmul

    kernels = {}
    for module in (paged_attention, quantized_matmul, encoder_attention):
        for fn, attr in module.COUNTERS:
            value = getattr(fn, attr)
            kernels[f'{fn.__name__}.{attr}'] = (
                {str(k): v for k, v in value.items()} if isinstance(value, dict) else value
            )
    engine = getattr(generator, 'engine', None)
    stats = getattr(engine, 'stats', None) or {}
    return {
        'kernels': kernels,
        'engine': {key: int(stats.get(key, 0)) for key in (
            'prefix_hit_tokens', 'prefix_lookup_tokens', 'forward_passes',
            'prefill_dispatches', 'decode_windows')},
    }


def load_app(path: str):
    """The :class:`~distllm_tpu_torch.chat.ChatAppConfig` of a chat app YAML,
    read as the JAX ``ChatAppConfig`` reads it: unknown keys refused, the
    retrieval keys validated, a ``retriever_config`` refused where the JAX
    ``RetrieverConfig`` refuses it."""
    from distllm_tpu_torch.chat import ChatAppConfig

    return ChatAppConfig.from_yaml(path)


def load_app_config(path: str) -> tuple:
    """``(generator config, system_prompt)`` of a chat app YAML
    (:func:`load_app`): ``generator_config.name`` honoured (``http`` an
    OpenAI-compatible client), the prefix cache on unless the YAML says
    otherwise, and ``model`` mapped by its ``name``."""
    app = load_app(path)
    return app.build_generator_config(), app.system_prompt


def main(argv: list[str] | None = None) -> None:
    from distllm_tpu_torch.generate.generators.torch_backend import (
        TorchGenerator,
        TorchGeneratorConfig,
    )
    from distllm_tpu_torch.models.mistral import MistralConfig

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument('--port', type=int, default=8000,
                        help='0 binds a free port, logged on start')
    parser.add_argument('--num-layers', type=int, default=32)
    parser.add_argument('--dtype', default='bfloat16')
    parser.add_argument('--device', default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--max-model-len', type=int, default=4096)
    parser.add_argument('--num-blocks', type=int, default=2048)
    parser.add_argument('--max-num-seqs', type=int, default=16)
    parser.add_argument('--max-tokens', type=int, default=256)
    parser.add_argument('--temperature', type=float, default=0.5)
    parser.add_argument(
        '--quantization', choices=('int8', 'nf4'), default=None,
        help='weight-only quantized serving (int8 runs through kernel K2)',
    )
    parser.add_argument(
        '--config', default=None,
        help='chat app YAML (generator_config, system_prompt); replaces the '
        'model and engine flags',
    )
    args = parser.parse_args(argv)
    retriever, app_kw = None, {}
    if args.config:
        app = load_app(args.config)
        generator = app.build_generator(device=args.device)
        retriever = app.build_retriever(device=args.device)
        app_kw = dict(
            system_prompt=app.system_prompt,
            retrieval_top_k=app.retrieval_top_k,
            retrieval_score_threshold=app.retrieval_score_threshold,
        )
    else:
        generator = TorchGenerator(TorchGeneratorConfig(
            model=MistralConfig(num_layers=args.num_layers, dtype=args.dtype),
            temperature=args.temperature,
            max_tokens=args.max_tokens,
            num_blocks=args.num_blocks,
            max_num_seqs=args.max_num_seqs,
            max_model_len=args.max_model_len,
            seed=args.seed,
            device=args.device,
            quantization=args.quantization,
        ))
    server = ChatServer(
        generator, host=args.host, port=args.port, retriever=retriever, **app_kw
    ).start()
    # With --port 0 this line is where a caller reads the port bound.
    instruments.log_event(
        f'[chat_server] listening on http://{args.host}:{server.port}', component='server'
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        instruments.log_event(
            f'[chat_server] shutdown {json.dumps(shutdown_report(generator))}',
            component='server',
        )
        shutdown = getattr(generator, 'shutdown', None)
        if shutdown is not None:
            shutdown()


if __name__ == '__main__':
    main()
