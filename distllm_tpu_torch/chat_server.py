"""OpenAI-compatible chat server on the standard library's HTTP server.

The counterpart of ``distllm_tpu.chat_server`` for this slice:
``POST /v1/chat/completions`` (the JAX payload shape) and ``GET /health``.
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
into the prompt, as the JAX server does. Streaming, drain, metrics and
the debug routes wait for later slices (ROADMAP A6).

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
import queue
import re
import threading
import time
import uuid
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import distllm_tpu_torch
from distllm_tpu_torch.chat import ConversationPromptTemplate, retrieve

# Accepted inbound X-Request-Id shape; anything else gets a generated id.
_REQUEST_ID_RE = re.compile(r'^[A-Za-z0-9._:-]{1,128}$')
MODEL_NAME = 'distllm-tpu-torch'  # payload 'model' when the body names none
REQUEST_TIMEOUT_S = 600.0  # an HTTP thread's wait for the engine worker


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


class ChatServer:
    """``ThreadingHTTPServer`` + one :class:`EngineWorker`. ``port=0`` binds
    a free port (read it back from :attr:`port`). With a ``retriever``,
    each request retrieves ``top_k`` contexts (default
    ``retrieval_top_k``) scoring at least ``score_threshold`` (default
    ``retrieval_score_threshold``); :attr:`timings` keeps each answered
    request's retrieve and generate seconds."""

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
        self._served = 0
        self._lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name='distllm-torch-http',
            daemon=True,
        )

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

    def answer(self, messages: list[dict], top_k: int, score_threshold: float) -> str:
        """One request on the worker thread: retrieval on the latest user
        message, the rendered prompt, one generation."""
        latest = next(
            (m['content'] for m in reversed(messages) if m['role'] == 'user'), ''
        )
        t0 = time.perf_counter()
        contexts, scores = [], []
        if latest:
            contexts, scores = retrieve(self.retriever, latest, top_k, score_threshold)
        t1 = time.perf_counter()
        prompt = self.template.render(list(messages), contexts, scores)
        content = self.generator.generate([prompt])[0]
        self.timings.append({
            'retrieve_s': t1 - t0, 'generate_s': time.perf_counter() - t1,
            'contexts': len(contexts),
        })
        return content

    def start(self) -> 'ChatServer':
        self.worker.start()
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(30.0)
        self._httpd.server_close()
        self.worker.stop()

    def __enter__(self) -> 'ChatServer':
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def _make_handler(server: ChatServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = 'HTTP/1.1'

        def log_message(self, format, *args) -> None:  # noqa: A002
            pass  # one line per request on stderr would drown the server log

        def _send_json(self, status: int, body: dict, headers=None) -> None:
            raw = json.dumps(body).encode()
            self.send_response(status)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(raw)))
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(raw)

        def do_GET(self) -> None:  # noqa: N802
            if self.path != '/health':
                self._send_json(404, {'error': {'message': 'not found'}})
                return
            self._send_json(200, {
                'status': 'ok',
                'ready': True,
                'version': distllm_tpu_torch.__version__,
                'uptime_s': round(time.time() - server.started_at, 3),
                'requests_served': server.requests_served,
            })

        def do_POST(self) -> None:  # noqa: N802
            if self.path != '/v1/chat/completions':
                self._send_json(404, {'error': {'message': 'not found'}})
                return
            length = int(self.headers.get('Content-Length') or 0)
            try:
                body = json.loads(self.rfile.read(length) or b'{}')
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
            future = server.worker.submit(
                lambda: server.answer(list(messages), top_k, score_threshold)
            )
            try:
                content = future.result(timeout=REQUEST_TIMEOUT_S)
            except Exception as exc:  # answered as a 500, never swallowed
                self._send_json(
                    500,
                    {'error': {'message': repr(exc)[:500], 'type': 'engine'},
                     'request_id': request_id},
                    {'X-Request-Id': request_id},
                )
                return
            server.count_served()
            self._send_json(
                200,
                _completion_payload(
                    body.get('model', MODEL_NAME), content, request_id
                ),
                {'X-Request-Id': request_id},
            )

    return Handler


def load_app(path: str):
    """The :class:`~distllm_tpu_torch.chat.ChatAppConfig` of a chat app YAML,
    read as the JAX ``ChatAppConfig`` reads it: unknown keys refused, the
    retrieval keys validated, a ``retriever_config`` refused where the JAX
    ``RetrieverConfig`` refuses it."""
    from distllm_tpu_torch.chat import ChatAppConfig

    return ChatAppConfig.from_yaml(path)


def load_app_config(path: str) -> tuple:
    """``(generator config, system_prompt)`` of a chat app YAML
    (:func:`load_app`): ``generator_config.name`` honoured (``http``
    raises, ROADMAP A11), the prefix cache on unless the YAML says
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
    parser.add_argument('--port', type=int, default=8000)
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
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        shutdown = getattr(generator, 'shutdown', None)
        if shutdown is not None:
            shutdown()


if __name__ == '__main__':
    main()
