"""The task fabric over ZMQ: the pod executors' transport, and the digest-
keyed KV block exchange between serving replicas (counterpart of
``distllm_tpu.parallel.fabric``, frame for frame).

The reference scales out through Parsl's HighThroughputExecutor: a ZMQ /
TCP fabric shipping pickled worker functions to persistent processes
(``distllm/parsl.py``). This module implements that pattern directly:

- :class:`Coordinator` — a ROUTER socket that hands ``(task_id, payload)``
  frames to idle workers, collects results, retries failed tasks and
  requeues the task of a worker silent past ``heartbeat_threshold``.
- :class:`FabricWorker` — the DEALER loop: ``READY``, then run each task
  and answer ``RESULT``; heartbeats (``HB``) flow while a task runs and
  while idle, an idle worker that hears nothing for ``idle_timeout``
  exits, and ``SHUTDOWN`` (the poison pill) ends the loop.
- :class:`ZmqPoolExecutor` — ``map(fn, items)`` over a coordinator, the
  in-process executors' interface.
- :class:`KVBlockServer` / :class:`KVBlockClient` — HAS / GET by block
  digest, answered with the ``.kvblock`` v2 payload the disk tier writes,
  between a replica and its siblings' ``PeerKVTier``.

``map_with_teardown`` (the JAX module's, re-exported here) lives in
``parallel.launcher`` beside the in-process executors, so a ``local`` run
needs no ``zmq``.

A task's payload is ``pickle.dumps((fn, args, kwargs))``, so ``fn`` must be
importable by its module path in the worker (a module-level function, or a
``functools.partial`` of one), as with Parsl. The wire frames are the JAX
package's, so a port coordinator and a JAX worker (or the reverse) speak
the same protocol; only what the pickles name differs.

``zmq`` (pyzmq) is imported here at module scope: a host without it cannot
run a pod config or a peer tier, and importing this module says so.
"""

from __future__ import annotations

import pickle
import socket as _socket
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import zmq

from distllm_tpu_torch.observability import instruments
from distllm_tpu_torch.observability.instruments import log_event
from distllm_tpu_torch.observability.tracing import span
from distllm_tpu_torch.parallel.launcher import map_with_teardown  # noqa: F401 - re-exported

_READY = b'READY'
_HEARTBEAT = b'HB'
_RESULT = b'RESULT'
# Poison pill: [b'', _SHUTDOWN] ends the worker loop. A worker that joined
# a torch.distributed world may be stuck in a collective's timeout rather
# than dead on SIGTERM, so a job ends its run by telling workers to exit,
# as Parsl's interchange does, instead of relying on signals.
_SHUTDOWN = b'SHUTDOWN'


@dataclass
class _Task:
    task_id: bytes
    payload: bytes
    tries: int = 0


@dataclass
class _WorkerState:
    ident: bytes
    last_seen: float = field(default_factory=time.monotonic)
    current: bytes | None = None


class Coordinator:
    """ROUTER-socket task pump with heartbeat-based failure detection.

    A task that fails is retried up to ``retries`` times (``parsl.py:85,
    130,197``); a worker silent for ``heartbeat_threshold`` seconds is
    reaped and its in-flight task requeued (:attr:`requeued` counts them).
    Workers heartbeat while a task runs, so the threshold bounds network
    silence, not task length. A reaped worker that later reports its
    requeued task's result is accepted if the task has not been handed out
    again yet.
    """

    def __init__(
        self,
        bind: str = 'tcp://*:0',
        retries: int = 1,
        heartbeat_threshold: float = 120.0,
        advertise_host: str | None = None,
    ) -> None:
        self._ctx = zmq.Context.instance()
        self._socket = self._ctx.socket(zmq.ROUTER)
        host = advertise_host or _socket.gethostname()
        if bind.endswith(':0'):
            port = self._socket.bind_to_random_port('tcp://*')
            self.endpoint = f'tcp://{host}:{port}'
        else:
            self._socket.bind(bind)
            self.endpoint = bind.replace('*', host)
        self.retries = retries
        self.heartbeat_threshold = heartbeat_threshold
        self._workers: dict[bytes, _WorkerState] = {}
        # Tasks taken back from reaped workers, over this coordinator's life.
        self.requeued = 0

    def run(self, tasks: list[_Task]) -> dict[bytes, Any]:
        """Dispatch every task; block until each has a result (or its
        final error)."""
        pending: list[_Task] = list(tasks)
        in_flight: dict[bytes, _Task] = {}
        results: dict[bytes, Any] = {}
        poller = zmq.Poller()
        poller.register(self._socket, zmq.POLLIN)

        def record(task: _Task, ok: bytes, payload: bytes) -> None:
            if ok == b'1':
                results[task.task_id] = pickle.loads(payload)
            elif task.tries <= self.retries:
                pending.append(task)
            else:
                results[task.task_id] = pickle.loads(payload)

        while len(results) < len(tasks):
            self._reap_lost_workers(in_flight, pending)
            events = dict(poller.poll(timeout=1000))
            if self._socket not in events:
                continue
            frames = self._socket.recv_multipart()
            ident, kind = frames[0], frames[1]
            worker = self._workers.setdefault(ident, _WorkerState(ident))
            worker.last_seen = time.monotonic()
            if kind == _HEARTBEAT:
                # Ack, so a worker that is alive but idle keeps resetting
                # its idle_timeout (liveness flows both ways).
                self._socket.send_multipart([ident, b'', _HEARTBEAT])
            if kind == _READY:
                worker.current = None
            elif kind == _RESULT:
                task_id, ok, payload = frames[2], frames[3], frames[4]
                worker.current = None
                task = in_flight.pop(task_id, None)
                if task is None:
                    # Reaped mid-task: take the result if the requeued copy
                    # has not been handed out again.
                    for i, queued in enumerate(pending):
                        if queued.task_id == task_id:
                            pending.pop(i)
                            task = queued
                            break
                if task is not None and task_id not in results:
                    record(task, ok, payload)
            # Dispatch on any message kind: a reaped worker that revived
            # must get work even if its next frame is only a heartbeat.
            if pending and worker.current is None:
                task = pending.pop(0)
                task.tries += 1
                worker.current = task.task_id
                in_flight[task.task_id] = task
                self._socket.send_multipart([ident, task.task_id, task.payload])
        return results

    def shutdown_workers(self, drain_seconds: float = 3.0) -> None:
        """Send every worker the poison pill (the pod's teardown).

        After pilling the known workers, drains the socket for
        ``drain_seconds`` and pills any ident that still speaks up: a host
        that booted after ``run`` returned, or a reaped worker still
        alive, would otherwise never hear it and hold its allocation."""
        pilled: set[bytes] = set()

        def pill(ident: bytes) -> None:
            if ident not in pilled:
                self._socket.send_multipart([ident, b'', _SHUTDOWN])
                pilled.add(ident)

        for ident in list(self._workers):
            pill(ident)
        poller = zmq.Poller()
        poller.register(self._socket, zmq.POLLIN)
        deadline = time.monotonic() + drain_seconds
        while time.monotonic() < deadline:
            events = dict(poller.poll(timeout=200))
            if self._socket in events:
                pill(self._socket.recv_multipart()[0])
        self._workers.clear()

    def _reap_lost_workers(
        self, in_flight: dict[bytes, _Task], pending: list[_Task]
    ) -> None:
        now = time.monotonic()
        for ident in list(self._workers):
            worker = self._workers[ident]
            if now - worker.last_seen > self.heartbeat_threshold:
                if worker.current is not None:
                    task = in_flight.pop(worker.current, None)
                    if task is not None:
                        pending.append(task)
                        self.requeued += 1
                        log_event(
                            f'[fabric] worker silent {now - worker.last_seen:.1f} s: '
                            f'task {task.task_id.hex()[:8]} requeued',
                            component='fabric',
                        )
                del self._workers[ident]

    def close(self) -> None:
        self._socket.close(linger=0)


class FabricWorker:
    """Worker loop: announce ``READY``, run tasks, answer, heartbeat.

    ZMQ sockets are not thread-safe, so every use of the socket holds one
    lock. While a task runs, a background thread sends the heartbeats (the
    loop is busy and the lock free); while idle, the poll loop sends them
    itself under the lock it already holds (``threading.Lock`` is not
    fair, and the tight poll cycle could starve the thread). So the
    coordinator reaps only on real network or process loss.

    ``idle_timeout`` bounds how long the worker lives without hearing
    anything from the coordinator (which acks heartbeats while it pumps):
    a straggler that booted after the job's coordinator exited, or
    outlived a crashed one, exits instead of polling a dead endpoint
    forever. It must cover the boot stagger and the job's dead time
    between ``map`` calls.
    """

    def __init__(
        self,
        coordinator: str,
        heartbeat_interval: float = 5.0,
        idle_timeout: float = 900.0,
    ) -> None:
        self._ctx = zmq.Context.instance()
        self._socket = self._ctx.socket(zmq.DEALER)  # guarded by self._send_lock
        self._socket.connect(coordinator)
        self.heartbeat_interval = heartbeat_interval
        self.idle_timeout = idle_timeout
        self._stop = threading.Event()
        self._send_lock = threading.Lock()

    def _send(self, frames: list[bytes]) -> None:
        with self._send_lock:
            self._socket.send_multipart(frames)

    def _recv(self) -> list[bytes]:
        """Receive under the socket lock (the poller already reported
        POLLIN, so this never blocks)."""
        with self._send_lock:
            return self._socket.recv_multipart()

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            self._send([_HEARTBEAT])
            instruments.WORKER_HEARTBEATS.inc()

    def run(self) -> None:
        # Register before the heartbeat thread exists, and keep a local
        # handle for the poll-result test so the loop never touches the
        # guarded slot unlocked.
        poller = zmq.Poller()
        with self._send_lock:
            sock = self._socket
            poller.register(sock, zmq.POLLIN)
        hb_thread = threading.Thread(target=self._heartbeat_loop, daemon=True)
        hb_thread.start()
        self._send([_READY])
        last_contact = time.monotonic()
        last_heartbeat = time.monotonic()
        while not self._stop.is_set():
            # Polling reads the socket's state, so it holds the lock too;
            # the idle-phase heartbeats go out here (see the class note).
            with self._send_lock:
                events = dict(poller.poll(timeout=500))
                now = time.monotonic()
                if now - last_heartbeat >= self.heartbeat_interval:
                    self._socket.send_multipart([_HEARTBEAT])
                    instruments.WORKER_HEARTBEATS.inc()
                    last_heartbeat = now
            if sock not in events:
                if time.monotonic() - last_contact > self.idle_timeout:
                    log_event(
                        f'[worker] no coordinator contact for '
                        f'{self.idle_timeout:.0f}s; exiting',
                        component='worker',
                    )
                    break
                continue
            last_contact = time.monotonic()
            task_id, payload = self._recv()
            if not task_id:
                if payload == _SHUTDOWN:
                    break
                continue
            task_start = time.monotonic()
            try:
                with span('fabric-task', task_id.hex()):
                    fn, args, kwargs = pickle.loads(payload)
                    result = fn(*args, **kwargs)
                instruments.WORKER_TASKS.labels(outcome='ok').inc()
                self._send([_RESULT, task_id, b'1', pickle.dumps(result)])
            except BaseException as exc:  # noqa: BLE001 - shipped to the coordinator
                instruments.WORKER_TASKS.labels(outcome='error').inc()
                self._send(
                    [_RESULT, task_id, b'0', pickle.dumps(RuntimeError(repr(exc)))]
                )
            finally:
                instruments.WORKER_TASK_SECONDS.observe(time.monotonic() - task_start)
        self._stop.set()  # ends the heartbeat thread on a poison-pill exit

    def stop(self) -> None:
        self._stop.set()


class ZmqPoolExecutor:
    """``map`` over a :class:`Coordinator` (the Parsl pool executor's
    interface); results come back in the items' order."""

    def __init__(self, coordinator: Coordinator) -> None:
        self.coordinator = coordinator

    def shutdown(self) -> None:
        """Poison-pill every connected worker (the end of a pod run)."""
        self.coordinator.shutdown_workers()

    def map(self, fn: Callable, items: Iterable[Any]) -> list[Any]:
        tasks = []
        order = []
        for item in items:
            task_id = uuid.uuid4().bytes
            order.append(task_id)
            tasks.append(_Task(task_id=task_id, payload=pickle.dumps((fn, (item,), {}))))
        results = self.coordinator.run(tasks)
        out = []
        for task_id in order:
            value = results[task_id]
            if isinstance(value, BaseException):
                raise value
            out.append(value)
        return out


_KV_HAS = b'HAS'
_KV_GET = b'GET'
KV_HIT = b'KVHIT'
KV_MISS = b'KVMISS'
KV_ERR = b'KVERR'


class KVBlockServer:
    """ROUTER-socket server answering HAS / GET by block digest for one
    replica's spilled KV blocks.

    Transport only: ``has_fn(digest) -> bool`` and ``get_fn(digest) ->
    bytes | None`` are injected (the engine passes its host tier's
    ``contains_local`` / ``encoded_local``, which count no metric and never
    ask this replica's own peers), so the fabric never imports the KV
    layer. A GET hit answers the ``.kvblock`` v2 payload, the bytes the
    disk tier persists. A handler exception answers ``KVERR`` and the
    serve thread goes on.

    Frames: request ``[cmd, digest]`` (cmd ``HAS`` or ``GET``; a REQ
    client's empty delimiter is accepted), reply ``[status, payload]``
    (status ``KVHIT``, ``KVMISS`` or ``KVERR``; the payload is empty except
    on a GET hit).
    """

    def __init__(
        self,
        has_fn: Callable[[bytes], bool],
        get_fn: Callable[[bytes], bytes | None],
        bind: str = 'tcp://127.0.0.1:0',
        advertise_host: str | None = None,
    ) -> None:
        self._has_fn = has_fn
        self._get_fn = get_fn
        self._ctx = zmq.Context.instance()
        # Touched only by the serve thread after start(); close() joins
        # the thread before closing the socket.
        self._socket = self._ctx.socket(zmq.ROUTER)
        host = advertise_host or '127.0.0.1'
        if bind.endswith(':0'):
            port = self._socket.bind_to_random_port(bind[: bind.rfind(':')])
            self.endpoint = f'tcp://{host}:{port}'
        else:
            self._socket.bind(bind)
            self.endpoint = bind.replace('*', host)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name='kvblock-server', daemon=True
        )
        self.served_blocks = 0
        self.served_bytes = 0

    def start(self) -> 'KVBlockServer':
        self._thread.start()
        return self

    def _serve(self) -> None:
        poller = zmq.Poller()
        poller.register(self._socket, zmq.POLLIN)
        while not self._stop.is_set():
            if self._socket not in dict(poller.poll(timeout=200)):
                continue
            frames = self._socket.recv_multipart()
            ident, rest = frames[0], frames[1:]
            if rest and rest[0] == b'':
                rest = rest[1:]
            status, payload = KV_ERR, b''
            if len(rest) == 2:
                cmd, digest = rest
                try:
                    if cmd == _KV_HAS:
                        status = KV_HIT if self._has_fn(digest) else KV_MISS
                    elif cmd == _KV_GET:
                        encoded = self._get_fn(digest)
                        if encoded is None:
                            status = KV_MISS
                        else:
                            status, payload = KV_HIT, encoded
                            self.served_blocks += 1
                            self.served_bytes += len(encoded)
                except Exception:  # answered as KVERR; the fetching side counts it
                    status = KV_ERR
            self._socket.send_multipart([ident, b'', status, payload])

    def close(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
        self._socket.close(linger=0)


class KVBlockClient:
    """REQ client with a bounded timeout for :class:`KVBlockServer`
    endpoints.

    One REQ socket per endpoint, made again after a timeout or a transport
    error (a REQ that missed its reply is stuck in its send state).
    ``request`` returns ``(status, payload)``, or None on a transport
    failure: the caller (``PeerKVTier``) owns the backoff and the counting.
    Thread-safe.
    """

    def __init__(self, timeout_ms: int = 500) -> None:
        self._ctx = zmq.Context.instance()
        self.timeout_ms = int(timeout_ms)
        self._lock = threading.Lock()
        self._sockets: dict[str, Any] = {}  # guarded by self._lock

    def request(
        self, endpoint: str, cmd: bytes, digest: bytes
    ) -> tuple[bytes, bytes] | None:
        with self._lock:
            sock = self._sockets.get(endpoint)
            if sock is None:
                sock = self._ctx.socket(zmq.REQ)
                sock.setsockopt(zmq.LINGER, 0)
                sock.connect(endpoint)
                self._sockets[endpoint] = sock
            try:
                sock.send_multipart([cmd, digest])
                if sock.poll(self.timeout_ms, zmq.POLLIN):
                    frames = sock.recv_multipart()
                    return frames[0], frames[1] if len(frames) > 1 else b''
            except zmq.ZMQError:  # a None answer: the caller counts and backs off
                pass
            sock.close(linger=0)
            del self._sockets[endpoint]
            return None

    def close(self) -> None:
        with self._lock:
            for sock in self._sockets.values():
                sock.close(linger=0)
            self._sockets.clear()
