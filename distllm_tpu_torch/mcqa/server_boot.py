"""Local engine-server boot for the MCQA harness (counterpart of
``distllm_tpu.mcqa.server_boot``): the harness boots the port's
OpenAI-compatible chat server (``python -m distllm_tpu_torch.chat_server``
over the paged-KV engine) as a subprocess on a free port, with monitor
threads writing timestamped stdout/stderr logs, a readiness poll of
``/health`` through ``urllib``, a failure report with the logs' tails, and
SIGINT/SIGTERM cleanup. Its ``server_config.yaml`` is the JAX harness's;
``--device`` is passed only when the caller names a device (the server
runs on CUDA otherwise).
"""

from __future__ import annotations

import atexit
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path


def find_free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


class LocalServerManager:
    """Boot + monitor + tear down a local OpenAI-compatible engine server."""

    def __init__(
        self,
        model_path: str,
        log_dir: str | Path | None = None,
        port: int | None = None,
        startup_timeout: float = 300.0,
        engine_args: dict | None = None,
        device: str | None = None,
    ) -> None:
        self.model_path = model_path
        self.device = device
        self.port = port or find_free_port()
        self.startup_timeout = startup_timeout
        self.engine_args = engine_args or {}
        self.log_dir = Path(log_dir or tempfile.mkdtemp(prefix='mcqa_server_'))
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.process: subprocess.Popen | None = None
        self._monitors: list[threading.Thread] = []
        self._log_files = []

    @property
    def base_url(self) -> str:
        return f'http://127.0.0.1:{self.port}/v1'

    def _write_config(self) -> Path:
        import yaml

        config = {
            'generator_config': {
                'name': 'tpu',
                'pretrained_model_name_or_path': self.model_path,
                'temperature': 0.0,
                'min_p': 0.0,
                **self.engine_args,
            }
        }
        path = self.log_dir / 'server_config.yaml'
        path.write_text(yaml.safe_dump(config))
        return path

    def _pump(self, stream, log_path: Path) -> None:
        with open(log_path, 'a') as fh:
            for line in iter(stream.readline, ''):
                stamp = time.strftime('%Y-%m-%d %H:%M:%S')
                fh.write(f'[{stamp}] {line}')
                fh.flush()

    def start(self) -> None:
        config_path = self._write_config()
        command = [
            sys.executable,
            '-m',
            'distllm_tpu_torch.chat_server',
            '--config',
            str(config_path),
            '--host',
            '127.0.0.1',
            '--port',
            str(self.port),
        ]
        if self.device is not None:
            command += ['--device', str(self.device)]
        # The package's root on the child's path, wherever it runs from.
        root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ)
        env['PYTHONPATH'] = os.pathsep.join(
            p for p in (root, env.get('PYTHONPATH', '')) if p
        )
        self.process = subprocess.Popen(
            command, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for stream, name in (
            (self.process.stdout, 'server_stdout.log'),
            (self.process.stderr, 'server_stderr.log'),
        ):
            thread = threading.Thread(
                target=self._pump, args=(stream, self.log_dir / name), daemon=True
            )
            thread.start()
            self._monitors.append(thread)
        self._install_cleanup()
        self._wait_ready()

    def _wait_ready(self) -> None:
        from distllm_tpu_torch.generate.generators.http_client import get_ok

        deadline = time.monotonic() + self.startup_timeout
        while time.monotonic() < deadline:
            if self.process.poll() is not None:
                raise RuntimeError(self._failure_report())
            try:
                if get_ok(f'http://127.0.0.1:{self.port}/health', timeout=2):
                    return
            except Exception:  # noqa: BLE001 - retrying until the deadline
                pass
            time.sleep(1.0)
        self.stop()
        raise TimeoutError(
            f'server not ready after {self.startup_timeout}s; '
            f'logs: {self.log_dir}'
        )

    def _failure_report(self) -> str:
        """Startup failure report with the logs' tails."""
        lines = [
            f'local server exited with code {self.process.returncode}',
            f'model: {self.model_path}',
            f'logs: {self.log_dir}',
        ]
        for name in ('server_stderr.log', 'server_stdout.log'):
            path = self.log_dir / name
            if path.exists():
                tail = path.read_text().splitlines()[-15:]
                lines.append(f'--- {name} tail ---')
                lines.extend(tail)
        return '\n'.join(lines)

    def _install_cleanup(self) -> None:
        atexit.register(self.stop)

        def handler(signum, frame):
            self.stop()
            signal.default_int_handler(signum, frame) if signum == signal.SIGINT else sys.exit(1)

        try:
            signal.signal(signal.SIGINT, handler)
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread (tests)

    def stop(self) -> None:
        if self.process is not None and self.process.poll() is None:
            self.process.terminate()
            try:
                self.process.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.process.kill()
        self.process = None
