"""MCQA checkpoint/resume (counterpart of ``distllm_tpu.mcqa.checkpoint``,
file for file): JSON checkpoints ``{version, timestamp, completed_indices,
results, metadata}`` saved every N questions (or after each one), the 3
newest kept, resume from the newest compatible one (the same version,
model and questions file), falling back through older ones. A checkpoint
written by either package resumes in the other.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any

from distllm_tpu_torch.observability.instruments import log_event

CHECKPOINT_VERSION = 1


class CheckpointManager:
    def __init__(
        self,
        checkpoint_dir: str | Path,
        metadata: dict[str, Any],
        every: int = 10,
        save_incremental: bool = False,
    ) -> None:
        self.checkpoint_dir = Path(checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.metadata = metadata
        self.every = max(1, every)
        self.save_incremental = save_incremental
        self._lock = threading.Lock()
        self.results: dict[int, dict[str, Any]] = {}  # guarded by self._lock
        self._since_save = 0  # guarded by self._lock

    # ---------------------------------------------------------------- save
    def record(self, index: int, result: dict[str, Any]) -> None:
        """Thread-safe progress update with periodic checkpointing."""
        with self._lock:
            self.results[index] = result
            self._since_save += 1
            if self.save_incremental or self._since_save >= self.every:
                self._save_locked()
                self._since_save = 0

    def save(self) -> Path:
        with self._lock:
            return self._save_locked()

    def _save_locked(self) -> Path:  # guarded by self._lock
        payload = {
            'version': CHECKPOINT_VERSION,
            'timestamp': time.time(),
            'completed_indices': sorted(self.results),
            'results': {str(k): v for k, v in self.results.items()},
            'metadata': self.metadata,
        }
        path = self.checkpoint_dir / f'checkpoint_{int(time.time()*1000)}.json'
        tmp = path.with_suffix('.tmp')
        tmp.write_text(json.dumps(payload))
        tmp.rename(path)
        # Keep only the 3 newest checkpoints.
        checkpoints = sorted(self.checkpoint_dir.glob('checkpoint_*.json'))
        for old in checkpoints[:-3]:
            old.unlink(missing_ok=True)
        return path

    # --------------------------------------------------------------- resume
    @staticmethod
    def find_latest(checkpoint_dir: str | Path) -> Path | None:
        checkpoints = sorted(Path(checkpoint_dir).glob('checkpoint_*.json'))
        return checkpoints[-1] if checkpoints else None

    def try_resume(self) -> int:
        """Load the newest compatible checkpoint; returns #completed.

        Falls back through the retained checkpoints (newest → oldest) so a
        corrupt or incompatible newest file doesn't discard the older valid
        ones.
        """
        candidates = sorted(
            self.checkpoint_dir.glob('checkpoint_*.json'), reverse=True
        )
        for path in candidates:
            results = self._load_compatible(path)
            if results is not None:
                with self._lock:
                    self.results = results
                log_event(
                    f'[checkpoint] resumed {len(results)} results '
                    f'from {path.name}',
                    component='checkpoint',
                )
                return len(results)
        return 0

    def _load_compatible(self, path: Path) -> dict[int, dict[str, Any]] | None:
        try:
            payload = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            log_event(f'[checkpoint] ignoring corrupt {path}', component='checkpoint')
            return None
        if payload.get('version') != CHECKPOINT_VERSION:
            log_event(
                f'[checkpoint] version mismatch in {path}; ignoring',
                component='checkpoint',
            )
            return None
        meta = payload.get('metadata', {})
        for key in ('model', 'questions_file'):
            if key in self.metadata and meta.get(key) != self.metadata[key]:
                log_event(
                    f'[checkpoint] {key} mismatch in {path.name} '
                    f'({meta.get(key)!r} != {self.metadata[key]!r}); ignoring',
                    component='checkpoint',
                )
                return None
        return {int(k): v for k, v in payload.get('results', {}).items()}

    @property
    def completed_indices(self) -> set[int]:
        with self._lock:
            return set(self.results)
