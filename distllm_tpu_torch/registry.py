"""Warmstart registry: keep ONE expensive object alive across work items
(the PyTorch port's counterpart of ``distllm_tpu.registry``).

Workers process many files through repeated calls; rebuilding a model
(and moving its weights to the GPU) per file would dominate the run. The
registry caches one active object per slot, keyed by a hash of its factory
and constructor arguments; a request with other arguments shuts the old
object down (its optional ``shutdown()`` drops device references) and
builds the new one.
"""

from __future__ import annotations

import hashlib
import json
import threading
import traceback
from typing import Any, Callable, TypeVar

T = TypeVar('T')

# Independent object families (an encoder, a generator) each keep one
# instance warm; past this many slots the oldest is shut down.
MAX_SLOTS = 2


def _stable_hash(obj: Any) -> str:
    """Deterministic hash of a kwargs structure, by value (the kwargs come
    from YAML: strings, numbers, lists and dicts)."""
    payload = json.dumps(obj, sort_keys=True, default=repr)
    return hashlib.sha256(payload.encode()).hexdigest()


class WarmstartRegistry:
    """Process-wide cache holding at most one active object per slot."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slots: dict[str, tuple[str, Any]] = {}  # guarded by self._lock

    def get(
        self,
        factory: Callable[..., T],
        slot: str | None = None,
        **kwargs: Any,
    ) -> T:
        """Return the cached object for (factory, kwargs), building it if
        needed; a miss shuts down the slot's previous object first."""
        name = getattr(factory, '__qualname__', repr(factory))
        slot = slot or name
        key = _stable_hash({'factory': name, 'kwargs': kwargs})
        with self._lock:
            entry = self._slots.get(slot)
            if entry is not None and entry[0] == key:
                return entry[1]
            if entry is not None:
                self._shutdown(self._slots.pop(slot)[1])
            if len(self._slots) >= MAX_SLOTS:
                oldest = next(iter(self._slots))
                self._shutdown(self._slots.pop(oldest)[1])
            value = factory(**kwargs)
            self._slots[slot] = (key, value)
            return value

    @staticmethod
    def _shutdown(value: Any) -> None:
        shutdown = getattr(value, 'shutdown', None)
        if callable(shutdown):
            try:
                shutdown()
            except Exception:  # noqa: BLE001 - eviction must not fail
                traceback.print_exc()


_REGISTRY = WarmstartRegistry()


def registry() -> WarmstartRegistry:
    """The process-wide registry."""
    return _REGISTRY
