"""Config base and device resolution for the PyTorch port.

``BaseConfig`` stands in for ``distllm_tpu.utils.BaseConfig`` (a pydantic
model there): a plain dataclass base whose ``__post_init__`` runs the
subclass's ``validate`` hook, so a config that cannot serve is refused at
construction, as the pydantic validators refuse it in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path

import torch


@dataclasses.dataclass
class BaseConfig:
    """Dataclass base for every config of the port.

    Subclasses are ``@dataclasses.dataclass`` classes that override
    :meth:`validate` to raise ``ValueError`` on a bad field combination.
    """

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Raise ``ValueError`` when the config is inconsistent."""

    @classmethod
    def from_dict(cls, raw: dict):
        """From a YAML mapping: an unknown or a missing key is a
        ``ValueError``, as the JAX package's pydantic configs (which forbid
        extra fields) refuse it."""
        if not isinstance(raw, dict):
            raise ValueError(f'{cls.__name__} needs a mapping, got {raw!r}')
        fields = {f.name: f for f in dataclasses.fields(cls) if f.init}
        extra = sorted(set(raw) - set(fields))
        missing = sorted(
            name for name, f in fields.items()
            if name not in raw and f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        )
        if extra or missing:
            raise ValueError(
                f'{cls.__name__}: unknown keys {extra}, missing keys {missing}'
            )
        return cls(**raw)

    @classmethod
    def from_yaml(cls, path):
        """From a YAML file, ``${env:VAR}`` markers substituted
        (:meth:`from_dict`'s checks)."""
        import yaml

        with open(path) as fh:
            raw = yaml.safe_load(fh) or {}
        return cls.from_dict(substitute_env(raw))

    def to_dict(self) -> dict:
        """The fields as plain values, paths as strings: written as JSON,
        which is valid YAML, :meth:`from_yaml` (and the JAX package's
        ``from_yaml``) reads it back."""
        return {
            key: str(value) if isinstance(value, Path) else value
            for key, value in dataclasses.asdict(self).items()
        }


_DTYPES = {
    'bfloat16': torch.bfloat16,
    'float32': torch.float32,
    'float16': torch.float16,
}


def torch_dtype(name: 'str | torch.dtype') -> torch.dtype:
    """The torch dtype of a config's dtype name (or the dtype itself)."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f'dtype must be one of {tuple(_DTYPES)}, got {name!r}')
    return _DTYPES[name]


def resolve_device(device: 'str | torch.device | None' = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: it returns ``cuda`` and raises when CUDA is
    absent — nothing quietly falls back to the CPU. ``'cpu'`` is returned
    only when the caller asks for it; a CUDA device that is not present
    raises too.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available: distllm_tpu_torch runs on the GPU unless '
            "the caller passes device='cpu'"
        )
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev}; expected cuda or cpu')
    return dev


def lax_int(name: str, value) -> int:
    """An int as a JAX config's pydantic field takes it (lax mode: a bool,
    an integral float, or a numeric string)."""
    if isinstance(value, (bool, int)):
        return int(value)
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            pass
    raise ValueError(f'{name} must be an integer, got {value!r}')


_TRUE = ('1', 'on', 't', 'true', 'y', 'yes')
_FALSE = ('0', 'off', 'f', 'false', 'n', 'no')


def lax_bool(name: str, value) -> bool:
    """A bool as a JAX config's pydantic field takes it (lax mode: 0 / 1,
    or one of pydantic's yes / no words)."""
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)) and value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.strip().lower() in _TRUE + _FALSE:
        return value.strip().lower() in _TRUE
    raise ValueError(f'{name} must be a boolean, got {value!r}')


def lax_str(name: str, value, choices: tuple | None = None) -> str:
    """A string field as pydantic takes it (no coercion), one of
    ``choices`` when they are given (a ``Literal`` field)."""
    if not isinstance(value, str):
        raise ValueError(f'{name} must be a string, got {value!r}')
    if choices is not None and value not in choices:
        raise ValueError(f'{name} must be one of {choices}, got {value!r}')
    return value


def lax_float(name: str, value) -> float:
    """A float as a JAX config's pydantic field takes it."""
    if isinstance(value, (bool, int, float)):
        return float(value)
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            pass
    raise ValueError(f'{name} must be a number, got {value!r}')


def curl_download(url: str, output_path: 'str | Path', timeout: int = 600) -> 'Path':
    """Download ``url`` to ``output_path`` with curl unless the file is
    already there (copy of ``distllm_tpu.utils.curl_download``): a
    transfer goes to a temporary name and is renamed on success, so a
    failed one never leaves a file a later call would take as cached."""
    import subprocess
    from pathlib import Path

    output_path = Path(output_path)
    if output_path.exists():
        return output_path
    output_path.parent.mkdir(parents=True, exist_ok=True)
    tmp_path = output_path.with_name(output_path.name + '.part')
    subprocess.run(
        ['curl', '-fsSL', url, '-o', str(tmp_path)], check=True, timeout=timeout
    )
    tmp_path.rename(output_path)
    return output_path


_ENV_PATTERN = re.compile(r'\$\{env:([A-Za-z_][A-Za-z0-9_]*)\}')


def substitute_env(obj):
    """Replace ``${env:VAR}`` markers in a YAML structure's strings with
    ``os.environ`` (unset variables become empty strings, as in the JAX
    package)."""
    if isinstance(obj, str):
        return _ENV_PATTERN.sub(lambda m: os.environ.get(m.group(1), ''), obj)
    if isinstance(obj, dict):
        return {k: substitute_env(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [substitute_env(v) for v in obj]
    return obj


def batch_data(data: list, chunk_size: int) -> list[list]:
    """``data`` in consecutive chunks of ``chunk_size`` (the last may be
    shorter; copy of ``distllm_tpu.utils.batch_data``)."""
    if chunk_size < 1:
        raise ValueError(f'batch_size must be >= 1, got {chunk_size}')
    return [data[i : i + chunk_size] for i in range(0, len(data), chunk_size)]


def canonical_function(fn, module: str):
    """``fn`` re-resolved from its importable ``module`` when it was defined
    in ``__main__`` (an entry point run as ``python -m ...``): a process
    pool pickles functions by module path, and a spawned worker cannot
    resolve the entry point's ``__main__`` (copy of
    ``distllm_tpu.utils.canonical_function``)."""
    if getattr(fn, '__module__', None) != '__main__':
        return fn
    import importlib

    return getattr(importlib.import_module(module), fn.__name__)


def expo_backoff_retry(
    fn,
    *,
    max_tries: int = 5,
    base_delay: float = 1.0,
    max_delay: float = 30.0,
    retry_on: tuple = (Exception,),
    give_up_on: tuple = (),
    jitter: bool = True,
    sleep=None,
):
    """Call ``fn()`` with exponential backoff (copy of
    ``distllm_tpu.utils.expo_backoff_retry``): up to ``max_tries`` calls,
    delays ``base_delay * 2**attempt`` capped at ``max_delay`` and, with
    ``jitter``, scaled by a factor in [0.5, 1); an exception of
    ``give_up_on`` is raised at once, the last one of ``retry_on`` after
    the last try."""
    import random
    import time

    if sleep is None:
        sleep = time.sleep
    last = None
    for attempt in range(max_tries):
        try:
            return fn()
        except give_up_on:
            raise
        except retry_on as exc:  # noqa: PERF203
            last = exc
            if attempt == max_tries - 1:
                raise
            delay = min(max_delay, base_delay * (2**attempt))
            if jitter:
                delay *= 0.5 + random.random() / 2
            sleep(delay)
    raise last  # pragma: no cover - unreachable
