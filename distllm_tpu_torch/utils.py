"""Config base and device resolution for the PyTorch port.

``BaseConfig`` stands in for ``distllm_tpu.utils.BaseConfig`` (a pydantic
model there): a plain dataclass base whose ``__post_init__`` runs the
subclass's ``validate`` hook, so a config that cannot serve is refused at
construction, as the pydantic validators refuse it in the JAX package.
"""

from __future__ import annotations

import dataclasses

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
