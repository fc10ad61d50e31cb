"""Checkpoint IO: read HuggingFace-format weights into CPU tensors (the
PyTorch counterpart of ``distllm_tpu.models.loader``).

Checkpoints are read directly from a local directory, with the JAX
loader's preference order: ``*.safetensors`` when any are present
(``safetensors`` is imported only then), else ``*.bin`` / ``*.pt`` /
``**/*.pth`` through ``torch.load``. Each model module maps the flat state
dict to its parameters (``models/bert.py`` ``params_from_hf``). Nothing is
downloaded.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch


def read_checkpoint(model_dir: 'str | Path') -> dict[str, torch.Tensor]:
    """Read all weights under ``model_dir`` into a flat {name: tensor} dict
    on the CPU (bf16 weights widened to fp32, as the JAX loader does)."""
    model_dir = Path(model_dir)
    if not model_dir.is_dir():
        raise FileNotFoundError(
            f'checkpoint dir not found: {model_dir} '
            '(network downloads are disabled; pass a local path)'
        )
    state: dict[str, torch.Tensor] = {}
    safetensor_files = sorted(model_dir.glob('*.safetensors'))
    if safetensor_files:
        from safetensors.torch import load_file

        for path in safetensor_files:
            state.update(load_file(str(path)))
    else:
        bin_files = (
            sorted(model_dir.glob('*.bin'))
            + sorted(model_dir.glob('*.pt'))
            + sorted(model_dir.glob('**/*.pth'))
        )
        if not bin_files:
            raise FileNotFoundError(f'no *.safetensors or *.bin under {model_dir}')
        for path in bin_files:
            state.update(torch.load(str(path), map_location='cpu', weights_only=True))
    return {
        key: value.float() if value.dtype == torch.bfloat16 else value
        for key, value in state.items()
    }


def read_hf_config(model_dir: 'str | Path') -> dict:
    with open(Path(model_dir) / 'config.json') as fh:
        return json.load(fh)
