"""The protein encoder strategies (counterpart of
``distllm_tpu.embed.encoders.esm2``): ``esm2`` over a local HF ``EsmModel``
checkpoint and its HF tokenizer, and ``esmc`` over an ``esm``-package
``.pth`` checkpoint and :class:`~distllm_tpu_torch.models.esmc.
EsmcSequenceTokenizer`. Both run their attention through kernel K3 on
CUDA."""

from __future__ import annotations

import dataclasses

import torch

from distllm_tpu_torch.embed.encoders.base import TorchEncoder
from distllm_tpu_torch.models import esm2, esmc
from distllm_tpu_torch.models.loader import read_checkpoint, read_hf_config
from distllm_tpu_torch.models.tokenizer import HFTokenizer
from distllm_tpu_torch.utils import BaseConfig, resolve_device


@dataclasses.dataclass(kw_only=True)
class Esm2EncoderConfig(BaseConfig):
    name: str = 'esm2'
    pretrained_model_name_or_path: str
    half_precision: bool = True
    model_max_length: int = 1024


class Esm2Encoder(TorchEncoder):
    def __init__(
        self,
        config: Esm2EncoderConfig,
        device: 'str | torch.device | None' = None,
    ) -> None:
        device = resolve_device(device)
        hf_cfg = read_hf_config(config.pretrained_model_name_or_path)
        model_cfg = esm2.Esm2Config.from_hf_config(hf_cfg)
        model_cfg.dtype = 'bfloat16' if config.half_precision else 'float32'
        params = esm2.params_from_hf(
            read_checkpoint(config.pretrained_model_name_or_path), model_cfg, device=device
        )
        tokenizer = HFTokenizer(
            config.pretrained_model_name_or_path,
            model_max_length=config.model_max_length,
        )
        super().__init__(
            config=config,
            apply_fn=esm2.apply,
            model_cfg=model_cfg,
            params=params,
            tokenizer=tokenizer,
            embedding_size=model_cfg.hidden_size,
            device=device,
        )


# The released ESM-C checkpoints and their hidden sizes (300M, 600M).
_ESMC_SIZES = {
    'EvolutionaryScale/esmc-300m-2024-12': 960,
    'EvolutionaryScale/esmc-600m-2024-12': 1152,
}


@dataclasses.dataclass(kw_only=True)
class EsmCambrianEncoderConfig(BaseConfig):
    """ESM-Cambrian: the two released sizes map 300M -> 960 and 600M ->
    1152; a fine-tuned checkpoint must set ``embedding_size``. Sequences
    cap at 2048 tokens."""

    name: str = 'esmc'
    pretrained_model_name_or_path: str = 'EvolutionaryScale/esmc-300m-2024-12'
    embedding_size: int | None = None
    half_precision: bool = True
    model_max_length: int = 2048

    def resolved_embedding_size(self) -> int:
        if self.embedding_size is not None:
            return self.embedding_size
        for name, size in _ESMC_SIZES.items():
            # Registry names and local paths ending in them.
            if self.pretrained_model_name_or_path.rstrip('/').endswith(name.split('/')[-1]):
                return size
        raise ValueError(
            f'Invalid model name for ESMC: '
            f'{self.pretrained_model_name_or_path}. Valid model names are: '
            f'{", ".join(_ESMC_SIZES)}. Or set embedding_size explicitly for a '
            'fine-tuned model.'
        )


class EsmCambrianEncoder(TorchEncoder):
    """The ESM-C stack (``models/esmc.py``) loaded from the ``esm``-package
    ``.pth`` format, not the ESM-2/HF layout; the depth is read from the
    checkpoint's ``transformer.blocks.N`` keys."""

    def __init__(
        self,
        config: EsmCambrianEncoderConfig,
        device: 'str | torch.device | None' = None,
    ) -> None:
        device = resolve_device(device)
        hidden = config.resolved_embedding_size()
        model_cfg = esmc.EsmcConfig.from_hidden_size(
            hidden,
            dtype='bfloat16' if config.half_precision else 'float32',
            max_position_embeddings=config.model_max_length,
        )
        state = read_checkpoint(config.pretrained_model_name_or_path)
        block_ids = [
            int(key.split('.')[2]) for key in state if key.startswith('transformer.blocks.')
        ]
        if not block_ids:
            raise ValueError(
                'checkpoint is not in esm-package ESMC layout (no '
                "'transformer.blocks.*' keys) — ESM-C loads the "
                'EvolutionaryScale .pth format, not HF/ESM-2 checkpoints'
            )
        model_cfg.num_layers = 1 + max(block_ids)
        super().__init__(
            config=config,
            apply_fn=esmc.apply,
            model_cfg=model_cfg,
            params=esmc.params_from_esm(state, model_cfg, device=device),
            tokenizer=esmc.EsmcSequenceTokenizer(model_max_length=config.model_max_length),
            embedding_size=hidden,
            device=device,
        )
