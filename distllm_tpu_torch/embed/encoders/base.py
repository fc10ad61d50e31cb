"""Encoder protocol and the shared PyTorch encoder runtime (counterpart of
``distllm_tpu.embed.encoders.base``).

An encoder owns a tokenizer and turns a host :class:`TokenBatch` into
``[B, S, H]`` last hidden states on its device. :meth:`TorchEncoder.
pooled_forward` is the embedder's hot call: encode -> pool -> optional L2
normalise -> fp32 in one call, so only pooled ``[B, H]`` rows ever leave
the device.
"""

from __future__ import annotations

from typing import Callable, Protocol, runtime_checkable

import torch

from distllm_tpu_torch.models.tokenizer import TokenBatch
from distllm_tpu_torch.ops.quantization import (
    leaves,
    normalize_mode,
    quantize_pytree,
)
from distllm_tpu_torch.utils import resolve_device


@runtime_checkable
class Encoder(Protocol):
    config: object
    embedding_size: int
    device: torch.device

    @property
    def tokenizer(self): ...

    def forward(self, batch: TokenBatch) -> torch.Tensor: ...

    def pooled_forward(
        self, pooler, normalize: bool = False
    ) -> Callable[[TokenBatch], torch.Tensor]: ...


class TorchEncoder:
    """Concrete encoder driving a functional model's ``apply``:
    ``apply_fn(params, model_cfg, ids, mask) -> [B, S, H]``.

    ``device=None`` means CUDA and raises without it; the parameters must
    already live on that device (``bert.init`` / ``params_from_*`` put
    them there). ``quantization`` ('int8' / 'nf4'; ``True`` means nf4)
    quantizes the large dense kernels on that device at construction,
    with the model dtype as the dequantization dtype; int8 ones then run
    through kernel K2.
    """

    def __init__(
        self,
        config,
        apply_fn,
        model_cfg,
        params: dict,
        tokenizer,
        embedding_size: int,
        device: 'str | torch.device | None' = None,
        quantization: 'bool | str | None' = None,
    ) -> None:
        self.device = resolve_device(device)
        for leaf in leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(
                    f'encoder parameters live on {leaf.device}, the encoder '
                    f'runs on {self.device}'
                )
        self.quantization = normalize_mode(quantization)
        if self.quantization:
            params = quantize_pytree(
                params, mode=self.quantization,
                out_dtype=getattr(model_cfg, 'dtype', 'bfloat16'),
            )
        self.config = config
        self.model_cfg = model_cfg
        self.params = params
        self.embedding_size = embedding_size
        self._apply_fn = apply_fn
        self._tokenizer = tokenizer

    @property
    def tokenizer(self):
        return self._tokenizer

    def _inputs(self, batch: TokenBatch) -> tuple[torch.Tensor, torch.Tensor]:
        ids = torch.from_numpy(batch.input_ids).to(self.device, non_blocking=True)
        mask = torch.from_numpy(batch.attention_mask).to(self.device, non_blocking=True)
        return ids, mask

    def forward(self, batch: TokenBatch) -> torch.Tensor:
        ids, mask = self._inputs(batch)
        with torch.inference_mode():
            return self._apply_fn(self.params, self.model_cfg, ids, mask)

    def pooled_forward(
        self, pooler, normalize: bool = False
    ) -> Callable[[TokenBatch], torch.Tensor]:
        """encode -> pool -> (L2 normalise) -> fp32 ``[B, H]`` on the
        device, as one call per batch. Zero vectors (the fully masked pad
        rows) normalise to zeros, not NaN."""

        def run(batch: TokenBatch) -> torch.Tensor:
            ids, mask = self._inputs(batch)
            with torch.inference_mode():
                hidden = self._apply_fn(self.params, self.model_cfg, ids, mask)
                pooled = pooler.pool(hidden, mask)
                if normalize:
                    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
                    pooled = pooled / norm.clamp(min=1e-12)
                return pooled.float()

        return run

    def shutdown(self) -> None:
        """Drop the parameter references so a swapped-in model can fit."""
        self.params = None
