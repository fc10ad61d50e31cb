"""Encoder protocol and the shared PyTorch encoder runtime (counterpart of
``distllm_tpu.embed.encoders.base``).

An encoder owns a tokenizer and turns a host :class:`TokenBatch` into
``[B, S, H]`` last hidden states on its device. :meth:`TorchEncoder.
pooled_forward` is the embedder's hot call: encode -> pool -> optional L2
normalise -> fp32 in one call, so only pooled ``[B, H]`` rows ever leave
the device.

:meth:`TorchEncoder.shard` puts an encoder on a mesh, as the JAX
``Encoder.shard`` places its parameters: every rank of the mesh builds the
same encoder, keeps its slices under the model's ``param_specs`` and runs
its heads and width, the row-parallel products summed over the ``model``
group; a ``data`` axis replicates the batch. It is a library capability:
no entry point of either package calls it.
"""

from __future__ import annotations

import sys
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

    def shard(self, mesh, specs) -> None:
        """Keep this rank's slices of the parameters under ``specs`` on
        ``mesh`` (``parallel.sharding.shard_pytree``: int8 leaves sharded
        with their scales, nf4 ones sliced at use) and bind the model
        config to the mesh (``parallel.comm.bind``), so ``apply`` runs the
        rank's heads with kernel K3 and sums ``o`` and ``down`` over the
        ``model`` group. The mesh's device is this encoder's. A model
        without ``param_specs`` (ESM-C, as in JAX) is refused."""
        from distllm_tpu_torch.parallel.comm import bind
        from distllm_tpu_torch.parallel.sharding import shard_pytree

        apply_fn = getattr(self._apply_fn, 'func', self._apply_fn)  # a partial's function
        module = sys.modules[apply_fn.__module__]
        if not hasattr(module, 'param_specs'):
            raise NotImplementedError(
                f'{module.__name__} has no param_specs (nor has the JAX package): '
                'it runs on one device'
            )
        if torch.device(mesh.device).type != self.device.type:
            raise ValueError(f'the mesh rank runs on {mesh.device}, the encoder on {self.device}')
        self.params = shard_pytree(self.params, specs, mesh)
        self.model_cfg = bind(self.model_cfg, mesh)

    def shutdown(self) -> None:
        """Drop the parameter references so a swapped-in model can fit."""
        self.params = None
