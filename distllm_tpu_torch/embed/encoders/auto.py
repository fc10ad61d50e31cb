"""Auto encoder: a local HF checkpoint directory to the port's model
(counterpart of ``distllm_tpu.embed.encoders.auto``).

``config.json``'s ``model_type`` picks the model: the encoder families
``bert``, ``esm`` (ESM-2) and ``modernbert``, or any decoder family of
``models.decoder_families`` (mistral, llama, qwen2, mixtral, gemma,
gemma2: embedding models such as SFR-Embedding-Mistral ride the decoder
forward, ``mistral.apply``, with ``last_token`` pooling; a Mixtral
checkpoint rides it through its router branch); ``half_precision``
picks bf16 activations (fp32 otherwise); the weights are read with
``models.loader`` and the tokenizer is the checkpoint's own HF tokenizer.
``quantization`` ('int8' / 'nf4'; ``True`` means nf4, the reference's
bitsandbytes flag) quantizes the checkpoint's fp32 dense kernels on the
device, as the JAX encoder quantizes its fp32 parameters, so the codes
are the JAX package's (a Mixtral expert bank one expert's slice at a
time).
"""

from __future__ import annotations

import dataclasses

import torch

from distllm_tpu_torch.embed.encoders.base import TorchEncoder
from distllm_tpu_torch.models import bert, decoder_family, esm2, modernbert
from distllm_tpu_torch.models.loader import read_checkpoint, read_hf_config
from distllm_tpu_torch.models.tokenizer import HFTokenizer
from distllm_tpu_torch.ops.quantization import normalize_mode
from distllm_tpu_torch.utils import BaseConfig, resolve_device

# The encoder-only families; every other model_type is a decoder family.
_ENCODER_FAMILIES = {
    'bert': (bert.BertConfig, bert),
    'esm': (esm2.Esm2Config, esm2),
    'modernbert': (modernbert.ModernBertConfig, modernbert),
}


@dataclasses.dataclass(kw_only=True)
class AutoEncoderConfig(BaseConfig):
    name: str = 'auto'
    # Local path to an HF-format checkpoint directory.
    pretrained_model_name_or_path: str
    tokenizer_name: str | None = None  # defaults to the model path
    half_precision: bool = True  # bf16 activations and weights
    model_max_length: int | None = None
    trust_remote_code: bool = False
    quantization: 'bool | str' = False

    def validate(self) -> None:
        normalize_mode(self.quantization)


class AutoEncoder(TorchEncoder):
    def __init__(
        self,
        config: AutoEncoderConfig,
        device: 'str | torch.device | None' = None,
    ) -> None:
        device = resolve_device(device)
        hf_cfg = read_hf_config(config.pretrained_model_name_or_path)
        model_type = hf_cfg.get('model_type', 'bert')
        if model_type in _ENCODER_FAMILIES:
            cfg_cls, module = _ENCODER_FAMILIES[model_type]
        else:  # a decoder family; anything else raises there
            cfg_cls, module = decoder_family(model_type)
        model_cfg = cfg_cls.from_hf_config(hf_cfg)
        model_cfg.dtype = 'bfloat16' if config.half_precision else 'float32'
        mode = normalize_mode(config.quantization)
        state = read_checkpoint(config.pretrained_model_name_or_path)
        # Quantized: the dense kernels stay fp32 until the quantizer has
        # read them (biases are cast to the activation dtype at use).
        params = module.params_from_hf(
            state, model_cfg, device=device, dtype='float32' if mode else None
        )
        tokenizer = HFTokenizer(
            config.tokenizer_name or config.pretrained_model_name_or_path,
            model_max_length=config.model_max_length
            or hf_cfg.get('max_position_embeddings'),
            trust_remote_code=config.trust_remote_code,
        )
        super().__init__(
            config=config,
            apply_fn=module.apply,
            model_cfg=model_cfg,
            params=params,
            tokenizer=tokenizer,
            embedding_size=model_cfg.hidden_size,
            device=device,
            quantization=mode,
        )
        self._module = module

    def param_specs(self, params: dict | None = None) -> dict:
        """The model family's ``param_specs`` for this encoder's tree (the
        JAX ``AutoEncoder.param_specs``), to pass to :meth:`shard`."""
        return self._module.param_specs(self.model_cfg, params or self.params)
