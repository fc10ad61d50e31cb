"""HuggingFace generator: transformers' ``AutoModelForCausalLM.generate``
(counterpart of ``distllm_tpu.generate.generators.huggingface_backend``,
torch code in the JAX package too): top-p, beams, ``do_sample`` and
batches of ``batch_size`` prompts, the prompt's tokens cut from each
answer. The port adds an explicit ``device`` (``None`` = CUDA, raising
without it; ``'cpu'`` only when asked). ``transformers`` is imported when
a generator is built, not with this module.
"""

from __future__ import annotations

import dataclasses

from distllm_tpu_torch.utils import (
    BaseConfig,
    batch_data,
    lax_bool,
    lax_float,
    lax_int,
    lax_str,
    resolve_device,
)


@dataclasses.dataclass(kw_only=True)
class HuggingFaceGeneratorConfig(BaseConfig):
    name: str = 'huggingface'
    pretrained_model_name_or_path: str
    half_precision: bool = False
    batch_size: int = 4
    top_p: float = 0.95
    num_beams: int = 1
    do_sample: bool = True
    max_new_tokens: int = 256
    trust_remote_code: bool = False
    # None = the GPU (raises without one); 'cpu' only when asked.
    device: str | None = None

    def validate(self) -> None:
        lax_str('name', self.name, ('huggingface',))
        lax_str('pretrained_model_name_or_path', self.pretrained_model_name_or_path)
        for key in ('half_precision', 'do_sample', 'trust_remote_code'):
            setattr(self, key, lax_bool(key, getattr(self, key)))
        for key in ('batch_size', 'num_beams', 'max_new_tokens'):
            setattr(self, key, lax_int(key, getattr(self, key)))
        self.top_p = lax_float('top_p', self.top_p)


class HuggingFaceGenerator:
    def __init__(self, config: HuggingFaceGeneratorConfig) -> None:
        import torch
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.config = config
        self.device = resolve_device(config.device)
        self.tokenizer = AutoTokenizer.from_pretrained(
            config.pretrained_model_name_or_path,
            trust_remote_code=config.trust_remote_code,
        )
        if self.tokenizer.pad_token is None:
            self.tokenizer.pad_token = self.tokenizer.eos_token
        dtype = torch.float16 if config.half_precision else torch.float32
        self.model = AutoModelForCausalLM.from_pretrained(
            config.pretrained_model_name_or_path,
            torch_dtype=dtype,
            trust_remote_code=config.trust_remote_code,
        ).to(self.device).eval()

    def generate(self, prompts: str | list[str]) -> list[str]:
        import torch

        if isinstance(prompts, str):
            prompts = [prompts]
        responses: list[str] = []
        for batch in batch_data(prompts, self.config.batch_size):
            inputs = self.tokenizer(
                batch, return_tensors='pt', padding=True, truncation=True
            ).to(self.device)
            with torch.no_grad():
                outputs = self.model.generate(
                    **inputs,
                    max_new_tokens=self.config.max_new_tokens,
                    top_p=self.config.top_p,
                    num_beams=self.config.num_beams,
                    do_sample=self.config.do_sample,
                    pad_token_id=self.tokenizer.pad_token_id,
                )
            prompt_len = inputs['input_ids'].shape[1]
            responses.extend(
                self.tokenizer.batch_decode(
                    outputs[:, prompt_len:], skip_special_tokens=True
                )
            )
        return responses

    def shutdown(self) -> None:
        self.model = None
