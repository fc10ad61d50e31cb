"""Torch generator: the in-process paged-KV engine behind the generator API.

The counterpart of ``distllm_tpu.generate.generators.tpu_backend
.TpuGenerator``: the same sampling surface (temperature, ``top_p`` XOR
``min_p``, ``max_tokens``) and engine capacity knobs, with the model built
from a :class:`~distllm_tpu_torch.models.mistral.MistralConfig` (or a
:class:`~distllm_tpu_torch.models.gemma.GemmaConfig` for the Gemma
families) — random weights made on the device from ``seed``, or params
bridged from the JAX package
(:func:`~distllm_tpu_torch.models.mistral.params_from_jax`).
``quantization`` ('int8' / 'nf4'; ``True`` means nf4, the reference's
bitsandbytes flag) serves weight-only quantized weights: int8 projections
run through kernel K2. The serving knobs of the JAX generator config
(``decode_steps``, ``sampling_top_window``, ``prefill_chunk_tokens``,
``enable_mixed_batching``, ``max_window_prefill_tokens``, ``draft_k``,
``spec_ngram``) and its resilience knobs (``ttft_slo_s``,
``request_deadline_s``, ``max_dispatch_retries``, ``admission_control``)
pass on to the engine, ``None`` inheriting its default.
The engine is warmed up at construction (its decode graphs, and with
``draft_k`` its verify graphs, captured on the GPU). Loading an HF
checkpoint and tokenizer waits until such files are in the repository.
"""

from __future__ import annotations

import dataclasses

import torch

from distllm_tpu_torch.generate.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.models.tokenizer import WhitespaceTokenizer
from distllm_tpu_torch.ops.paged_attention import ATTN_BACKENDS
from distllm_tpu_torch.ops.quantization import normalize_mode
from distllm_tpu_torch.resilience.admission import EngineOverloaded
from distllm_tpu_torch.utils import BaseConfig, resolve_device


# min_p when neither top_p nor min_p is set (the reference's default).
_DEFAULT_MIN_P = 0.1

# Fields passed on to EngineConfig as they are, when set.
_ENGINE_KNOBS = (
    'enable_prefix_cache', 'decode_steps', 'sampling_top_window',
    'prefill_chunk_tokens', 'enable_mixed_batching', 'max_window_prefill_tokens',
    'draft_k', 'spec_ngram', 'ttft_slo_s', 'request_deadline_s',
    'max_dispatch_retries', 'admission_control',
)


@dataclasses.dataclass
class TorchGeneratorConfig(BaseConfig):
    model: mistral.MistralConfig = dataclasses.field(
        default_factory=mistral.MistralConfig
    )
    temperature: float = 0.5
    # Reference behaviour: a set top_p wins and min_p (0.1 when not set)
    # is then ignored; setting both to nonzero values is refused, as the
    # JAX config refuses it.
    min_p: float | None = None
    top_p: float = 0.0
    max_tokens: int = 2000
    # Engine capacity knobs (vLLM analogues).
    block_size: int = 16
    num_blocks: int = 2048
    max_num_seqs: int = 16
    max_model_len: int = 4096
    # Seed of the random weights when no params are given.
    seed: int = 0
    # Weight-only quantized serving; True means nf4 (the reference's
    # bitsandbytes NF4 load path).
    quantization: 'bool | str | None' = None
    # Automatic prefix caching (EngineConfig.enable_prefix_cache); None
    # inherits the engine's default. The host and disk tier knobs and
    # kv_cache_dtype stay EngineConfig-only, as in the JAX package.
    enable_prefix_cache: bool | None = None
    # The JAX generator config's serving knobs (EngineConfig fields of the
    # same names); None inherits the engine's default.
    decode_steps: int | None = None
    sampling_top_window: int | None = None
    prefill_chunk_tokens: int | None = None
    enable_mixed_batching: bool | None = None
    max_window_prefill_tokens: int | None = None
    draft_k: int | None = None
    spec_ngram: int | None = None
    # The resilience knobs (EngineConfig fields of the same names); None
    # inherits the engine's default. The chat app sets the deadline and the
    # retry budget for a served engine (ChatAppConfig.build_generator).
    ttft_slo_s: float | None = None
    request_deadline_s: float | None = None
    max_dispatch_retries: int | None = None
    admission_control: bool | None = None
    # The paged-attention backend (the JAX config's field, with the port's
    # values): 'auto' = kernel K1 on CUDA, 'reference' pins the plain op.
    attn_backend: str = 'auto'
    # None = the GPU (raises without one); 'cpu' only when asked.
    device: str | None = None

    def validate(self) -> None:
        if self.max_tokens < 1:
            raise ValueError('max_tokens must be >= 1')
        if self.top_p < 0 or (self.min_p or 0.0) < 0:
            raise ValueError('top_p and min_p must be >= 0')
        if self.top_p and self.min_p:
            raise ValueError('Only one of top_p or min_p can be set')
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(
                f'attn_backend must be one of {ATTN_BACKENDS}, got {self.attn_backend!r}'
            )
        self.engine_config()  # refuses what the engine would refuse

    def engine_config(self) -> EngineConfig:
        overrides = {
            name: getattr(self, name) for name in _ENGINE_KNOBS
            if getattr(self, name) is not None
        }
        return EngineConfig(
            block_size=self.block_size,
            num_blocks=self.num_blocks,
            max_num_seqs=self.max_num_seqs,
            max_model_len=self.max_model_len,
            quantization=normalize_mode(self.quantization),
            **overrides,
        )


class TorchGenerator:
    def __init__(
        self,
        config: TorchGeneratorConfig,
        params: dict | None = None,
        tokenizer=None,
        attn_backend: str | None = None,
        qmm_backend: str | None = None,
    ) -> None:
        self.config = config
        device = resolve_device(config.device)
        model_cfg = config.model
        # Weights made here are ours: the engine may free each float leaf
        # as its quantized codes appear.
        own_params = params is None
        if own_params:
            params = mistral.init(
                model_cfg,
                torch.Generator(device=device).manual_seed(config.seed),
                device=device,
            )
        self.tokenizer = tokenizer or WhitespaceTokenizer(
            vocab_size=model_cfg.vocab_size,
            model_max_length=config.max_model_len,
        )
        self.engine = LLMEngine(
            model_cfg, params, self.tokenizer, config.engine_config(),
            device=device, attn_backend=attn_backend or config.attn_backend,
            qmm_backend=qmm_backend,
            own_params=own_params,
        )
        # Capture the decode graphs here, in the constructing thread, before
        # any server thread exists: a capture must see no other thread's
        # device work, and the chat server's engine worker then only
        # replays (a replay is safe from any thread, on its current stream).
        self.engine.warmup()

    def sampling_params(self) -> SamplingParams:
        min_p = self.config.min_p
        if self.config.top_p:
            min_p = 0.0
        elif min_p is None:
            min_p = _DEFAULT_MIN_P
        return SamplingParams(
            temperature=self.config.temperature,
            top_p=self.config.top_p or 1.0,
            min_p=min_p,
            max_tokens=self.config.max_tokens,
        )

    def generate(
        self,
        prompts: str | list[str],
        sampling: 'SamplingParams | list[SamplingParams] | None' = None,
    ) -> list[str]:
        """Generate one completion per prompt; ``sampling`` overrides the
        config's sampling knobs (one for all prompts, or one per prompt)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        return self.engine.generate(prompts, sampling or self.sampling_params())

    def shutdown(self) -> None:
        self.engine.shutdown()


@dataclasses.dataclass
class FakeGeneratorConfig(BaseConfig):
    """The JAX package's deterministic test backend (``FakeGenerator`` of
    ``distllm_tpu.generate.generators.tpu_backend``): every prompt answers
    ``response_template`` over its first ``max_prompt_chars`` characters.
    Every ``overload_every``-th ``generate`` call raises
    ``resilience.EngineOverloaded`` (the engine's shed signal), so the chat
    server's 429 / Retry-After path runs without a loaded engine; 0
    disables."""

    name: str = 'fake'
    response_template: str = 'response to: {prompt}'
    max_prompt_chars: int = 48
    overload_every: int = 0

    def validate(self) -> None:
        if self.overload_every < 0:
            raise ValueError('overload_every must be >= 0')


class FakeGenerator:
    def __init__(self, config: FakeGeneratorConfig) -> None:
        self.config = config
        self._calls = 0

    def generate(self, prompts: str | list[str]) -> list[str]:
        if isinstance(prompts, str):
            prompts = [prompts]
        self._calls += 1
        every = self.config.overload_every
        if every > 0 and self._calls % every == 0:
            raise EngineOverloaded(predicted_ttft_s=1.25, retry_after_s=3.0, slo_s=0.5)
        return [
            self.config.response_template.format(
                prompt=p[: self.config.max_prompt_chars]
            )
            for p in prompts
        ]
