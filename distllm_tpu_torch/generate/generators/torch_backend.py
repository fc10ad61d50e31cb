"""Torch generator: the in-process paged-KV engine behind the generator API.

The counterpart of ``distllm_tpu.generate.generators.tpu_backend
.TpuGenerator``: the same sampling surface (temperature, ``top_p`` XOR
``min_p``, ``max_tokens``) and engine capacity knobs. The model comes from
``pretrained_model_name_or_path``, a local HF checkpoint directory, as
``TpuGenerator`` builds it: ``config.json``'s ``model_type`` picks the
family (``models.decoder_family``), ``from_hf_config`` and
``params_from_hf`` build the config and the weights (a ``weight_load``
start-up phase), the tokenizer is an ``HFTokenizer`` of ``tokenizer_name``
or the path, and every ``eos_token_id`` of ``generation_config.json``
stops a request (the first one the EOS when the tokenizer has none, the
rest as stop ids). Without a path the model is built from a
:class:`~distllm_tpu_torch.models.mistral.MistralConfig` (or a
:class:`~distllm_tpu_torch.models.gemma.GemmaConfig` for the Gemma
families, a :class:`~distllm_tpu_torch.models.mixtral.MixtralConfig` for
Mixtral): random weights made on the device from ``seed`` by the
family's own ``init`` (quantized there when ``quantization`` is set, so
Mixtral-8x7B's int8 tree is built without its 93 GB bf16 one), or params
bridged from the JAX package
(:func:`~distllm_tpu_torch.models.mistral.params_from_jax`).
``tensor_parallel_size: N`` above 1 serves on a mesh ``data=1, model=N``
(the JAX generator's ``MeshSpec(data=1, model=tp)``) from this one
process: it is rank 0, and it spawns the other ``N - 1`` ranks itself
(``generate.engine.sharded.ShardedEngine``; no torchrun). Each rank draws
or reads only its own slices, and the ranks stop with :meth:`shutdown`.
Rank r runs on ``cuda:<r % cards>`` (``CUDA_VISIBLE_DEVICES`` picks the
cards), or every rank on the CPU when the generator's device is the CPU;
``tensor_parallel_backend`` is their collectives': by default NCCL on
CUDA and gloo on the CPU. NCCL refuses two ranks on one card, so ranks
that share a card take ``tensor_parallel_backend: gloo``.
``quantization`` ('int8' / 'nf4'; ``True`` means nf4, the reference's
bitsandbytes flag) serves weight-only quantized weights: int8 projections
run through kernel K2. The serving knobs of the JAX generator config
(``decode_steps``, ``sampling_top_window``, ``prefill_chunk_tokens``,
``enable_mixed_batching``, ``max_window_prefill_tokens``, ``draft_k``,
``spec_ngram``) and its resilience knobs (``ttft_slo_s``,
``request_deadline_s``, ``max_dispatch_retries``, ``admission_control``)
pass on to the engine, ``None`` inheriting its default.
The engine is warmed up at construction (its decode graphs, and with
``draft_k`` its verify graphs, captured on the GPU).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from distllm_tpu_torch.generate.engine import (
    EngineConfig,
    LLMEngine,
    SamplingParams,
)
from distllm_tpu_torch.models import mistral
from distllm_tpu_torch.models.tokenizer import HFTokenizer, WhitespaceTokenizer
from distllm_tpu_torch.observability.instruments import log_event
from distllm_tpu_torch.observability.startup import get_compile_watcher
from distllm_tpu_torch.ops.paged_attention import ATTN_BACKENDS
from distllm_tpu_torch.ops.quantization import normalize_mode
from distllm_tpu_torch.resilience.admission import EngineOverloaded
from distllm_tpu_torch.utils import BaseConfig, lax_bool, resolve_device


# min_p when neither top_p nor min_p is set (the reference's default).
_DEFAULT_MIN_P = 0.1
_unroll_noted = False


def _note_decode_layer_unroll() -> None:
    """Say once a process that ``decode_layer_unroll`` is ignored."""
    global _unroll_noted
    if not _unroll_noted:
        _unroll_noted = True
        log_event(
            'decode_layer_unroll has no effect in distllm_tpu_torch: a CUDA graph '
            'already holds the whole decode step', component='generate',
        )

# Fields passed on to EngineConfig as they are, when set.
_ENGINE_KNOBS = (
    'enable_prefix_cache', 'decode_steps', 'sampling_top_window',
    'prefill_chunk_tokens', 'enable_mixed_batching', 'max_window_prefill_tokens',
    'draft_k', 'spec_ngram', 'ttft_slo_s', 'request_deadline_s',
    'max_dispatch_retries', 'admission_control',
)


@dataclasses.dataclass
class TorchGeneratorConfig(BaseConfig):
    # A local HF-format decoder checkpoint directory; when set, the model
    # and the tokenizer come from it and ``model`` is not read.
    pretrained_model_name_or_path: str | None = None
    tokenizer_name: str | None = None
    trust_remote_code: bool = False
    # The JAX field: the ranks of the model axis (this process is rank 0
    # and starts the others).
    tensor_parallel_size: int = 1
    # The ranks' collectives: None = 'nccl' on CUDA (one rank a card),
    # 'gloo' on the CPU; 'gloo' on CUDA lets ranks share a card.
    tensor_parallel_backend: str | None = None
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
    # The JAX config's switch for unrolling its decode layer scan. Accepted
    # so a JAX YAML reads here; it has no effect (a CUDA graph holds the
    # whole decode step), which is logged once when it is set.
    decode_layer_unroll: bool | None = None
    # The paged-attention backend (the JAX config's field, with the port's
    # values): 'auto' = kernel K1 on CUDA, 'reference' pins the plain op.
    attn_backend: str = 'auto'
    # None = the GPU (raises without one); 'cpu' only when asked.
    device: str | None = None

    def validate(self) -> None:
        if self.tensor_parallel_size < 1:
            raise ValueError('tensor_parallel_size must be >= 1')
        if self.tensor_parallel_backend not in (None, 'nccl', 'gloo'):
            raise ValueError(
                "tensor_parallel_backend must be 'nccl' or 'gloo', got "
                f'{self.tensor_parallel_backend!r}'
            )
        if self.max_tokens < 1:
            raise ValueError('max_tokens must be >= 1')
        if self.top_p < 0 or (self.min_p or 0.0) < 0:
            raise ValueError('top_p and min_p must be >= 0')
        if self.top_p and self.min_p:
            raise ValueError('Only one of top_p or min_p can be set')
        if self.decode_layer_unroll is not None:
            self.decode_layer_unroll = lax_bool('decode_layer_unroll', self.decode_layer_unroll)
            _note_decode_layer_unroll()
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


def generation_config_eos(model_dir: str) -> tuple[int, ...]:
    """Every ``eos_token_id`` of the checkpoint's ``generation_config.json``
    (an int or a list, as vLLM honours them); ``()`` when the file is
    missing or malformed (the JAX ``_generation_config_eos``)."""
    path = Path(model_dir) / 'generation_config.json'
    if not path.exists():
        return ()
    try:
        eos = json.loads(path.read_text()).get('eos_token_id')
        ids = eos if isinstance(eos, list) else [eos]
        return tuple(int(i) for i in ids if i is not None)
    except (OSError, ValueError, TypeError, AttributeError):
        return ()


def load_checkpoint(config: TorchGeneratorConfig, device: torch.device, *,
                    weights: bool = True):
    """``(model_cfg, params, tokenizer, extra_stop_ids)`` of the config's
    checkpoint directory, as ``TpuGenerator.__init__`` builds them: the
    family from ``config.json``'s ``model_type``, its ``from_hf_config``
    and ``params_from_hf`` (the params on ``device``; ``None`` without
    ``weights``), an ``HFTokenizer`` of ``tokenizer_name`` or the path
    whose EOS is its own or else the first of ``generation_config.json``'s,
    and that file's other EOS ids as extra stop ids."""
    from distllm_tpu_torch.models import decoder_family
    from distllm_tpu_torch.models.loader import read_checkpoint, read_hf_config

    path = config.pretrained_model_name_or_path
    hf_cfg = read_hf_config(path)
    cfg_cls, family = decoder_family(hf_cfg.get('model_type', 'mistral'))
    model_cfg = cfg_cls.from_hf_config(hf_cfg)
    params = None
    if weights:
        with get_compile_watcher().phase('weight_load', Path(path).name or path) as phase:
            params = family.params_from_hf(read_checkpoint(path), model_cfg, device=device)
            phase['model_type'] = hf_cfg.get('model_type', 'mistral')
    tokenizer = HFTokenizer(
        config.tokenizer_name or path, trust_remote_code=config.trust_remote_code,
    )
    gc_eos = generation_config_eos(path)
    if getattr(tokenizer._tok, 'eos_token_id', None) is not None:
        tokenizer.eos_id = int(tokenizer._tok.eos_token_id)
    elif gc_eos:
        tokenizer.eos_id = gc_eos[0]
    extra = tuple(i for i in gc_eos if i != getattr(tokenizer, 'eos_id', None))
    return model_cfg, params, tokenizer, extra


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
        # Weights made or read here are ours: the engine may free each
        # float leaf as its quantized codes appear.
        own_params = params is None
        # Stop ids of generation_config.json beyond the EOS.
        self._extra_stop_ids: tuple[int, ...] = ()
        self._sharded = None
        if config.tensor_parallel_size > 1:
            self._start_ranks(config, device, params, tokenizer, attn_backend, qmm_backend)
            return
        if own_params and config.pretrained_model_name_or_path:
            model_cfg, params, hf_tokenizer, self._extra_stop_ids = load_checkpoint(
                config, device
            )
            tokenizer = tokenizer or hf_tokenizer
        elif own_params:
            # The family's own init: Mixtral's draws its expert banks and,
            # quantized, codes them layer by layer (its bf16 tree would not
            # fit the card).
            from distllm_tpu_torch.models import decoder_family

            _, family = decoder_family(model_cfg.name)
            params = family.init(
                model_cfg,
                torch.Generator(device=device).manual_seed(config.seed),
                device=device,
                quantization=config.quantization,
            )
        self.model_cfg = model_cfg
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

    def _start_ranks(self, config, device, params, tokenizer, attn_backend,
                     qmm_backend) -> None:
        """``tensor_parallel_size > 1``: this process becomes rank 0 of a
        mesh ``data=1, model=N`` and spawns the other ranks, each building
        its slices from the config's weights (a checkpoint, the seed, or
        ``params`` handed over whole), then warms the engine up on every
        rank."""
        from distllm_tpu_torch.generate.engine.sharded import (
            ShardedEngine,
            WeightSource,
        )
        from distllm_tpu_torch.parallel.mesh import rank_devices

        world = config.tensor_parallel_size
        backend = config.tensor_parallel_backend or (
            'gloo' if device.type == 'cpu' else 'nccl'
        )
        devices = rank_devices(world, device)
        mode = normalize_mode(config.quantization)
        model_cfg = config.model
        if params is not None:
            source = WeightSource('tree', tree=params)
        elif config.pretrained_model_name_or_path:
            model_cfg, _, hf_tokenizer, self._extra_stop_ids = load_checkpoint(
                config, device, weights=False,
            )
            tokenizer = tokenizer or hf_tokenizer
            source = WeightSource(
                'checkpoint', quantization=mode,
                path=config.pretrained_model_name_or_path,
            )
        else:
            source = WeightSource('init', seed=config.seed, quantization=mode)
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer or WhitespaceTokenizer(
            vocab_size=model_cfg.vocab_size, model_max_length=config.max_model_len,
        )
        with get_compile_watcher().phase('tensor_parallel', f'tp{world}') as phase:
            self._sharded = ShardedEngine(
                world, model_cfg, source, config.engine_config(), backend=backend,
                devices=devices, tokenizer=self.tokenizer,
                attn_backend=attn_backend or config.attn_backend,
                qmm_backend=qmm_backend,
            )
            phase.update(backend=backend, devices=','.join(devices))
        self.engine = self._sharded.engine
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
            # generation_config.json's stop ids beyond the EOS.
            stop_token_ids=getattr(self, '_extra_stop_ids', ()),
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

    @property
    def rank_reports(self) -> list[dict]:
        """Each rank's ``LLMEngine.tp_report`` after :meth:`shutdown` of a
        tensor-parallel generator (equal digests: every rank sampled the
        same tokens); ``[]`` otherwise."""
        return self._sharded.reports if self._sharded is not None else []

    def shutdown(self) -> None:
        if self._sharded is not None:
            if not self._sharded.reports:
                self._sharded.close()
            return
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
