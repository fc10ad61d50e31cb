"""Chat app config and prompt rendering (counterparts of
``distllm_tpu.chat.ChatAppConfig`` and ``ConversationPromptTemplate``;
retrieval waits for the RAG slice, ROADMAP A9)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

from distllm_tpu_torch.utils import BaseConfig

# generator_config names that build the paged-KV engine: the JAX package's
# ('tpu', 'vllm') and the port's own.
ENGINE_BACKENDS = ('tpu', 'vllm', 'torch')
# The JAX chat app's other backends, with the ROADMAP item that ports them.
_NOT_PORTED_BACKENDS = {'fake': 'ROADMAP A11', 'http': 'ROADMAP A11'}
# Fields of the JAX generator config the port's has not yet.
_NOT_PORTED_FIELDS = {
    'pretrained_model_name_or_path': 'ROADMAP A6',
    'request_deadline_s': 'ROADMAP A6',
    'max_dispatch_retries': 'ROADMAP A6',
}


def _lax_int(name: str, value) -> int:
    """An int as the JAX config's pydantic field takes it (lax mode: a
    bool, an integral float, or a numeric string)."""
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


def _lax_float(name: str, value) -> float:
    if isinstance(value, (bool, int, float)):
        return float(value)
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            pass
    raise ValueError(f'{name} must be a number, got {value!r}')


@dataclasses.dataclass
class ChatAppConfig(BaseConfig):
    """YAML config of the chat server: the JAX ``ChatAppConfig``'s keys,
    defaults and checks. The retrieval keys are read and validated; a
    retriever itself is refused until ROADMAP A9."""

    generator_config: dict = dataclasses.field(default_factory=lambda: {'name': 'fake'})
    retriever_config: dict | None = None
    system_prompt: str = ''
    retrieval_top_k: int = 20
    retrieval_score_threshold: float = 0.1
    transcript_dir: Path | None = None

    def validate(self) -> None:
        if not isinstance(self.generator_config, dict):
            raise ValueError('generator_config must be a mapping')
        if self.retriever_config is not None and not isinstance(self.retriever_config, dict):
            raise ValueError('retriever_config must be a mapping or null')
        if not isinstance(self.system_prompt, str):
            raise ValueError('system_prompt must be a string')
        self.retrieval_top_k = _lax_int('retrieval_top_k', self.retrieval_top_k)
        self.retrieval_score_threshold = _lax_float(
            'retrieval_score_threshold', self.retrieval_score_threshold
        )
        if self.transcript_dir is not None:
            if not isinstance(self.transcript_dir, (str, Path)):
                raise ValueError('transcript_dir must be a path or null')
            self.transcript_dir = Path(self.transcript_dir)
        if self.retriever_config is not None:
            raise NotImplementedError(
                'retriever_config: retrieval is not ported to distllm_tpu_torch '
                'yet (ROADMAP A9)'
            )

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> 'ChatAppConfig':
        """From a YAML mapping; an unknown key is refused (the JAX config
        forbids extra fields)."""
        known = {f.name for f in dataclasses.fields(cls)}
        extra = sorted(set(raw) - known)
        if extra:
            raise ValueError(f'unknown chat app keys {extra}; known: {sorted(known)}')
        return cls(**raw)

    def build_generator_config(self):
        """The ``TorchGeneratorConfig`` of ``generator_config``: its
        ``name`` picks the backend (an engine name builds the engine;
        ``fake`` and ``http`` raise, ROADMAP A11), the prefix cache is on
        unless the mapping says otherwise (as in the JAX app: chat prompts
        share their system prompt), and a ``model`` mapping picks its
        config class by its ``name`` (``mistral`` by default; ``gemma2``
        gives a ``GemmaConfig``) through ``models.decoder_family``."""
        from distllm_tpu_torch.generate.generators.torch_backend import (
            TorchGeneratorConfig,
        )
        from distllm_tpu_torch.models import decoder_family

        backend = dict(self.generator_config)
        name = backend.pop('name', 'fake')
        if name in _NOT_PORTED_BACKENDS:
            raise NotImplementedError(
                f'generator backend {name!r} is not ported to distllm_tpu_torch '
                f'yet ({_NOT_PORTED_BACKENDS[name]})'
            )
        if name not in ENGINE_BACKENDS:
            raise ValueError(
                f'unknown generator backend {name!r}; the engine serves '
                f'{ENGINE_BACKENDS}'
            )
        for key in sorted(set(backend) & set(_NOT_PORTED_FIELDS)):
            raise NotImplementedError(
                f'generator_config.{key} is not ported to distllm_tpu_torch yet '
                f'({_NOT_PORTED_FIELDS[key]})'
            )
        # The JAX app also defaults request_deadline_s and
        # max_dispatch_retries on for an engine; they wait on ROADMAP A6.
        backend.setdefault('enable_prefix_cache', True)
        if isinstance(backend.get('model'), dict):
            fields = dict(backend['model'])
            family = fields.pop('name', 'mistral')
            cfg_cls, _ = decoder_family(family)
            if family in cfg_cls.NAMES:
                fields['name'] = family
            backend['model'] = cfg_cls(**fields)
        return TorchGeneratorConfig(**backend)


class ConversationPromptTemplate:
    """Render history into one prompt: the system prompt, every turn as
    ``role: content``, ending with 'assistant:' (the JAX template with no
    retrieved context)."""

    def __init__(self, system_prompt: str = '') -> None:
        self.system_prompt = system_prompt

    def render(self, history: list[dict[str, str]]) -> str:
        parts: list[str] = []
        if self.system_prompt:
            parts.append(self.system_prompt)
        for turn in history:
            parts.append(f'{turn["role"]}: {turn["content"]}')
        parts.append('assistant:')
        return '\n\n'.join(parts)
