"""The chat app: its YAML config, prompt rendering, one conversation and
the REPL (counterparts of ``distllm_tpu.chat``'s ``ChatAppConfig``,
``ConversationPromptTemplate``, ``ChatSession`` and ``chat_with_model``).

Retrieval runs on the latest user message only; the whole history still
goes into the prompt, under the retrieved contexts.

    python -m distllm_tpu_torch.chat --config examples/chat/chat.fake.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any

from distllm_tpu_torch.utils import BaseConfig, lax_float, lax_int


def http_generator_config(
    base_url: str,
    model: str = 'default',
    api_key: str = '',
    temperature: float = 0.2,
    max_tokens: int = 1024,
    extra_body: dict[str, Any] | None = None,
    timeout: float = 300.0,
):
    """The ``ApiGeneratorConfig`` of the ``http`` backend's keys: the
    ``openai`` wire whatever the served model is named (a proxy may host
    ``claude-*``)."""
    from distllm_tpu_torch.generate.generators.api_backend import ApiGeneratorConfig

    return ApiGeneratorConfig(
        provider='openai',
        openai_api_base=base_url,
        model=model,
        api_key=api_key,
        temperature=temperature,
        max_tokens=max_tokens,
        extra_body=extra_body or {},
        timeout=timeout,
    )


def make_http_generator(**kwargs):
    """OpenAI-compatible HTTP backend (the JAX ``make_http_generator``):
    an :class:`ApiGenerator`, with its exponential backoff, over
    :func:`http_generator_config`'s config."""
    from distllm_tpu_torch.generate.generators.api_backend import ApiGenerator

    return ApiGenerator(http_generator_config(**kwargs))


@dataclasses.dataclass
class ChatAppConfig(BaseConfig):
    """YAML config of the chat apps: the JAX ``ChatAppConfig``'s keys,
    defaults and checks. A ``retriever_config`` is checked here as the JAX
    ``RetrieverConfig`` checks it when the JAX app builds its retriever."""

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
        self.retrieval_top_k = lax_int('retrieval_top_k', self.retrieval_top_k)
        self.retrieval_score_threshold = lax_float(
            'retrieval_score_threshold', self.retrieval_score_threshold
        )
        if self.transcript_dir is not None:
            if not isinstance(self.transcript_dir, (str, Path)):
                raise ValueError('transcript_dir must be a path or null')
            self.transcript_dir = Path(self.transcript_dir)
        if self.retriever_config is not None:
            from distllm_tpu_torch.rag.search import RetrieverConfig

            RetrieverConfig.from_dict(self.retriever_config)


    def _backend(self) -> dict:
        """``generator_config`` with its name (``fake`` when missing, the
        JAX default); an engine backend serves with the prefix cache on
        (chat prompts share their system prompt and contexts), a 120 s
        request deadline and 2 dispatch retries unless the mapping says
        otherwise."""
        from distllm_tpu_torch.generate.generators import ENGINE_BACKENDS

        backend = dict(self.generator_config)
        backend.setdefault('name', 'fake')
        if backend['name'] in ENGINE_BACKENDS:
            backend.setdefault('enable_prefix_cache', True)
            # The serving defaults of the JAX app: a stuck request times
            # out and frees its KV, and a failed window retries with a
            # bounded backoff before quarantining only the requests it
            # involved. Callers that build an engine directly keep the
            # propagate-the-first-exception contract.
            backend.setdefault('request_deadline_s', 120.0)
            backend.setdefault('max_dispatch_retries', 2)
        return backend

    def build_generator_config(self):
        """The config of ``generator_config``'s backend: a
        ``TorchGeneratorConfig`` for an engine name (a ``model`` mapping
        picks its config class by its ``name``), the ``ApiGeneratorConfig``
        of :func:`make_http_generator` for ``http``, and the factory's
        config class for any other name."""
        from distllm_tpu_torch.generate.generators import generator_config

        backend = self._backend()
        if backend['name'] == 'http':
            backend.pop('name')
            return http_generator_config(**backend)
        return generator_config(backend)

    def build_generator(self, device: 'str | None' = None):
        """The generator: ``http`` builds a new OpenAI-compatible client
        (:func:`make_http_generator`), any other backend is warm-started
        through the registry; ``device`` overrides an engine backend's
        ``device`` field."""
        from distllm_tpu_torch.generate.generators import get_generator

        backend = self._backend()
        if backend['name'] == 'http':
            backend.pop('name')
            return make_http_generator(**backend)
        return get_generator(backend, register=True, device=device)

    def build_retriever(self, device: 'str | None' = None):
        if self.retriever_config is None:
            return None
        from distllm_tpu_torch.rag.search import RetrieverConfig

        return RetrieverConfig.from_dict(self.retriever_config).get_retriever(
            register=True, device=device
        )


class ConversationPromptTemplate:
    """Render history and retrieved context into one prompt: the system
    prompt, the contexts under a '[Context from retrieval]' header, every
    turn as ``role: content``, ending with 'assistant:' (the JAX
    template)."""

    def __init__(self, system_prompt: str = '') -> None:
        self.system_prompt = system_prompt

    def render(
        self,
        history: list[dict[str, str]],
        contexts: list[str] | None = None,
        scores: list[float] | None = None,
    ) -> str:
        parts: list[str] = []
        if self.system_prompt:
            parts.append(self.system_prompt)
        if contexts:
            lines = [
                f'- (score {score:.3f}) {ctx}'
                for ctx, score in zip(contexts, scores or [0.0] * len(contexts))
            ]
            parts.append('[Context from retrieval]\n' + '\n'.join(lines))
        for turn in history:
            parts.append(f'{turn["role"]}: {turn["content"]}')
        parts.append('assistant:')
        return '\n\n'.join(parts)


def retrieve(retriever, query: str, top_k: int, score_threshold: float):
    """``(contexts, scores)`` of one query (empty without a retriever)."""
    if retriever is None:
        return [], []
    results, _ = retriever.search(query, top_k=top_k, score_threshold=score_threshold)
    indices = results.total_indices[0]
    contexts = retriever.get_texts(indices) if indices else []
    return contexts, results.total_scores[0]


class ChatSession:
    """Drives one conversation (the JAX ``ChatSession``)."""

    def __init__(self, config: ChatAppConfig, device: 'str | None' = None) -> None:
        self.config = config
        self.generator = config.build_generator(device)
        self.retriever = config.build_retriever(device)
        self.template = ConversationPromptTemplate(config.system_prompt)
        self.history: list[dict[str, str]] = []

    def ask(self, user_message: str) -> str:
        """One turn: retrieval on the latest message, history in the prompt."""
        self.history.append({'role': 'user', 'content': user_message})
        contexts, scores = retrieve(
            self.retriever, user_message, self.config.retrieval_top_k,
            self.config.retrieval_score_threshold,
        )
        prompt = self.template.render(self.history, contexts, scores)
        response = self.generator.generate([prompt])[0]
        self.history.append({'role': 'assistant', 'content': response})
        return response

    def inspect(self, query: str) -> list[dict[str, Any]]:
        """Retrieval only, every score kept (``/inspect``)."""
        if self.retriever is None:
            return []
        results, _ = self.retriever.search(
            query, top_k=self.config.retrieval_top_k, score_threshold=-1e9
        )
        indices = results.total_indices[0]
        texts = self.retriever.get_texts(indices) if indices else []
        return [
            {'index': idx, 'score': score, 'text': text}
            for idx, score, text in zip(indices, results.total_scores[0], texts)
        ]

    def save_transcript(self) -> Path | None:
        if self.config.transcript_dir is None or not self.history:
            return None
        self.config.transcript_dir.mkdir(parents=True, exist_ok=True)
        path = self.config.transcript_dir / f'chat_{time.strftime("%Y%m%d_%H%M%S")}.json'
        path.write_text(json.dumps(self.history, indent=2))
        return path


def chat_with_model(
    config: ChatAppConfig, input_fn=input, echo=print, device: 'str | None' = None
) -> None:
    """The REPL: ``quit`` saves the transcript, ``/inspect <query>`` prints
    the retrieval."""
    session = ChatSession(config, device)
    echo('Chat ready. Commands: quit | /inspect <query>')
    while True:
        try:
            user_message = input_fn('you> ').strip()
        except (EOFError, KeyboardInterrupt):
            user_message = 'quit'
        if not user_message:
            continue
        if user_message.lower() in ('quit', 'exit'):
            path = session.save_transcript()
            if path:
                echo(f'Transcript saved to {path}')
            echo('bye')
            return
        if user_message.startswith('/inspect '):
            for hit in session.inspect(user_message[len('/inspect '):]):
                echo(f'[{hit["index"]}] score={hit["score"]:.4f} {hit["text"][:120]}')
            continue
        echo(f'assistant> {session.ask(user_message)}')


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config', required=True, type=Path)
    parser.add_argument(
        '--device', default=None,
        help="device of the engine and the retriever (default: cuda; 'cpu' only when asked)",
    )
    args = parser.parse_args(argv)
    chat_with_model(ChatAppConfig.from_yaml(args.config), device=args.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
