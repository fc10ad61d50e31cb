"""API generator: hosted-LLM chat over HTTP (counterpart of
``distllm_tpu.generate.generators.api_backend``).

Each provider's wire protocol is spoken natively, with the JAX module's
request bodies, headers, parse rules, retries and auth behaviour:

- ``openai``    — ``POST {base}/chat/completions`` (also the port's own
  chat server and any vLLM-style endpoint);
- ``anthropic`` — ``POST {base}/v1/messages`` (Messages API);
- ``google``    — ``POST {base}/v1beta/models/{model}:generateContent``.

``provider='auto'`` infers from the model name (``claude*`` → anthropic,
``gemini*`` → google, anything else → openai) unless ``openai_api_base``
is not the default, which means an OpenAI-compatible proxy. Registered
under ``api`` and ``langchain``. API keys come from the config or the
environment. HTTP goes through ``urllib.request``
(:mod:`~distllm_tpu_torch.generate.generators.http_client`).
"""

from __future__ import annotations

import dataclasses
import os

from distllm_tpu_torch.generate.generators.http_client import ApiAuthError, post_json
from distllm_tpu_torch.utils import BaseConfig, expo_backoff_retry, lax_float, lax_int, lax_str

_KEY_ENVS = {
    'openai': 'OPENAI_API_KEY',
    'anthropic': 'ANTHROPIC_API_KEY',
    'google': 'GOOGLE_API_KEY',
}
PROVIDERS = ('auto', 'openai', 'anthropic', 'google')
_DEFAULT_OPENAI_BASE = 'https://api.openai.com/v1'


class ApiResponseError(Exception):
    """A 200 response whose body carries no generatable text (e.g. a
    Gemini safety block) — deterministic, so retrying cannot help."""


@dataclasses.dataclass
class ApiGeneratorConfig(BaseConfig):
    name: str = 'api'
    # Wire protocol; 'auto' infers it from the model name.
    provider: str = 'auto'
    openai_api_base: str = _DEFAULT_OPENAI_BASE
    anthropic_api_base: str = 'https://api.anthropic.com'
    anthropic_version: str = '2023-06-01'
    google_api_base: str = 'https://generativelanguage.googleapis.com'
    model: str = 'gpt-3.5-turbo'
    # Inline API key (takes precedence over api_key_env).
    api_key: str = ''
    # Env var holding the key; defaults per provider (_KEY_ENVS).
    api_key_env: str = ''
    temperature: float = 0.0
    max_tokens: int = 512
    timeout: float = 120.0
    max_tries: int = 5
    # Parallel HTTP requests per generate() batch, so an OpenAI-compatible
    # server's continuous batching sees the whole batch at once.
    concurrency: int = 8
    # Extra JSON merged into each request (e.g. Argo-proxy 'user' fields).
    extra_body: dict = dataclasses.field(default_factory=dict)

    def validate(self) -> None:
        lax_str('name', self.name, ('api', 'langchain'))
        lax_str('provider', self.provider, PROVIDERS)
        for key in ('openai_api_base', 'anthropic_api_base', 'anthropic_version',
                    'google_api_base', 'model', 'api_key', 'api_key_env'):
            lax_str(key, getattr(self, key))
        self.temperature = lax_float('temperature', self.temperature)
        self.timeout = lax_float('timeout', self.timeout)
        for key in ('max_tokens', 'max_tries', 'concurrency'):
            setattr(self, key, lax_int(key, getattr(self, key)))
        if not isinstance(self.extra_body, dict):
            raise ValueError('extra_body must be a mapping')

    def resolved_provider(self) -> str:
        if self.provider != 'auto':
            return self.provider
        # A base other than the default is an OpenAI-compatible proxy:
        # honour it rather than reroute a claude*/gemini* name to a vendor.
        if self.openai_api_base.rstrip('/') != _DEFAULT_OPENAI_BASE.rstrip('/'):
            return 'openai'
        model = self.model.lower()
        if model.startswith('claude'):
            return 'anthropic'
        if model.startswith('gemini'):
            return 'google'
        return 'openai'


class ApiGenerator:
    def __init__(self, config: ApiGeneratorConfig) -> None:
        self.config = config
        self.provider = config.resolved_provider()

    def _api_key(self) -> str:
        if self.config.api_key:
            return self.config.api_key
        env = self.config.api_key_env or _KEY_ENVS[self.provider]
        return os.environ.get(env, '')

    def _request(self, prompt: str) -> tuple[str, dict, dict]:
        """(url, headers, body) for one prompt on the resolved provider."""
        cfg = self.config
        key = self._api_key()
        if self.provider == 'anthropic':
            headers = {'Content-Type': 'application/json',
                       'anthropic-version': cfg.anthropic_version}
            if key:
                headers['x-api-key'] = key
            return (
                f'{cfg.anthropic_api_base.rstrip("/")}/v1/messages',
                headers,
                {
                    'model': cfg.model,
                    'max_tokens': cfg.max_tokens,
                    'temperature': cfg.temperature,
                    'messages': [{'role': 'user', 'content': prompt}],
                    **cfg.extra_body,
                },
            )
        if self.provider == 'google':
            url = (
                f'{cfg.google_api_base.rstrip("/")}/v1beta/models/'
                f'{cfg.model}:generateContent'
            )
            # The key goes in a header, never the URL (messages print URLs).
            headers = {'Content-Type': 'application/json'}
            if key:
                headers['x-goog-api-key'] = key
            gen_config = {'temperature': cfg.temperature, 'maxOutputTokens': cfg.max_tokens}
            extra = dict(cfg.extra_body)
            # Sampling knobs nest under generationConfig: merge, not clobber.
            gen_config.update(extra.pop('generationConfig', {}))
            return (
                url,
                headers,
                {
                    'contents': [{'parts': [{'text': prompt}]}],
                    'generationConfig': gen_config,
                    **extra,
                },
            )
        headers = {'Content-Type': 'application/json'}
        if key:
            headers['Authorization'] = f'Bearer {key}'
        return (
            f'{cfg.openai_api_base.rstrip("/")}/chat/completions',
            headers,
            {
                'model': cfg.model,
                'messages': [{'role': 'user', 'content': prompt}],
                'temperature': cfg.temperature,
                'max_tokens': cfg.max_tokens,
                **cfg.extra_body,
            },
        )

    def _parse(self, payload: dict) -> str:
        # A 200 without the provider's fields (e.g. a proxy's error JSON)
        # is deterministic: ApiResponseError, which is not retried.
        try:
            return self._parse_payload(payload)
        except (KeyError, IndexError, TypeError, AttributeError) as e:
            shape = sorted(payload)[:8] if isinstance(payload, dict) else type(payload).__name__
            raise ApiResponseError(
                f'malformed {self.provider} payload ({shape!r}): {e!r}'
            ) from e

    def _parse_payload(self, payload: dict) -> str:
        if self.provider == 'anthropic':
            return ''.join(
                block.get('text', '')
                for block in payload['content']
                if block.get('type', 'text') == 'text'
            )
        if self.provider == 'google':
            candidates = payload.get('candidates') or []
            if not candidates or 'content' not in candidates[0]:
                # Safety-blocked / empty answers: surface the reason.
                reason = (
                    candidates[0].get('finishReason')
                    if candidates
                    else payload.get('promptFeedback')
                )
                raise ApiResponseError(f'no generatable content (reason: {reason!r})')
            parts = candidates[0]['content'].get('parts', [])
            return ''.join(p.get('text', '') for p in parts)
        return payload['choices'][0]['message']['content']

    def _chat(self, prompt: str) -> str:
        url, headers, body = self._request(prompt)

        def call() -> str:
            return self._parse(post_json(url, body, headers, self.config.timeout))

        return expo_backoff_retry(
            call,
            max_tries=self.config.max_tries,
            give_up_on=(ApiAuthError, ApiResponseError),
        )

    def generate(self, prompts: str | list[str]) -> list[str]:
        if isinstance(prompts, str):
            prompts = [prompts]
        if len(prompts) == 1 or self.config.concurrency <= 1:
            return [self._chat(p) for p in prompts]
        # Concurrent requests: a continuous-batching server schedules them
        # together.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(self.config.concurrency, len(prompts))
        ) as pool:
            return list(pool.map(self._chat, prompts))


__all__ = ['ApiAuthError', 'ApiGenerator', 'ApiGeneratorConfig', 'ApiResponseError']
