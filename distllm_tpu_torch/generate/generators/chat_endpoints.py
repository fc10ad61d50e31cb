"""Dedicated Argo-proxy and direct-OpenAI chat generators (counterpart of
``distllm_tpu.generate.generators.chat_endpoints``), each with its own
conventions:

- :class:`ArgoGenerator` — Argonne's Argo proxy: ``argo:`` model names, an
  api key that can be any string, ``MODEL`` / ``BASE_URL`` / ``USER`` from
  the environment by default, ``/v1`` appended to the base URL, a ``user``
  field in each request (the proxy's attribution), and errors returned as
  ``"Error: ..."`` strings rather than raised.
- :class:`OpenAIAPIGenerator` — the public OpenAI API: the key is required
  at construction, ``max_completion_tokens`` replaces the legacy
  ``max_tokens``, and a None content answers with its finish reason.

Both take per-call ``temperature`` / ``max_tokens`` overrides. HTTP goes
through ``urllib.request``.
"""

from __future__ import annotations

import dataclasses
import os

from distllm_tpu_torch.generate.generators.http_client import ApiAuthError, post_json
from distllm_tpu_torch.observability.instruments import log_event
from distllm_tpu_torch.utils import BaseConfig, expo_backoff_retry, lax_float, lax_int, lax_str

_SYSTEM = 'You are a helpful assistant.'


class _ChatEndpointBase:
    """The POST with retries shared by the two endpoint flavours."""

    def _post(self, url: str, headers: dict, body: dict) -> dict:
        def call() -> dict:
            # A 401/403 raises ApiAuthError: bad credentials fail fast.
            return post_json(url, body, headers, self.config.timeout)

        return expo_backoff_retry(
            call, max_tries=self.config.max_tries, give_up_on=(ApiAuthError,)
        )

    def _generate_many(self, prompts, temperature, max_tokens) -> list[str]:
        if isinstance(prompts, str):
            prompts = [prompts]
        return [self._one(p, temperature, max_tokens) for p in prompts]


def _check_common(config) -> None:
    config.temperature = lax_float('temperature', config.temperature)
    config.timeout = lax_float('timeout', config.timeout)
    config.max_tokens = lax_int('max_tokens', config.max_tokens)
    config.max_tries = lax_int('max_tries', config.max_tries)


@dataclasses.dataclass
class ArgoGeneratorConfig(BaseConfig):
    name: str = 'argo'
    # Argo-proxy model name.
    model: str = dataclasses.field(default_factory=lambda: os.getenv('MODEL', 'argo:gpt-4o'))
    # The proxy's base URL ('/v1' is appended).
    base_url: str = dataclasses.field(
        default_factory=lambda: os.getenv('BASE_URL', 'http://localhost:56267')
    )
    # Argo accepts any string as the key.
    api_key: str = 'whatever+random'
    # Sent in each request body: the proxy attributes usage per user.
    user: str = dataclasses.field(default_factory=lambda: os.getenv('USER', 'distllm'))
    temperature: float = 0.0
    max_tokens: int = 16384
    timeout: float = 300.0
    max_tries: int = 3

    def validate(self) -> None:
        lax_str('name', self.name, ('argo',))
        for key in ('model', 'base_url', 'api_key', 'user'):
            lax_str(key, getattr(self, key))
        _check_common(self)


class ArgoGenerator(_ChatEndpointBase):
    """Chat generator against an Argo proxy."""

    def __init__(self, config: ArgoGeneratorConfig) -> None:
        self.config = config

    def _one(self, prompt, temperature=None, max_tokens=None) -> str:
        cfg = self.config
        body = {
            'model': cfg.model,
            'messages': [
                {'role': 'system', 'content': _SYSTEM},
                {'role': 'user', 'content': prompt},
            ],
            'temperature': cfg.temperature if temperature is None else temperature,
            'max_tokens': cfg.max_tokens if max_tokens is None else max_tokens,
            'user': cfg.user,
        }
        headers = {
            'Content-Type': 'application/json',
            'Authorization': f'Bearer {cfg.api_key}',
        }
        url = f'{cfg.base_url.rstrip("/")}/v1/chat/completions'
        try:
            payload = self._post(url, headers, body)
            return payload['choices'][0]['message']['content']
        except Exception as exc:  # returned, not raised (the Argo convention)
            log_event(f'Error calling Argo proxy: {exc}', component='generate')
            return f'Error: {exc!s}'

    def generate(self, prompts, temperature=None, max_tokens=None) -> list[str]:
        return self._generate_many(prompts, temperature, max_tokens)


@dataclasses.dataclass
class OpenAIAPIGeneratorConfig(BaseConfig):
    name: str = 'openai'
    model: str = dataclasses.field(default_factory=lambda: os.getenv('OPENAI_MODEL', 'gpt-4.1'))
    api_key: str = dataclasses.field(default_factory=lambda: os.getenv('OPENAI_API_KEY', ''))
    # Optional override (e.g. Azure).
    base_url: str | None = dataclasses.field(
        default_factory=lambda: os.getenv('OPENAI_BASE_URL', None)
    )
    temperature: float = 0.0
    max_tokens: int = 16384
    timeout: float = 300.0
    max_tries: int = 3

    def validate(self) -> None:
        lax_str('name', self.name, ('openai',))
        lax_str('model', self.model)
        lax_str('api_key', self.api_key)
        if self.base_url is not None:
            lax_str('base_url', self.base_url)
        _check_common(self)


class OpenAIAPIGenerator(_ChatEndpointBase):
    """Direct OpenAI API client."""

    def __init__(self, config: OpenAIAPIGeneratorConfig) -> None:
        if not config.api_key:
            raise ValueError(
                'OpenAI API key is required. Set OPENAI_API_KEY environment '
                'variable or provide it in the config file.'
            )
        self.config = config

    def _one(self, prompt, temperature=None, max_tokens=None) -> str:
        cfg = self.config
        body = {
            'model': cfg.model,
            'messages': [
                {'role': 'system', 'content': _SYSTEM},
                {'role': 'user', 'content': prompt},
            ],
            'temperature': cfg.temperature if temperature is None else temperature,
            # Current-generation models reject the legacy max_tokens field.
            'max_completion_tokens': cfg.max_tokens if max_tokens is None else max_tokens,
        }
        headers = {
            'Content-Type': 'application/json',
            'Authorization': f'Bearer {cfg.api_key}',
        }
        base = (cfg.base_url or 'https://api.openai.com/v1').rstrip('/')
        try:
            payload = self._post(f'{base}/chat/completions', headers, body)
            choice = payload['choices'][0]
            content = choice['message'].get('content')
            if content is None:
                reason = choice.get('finish_reason')
                return f'[No content returned. Finish reason: {reason}]'
            return content
        except Exception as exc:
            log_event(f'Error calling OpenAI API: {exc}', component='generate')
            return f'Error: {exc}'

    def generate(self, prompts, temperature=None, max_tokens=None) -> list[str]:
        return self._generate_many(prompts, temperature, max_tokens)
