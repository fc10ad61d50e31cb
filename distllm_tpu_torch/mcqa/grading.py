"""Answer grading by a second LLM with a JSON retry ladder (counterpart of
``distllm_tpu.mcqa.grading``, its three prompts character for character):
the grader is asked for a strict JSON verdict; when none parses, the
prompt escalates through three stricter phrasings, each attempt wrapped in
exponential backoff. An auth error gives up at once.
"""

from __future__ import annotations

import json
from typing import Callable

from distllm_tpu_torch.utils import expo_backoff_retry


class GraderAuthError(Exception):
    """Authentication failure — never retried."""


_PROMPT_LADDER = [
    (
        'You are grading a multiple-choice answer.\n'
        'Question:\n{question}\n\nReference answer: {reference}\n'
        'Model answer: {answer}\n\n'
        'Reply with JSON: {{"correct": true|false, "reason": "..."}}'
    ),
    (
        'Grade the answer. Respond with ONLY a JSON object, no prose.\n'
        'Question:\n{question}\nReference answer: {reference}\n'
        'Model answer: {answer}\n'
        'JSON schema: {{"correct": boolean, "reason": string}}'
    ),
    (
        'Output exactly one line of minified JSON and nothing else: '
        '{{"correct":true}} or {{"correct":false}}.\n'
        'Question: {question}\nReference: {reference}\nAnswer: {answer}'
    ),
]

def parse_grader_json(response: str) -> dict | None:
    """Extract the first JSON object with a boolean 'correct' field.

    Decodes at each '{' with ``raw_decode`` so a valid verdict followed by
    stray braces (grader prose) still parses.
    """
    decoder = json.JSONDecoder()
    pos = response.find('{')
    while pos != -1:
        try:
            payload, _ = decoder.raw_decode(response, pos)
        except json.JSONDecodeError:
            pos = response.find('{', pos + 1)
            continue
        if isinstance(payload, dict) and isinstance(
            payload.get('correct'), bool
        ):
            return payload
        pos = response.find('{', pos + 1)
    return None


def grade_answer(
    call_grader: Callable[[str], str],
    question: str,
    reference: str,
    answer: str,
    max_tries_per_level: int = 3,
) -> dict:
    """Run the retry ladder; returns {'correct': bool, 'reason': str, ...}.

    Raises RuntimeError when every ladder level fails to produce valid JSON.
    """
    last_response = ''
    for level, template in enumerate(_PROMPT_LADDER):
        prompt = template.format(
            question=question, reference=reference, answer=answer
        )

        def attempt() -> str:
            from distllm_tpu_torch.generate.generators.api_backend import ApiAuthError

            try:
                return call_grader(prompt)
            except ApiAuthError as exc:
                raise GraderAuthError(str(exc)) from exc

        try:
            response = expo_backoff_retry(
                attempt,
                max_tries=max_tries_per_level,
                give_up_on=(GraderAuthError,),
                base_delay=0.5,
            )
        except GraderAuthError:
            raise
        except Exception as exc:  # noqa: BLE001 - try the next ladder level
            last_response = f'<error: {exc}>'
            continue
        last_response = response
        payload = parse_grader_json(response)
        if payload is not None:
            payload.setdefault('reason', '')
            payload['ladder_level'] = level
            return payload
    raise RuntimeError(
        f'grader produced no parseable JSON verdict; last response: '
        f'{last_response[:200]}'
    )
