"""Models of the port (the decoder families, the BERT encoder), the
tokenizers and checkpoint reading. A decoder family's module carries, as
in JAX, ``init``, ``apply``, ``params_from_hf`` and ``param_specs`` (the
partition specs ``parallel.sharding`` slices each rank's weights by)."""

from __future__ import annotations


def decoder_families() -> dict:
    """``model_type -> (config_cls, module)`` for every decoder family the
    port serves (the JAX table): the serving entry points and the
    ``auto`` encoder dispatch through :func:`decoder_family`."""
    from distllm_tpu_torch.models import gemma, mistral, mixtral

    return {
        'mistral': (mistral.MistralConfig, mistral),
        'llama': (mistral.MistralConfig, mistral),
        'qwen2': (mistral.MistralConfig, mistral),
        'mixtral': (mixtral.MixtralConfig, mixtral),
        'gemma': (gemma.GemmaConfig, gemma),
        'gemma2': (gemma.GemmaConfig, gemma),
    }


def decoder_family(model_type: str):
    """``(config_cls, module)`` for a decoder checkpoint's HF
    ``model_type``; anything else (encoder families included) raises
    ``ValueError``, as in JAX."""
    families = decoder_families()
    if model_type in families:
        return families[model_type]
    raise ValueError(
        f'Unsupported decoder model_type {model_type!r}; '
        f'supported: {sorted(families)}'
    )
