"""MCQA harness configuration (counterpart of ``distllm_tpu.mcqa.config``):
``MCQAConfig`` and the ``model_servers.yaml`` shortname registry, read
with the JAX configs' fields, defaults and refusals."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

from distllm_tpu_torch.utils import BaseConfig, lax_bool, lax_float, lax_int, lax_str


def _check(config, ints=(), floats=(), bools=(), strs=()) -> None:
    for key in ints:
        setattr(config, key, lax_int(key, getattr(config, key)))
    for key in floats:
        setattr(config, key, lax_float(key, getattr(config, key)))
    for key in bools:
        setattr(config, key, lax_bool(key, getattr(config, key)))
    for key in strs:
        lax_str(key, getattr(config, key))


def _path(name: str, value) -> Path:
    if not isinstance(value, (str, Path)):
        raise ValueError(f'{name} must be a path, got {value!r}')
    return Path(value)


@dataclasses.dataclass(kw_only=True)
class ModelServerEntry(BaseConfig):
    """One row of the model-servers registry."""

    server: str = ''
    shortname: str
    openai_api_key: str = ''
    openai_api_base: str = ''
    openai_model: str = ''

    def validate(self) -> None:
        _check(self, strs=('server', 'shortname', 'openai_api_key', 'openai_api_base',
                           'openai_model'))


def load_model_servers(path: 'str | Path') -> dict[str, ModelServerEntry]:
    """A ``model_servers.yaml`` as a shortname-keyed registry (``servers:``
    a list or a mapping, or the list itself). The file is read as it is:
    ``${env:VAR}`` markers stay, as in the JAX package."""
    import yaml

    with open(path) as fh:
        raw = yaml.safe_load(fh) or {}
    entries = raw.get('servers', raw) if isinstance(raw, dict) else raw
    if isinstance(entries, dict):
        entries = list(entries.values())
    registry = {}
    for item in entries:
        entry = ModelServerEntry.from_dict(item)
        registry[entry.shortname] = entry
    return registry


@dataclasses.dataclass
class VllmArgs(BaseConfig):
    """Engine knobs of the locally booted server (vLLM's argument names)."""

    tensor_parallel_size: int = 1
    max_model_len: int = 4096
    max_num_seqs: int = 16
    block_size: int = 16
    num_blocks: int = 2048

    def validate(self) -> None:
        _check(self, ints=[f.name for f in dataclasses.fields(self)])


@dataclasses.dataclass(kw_only=True)
class MCQAConfig(BaseConfig):
    questions_file: Path
    output_dir: Path = Path('mcqa_results')

    # The model under test: a registry shortname, an explicit endpoint, or
    # a local checkpoint to boot a server for.
    model_servers_file: Path | None = None
    model_shortname: str = ''
    model_api_base: str = ''
    model_api_key: str = ''
    model_name: str = 'distllm-tpu'
    local_model_path: str = ''  # non-empty => boot a local engine server
    vllm_args: VllmArgs = dataclasses.field(default_factory=VllmArgs)

    # The grader LLM.
    grader_shortname: str = ''
    grader_api_base: str = ''
    grader_api_key: str = ''
    grader_model: str = ''
    grader_max_new_tokens: int = 64
    grader_temperature: float = 0.0

    # RAG (optional).
    retriever_config: dict[str, Any] | None = None
    retrieval_top_k: int = 5
    retrieval_score_threshold: float = 0.0

    # Parallelism and client batching.
    parallel_workers: int = 8
    batch_size: int = 16
    batch_timeout: float = 0.5
    request_temperature: float = 0.0
    request_max_tokens: int = 256

    # Checkpointing: a checkpoint every ``checkpoint_every`` questions, or
    # after every question with ``save_incremental``.
    checkpoint_every: int = 10
    save_incremental: bool = False
    resume: bool = True

    def validate(self) -> None:
        self.questions_file = _path('questions_file', self.questions_file)
        self.output_dir = _path('output_dir', self.output_dir)
        if self.model_servers_file is not None:
            self.model_servers_file = _path('model_servers_file', self.model_servers_file)
        if isinstance(self.vllm_args, dict):
            self.vllm_args = VllmArgs.from_dict(self.vllm_args)
        if not isinstance(self.vllm_args, VllmArgs):
            raise ValueError('vllm_args must be a mapping')
        if self.retriever_config is not None and not isinstance(self.retriever_config, dict):
            raise ValueError('retriever_config must be a mapping or null')
        _check(
            self,
            ints=('grader_max_new_tokens', 'retrieval_top_k', 'parallel_workers', 'batch_size',
                  'request_max_tokens', 'checkpoint_every'),
            floats=('grader_temperature', 'retrieval_score_threshold', 'batch_timeout',
                    'request_temperature'),
            bools=('save_incremental', 'resume'),
            strs=('model_shortname', 'model_api_base', 'model_api_key', 'model_name',
                  'local_model_path', 'grader_shortname', 'grader_api_base',
                  'grader_api_key', 'grader_model'),
        )

    def resolve_model_endpoint(self) -> tuple[str, str, str]:
        """(api_base, api_key, model) of the model under test."""
        if self.model_shortname and self.model_servers_file:
            entry = load_model_servers(self.model_servers_file)[self.model_shortname]
            return entry.openai_api_base, entry.openai_api_key, entry.openai_model
        return self.model_api_base, self.model_api_key, self.model_name

    def resolve_grader_endpoint(self) -> tuple[str, str, str]:
        """(api_base, api_key, model) of the grader."""
        if self.grader_shortname and self.model_servers_file:
            entry = load_model_servers(self.model_servers_file)[self.grader_shortname]
            return entry.openai_api_base, entry.openai_api_key, entry.openai_model
        return self.grader_api_base, self.grader_api_key, self.grader_model
