"""``distllm_tpu_torch`` imports neither ``jax`` nor any module of
``distllm_tpu`` (nor ``pydantic``: its configs are dataclasses; nor
``requests``: its HTTP goes through ``urllib.request``): every
module of the port is imported in a fresh interpreter and ``sys.modules``
is inspected afterwards."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import distllm_tpu_torch
names = ['distllm_tpu_torch'] + [
    m.name for m in pkgutil.walk_packages(
        distllm_tpu_torch.__path__, 'distllm_tpu_torch.'
    )
]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'
    or m == 'distllm_tpu' or m.startswith('distllm_tpu.')
    or m == 'pydantic' or m.startswith('pydantic.')
    or m == 'requests' or m.startswith('requests.')
)
print(json.dumps({'imported': names, 'leaked': leaked}))
"""


def test_port_imports_no_jax_and_nothing_of_distllm_tpu():
    proc = subprocess.run(
        [sys.executable, '-c', _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['leaked'] == []
    expected = {
        'distllm_tpu_torch.chat_server',
        'distllm_tpu_torch.generate.engine.engine',
        'distllm_tpu_torch.generate.engine.decode_graph',
        'distllm_tpu_torch.generate.engine.kv_cache',
        'distllm_tpu_torch.generate.engine.spec',
        'distllm_tpu_torch.generate.engine.scheduler',
        'distllm_tpu_torch.ops.sampling',
        'distllm_tpu_torch.models.mistral',
        'distllm_tpu_torch.generate.generators.torch_backend',
        'distllm_tpu_torch.ops.paged_attention',
        'distllm_tpu_torch.ops._build',
        'distllm_tpu_torch.ops.encoder_attention',
        'distllm_tpu_torch.ops.quantization',
        'distllm_tpu_torch.ops.quantized_matmul',
        'distllm_tpu_torch.models.bert',
        'distllm_tpu_torch.embed.encoders.auto',
        'distllm_tpu_torch.embed.embedders.full_sequence',
        'distllm_tpu_torch.distributed_embedding',
        'distllm_tpu_torch.chat',
        'distllm_tpu_torch.models',
        'distllm_tpu_torch.models.gemma',
        'distllm_tpu_torch.models.mixtral',
        'distllm_tpu_torch.models.common',
        'distllm_tpu_torch.models.esm2',
        'distllm_tpu_torch.models.esmc',
        'distllm_tpu_torch.models.modernbert',
        'distllm_tpu_torch.embed.encoders.esm2',
        'distllm_tpu_torch.embed.encoders.fake',
        'distllm_tpu_torch.embed.datasets.fasta',
        'distllm_tpu_torch.embed.datasets.single_line',
        'distllm_tpu_torch.embed.datasets.jsonl_chunk',
        'distllm_tpu_torch.embed.datasets.huggingface',
        'distllm_tpu_torch.embed.embedders.semantic_chunk',
        'distllm_tpu_torch.embed.writers.huggingface',
        'distllm_tpu_torch.parallel.launcher',
        'distllm_tpu_torch.parallel',
        'distllm_tpu_torch.parallel.mesh',
        'distllm_tpu_torch.parallel.multihost',
        'distllm_tpu_torch.parallel.sharding',
        'distllm_tpu_torch.parallel.comm',
        'distllm_tpu_torch.generate.engine.sharded',
        'distllm_tpu_torch.generate.prompts',
        'distllm_tpu_torch.generate.prompts.amp_question',
        'distllm_tpu_torch.generate.prompts.keyword_selection',
        'distllm_tpu_torch.generate.prompts.question_answer',
        'distllm_tpu_torch.generate.prompts.question_chunk',
        'distllm_tpu_torch.generate.readers',
        'distllm_tpu_torch.generate.readers.amp_json',
        'distllm_tpu_torch.generate.readers.huggingface',
        'distllm_tpu_torch.generate.writers',
        'distllm_tpu_torch.generate.writers.amp_json',
        'distllm_tpu_torch.generate.writers.huggingface',
        'distllm_tpu_torch.generate.generators',
        'distllm_tpu_torch.distributed_generation',
        'distllm_tpu_torch.ops.topk',
        'distllm_tpu_torch.rag.search',
        'distllm_tpu_torch.rag.response_synthesizer',
        'distllm_tpu_torch.rag.evaluate',
        'distllm_tpu_torch.rag.tasks',
        'distllm_tpu_torch.rag.tasks.litqa',
        'distllm_tpu_torch.rag.tasks.protein_qa',
        'distllm_tpu_torch.rag.tasks.pubmedqa',
        'distllm_tpu_torch.rag.tasks.sciq',
        'distllm_tpu_torch.observability',
        'distllm_tpu_torch.observability.metrics',
        'distllm_tpu_torch.observability.instruments',
        'distllm_tpu_torch.observability.tracing',
        'distllm_tpu_torch.observability.flight',
        'distllm_tpu_torch.observability.roofline',
        'distllm_tpu_torch.resilience',
        'distllm_tpu_torch.resilience.admission',
        'distllm_tpu_torch.resilience.faults',
        'distllm_tpu_torch.generate.loadgen',
        'distllm_tpu_torch.observability.history',
        'distllm_tpu_torch.observability.slo',
        'distllm_tpu_torch.observability.baseline',
        'distllm_tpu_torch.observability.sentinel',
        'distllm_tpu_torch.observability.perfetto',
        'distllm_tpu_torch.observability.profiling',
        'distllm_tpu_torch.observability.startup',
        'distllm_tpu_torch.observability.op_cost',
        'distllm_tpu_torch.observability.aggregate',
        'distllm_tpu_torch.timer',
        'distllm_tpu_torch.generate.generators.base',
        'distllm_tpu_torch.generate.generators.http_client',
        'distllm_tpu_torch.generate.generators.api_backend',
        'distllm_tpu_torch.generate.generators.chat_endpoints',
        'distllm_tpu_torch.generate.generators.huggingface_backend',
        'distllm_tpu_torch.embed.writers.base',
        'distllm_tpu_torch.mcqa',
        'distllm_tpu_torch.mcqa.config',
        'distllm_tpu_torch.mcqa.batching',
        'distllm_tpu_torch.mcqa.checkpoint',
        'distllm_tpu_torch.mcqa.grading',
        'distllm_tpu_torch.mcqa.server_boot',
        'distllm_tpu_torch.mcqa.harness',
        'distllm_tpu_torch.distributed_tokenization',
        'distllm_tpu_torch.cli',
        'distllm_tpu_torch.cli_commands',
        'distllm_tpu_torch.protein_search',
        'distllm_tpu_torch.parallel.fabric',
        'distllm_tpu_torch.parallel.worker',
        'distllm_tpu_torch.router',
        'distllm_tpu_torch.router.affinity',
        'distllm_tpu_torch.router.app',
        'distllm_tpu_torch.router.__main__',
    }
    assert expected <= set(result['imported'])


_RANK_PROBE = r"""
import json, sys
sys.path.insert(0, 'tests')
import test_torch_fabric_tasks, test_torch_rank_tasks
test_torch_rank_tasks.sharded_encoder_forward.__code__  # the rank's work is importable
leaked = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')
                or m == 'distllm_tpu' or m.startswith('distllm_tpu.'))
print(json.dumps(leaked))
"""


def test_the_spawned_ranks_task_modules_import_no_jax():
    """A spawned rank or pod worker imports its task's module by path:
    those modules (``test_torch_rank_tasks``: the encoder mesh's ranks;
    ``test_torch_fabric_tasks``: the fabric's workers) stay free of JAX,
    which would cost each process seconds and hold the oracle's devices."""
    proc = subprocess.run(
        [sys.executable, '-c', _RANK_PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
