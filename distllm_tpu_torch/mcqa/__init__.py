"""MCQA evaluation harness (counterpart of ``distllm_tpu.mcqa``): a model
answers multiple-choice questions, directly or with retrieved context, and
a second LLM grades the answers. The parts:

- a local boot of the port's chat server (``python -m
  distllm_tpu_torch.chat_server``) with a free port, monitor threads and a
  readiness poll (:mod:`.server_boot`);
- client-side request batching (a queue and a batch thread, :mod:`.batching`);
- a thread pool over the questions, checkpoints and resume
  (:mod:`.checkpoint`), files interchangeable with the JAX harness's;
- the grader's JSON retry ladder of three prompts (:mod:`.grading`);
- chunk ids, retrieval metrics, accuracy and the incorrect-answer export
  (:mod:`.harness`).
"""

from distllm_tpu_torch.mcqa.config import MCQAConfig, ModelServerEntry
from distllm_tpu_torch.mcqa.harness import main, run_mcqa

__all__ = ['MCQAConfig', 'ModelServerEntry', 'main', 'run_mcqa']
