"""distllm-tpu-torch: the PyTorch/CUDA port of ``distllm_tpu`` for NVIDIA Hopper.

The package mirrors ``distllm_tpu``'s module paths so each module's
counterpart is found by name; inside, it is PyTorch idiom: plain functions
on tensors, dataclass configs, an explicit ``device`` argument and explicit
``torch.Generator`` objects. It never imports ``jax`` or anything of
``distllm_tpu``: what it needs from there is copied.

Every entry point runs on ``cuda`` unless the caller passes
``device='cpu'``; with no GPU and no explicit ``device='cpu'`` it raises
(:func:`distllm_tpu_torch.utils.resolve_device`).

Layer map of the ported slices (paged-KV serving of the Mistral, Llama,
Qwen2 and Gemma families; the embedding pipeline over BERT, ESM-2, ESM-C,
ModernBERT and the decoders; int8 / nf4 weight-only quantization on
both):

- ``utils``                 — dataclass config base, dtypes, device resolution
- ``ops.paged_attention``   — ragged paged attention: plain PyTorch op plus
  the hand-written CUDA kernel (``csrc/ragged_paged_attention.cu``)
- ``ops.encoder_attention`` — encoder attention: plain PyTorch version plus
  the hand-written CUDA kernel (``csrc/encoder_attention.cu``)
- ``ops.quantization``      — ``QTensor``, int8 / nf4 quantizers on the device
- ``ops.quantized_matmul``  — int8 weight-only matmul: plain PyTorch version
  plus the hand-written CUDA kernel (``csrc/int8_matmul.cu``)
- ``ops.sampling``          — logit filtering and counter-based sampling
- ``models``                — the decoder families (``decoder_family``: one
  Mistral forward, Gemma as its config knobs) over the paged KV cache and
  as a dense forward, the BERT, ESM-2, ESM-C and ModernBERT encoders,
  tokenizers, checkpoint reading
- ``generate.engine``       — block allocator, scheduler, serving engine
- ``generate.generators``   — ``TorchGenerator`` and the ``huggingface``,
  ``api`` / ``langchain``, ``argo`` and ``openai`` backends (HTTP through
  ``urllib.request``)
- ``chat`` / ``chat_server`` — the chat app config, prompt template and
  the HTTP server
- ``embed``                 — datasets, encoders, poolers, embedders, writers
- ``distributed_embedding`` / ``distributed_generation`` /
  ``distributed_tokenization`` — the jobs' entry points (``registry``,
  ``timer``)
- ``mcqa``                  — the MCQA harness over the chat server
- ``cli``                   — the ``distllm`` subcommands
- ``parallel.launcher``     — the ``local``, ``workstation``, ``pod``,
  ``pbspro`` and ``slurm`` executors; ``parallel.fabric`` /
  ``parallel.worker`` — the ZMQ task fabric and its per-host worker
- ``router``                — the prefix-affinity router over chat-server
  replicas
"""

from __future__ import annotations

__version__ = '0.1.0'
