"""Kernels and plain-PyTorch ops of the port (paged attention, encoder
attention, the int8 weight-only matmul and its quantizers, sampling).

CUDA sources live in ``distllm_tpu_torch/csrc/`` and are built at first
use by ``ops._build``; importing a module here builds nothing.
"""
