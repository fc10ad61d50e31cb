"""Work for the spawned ranks of the port's mesh tests (no tests here).

A spawned rank imports its target by module path, so the targets live in
a module with light imports (torch, numpy and the port; no JAX): rank 0
runs the same function in the test's process, and their collectives meet.
"""

import numpy as np
import torch


def serve_rank(conn, world: int):
    """A spawned rank of a ``data=1, model=world`` mesh over gloo on the
    CPU: run each ``(name, args)`` rank 0 sends (``name`` a function of
    this module taking the mesh first) until ``stop``; returns how many
    ran."""
    from distllm_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(data=1, model=world), devices=['cpu'] * world, backend='gloo')
    torch.set_num_threads(1)
    done = 0
    while True:
        name, args = conn.recv()
        if name == 'stop':
            return done
        globals()[name](mesh, *args)
        done += 1


def sharded_encoder_forward(mesh, family: str, cfg_kwargs: dict, tree: dict,
                            quantization, ids: np.ndarray, mask: np.ndarray):
    """Build a ``TorchEncoder`` of ``family`` over a bridged JAX ``tree``
    (quantized on construction with ``quantization``), put it on ``mesh``
    under the family's ``param_specs`` and run one forward; returns
    ``(hidden states, the rank's encoder)``."""
    from distllm_tpu_torch.embed.encoders.base import TorchEncoder
    from distllm_tpu_torch.models import bert, esm2, modernbert
    from distllm_tpu_torch.models.tokenizer import TokenBatch

    module, cfg_cls = {
        'bert': (bert, bert.BertConfig), 'esm2': (esm2, esm2.Esm2Config),
        'modernbert': (modernbert, modernbert.ModernBertConfig),
    }[family]
    cfg = cfg_cls(**cfg_kwargs)
    params = module.params_from_jax(tree, cfg, device='cpu')
    encoder = TorchEncoder(None, module.apply, cfg, params, None, cfg.hidden_size,
                           device='cpu', quantization=quantization)
    encoder.shard(mesh, module.param_specs(cfg, encoder.params))
    out = encoder.forward(TokenBatch(ids, mask))
    return out.float().numpy(), encoder
