"""A tensor-parallel engine started from one process: rank 0's
:class:`~distllm_tpu_torch.generate.engine.engine.LLMEngine` over a mesh
``data=1, model=N`` (the JAX generator's ``MeshSpec(data=1, model=tp)``)
whose other ``N - 1`` ranks this process spawns
(``parallel.multihost.RankGroup``).

Each rank makes its mesh, builds its own slice of the weights from a
:class:`WeightSource` — random weights from a seed drawn leaf by leaf and
sliced as they are drawn, a checkpoint read and sliced leaf by leaf
(quantized whole first), or a whole tree handed over (small models, the
tests) — and its engine. Rank 0's engine schedules and sends every device
program to the others (``LLMEngine.follow``). :meth:`ShardedEngine.close`
stops them and returns every rank's :meth:`LLMEngine.tp_report`, whose
token digests agree when every rank sampled the same tokens.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from distllm_tpu_torch.generate.engine.engine import (
    EngineConfig,
    LLMEngine,
    check_tp_heads,
)
from distllm_tpu_torch.parallel.mesh import MeshSpec, make_mesh, rank_devices
from distllm_tpu_torch.parallel.multihost import DEFAULT_TIMEOUT_S, RankGroup
from distllm_tpu_torch.parallel.sharding import leaf_sharder, shard_pytree


@dataclasses.dataclass
class WeightSource:
    """Where each rank's weights come from (picklable: it travels to the
    spawned ranks).

    - ``kind='init'``: the family's ``init`` from ``seed`` on the rank's
      device, quantized with ``quantization`` and sliced leaf by leaf;
    - ``kind='checkpoint'``: ``path``'s HF checkpoint (the config from its
      ``config.json``), each leaf quantized whole and then sliced;
    - ``kind='tree'``: ``tree``, a whole parameter tree (CPU tensors,
      quantized leaves included), sliced and moved to the rank's device.
    """

    kind: str
    seed: int = 0
    quantization: str | None = None
    path: str | None = None
    tree: Any = None

    def build(self, model_cfg, mesh) -> tuple:
        """``(model_cfg, this rank's params on mesh.device)``."""
        from distllm_tpu_torch.models import decoder_family

        device = mesh.device
        if self.kind == 'checkpoint':
            from distllm_tpu_torch.models.loader import read_checkpoint, read_hf_config

            hf_cfg = read_hf_config(self.path)
            cfg_cls, family = decoder_family(hf_cfg.get('model_type', 'mistral'))
            model_cfg = cfg_cls.from_hf_config(hf_cfg)
            shard = leaf_sharder(
                family.param_specs(model_cfg), mesh, self.quantization, model_cfg.dtype,
            )
            params = family.params_from_hf(
                read_checkpoint(self.path), model_cfg, device=device, leaf_fn=shard,
            )
            return model_cfg, params
        family = decoder_family(model_cfg.name)[1]
        if self.kind == 'init':
            return model_cfg, family.init(
                model_cfg, torch.Generator(device=device).manual_seed(self.seed),
                device=device, quantization=self.quantization,
                leaf_fn=leaf_sharder(family.param_specs(model_cfg), mesh),
            )
        if self.kind == 'tree':
            local = shard_pytree(
                self.tree, family.param_specs(model_cfg, self.tree), mesh,
            )
            return model_cfg, _to_device(local, device)
        raise ValueError(f"WeightSource.kind must be 'init', 'checkpoint' or 'tree', got {self.kind!r}")


def _to_device(tree, device):
    from distllm_tpu_torch.ops.quantization import QTensor

    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q.to(device), tree.scale.to(device), tree.kind, tree.shape,
                       tree.out_dtype, tree.block_size, tree.view)
    return tree.to(device)


def _rank_engine(mesh, model_cfg, source: WeightSource, config: EngineConfig,
                 engine_kwargs: dict, followers=None, tokenizer=None) -> LLMEngine:
    model_cfg, params = source.build(model_cfg, mesh)
    return LLMEngine(
        model_cfg, params, tokenizer, config, device=mesh.device, mesh=mesh,
        followers=followers, own_params=True, **engine_kwargs,
    )


def _follow(conn, world, devices, backend, model_cfg, source, config, engine_kwargs):
    """A spawned rank: its mesh, its engine, then rank 0's programs."""
    mesh = make_mesh(MeshSpec(data=1, model=world), devices=devices, backend=backend)
    if mesh.device.type == 'cpu':
        # The ranks share the host's cores (rank 0 keeps its own setting).
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    engine = _rank_engine(mesh, model_cfg, source, config, engine_kwargs)
    try:
        return engine.follow(conn)
    finally:
        engine.shutdown()


class ShardedEngine:
    """Rank 0 of a ``tensor_parallel_size = world`` engine, its other ranks
    spawned here. ``devices`` names each rank's device, or one device type
    for all (``parallel.mesh.rank_devices``: ``'cuda'`` puts rank r on
    ``cuda:<r % cards>``, ``'cpu'`` every rank on the CPU), and
    ``backend`` the collectives' ('nccl': one rank a card; 'gloo': the
    CPU, or ranks sharing a card). ``engine`` is rank 0's :class:`LLMEngine` (requests go
    to it alone; ``tokenizer`` is its). ``timeout_s`` bounds each
    collective's wait for a peer."""

    def __init__(
        self,
        world: int,
        model_cfg,
        source: WeightSource,
        config: EngineConfig,
        *,
        backend: str,
        devices: 'list | str' = 'cuda',
        tokenizer=None,
        timeout_s: float = DEFAULT_TIMEOUT_S,
        **engine_kwargs,
    ) -> None:
        if isinstance(devices, (str, torch.device)):
            devices = rank_devices(world, devices)
        if len(devices) != world:
            raise ValueError(f'{len(devices)} devices for tensor_parallel_size {world}')
        check_tp_heads(model_cfg, world)  # refused before any rank starts
        self.ranks = RankGroup(
            world, _follow,
            (world, list(devices), backend, model_cfg, source, config, engine_kwargs),
            backend=backend, timeout_s=timeout_s,
        )
        self.reports: list[dict] = []
        try:
            self.mesh = make_mesh(
                MeshSpec(data=1, model=world), devices=list(devices), backend=backend,
            )
            self.engine = _rank_engine(
                self.mesh, model_cfg, source, config, engine_kwargs,
                followers=self.ranks, tokenizer=tokenizer,
            )
        except BaseException as exc:
            for error in self.ranks.errors():
                exc.add_note(error)
            self._stop()
            raise

    def close(self) -> list[dict]:
        """Stop the other ranks; every rank's ``tp_report`` in rank order,
        also kept in ``reports``."""
        leader = self.engine.tp_report()
        self.engine.shutdown()
        self.reports = [leader] + self.ranks.close()
        return self.reports

    def _stop(self) -> None:
        try:
            self.ranks.close(join_s=10.0)
        except RuntimeError:
            pass  # the construction error is the one raised

