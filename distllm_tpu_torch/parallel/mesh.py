"""Device mesh over ``torch.distributed`` (counterpart of
``distllm_tpu.parallel.mesh``).

The same four named axes as the JAX package:

- ``data``   — batch-dim sharding (DP);
- ``model``  — tensor parallelism over attention heads / MLP widths (the
  reference's ``tensor_parallel_size``);
- ``seq``    — sequence parallelism (ring attention; not ported yet,
  ROADMAP A10c);
- ``expert`` — expert parallelism for MoE banks.

A JAX ``Mesh`` is one array of devices seen whole by one program; here
every rank is a process, so :func:`make_mesh` returns this rank's view of
the mesh (:class:`Mesh`): its coordinates, the axis sizes, and one
process group per axis (plus the ``expert`` x ``model`` group the MoE
combine sums over). Ranks are laid out in :data:`AXIS_ORDER`, ``model``
innermost, as the JAX mesh reshapes its device list.

The backend is the caller's: ``'nccl'`` for ranks on distinct CUDA
devices, ``'gloo'`` on the CPU, or gloo on CUDA tensors for several ranks
sharing one card (its collectives stage through the host and cannot be
captured in a CUDA graph). NCCL with two ranks on one device raises; the
mesh never switches backend on its own. ``torch.distributed.device_mesh``
is not used: it sets one device per local rank and has no notion of two
ranks on one card, and the combined ``expert`` x ``model`` group would
need its private flattening API.
"""

from __future__ import annotations

import dataclasses
import math
import socket

import torch

from distllm_tpu_torch.utils import BaseConfig

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
SEQ_AXIS = 'seq'
EXPERT_AXIS = 'expert'

AXIS_ORDER = (DATA_AXIS, SEQ_AXIS, EXPERT_AXIS, MODEL_AXIS)
# The process groups a rank holds: one per axis, and the MoE combine's.
MOE_AXES = (EXPERT_AXIS, MODEL_AXIS)
BACKENDS = ('nccl', 'gloo')


@dataclasses.dataclass
class MeshSpec(BaseConfig):
    """Declarative mesh shape; ``-1`` on one axis means "fill remaining".

    Example: on 8 ranks, ``MeshSpec(data=-1, model=2)`` builds a 4x2
    ``(data, model)`` mesh.
    """

    name: str = 'mesh'
    data: int = -1
    seq: int = 1
    expert: int = 1
    model: int = 1

    def validate(self) -> None:
        if self.name != 'mesh':
            raise ValueError(f"MeshSpec.name must be 'mesh', got {self.name!r}")

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {
            DATA_AXIS: self.data,
            SEQ_AXIS: self.seq,
            EXPERT_AXIS: self.expert,
            MODEL_AXIS: self.model,
        }
        fills = [ax for ax, s in sizes.items() if s == -1]
        if len(fills) > 1:
            raise ValueError(f'at most one mesh axis may be -1, got {fills}')
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if fills:
            if n_devices % fixed != 0:
                raise ValueError(
                    f'{n_devices} devices not divisible by fixed axes {fixed}'
                )
            sizes[fills[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f'mesh {sizes} needs {fixed} devices, have {n_devices}'
            )
        return sizes


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh.

    ``shape`` maps each axis of :data:`AXIS_ORDER` to its size (the JAX
    ``mesh.shape``), ``coords`` this rank's coordinate on each, ``groups``
    the process group of each axis and of :data:`MOE_AXES` (``None`` on a
    mesh made without ``torch.distributed``: :func:`single_device_mesh`).
    ``device`` is this rank's device and ``num_devices`` the number of
    distinct devices under the whole mesh (two ranks on one card count
    once)."""

    shape: dict
    rank: int
    coords: dict
    groups: dict | None
    backend: str | None
    device: torch.device
    num_devices: int
    axis_names: tuple = AXIS_ORDER

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axes) -> 'object | None':
        """The process group over one axis name or a tuple of them."""
        return None if self.groups is None else self.groups[axes]


def _rank_coords(rank: int, sizes: dict) -> dict:
    coords, rest = {}, rank
    for axis in reversed(AXIS_ORDER):
        coords[axis] = rest % sizes[axis]
        rest //= sizes[axis]
    return {axis: coords[axis] for axis in AXIS_ORDER}


def _group_ranks(sizes: dict, axes: tuple) -> list[list[int]]:
    """Every group of ranks that differ only along ``axes`` (rank order,
    ``axes`` in :data:`AXIS_ORDER` order), each group once."""
    world = math.prod(sizes.values())
    groups: dict[tuple, list[int]] = {}
    for rank in range(world):
        coords = _rank_coords(rank, sizes)
        key = tuple(coords[a] for a in AXIS_ORDER if a not in axes)
        groups.setdefault(key, []).append(rank)
    return list(groups.values())


def device_key(device: torch.device) -> str:
    """A name of the physical device under ``device`` that two ranks on
    one host agree on: the CUDA device's UUID (``cuda:0`` in two processes
    is one card), or the host's CPU."""
    host = socket.gethostname()
    if device.type == 'cuda':
        props = torch.cuda.get_device_properties(device)
        return f'{host}:cuda:{getattr(props, "uuid", device.index)}'
    return f'{host}:{device.type}'


def check_backend_devices(backend: str, keys: list[str]) -> None:
    """Refuse NCCL over ranks that share a device (``keys``: each rank's
    :func:`device_key`): NCCL puts one rank on a device; gloo is the
    caller's way to share one."""
    if backend == 'nccl' and len(set(keys)) < len(keys):
        shared = sorted({k for k in keys if keys.count(k) > 1})
        raise ValueError(
            f'NCCL cannot run two ranks on one device ({shared}); '
            "use backend='gloo' for ranks that share a card"
        )


def rank_devices(world: int, device: 'str | torch.device' = 'cuda') -> list[str]:
    """Where ``world`` ranks go when the caller names no device for each:
    every rank on the CPU when ``device`` is the CPU, else rank r on
    ``cuda:<r % cards>`` (ranks then share a card only when there are
    fewer cards than ranks, which :func:`make_mesh` refuses under NCCL)."""
    if torch.device(device).type == 'cpu':
        return ['cpu'] * world
    count = max(1, torch.cuda.device_count())
    return [f'cuda:{r % count}' for r in range(world)]


def make_mesh(
    spec: MeshSpec | None = None,
    *,
    devices: 'list | str | None' = None,
    backend: str | None = None,
    **axis_sizes: int,
) -> Mesh:
    """This rank's :class:`Mesh` from a spec or keyword axis sizes, over
    the process group ``init_multihost`` joined.

    ``devices`` names each rank's device, in rank order, or one device
    type for all of them (:func:`rank_devices`; default ``'cuda'``: rank
    r on ``cuda:<r % cards>``, ``'cpu'``: every rank on the CPU);
    ``backend`` ('nccl' or 'gloo') is
    that of the axis groups (default: the world's, as ``init_multihost``
    was given it). Every rank must call this with the same arguments, in
    step: each axis group is made by all ranks. The ranks' devices are
    compared over a gloo group before any NCCL communicator exists, and
    NCCL with two ranks on one device raises."""
    import torch.distributed as dist

    if spec is None:
        spec = MeshSpec(**axis_sizes)
    if not dist.is_initialized():
        raise RuntimeError(
            'make_mesh needs the process group: call '
            'parallel.multihost.init_multihost first (or single_device_mesh())'
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = spec.resolve(world)
    backend = backend or dist.get_backend()
    if backend not in BACKENDS:
        raise ValueError(f'backend must be one of {BACKENDS}, got {backend!r}')
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = rank_devices(world, devices or 'cuda')
    if len(devices) != world:
        raise ValueError(f'{len(devices)} devices for {world} ranks')
    device = torch.device(devices[rank])
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available: give each rank devices=["cpu", ...] '
                'and backend="gloo" to run the mesh on the CPU'
            )
        torch.cuda.set_device(device)
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError(f'NCCL needs a CUDA device per rank, rank {rank} has {device}')
    # The device check runs over gloo: an NCCL communicator over two ranks
    # of one card would fail (or hang) before it could report anything.
    control = dist.new_group(backend='gloo')
    keys: list = [None] * world
    dist.all_gather_object(keys, device_key(device), group=control)
    check_backend_devices(backend, keys)
    groups = {}
    for axes in [(axis,) for axis in AXIS_ORDER] + [MOE_AXES]:
        for ranks in _group_ranks(sizes, axes):
            group = dist.new_group(ranks=ranks, backend=backend)
            if rank in ranks:
                groups[axes[0] if len(axes) == 1 else axes] = group
    return Mesh(
        shape=sizes, rank=rank, coords=_rank_coords(rank, sizes), groups=groups,
        backend=backend, device=device, num_devices=len(set(keys)),
    )


def single_device_mesh(device: 'str | torch.device | None' = None) -> Mesh:
    """1-device mesh (all axes size 1, no process group) — used by
    single-host paths; ``device`` defaults to the GPU."""
    from distllm_tpu_torch.utils import resolve_device

    sizes = MeshSpec(data=1, seq=1, expert=1, model=1).resolve(1)
    return Mesh(
        shape=sizes, rank=0, coords=dict.fromkeys(AXIS_ORDER, 0), groups=None,
        backend=None, device=resolve_device(device), num_devices=1,
    )
