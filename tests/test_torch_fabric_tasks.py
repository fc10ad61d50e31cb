"""Task functions that the fabric, launcher and pod tests ship to worker
processes (``python -m distllm_tpu_torch.parallel.worker``), which resolve
them by import path. Kept apart from the test modules, whose imports (the
JAX package among them) a worker would otherwise load first. No tests here.
"""

from __future__ import annotations

import os
import time
from pathlib import Path


def marked_task(item):
    """Write ``<marker dir>/<pid>-<name>`` when the task starts; sleep the
    item's seconds on its first start only (a requeued copy runs at once).
    The kill test waits for a marker to kill its worker mid-task."""
    marker_dir, name, seconds = item
    first = not any(p.name.endswith(f'-{name}') for p in Path(marker_dir).iterdir())
    Path(marker_dir, f'{os.getpid()}-{name}').write_text('')
    if first:
        time.sleep(seconds)
    return name, os.getpid()


def world_report(values):
    """This process's ``torch.distributed`` rank, size and backend, and one
    all-reduce of ``values`` over the world."""
    import torch
    import torch.distributed as dist

    tensor = torch.tensor(values, dtype=torch.float32)
    dist.all_reduce(tensor)
    return dist.get_rank(), dist.get_world_size(), dist.get_backend(), tensor.tolist()
