"""The multi-replica serving tier (counterpart of ``distllm_tpu.router``).

A prefix-aware HTTP router in front of N chat-server replicas
(``router/app.py``; ``python -m distllm_tpu_torch.router``), and the
affinity bookkeeping the replicas also use to annotate their answers
(``router/affinity.py``). The peer KV tier that lets replicas hand spilled
blocks to each other lives with the other tiers in
``generate/engine/kv_cache.py`` (``PeerKVTier``), its transport in
``parallel/fabric.py`` (``KVBlockServer`` / ``KVBlockClient``).
"""

from distllm_tpu_torch.router.affinity import AffinityMap, prompt_prefix_digests
from distllm_tpu_torch.router.app import Replica, Router, RouterConfig, RouterServer

__all__ = [
    'AffinityMap',
    'Replica',
    'Router',
    'RouterConfig',
    'RouterServer',
    'prompt_prefix_digests',
]
