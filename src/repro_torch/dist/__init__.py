"""Distributed training: the data-parallel axis over ``torch.distributed``
(``sharding.py``: ``ParallelCtx``; the mesh itself is ``launch/mesh.py``) and
error-feedback gradient compression (``compression.py``).  The model axis
(tensor, expert and sequence parallelism, FSDP) waits for the pod-scale
launcher (ROADMAP A.9)."""
from repro_torch.dist.sharding import ParallelCtx  # noqa: F401
