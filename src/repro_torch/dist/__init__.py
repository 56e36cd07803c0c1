"""Distributed training over ``torch.distributed``: ``sharding.py``'s
``ParallelCtx`` (the data axis' row helpers, the logical axes and the
model axis' collectives; the meshes are ``launch/mesh.py``) and
error-feedback gradient compression (``compression.py``).  Expert and
sequence parallelism are ROADMAP A.9(c)."""
from repro_torch.dist.sharding import ParallelCtx  # noqa: F401
