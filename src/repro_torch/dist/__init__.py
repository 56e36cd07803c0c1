"""Distributed training over ``torch.distributed``: ``sharding.py``'s
``ParallelCtx`` (the data axis' row helpers, the logical axes and the
model axis' collectives; the meshes are ``launch/mesh.py``) and
error-feedback gradient compression (``compression.py``)."""
from repro_torch.dist.sharding import ParallelCtx  # noqa: F401
