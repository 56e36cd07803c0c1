"""Distributed training pieces that also run on one device: error-feedback
gradient compression (``compression.py``).  The mesh (``sharding.py``,
``launch/mesh.py``) is not ported yet (ROADMAP A.8)."""
