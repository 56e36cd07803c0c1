"""Fault-tolerant checkpoints (``checkpoint.py``)."""
