"""Checkpoints in the JAX package's on-disk format (``store.py``)."""
