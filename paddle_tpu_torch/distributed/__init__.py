"""Distributed pieces of the port: checkpoints (``checkpoint``) and fault
tolerance (``ft``: checkpoint manager, training sentinel, chaos plan)."""
