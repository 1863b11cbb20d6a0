"""Parallelism building blocks of the port (one device so far: MoE)."""
