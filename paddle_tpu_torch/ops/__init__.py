"""Operators of the port: hand-written kernels under ``ops.kernels``."""
