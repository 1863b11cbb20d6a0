"""Serving counters of the port (``ServingMetrics``)."""
from .serving import ServingMetrics

__all__ = ["ServingMetrics"]
