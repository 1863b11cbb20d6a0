"""Framework-level state of the port: the threefry PRNG (``prng``), the
seeded random streams built on it (``random``), the serving steps' CUDA
graphs (``cuda_graph``) and the named gauges of the stat registry
(``monitor``)."""
from .monitor import stat_get, stat_registry, stats_prom, stats_report

__all__ = ["stat_get", "stat_registry", "stats_prom", "stats_report"]
