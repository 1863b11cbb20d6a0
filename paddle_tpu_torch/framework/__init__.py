"""Framework-level state of the port: the threefry PRNG (``prng``), the
seeded random streams built on it (``random``), the serving steps' CUDA
graphs (``cuda_graph``), the named gauges of the stat registry
(``monitor``), and the eager surface's dtypes (``dtype``), places
(``place``), flags (``flags``) and ``save``/``load`` (``io_state``)."""
from .monitor import stat_get, stat_registry, stats_prom, stats_report

__all__ = ["stat_get", "stat_registry", "stats_prom", "stats_report"]
