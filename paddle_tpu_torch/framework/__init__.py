"""Framework-level state of the port: the threefry PRNG (``prng``), the
seeded random streams built on it (``random``) and the serving steps'
CUDA graphs (``cuda_graph``)."""
