"""Framework-level state of the port: the threefry PRNG (``prng``) and
the seeded random streams built on it (``random``)."""
