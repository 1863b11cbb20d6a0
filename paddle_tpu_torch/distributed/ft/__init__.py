"""Fault injection of the port: the chaos plan and its serving faults."""
