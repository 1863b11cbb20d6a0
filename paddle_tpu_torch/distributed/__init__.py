"""Fault-tolerance pieces of the port that serving uses (``ft.chaos``)."""
