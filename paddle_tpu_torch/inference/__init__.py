"""Slot-based generation sessions of the port."""
from .generation import GenerationSession, eager_ticks

__all__ = ["GenerationSession", "eager_ticks"]
