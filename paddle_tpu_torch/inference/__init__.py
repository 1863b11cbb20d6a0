"""Slot-based generation sessions of the port."""
from .generation import GenerationSession

__all__ = ["GenerationSession"]
