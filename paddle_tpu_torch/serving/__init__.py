"""Continuous-batching serving engine of the port."""
from .engine import QueueFull, ServingEngine
from .request import Request, RequestState

__all__ = ["QueueFull", "Request", "RequestState", "ServingEngine"]
