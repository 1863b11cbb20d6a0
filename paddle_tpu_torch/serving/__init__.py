"""Continuous-batching serving engine of the port, and its prefix KV
pool."""
from .engine import QueueFull, ServingEngine
from .prefix_cache import PageSpan, PrefixCache
from .request import Request, RequestState

__all__ = ["PageSpan", "PrefixCache", "QueueFull", "Request",
           "RequestState", "ServingEngine"]
