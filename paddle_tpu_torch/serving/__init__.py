"""Continuous-batching serving of the port: the engine and its prefix KV
pool, the resilience plane (shedding, brownout, retries, the crash
journal) and the multi-replica fleet with prefill/decode handoff."""
from .engine import QueueFull, ServingEngine
from .fleet import FleetReplica, KVHandoff, ServingFleet, plan_handoff
from .prefix_cache import PageSpan, PrefixCache, chain_keys
from .request import Request, RequestState
from .resilience import (LaneSLO, RequestJournal, RequestShed,
                         ResiliencePolicy, replay_journal)

__all__ = ["FleetReplica", "KVHandoff", "LaneSLO", "PageSpan", "PrefixCache",
           "QueueFull", "Request", "RequestJournal", "RequestShed",
           "RequestState", "ResiliencePolicy", "ServingEngine",
           "ServingFleet", "chain_keys", "plan_handoff", "replay_journal"]
