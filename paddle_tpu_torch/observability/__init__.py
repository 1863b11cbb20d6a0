"""The serving telemetry plane of the port: ``ServingMetrics`` (counters,
latency percentiles, events and gauges), the quant byte accounting and the
JSONL event sink (``events``; one flag, ``PADDLE_TPU_TELEMETRY=1``)."""
from . import events
from .events import (enabled, event_log_path, iter_events, set_enabled,
                     set_event_path)
from .serving import ServingMetrics

__all__ = ["ServingMetrics", "enabled", "event_log_path", "events",
           "iter_events", "set_enabled", "set_event_path"]
