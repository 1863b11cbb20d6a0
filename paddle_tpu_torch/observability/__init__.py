"""The serving telemetry plane of the port: ``ServingMetrics`` (counters,
latency percentiles, events and gauges), the quant byte accounting, the
resilience and fleet events (``resilience``, ``fleet``), per-tenant
metering (``metering.TenantMeter``), request tracing with its flight
recorder (``tracing``; ``PADDLE_TPU_TRACING=1``) and the JSONL event sink
(``events``; ``PADDLE_TPU_TELEMETRY=1``). ``python -m
paddle_tpu_torch.observability`` prints the gauge snapshot."""
from . import events, fleet, metering, resilience, tracing
from .events import (enabled, event_log_path, iter_events, set_enabled,
                     set_event_path)
from .metering import TenantMeter
from .serving import ServingMetrics

__all__ = ["ServingMetrics", "TenantMeter", "enabled", "event_log_path",
           "events", "fleet", "iter_events", "metering", "resilience",
           "set_enabled", "set_event_path", "tracing"]
