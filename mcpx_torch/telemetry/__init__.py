from mcpx_torch.telemetry.stats import ServiceStats, TelemetryStore
from mcpx_torch.telemetry.metrics import Metrics
from mcpx_torch.telemetry.tracing import Span, TraceRecord, Tracer

__all__ = ["ServiceStats", "TelemetryStore", "Metrics", "Span", "TraceRecord", "Tracer"]
