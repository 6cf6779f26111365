from mcpx_torch.telemetry.stats import ServiceStats, TelemetryStore

__all__ = ["ServiceStats", "TelemetryStore"]
