from mcpx_torch.orchestrator.executor import ExecuteResult, Orchestrator
from mcpx_torch.orchestrator.transport import (
    AioHttpTransport,
    LocalTransport,
    RouterTransport,
    Transport,
    TransportError,
)

__all__ = [
    "Orchestrator",
    "ExecuteResult",
    "Transport",
    "TransportError",
    "AioHttpTransport",
    "LocalTransport",
    "RouterTransport",
]
