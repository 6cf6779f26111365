from mcpx_torch.core.dag import DagEdge, DagNode, Plan, PlanValidationError
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.errors import (
    ConfigError,
    EngineError,
    ExecutionError,
    MCPXError,
    PlannerError,
    RegistryError,
)
from mcpx_torch.core.trace import ExecutionTrace, NodeAttempt, NodeTrace, Span, new_trace_id

__all__ = [
    "DagEdge",
    "DagNode",
    "Plan",
    "PlanValidationError",
    "MCPXConfig",
    "MCPXError",
    "ConfigError",
    "PlannerError",
    "RegistryError",
    "ExecutionError",
    "EngineError",
    "ExecutionTrace",
    "NodeAttempt",
    "NodeTrace",
    "Span",
    "new_trace_id",
]
