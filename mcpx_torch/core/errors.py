"""Framework exception hierarchy.

The reference has no error taxonomy — it raises bare ``HTTPException(502)``
mid-walk and discards partial results (reference ``control_plane.py:130``,
SURVEY.md bug B5). Here every error carries structure so the API layer can
return partial-failure responses instead of aborting.
"""

from __future__ import annotations


class MCPXError(Exception):
    """Base class for all framework errors."""


class RegistryError(MCPXError):
    """Service registry lookup/storage failure."""


class PlannerError(MCPXError):
    """The planner could not produce a valid plan within its retry budget."""


class EngineError(MCPXError):
    """Inference-engine failure (kernel build or launch, device, scheduler)."""


class ConfigError(MCPXError):
    """Invalid configuration detected at startup validation."""
