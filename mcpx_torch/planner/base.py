"""Planner interface: intent → validated Plan.

The reference's planner is a single blocking method gluing Redis scan +
prompt + OpenAI + ``json.loads`` (reference ``control_plane.py:57-75``).
Here planning is async (the reference blocks the event loop, bug B6), takes
an explicit context (registry + telemetry snapshot) instead of reaching into
global singletons, and must return a *validated* ``Plan`` — planners are
responsible for their own retry/repair loops (bug B7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol, runtime_checkable

from mcpx_torch.core.dag import Plan
from mcpx_torch.registry.base import RegistryBackend
from mcpx_torch.telemetry.stats import ServiceStats


@dataclass
class PlanContext:
    registry: RegistryBackend
    telemetry: dict[str, ServiceStats] = field(default_factory=dict)
    # Services the retrieval layer shortlisted for this intent (names, ranked).
    shortlist: Optional[list[str]] = None
    # Services a replan must avoid (observed failing in this request).
    exclude: set[str] = field(default_factory=set)
    # Registry version this context was built against (None = caller didn't
    # snapshot one; consumers fetch it themselves). Keys the planner's
    # per-registry grammar cache.
    registry_version: Optional[int] = None
    # EDF deadline (time.monotonic timestamp) the serving scheduler granted
    # this request under, threaded to the engine so its prefix-locality
    # admission sort never regroups a request whose deadline can't afford
    # the wait (scheduler/locality.py). None = no deadline.
    deadline_at: Optional[float] = None
    # Cache-governance identity (scheduler grant / tenant header), threaded
    # to the engine so radix-tree KV insertions are charged to the tenant's
    # weighted-fair cache quota (engine/cache_governor.py). "default" =
    # single-tenant traffic (no quota pressure).
    tenant: str = "default"
    # Warm-replan rendering order (names, as originally rendered): when set
    # alongside ``exclude``, the LLM planner keeps these services in the
    # prompt IN THIS ORDER — excluded ones included — and splices the
    # exclusions into the SUFFIX as an Avoid line, so the replan prompt
    # shares every byte of the original services block and the engine's
    # radix prefix cache serves its KV instead of re-prefilling.
    # Exclusions still leave the grammar trie and the resolution map — only
    # the rendering is stable.
    replan_prior: Optional[tuple[str, ...]] = None


@runtime_checkable
class Planner(Protocol):
    async def plan(self, intent: str, context: PlanContext) -> Plan: ...
