"""ControlPlane: planner and retrieval tied together, independent of HTTP.

Trimmed PyTorch-port copy of ``mcpx/server/control.py``: ``plan`` with its
LRU plan cache keyed by (intent, registry version) and the retrieval
shortlist of ``_context`` — the call the ``/plan`` handler makes. Execution,
replanning, tracing and telemetry are not in the port yet.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Optional

from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.dag import Plan
from mcpx_torch.planner.base import PlanContext, Planner
from mcpx_torch.registry.base import RegistryBackend


class ControlPlane:
    def __init__(
        self,
        *,
        config: Optional[MCPXConfig] = None,
        registry: RegistryBackend,
        planner: Planner,
        retriever: Any = None,  # duck-typed: async shortlist(intent, k)
    ) -> None:
        self.config = config or MCPXConfig()
        self.registry = registry
        self.planner = planner
        self.retriever = retriever
        self._plan_cache: OrderedDict[tuple[str, int], Plan] = OrderedDict()
        self.plan_cache_stats = {"hits": 0, "misses": 0}

    # ------------------------------------------------------------- lifecycle
    async def startup(self) -> None:
        """Bring the planner's inference engine up (weights onto the device)
        and push one request through the current registry's grammar before
        serving traffic."""
        ensure = getattr(self.planner, "ensure_ready", None)
        if ensure is not None:
            await ensure()
        warm = getattr(self.planner, "warm", None)
        if warm is not None:
            await warm(self.registry)

    async def aclose(self) -> None:
        engine = getattr(self.planner, "engine", None)
        if engine is not None:
            await engine.aclose()

    # ------------------------------------------------------------------ plan
    async def plan(
        self,
        intent: str,
        *,
        use_cache: bool = True,
        deadline_at: Optional[float] = None,
        tenant: str = "default",
    ) -> tuple[Plan, float]:
        """Plan an intent; returns (plan, latency_ms)."""
        t0 = time.monotonic()
        version = await self.registry.version()
        key = (intent, version)
        local_tier = self.config.planner.plan_cache_size > 0
        if use_cache and local_tier:
            cached = self._plan_cache.get(key)
            if cached is not None:
                self._plan_cache.move_to_end(key)
                self.plan_cache_stats["hits"] += 1
                return cached, (time.monotonic() - t0) * 1e3
            self.plan_cache_stats["misses"] += 1
        context = await self._context(
            intent, version=version, deadline_at=deadline_at, tenant=tenant
        )
        plan = await self.planner.plan(intent, context)
        if use_cache and local_tier:
            self._cache_put(key, plan)
        return plan, (time.monotonic() - t0) * 1e3

    def _cache_put(self, key: tuple[str, int], plan: Plan) -> None:
        self._plan_cache[key] = plan
        self._plan_cache.move_to_end(key)
        while len(self._plan_cache) > self.config.planner.plan_cache_size:
            self._plan_cache.popitem(last=False)

    async def _context(
        self,
        intent: str,
        exclude: Optional[set[str]] = None,
        version: Optional[int] = None,
        *,
        deadline_at: Optional[float] = None,
        tenant: str = "default",
    ) -> PlanContext:
        shortlist = None
        exclude = exclude or set()
        if self.retriever is not None:
            refresh = getattr(self.retriever, "maybe_refresh", None)
            if refresh is not None:
                await refresh(self.registry, version)
            # Over-fetch so excluded services don't starve the shortlist.
            k = self.config.planner.shortlist_top_k
            names = await self.retriever.shortlist(intent, k + len(exclude))
            shortlist = [n for n in names if n not in exclude][:k]
        if version is None:
            version = await self.registry.version()
        return PlanContext(
            registry=self.registry,
            shortlist=shortlist,
            exclude=exclude,
            registry_version=version,
            deadline_at=deadline_at,
            tenant=tenant,
        )
