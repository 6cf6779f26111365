"""Application factory: config -> wired ControlPlane on a device.

PyTorch-port copy of ``mcpx/server/factory.py``: the configured registry
backend (memory, file or Redis) and planner (llm, heuristic or mock), the
retrieval index on the control plane's device, loaded from
``retrieval.snapshot_path`` when one is set (an unusable snapshot is logged
and rebuilt from the registry, as in the reference), the telemetry store, one ``Metrics`` registry shared by the orchestrator, the
planner's engine and the control plane, the orchestrator over an injected
transport, the replan policy and the optional Redis plan-cache tier; the
``/plan`` admission scheduler (``scheduler.enabled``, over the engine's
``queue_stats``), the resilience facade (``resilience.enabled``: breakers,
deadline budgets, hedges, breaker-fed replan exclusions) and the seeded
chaos transport (``resilience.chaos_profile``, wrapped outside the
resilience gate); the Redis telemetry mirror (``telemetry.redis_url``
while ``telemetry.enabled``). The control plane builds its tracer from
``config.tracing`` and telemetry's default-off parts (the cost ledger, the
SLO tracker, the flight recorder, decision provenance) from their options.
With ``cluster.enabled`` the LLM planner's engine is an ``EnginePool`` of
``cluster.replicas`` engines on the control plane's device, which reads a
chaos profile's ``cluster`` section; with ``cluster.shard_registry`` too the
retrieval index is a ``ShardedRetrievalIndex`` of ``registry_shards`` (0:
one per replica) row shards. ``device=None`` means the GPU and raises
without CUDA; pass ``device="cpu"`` for the plain PyTorch path.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from mcpx_torch.cluster import EnginePool
from mcpx_torch.cluster.sharding import ShardedRetrievalIndex
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.device import resolve_device
from mcpx_torch.orchestrator.executor import Orchestrator
from mcpx_torch.orchestrator.transport import RouterTransport, Transport
from mcpx_torch.planner.base import Planner
from mcpx_torch.planner.heuristic import HeuristicPlanner
from mcpx_torch.planner.mock import MockPlanner
from mcpx_torch.registry import make_registry
from mcpx_torch.registry.base import RegistryBackend
from mcpx_torch.resilience import Resilience
from mcpx_torch.resilience.chaos import ChaosProfile, ChaosTransport
from mcpx_torch.retrieval.index import RetrievalIndex
from mcpx_torch.scheduler import Scheduler
from mcpx_torch.server.control import ControlPlane
from mcpx_torch.server.plan_cache import RedisPlanCache
from mcpx_torch.telemetry.metrics import Metrics
from mcpx_torch.telemetry.mirror import RedisTelemetryMirror
from mcpx_torch.telemetry.replan import ReplanPolicy
from mcpx_torch.telemetry.stats import TelemetryStore


def build_control_plane(
    config: Optional[MCPXConfig] = None,
    *,
    registry: Optional[RegistryBackend] = None,
    planner: Optional[Planner] = None,
    transport: Optional[Transport] = None,
    retriever=None,
    device: "torch.device | str | None" = None,
) -> ControlPlane:
    config = config or MCPXConfig()
    config.validate()
    device = resolve_device(device)
    registry = registry if registry is not None else make_registry(config.registry)
    transport = transport if transport is not None else RouterTransport()
    if retriever is None and config.retrieval.enabled:
        if config.cluster.enabled and config.cluster.shard_registry:
            # Registry sharding: row-partitioned table, shard-local top-k
            # merged on the host.
            retriever = ShardedRetrievalIndex(
                config.retrieval, n_shards=config.cluster.registry_shards or config.cluster.replicas,
                device=device,
            )
        else:
            retriever = RetrievalIndex(config.retrieval, device=device)
        if config.retrieval.snapshot_path:
            try:
                retriever.load(config.retrieval.snapshot_path)
            except Exception as e:  # noqa: BLE001 - the snapshot is rebuildable
                logging.getLogger("mcpx_torch.factory").warning(
                    "retrieval snapshot %s unusable (%s); will rebuild from registry",
                    config.retrieval.snapshot_path, e,
                )
    telemetry = TelemetryStore(config.telemetry.ewma_alpha)
    telemetry_mirror = None
    if config.telemetry.enabled and config.telemetry.redis_url:
        # Built here, connected at its first sync (the app's mirror loop).
        telemetry_mirror = RedisTelemetryMirror(telemetry, config.telemetry.redis_url)
    redis_plan_cache = None
    if config.planner.plan_cache_redis_url:
        redis_plan_cache = RedisPlanCache(
            config.planner.plan_cache_redis_url, ttl_s=config.planner.plan_cache_redis_ttl_s
        )
    metrics = Metrics()
    chaos_profile = None
    if config.resilience.chaos_profile:
        # Every service call crosses the seeded fault injector, wrapped
        # outside the resilience gate, so the same fault profile can be
        # served with resilience on and off. A profile's "cluster" section
        # is not a transport fault: the engine pool reads it below (the
        # kill-a-replica and rejoin schedule).
        chaos_profile = ChaosProfile.from_file(config.resilience.chaos_profile)
        transport = ChaosTransport(transport, chaos_profile)
    resilience = (
        Resilience(config.resilience, telemetry=telemetry, metrics=metrics)
        if config.resilience.enabled
        else None
    )
    orchestrator = Orchestrator(
        transport, config.orchestrator, registry=registry, telemetry=telemetry, metrics=metrics,
        resilience=resilience,
    )
    if planner is None:
        if config.planner.kind == "heuristic":
            planner = HeuristicPlanner(config.planner)
        elif config.planner.kind == "mock":
            planner = MockPlanner()
        else:  # "llm"
            from mcpx_torch.planner.llm import LLMPlanner

            if config.cluster.enabled:
                # N engine replicas behind the surface a bare engine
                # exposes, so the scheduler, app and flight wiring below is
                # the same.
                pool = EnginePool(
                    config, metrics=metrics, chaos=chaos_profile.cluster if chaos_profile else None,
                    device=device,
                )
                planner = LLMPlanner(pool, config.planner)
            else:
                planner = LLMPlanner.from_config(config, retriever=retriever, metrics=metrics, device=device)
    scheduler = None
    if config.scheduler.enabled:
        # The engine's queue ETA floors the scheduler's own estimate; the
        # heuristic and mock planners have no engine, and the scheduler then
        # estimates from its own grant and release accounting alone.
        engine = getattr(planner, "engine", None)
        scheduler = Scheduler(
            config.scheduler, metrics, engine_stats=engine.queue_stats if engine is not None else None
        )
    return ControlPlane(
        config=config,
        registry=registry,
        planner=planner,
        orchestrator=orchestrator,
        telemetry=telemetry,
        metrics=metrics,
        retriever=retriever,
        # Breaker state feeds replan exclusions: a learned-down endpoint is
        # routed around at plan time, not rediscovered per execute.
        replan_policy=ReplanPolicy(
            config.telemetry, breakers=resilience.breakers if resilience is not None else None
        ),
        telemetry_mirror=telemetry_mirror,
        redis_plan_cache=redis_plan_cache,
        scheduler=scheduler,
    )
