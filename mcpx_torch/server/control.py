"""ControlPlane: the use-case layer tying planner, orchestrator, retrieval
and telemetry together, independent of HTTP.

PyTorch-port copy of ``mcpx/server/control.py``: ``plan`` with its two plan
cache tiers (the in-process LRU keyed by (intent, registry version) and the
optional Redis tier), ``execute``, and ``plan_and_execute`` with the
telemetry-adaptive replan loop over a pinned prompt prefix; the metrics
registry (``metrics``, shared with the orchestrator, the planner and the
engine) and the request tracer (``tracer``, built from ``config.tracing``
and read per request by the HTTP middleware, so it can be swapped on a live
server), with the ``plan`` and ``plan.context`` spans; the admission
scheduler (``scheduler``, read per request by the ``/plan`` handler, so it
can be attached to a live control plane) and its degraded tier
(``plan(degraded=)`` serves ``degraded_planner``, a ``HeuristicPlanner``
over the retrieval shortlist, and never writes a plan cache tier); the
``/execute`` deadline (``execute(deadline_ms=)``), a budget inside the
orchestrator's attempt chains while resilience is wired; and telemetry's
default-off parts, each None while its option is off and read per request
by the HTTP middleware, so each can be attached to a live control plane:
the cost ledger (``ledger``, ``telemetry.ledger``), the SLO error-budget
tracker (``slo``, ``slo.enabled``; with ``scheduler.burn_aware`` its
``burning`` feeds the scheduler's degradation ladder), the flight recorder
(``flight``, ``telemetry.flight``, built after the SLO tracker, whose fast
burn it watches), decision provenance (``provenance``,
``telemetry.provenance``: the ``plan``, ``prefix`` and ``replan``
decisions are emitted here) and the Redis telemetry mirror
(``telemetry_mirror``, built by the factory); the replica pool
(``cluster``: the planner's engine when it is an ``EnginePool``, None
otherwise), whose burn-aware routing reads the ledger and the SLO tracker.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict
from typing import Any, Optional

import torch

from mcpx_torch import __version__
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.dag import Plan
from mcpx_torch.core.trace import ExecutionTrace
from mcpx_torch.orchestrator.executor import ExecuteResult, Orchestrator
from mcpx_torch.planner.base import PlanContext, Planner
from mcpx_torch.planner.heuristic import HeuristicPlanner
from mcpx_torch.registry.base import RegistryBackend
from mcpx_torch.telemetry import provenance, tracing
from mcpx_torch.telemetry.flight import build_flight_recorder
from mcpx_torch.telemetry.ledger import build_ledger
from mcpx_torch.telemetry.metrics import Metrics
from mcpx_torch.telemetry.replan import ReplanPolicy
from mcpx_torch.telemetry.slo import build_slo_tracker
from mcpx_torch.telemetry.stats import TelemetryStore
from mcpx_torch.telemetry.tracing import Tracer

log = logging.getLogger("mcpx_torch.control")


def _backend_label(planner: Any) -> str:
    """The device this build serves on: the engine's, or "none" without
    one (a heuristic planner)."""
    engine = getattr(planner, "engine", None)
    device = getattr(engine, "device", None)
    return device.type if device is not None else "none"


class ControlPlane:
    def __init__(
        self,
        *,
        config: Optional[MCPXConfig] = None,
        registry: RegistryBackend,
        planner: Planner,
        orchestrator: Orchestrator,
        telemetry: Optional[TelemetryStore] = None,
        retriever: Any = None,  # duck-typed: async shortlist(intent, k)
        replan_policy: Optional[ReplanPolicy] = None,
        telemetry_mirror: Any = None,  # mcpx_torch.telemetry.mirror.RedisTelemetryMirror
        redis_plan_cache: Any = None,  # mcpx_torch.server.plan_cache.RedisPlanCache
        metrics: Optional[Metrics] = None,
        tracer: Optional[Tracer] = None,
        scheduler: Any = None,  # mcpx_torch.scheduler.Scheduler (None = pass-through)
    ) -> None:
        self.config = config or MCPXConfig()
        self.registry = registry
        self.planner = planner
        self.orchestrator = orchestrator
        self.telemetry = telemetry or TelemetryStore(self.config.telemetry.ewma_alpha)
        self.metrics = metrics or Metrics()
        # Read per request by the HTTP middleware, so a tracer can be
        # attached to, or swapped on, a live server.
        self.tracer = tracer if tracer is not None else Tracer(self.config.tracing)
        self.metrics.set_build_info(
            version=__version__, torch=torch.__version__, backend=_backend_label(planner)
        )
        self.retriever = retriever
        self.replan_policy = replan_policy or ReplanPolicy(self.config.telemetry)
        self.telemetry_mirror = telemetry_mirror
        self.redis_plan_cache = redis_plan_cache
        # The /plan admission scheduler: read per request by the handler,
        # so it can be attached to or detached from a live control plane.
        self.scheduler = scheduler
        # The cost ledger and the SLO tracker (None while off: the serving
        # path then carries no bill and no SLO observe).
        self.ledger = build_ledger(self.config, self.metrics)
        self.slo = build_slo_tracker(self.config)
        if self.scheduler is not None and self.slo is not None and self.config.scheduler.burn_aware:
            # Burn-aware degradation: the ladder consults the error budget's
            # global fast burn, so overload sheds burn-aware, not blind.
            attach = getattr(self.scheduler, "attach_slo", None)
            if attach is not None:
                attach(self.slo.burning)
        # The replica pool, present iff the factory wrapped the planner's
        # engine in an EnginePool. Its burn-aware placement reads the ledger
        # and the SLO tracker built just above, which did not exist when the
        # factory built the pool: they bind here.
        engine = getattr(self.planner, "engine", None)
        self.cluster = engine if hasattr(engine, "scoreboard_snapshot") else None
        if self.cluster is not None:
            self.cluster.attach_signals(slo=self.slo, ledger=self.ledger)
        # The flight recorder (None while off), after the SLO tracker: its
        # slo_burn detector watches the fast-burn signal.
        self.flight = build_flight_recorder(self)
        # Decision provenance (None while off: no trail ever begins).
        self.provenance = provenance.build_provenance(self)
        # Degradation target: the model-free shortlist planner, still over
        # the retrieval shortlist through ``_context``.
        self.degraded_planner = HeuristicPlanner(self.config.planner)
        self._plan_cache: OrderedDict[tuple[str, int], Plan] = OrderedDict()
        self._cache_writes: set = set()  # in-flight shared-tier writes
        # Plain-int plan-cache counters for GET /cache.
        self.plan_cache_stats = {"hits": 0, "redis_hits": 0, "misses": 0}

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
            try:
                await warm(self.registry)
            except Exception:  # warm is best-effort, and logged
                log.exception("registry-grammar warmup failed; first plan pays the capture")

    async def aclose(self) -> None:
        """Release the transport's sessions and stop the engine."""
        await self.orchestrator.aclose()
        engine = getattr(self.planner, "engine", None)
        if engine is not None and engine.state in ("ready", "warming"):
            await engine.aclose()

    # ------------------------------------------------------------------ plan
    async def plan(
        self,
        intent: str,
        *,
        use_cache: bool = True,
        degraded: bool = False,
        deadline_at: Optional[float] = None,
        tenant: str = "default",
    ) -> tuple[Plan, float]:
        """Plan an intent; returns (plan, latency_ms). ``degraded=True`` (the
        scheduler's degradation ladder) serves ``degraded_planner`` instead
        of the configured planner: cache reads stay on (a hit returns an
        earlier LLM plan at heuristic cost), but a degraded plan is never
        written to either cache tier, or it would go on serving after the
        ladder recovers. ``deadline_at`` (monotonic) rides the PlanContext
        to the engine so prefix-locality admission never regroups a request
        whose deadline can't afford it; ``tenant`` rides along to the
        engine's cache governor."""
        t0 = time.monotonic()
        with tracing.span("plan", path="degraded" if degraded else "primary") as sp:
            version = await self.registry.version()
            key = (intent, version)
            local_tier = self.config.planner.plan_cache_size > 0
            if use_cache and local_tier:
                cached = self._plan_cache.get(key)
                if cached is not None:
                    self._plan_cache.move_to_end(key)
                    self.plan_cache_stats["hits"] += 1
                    self.metrics.plan_cache.labels(result="hit").inc()
                    if sp is not None:
                        sp.set(cache="hit", origin=cached.origin)
                    provenance.emit("plan", "plan-cache hit (local tier)", origin=cached.origin or "unknown")
                    return cached, (time.monotonic() - t0) * 1e3  # mcpx: ignore[span-across-await-blocking] - latency_ms is a client response field, served with tracing off too
            if use_cache and self.redis_plan_cache is not None:
                # Second tier: shared across replicas/restarts, independent of
                # the local LRU (plan_cache_size=0 disables only the local
                # tier); a hit here still warms the LRU when enabled.
                shared = await self.redis_plan_cache.get(intent, version)
                if shared is not None:
                    if local_tier:
                        self._cache_put(key, shared)
                    self.plan_cache_stats["redis_hits"] += 1
                    self.metrics.plan_cache.labels(result="redis_hit").inc()
                    if sp is not None:
                        sp.set(cache="redis_hit", origin=shared.origin)
                    provenance.emit("plan", "plan-cache hit (redis tier)", origin=shared.origin or "unknown")
                    return shared, (time.monotonic() - t0) * 1e3  # mcpx: ignore[span-across-await-blocking] - latency_ms is a client response field, served with tracing off too
            if use_cache and (local_tier or self.redis_plan_cache is not None):
                self.plan_cache_stats["misses"] += 1
                self.metrics.plan_cache.labels(result="miss").inc()
                if sp is not None:
                    sp.set(cache="miss")
            planner = self.degraded_planner if degraded else self.planner
            if sp is not None:
                sp.set(planner=type(planner).__name__)
            with tracing.span("plan.context"):
                context = await self._context(
                    intent, version=version, deadline_at=deadline_at, tenant=tenant
                )
            n_spans0 = len(sp.record.spans) if sp is not None else 0
            tier0 = self._tier_counts() if provenance.active() else None
            try:
                plan = await planner.plan(intent, context)
                self.metrics.plans.labels(
                    planner=type(planner).__name__, origin=plan.origin or "unknown", status="ok"
                ).inc()
            except Exception:
                self.metrics.plans.labels(
                    planner=type(planner).__name__, origin="none", status="error"
                ).inc()
                raise
            if sp is not None:
                sp.set(origin=plan.origin or "unknown")
            if provenance.active():
                self._emit_plan_provenance(intent, plan, planner, context, degraded=degraded)
                self._emit_prefix_provenance(sp.record.spans[n_spans0:] if sp is not None else [], tier0)
            if use_cache and not degraded and local_tier:
                self._cache_put(key, plan)
            if use_cache and not degraded and self.redis_plan_cache is not None:
                self._redis_cache_write(intent, version, plan)
            return plan, (time.monotonic() - t0) * 1e3  # mcpx: ignore[span-across-await-blocking] - latency_ms is a client response field, served with tracing off too

    # ------------------------------------------------------------ provenance
    def _emit_plan_provenance(
        self, intent: str, plan: Plan, planner: Any, context: PlanContext, *, degraded: bool
    ) -> None:
        """The planner outcome's decision record (active trail only): the
        origin, the grammar mode, and the retrieval shortlist that formed
        the planner's universe, with its embedding scores where the
        retriever gives them (``contributions``)."""
        scores: dict[str, float] = {}
        sf = getattr(self.retriever, "scores_for", None)
        if sf is not None and context.shortlist:
            try:
                scores = sf(intent, list(context.shortlist))
            except Exception:  # mcpx: ignore[broad-except] - provenance must never fail a plan; the record just loses its scores
                scores = {}
        provenance.emit(
            "plan",
            f"planned via {type(planner).__name__} (origin={plan.origin or 'unknown'})",
            alternatives=list(context.shortlist or []),
            contributions=scores,
            origin=plan.origin or "unknown",
            grammar_mode=self.config.planner.constrain_names,
            degraded=degraded,
            shortlist_k=self.config.planner.shortlist_top_k,
            excluded=sorted(context.exclude) if context.exclude else [],
        )

    def _tier_counts(self) -> Optional[dict]:
        """Cumulative KV spill and readmit counts of a ready engine (a
        provenance-only read): the plan window's delta attributes tier churn
        to the request that saw it."""
        engine = getattr(self.planner, "engine", None)
        if engine is None or getattr(engine, "state", None) != "ready":
            return None
        try:
            qs = engine.queue_stats()
        except Exception:  # mcpx: ignore[broad-except] - provenance must never fail a plan; the record just loses tier signals
            return None
        return {"spills": int(qs.get("prefix_spills", 0)), "readmits": int(qs.get("prefix_readmits", 0))}

    def _emit_prefix_provenance(self, new_spans: list, tier0: Optional[dict]) -> None:
        """Prefix-cache and tier decision records from the engine worker's
        spans the plan just added. The worker thread cannot emit
        (contextvars do not cross threads), so the loop re-emits from the
        span tree after generate returns; spill and readmit churn over the
        plan window rides as signals."""
        for s in list(new_spans):
            if s.name != "engine.prefill":
                continue
            a = s.attrs
            if "prefix_matched_tokens" not in a:
                continue
            matched = int(a.get("prefix_matched_tokens", 0))
            provenance.emit(
                "prefix",
                "prefix cache " + (f"hit ({matched} tokens)" if a.get("prefix_hit") else "miss"),
                signals={"matched_tokens": matched},
            )
        tier1 = self._tier_counts() if tier0 is not None else None
        if tier0 is not None and tier1 is not None:
            d_spill = tier1["spills"] - tier0["spills"]
            d_readmit = tier1["readmits"] - tier0["readmits"]
            if d_spill > 0 or d_readmit > 0:
                provenance.emit(
                    "prefix",
                    f"kv tier churn during plan window ({d_spill} spill(s), {d_readmit} readmit(s))",
                    signals={"spills": d_spill, "readmits": d_readmit},
                )

    def _redis_cache_write(self, intent: str, version: int, plan: Plan) -> None:
        """Fire-and-forget write to the shared tier: put() swallows its own
        errors, and the plan response must not wait out a slow Redis. The
        task set keeps references so the event loop can't GC in-flight
        writes."""
        task = asyncio.create_task(self.redis_plan_cache.put(intent, version, plan))
        self._cache_writes.add(task)
        task.add_done_callback(self._cache_writes.discard)

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
        replan_prior: Optional[tuple[str, ...]] = None,
        tenant: str = "default",
    ) -> PlanContext:
        shortlist = None
        exclude = exclude or set()
        if self.retriever is not None:
            refresh = getattr(self.retriever, "maybe_refresh", None)
            if refresh is not None:
                await refresh(self.registry, version)
            # Over-fetch so excluded (replanned-around) services don't starve
            # the shortlist of viable candidates.
            k = self.config.planner.shortlist_top_k
            names = await self.retriever.shortlist(intent, k + len(exclude))
            shortlist = [n for n in names if n not in exclude][:k]
        if version is None:
            version = await self.registry.version()
        return PlanContext(
            registry=self.registry,
            telemetry=self.telemetry.snapshot(),
            shortlist=shortlist,
            exclude=exclude,
            registry_version=version,
            deadline_at=deadline_at,
            replan_prior=replan_prior,
            tenant=tenant,
        )

    # --------------------------------------------------------------- execute
    async def execute(
        self,
        plan: Plan,
        payload: dict[str, Any],
        trace: Optional[ExecutionTrace] = None,
        *,
        deadline_ms: Optional[float] = None,
    ) -> ExecuteResult:
        """``deadline_ms`` (the /execute deadline header, parsed by the
        handler only while resilience is wired) becomes the request's
        deadline budget inside the orchestrator's attempt chains."""
        return await self.orchestrator.execute(plan, payload, trace, deadline_ms=deadline_ms)

    # ------------------------------------------------------- plan_and_execute
    async def plan_and_execute(
        self, intent: str, payload: dict[str, Any], *, tenant: str = "default"
    ) -> dict[str, Any]:
        """Plan, execute, and adaptively replan around observed failures
        (bounded by ``telemetry.max_replans``).

        With the engine's radix prefix cache this is a structured program,
        not three independent calls: the plan's prompt KV is PINNED for the
        whole execution (tool calls take seconds — long enough for eviction
        to reclaim an unpinned prefix under load), and a failure-triggered
        replan renders its prompt as the ORIGINAL prompt plus a spliced-in
        suffix (an Avoid line carrying the exclusions), so the replan
        continues from the cached prefix: only its suffix is prefilled.
        The services block renders live telemetry, as the reference's
        does, so a service line whose ``err=``/``p50=`` features the
        execution changed parts the two prompts there."""
        trace = ExecutionTrace()
        plan, _ = await self.plan(intent, tenant=tenant)
        engine = getattr(self.planner, "engine", None)
        pin = None
        if engine is not None and plan.prompt_ids:
            try:
                pin = await engine.pin_prefix(plan.prompt_ids)
            except Exception:  # pinning is an optimisation
                log.debug("prefix pin failed; replans run unpinned", exc_info=True)
        try:
            result = await self.execute(plan, payload, trace)
            exclude: set[str] = set()
            prior = tuple(plan.prompt_services or ())
            while result.status != "ok" and trace.replans < self.replan_policy.max_replans:
                records = {r.name: r for r in await self.registry.list_services()}
                decision = self.replan_policy.assess(plan, result, self.telemetry, records)
                if not decision.should_replan:
                    break
                exclude |= decision.exclude
                self.metrics.replans.inc()
                trace.replans += 1
                provenance.emit(
                    "replan",
                    f"replan attempt {trace.replans}: " + ("; ".join(decision.reasons) or "policy"),
                    alternatives=sorted(decision.exclude),
                    signals={"status": result.status},
                    excluded=sorted(exclude),
                )
                context = await self._context(
                    intent, exclude, replan_prior=prior or None, tenant=tenant
                )
                try:
                    plan = await self.planner.plan(intent, context)
                except Exception:
                    # Nothing viable left to route around; keep the last
                    # result — but say so, or a planner crash mid-replan is
                    # invisible.
                    log.exception("replan attempt %d failed; keeping last result", trace.replans)
                    break
                if provenance.active():
                    # The repaired plan's origin (the replan loop calls the
                    # planner directly, not through plan()).
                    self._emit_plan_provenance(intent, plan, self.planner, context, degraded=False)
                result = await self.execute(plan, payload, trace)
        finally:
            if pin is not None:
                engine.unpin_prefix(pin)
        if trace.replans and result.status == "ok":
            # The repaired plan is the one worth caching — in EVERY enabled
            # tier; a stale failing plan left in Redis would keep re-warming
            # every replica's LRU with the plan that triggers the
            # fail->replan cycle.
            version = await self.registry.version()
            if self.config.planner.plan_cache_size > 0:
                self._cache_put((intent, version), plan)
            if self.redis_plan_cache is not None:
                self._redis_cache_write(intent, version, plan)
        return {
            "graph": plan.to_wire(),
            "results": result.results,
            "errors": result.errors,
            "status": result.status,
            "replans": trace.replans,
            # Which planner authored the final plan.
            "origin": plan.origin,
            "trace": result.trace.to_dict() if result.trace else None,
        }

    # ------------------------------------------------------------ cache stats
    def cache_stats(self) -> dict[str, Any]:
        """Combined cache observability for ``GET /cache``: the plan cache
        and the engine's radix prefix KV cache in one JSON read."""
        s = self.plan_cache_stats
        lookups = s["hits"] + s["redis_hits"] + s["misses"]
        out: dict[str, Any] = {
            "plan_cache": {
                "entries": len(self._plan_cache),
                "capacity": self.config.planner.plan_cache_size,
                "redis_tier": self.redis_plan_cache is not None,
                **s,
                "hit_rate": ((s["hits"] + s["redis_hits"]) / lookups if lookups else 0.0),
            },
            "prefix_cache": None,
        }
        engine = getattr(self.planner, "engine", None)
        stats_fn = getattr(engine, "prefix_cache_stats", None)
        if stats_fn is not None:
            out["prefix_cache"] = stats_fn()
        return out
