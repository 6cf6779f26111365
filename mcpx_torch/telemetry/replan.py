"""Telemetry-adaptive replanning policy.

PyTorch-port copy of ``mcpx/telemetry/replan.py``. After an execution, a
plan is re-attempted (bounded by ``max_replans``) when

  - a node finally failed (its service goes on the exclusion list), or
  - a planned service's live EWMA error-rate breaches
    ``replan_error_rate``, or
  - its observed EWMA latency exceeds ``replan_latency_factor`` × the
    registry's declared ``cost_profile.latency_ms``, or
  - its primary endpoint's circuit breaker is open (``resilience/``): the
    executor has already learned the endpoint is down, so the replan
    routes around it instead of rediscovering the outage.

The excluded services feed ``PlanContext.exclude`` so the next plan routes
around them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from mcpx_torch.core.config import TelemetryConfig
from mcpx_torch.core.dag import Plan
from mcpx_torch.orchestrator.executor import ExecuteResult
from mcpx_torch.registry.base import ServiceRecord
from mcpx_torch.telemetry.stats import TelemetryStore


@dataclass
class ReplanDecision:
    should_replan: bool
    exclude: set[str] = field(default_factory=set)
    reasons: list[str] = field(default_factory=list)


class ReplanPolicy:
    def __init__(
        self,
        config: Optional[TelemetryConfig] = None,
        *,
        breakers: Any = None,  # mcpx_torch.resilience.breaker.BreakerRegistry
    ) -> None:
        self._cfg = config or TelemetryConfig()
        self._breakers = breakers

    @property
    def max_replans(self) -> int:
        return self._cfg.max_replans

    def assess(
        self,
        plan: Plan,
        result: ExecuteResult,
        telemetry: TelemetryStore,
        records: Optional[dict[str, ServiceRecord]] = None,
    ) -> ReplanDecision:
        decision = ReplanDecision(should_replan=False)
        for name, error in result.errors.items():
            if error.startswith("skipped:"):
                continue
            try:
                service = plan.node(name).service
            except KeyError:
                service = name
            decision.exclude.add(service)
            decision.reasons.append(f"node '{name}' failed: {error}")
        if self._breakers is not None and records:
            # Circuit-breaker exclusions: a service whose primary endpoint is
            # inside an open cool-down is known-down right now; exclude it
            # even if its EWMA (dominated by older successes) looks healthy.
            for service in sorted(self._breakers.open_services(records)):
                if any(n.service == service for n in plan.nodes):
                    decision.exclude.add(service)
                    decision.reasons.append(f"service '{service}' primary endpoint circuit breaker open")
        for node in plan.nodes:
            stats = telemetry.get(node.service)
            if stats is None:
                continue
            if stats.ewma_error_rate > self._cfg.replan_error_rate:
                decision.exclude.add(node.service)
                decision.reasons.append(
                    f"service '{node.service}' error-rate {stats.ewma_error_rate:.0%} "
                    f"> {self._cfg.replan_error_rate:.0%}"
                )
            record = (records or {}).get(node.service)
            declared = float((record.cost_profile if record else {}).get("latency_ms", 0.0))
            if declared > 0 and stats.ewma_latency_ms > self._cfg.replan_latency_factor * declared:
                decision.exclude.add(node.service)
                decision.reasons.append(
                    f"service '{node.service}' latency {stats.ewma_latency_ms:.0f}ms "
                    f"> {self._cfg.replan_latency_factor:g}x declared {declared:.0f}ms"
                )
        # Replan only when the execution actually degraded; a healthy "ok"
        # run never replans even if background telemetry is noisy.
        decision.should_replan = bool(decision.exclude) and result.status != "ok"
        return decision
