"""Deterministic schema-chaining planner.

A fast, model-free planner used (a) as the default before a checkpoint is
loaded, (b) as the repair fallback when the LLM planner exhausts its retry
budget, and (c) as a latency floor in benchmarks. It implements for real two
features the reference only advertises: cost-aware planning (reference
``README.md:41,48`` — ``cost_profile`` is never read by the reference code)
and human-readable plan explanations (``README.md:50`` — absent in code).

Algorithm:
  1. rank candidate services by lexical overlap between the intent and each
     record's schema text, minus telemetry penalties (live EWMA error-rate
     and latency from ``TelemetryStore``) and static ``cost_profile`` cost;
  2. keep the top-k scoring services (the retrieval layer's shortlist, when
     present, pre-filters candidates);
  3. wire them into a DAG by schema compatibility: service B consumes
     service A's output when an input key of B matches an output key of A —
     unmatched inputs resolve from the request payload. Services with no
     producer dependency become parallel roots (fan-out); multi-producer
     consumers become fan-in joins.
"""

from __future__ import annotations

import re
from typing import Optional

from mcpx_torch.core.config import PlannerConfig
from mcpx_torch.core.dag import DagEdge, DagNode, Plan
from mcpx_torch.core.errors import PlannerError
from mcpx_torch.planner.base import PlanContext
from mcpx_torch.registry.base import ServiceRecord

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _tokens(text: str) -> set[str]:
    return set(_TOKEN_RE.findall(text.lower()))


class HeuristicPlanner:
    def __init__(self, config: Optional[PlannerConfig] = None) -> None:
        self._cfg = config or PlannerConfig()

    async def plan(self, intent: str, context: PlanContext) -> Plan:
        services = await context.registry.list_services()
        if context.exclude:
            services = [s for s in services if s.name not in context.exclude]
        if context.shortlist:
            order = {name: i for i, name in enumerate(context.shortlist)}
            services = sorted(
                (s for s in services if s.name in order), key=lambda s: order[s.name]
            )
        if not services:
            raise PlannerError("registry is empty; nothing to plan with")

        scored = sorted(
            ((self._score(intent, s, context), s) for s in services),
            key=lambda t: (-t[0], t[1].name),
        )
        selected = [s for score, s in scored[: self._cfg.shortlist_top_k] if score > 0.0]
        if not selected:
            # No lexical signal: fall back to the single cheapest service.
            selected = [scored[0][1]]

        plan = self._chain(intent, selected)
        plan.origin = "heuristic"
        if self._cfg.explain:
            plan.explanation = self._explain(intent, selected, plan, context)
        plan.validate()
        return plan

    # ----------------------------------------------------------------- score
    def _score(self, intent: str, record: ServiceRecord, context: PlanContext) -> float:
        overlap = len(_tokens(intent) & _tokens(record.schema_text()))
        score = float(overlap)
        stats = context.telemetry.get(record.name)
        if stats is not None:
            score -= 2.0 * stats.ewma_error_rate
            score -= stats.ewma_latency_ms / 1000.0
        score -= float(record.cost_profile.get("cost", 0.0)) * 0.1
        return score

    # ----------------------------------------------------------------- chain
    @staticmethod
    def _chain(intent: str, selected: list[ServiceRecord]) -> Plan:
        producers: dict[str, str] = {}  # output key -> node name (first producer wins)
        nodes: list[DagNode] = []
        edges: list[DagEdge] = []
        for record in selected:
            inputs: dict[str, str] = {}
            deps: set[str] = set()
            for param in record.input_schema:
                producer = producers.get(param)
                if producer is not None:
                    inputs[param] = producer
                    deps.add(producer)
                else:
                    inputs[param] = param  # resolve from request payload
            nodes.append(
                DagNode(
                    name=record.name,
                    service=record.name,
                    endpoint=record.endpoint,
                    inputs=inputs,
                    fallbacks=list(record.fallbacks),
                )
            )
            for dep in sorted(deps):
                edges.append(DagEdge(src=dep, dst=record.name))
            for out_key in record.output_schema:
                producers.setdefault(out_key, record.name)
        return Plan(nodes=nodes, edges=edges, intent=intent)

    # --------------------------------------------------------------- explain
    @staticmethod
    def _explain(
        intent: str, selected: list[ServiceRecord], plan: Plan, context: PlanContext
    ) -> str:
        parts = [f"Matched {len(selected)} service(s) to intent {intent!r}."]
        for node in plan.nodes:
            wired = [f"{p}<-{src}" for p, src in node.inputs.items() if src != p]
            stats = context.telemetry.get(node.service)
            extra = (
                f" (observed p50~{stats.ewma_latency_ms:.0f}ms,"
                f" err~{stats.ewma_error_rate:.0%})"
                if stats
                else ""
            )
            parts.append(
                f"{node.name}: "
                + (f"consumes {', '.join(wired)}" if wired else "root (payload inputs)")
                + extra
            )
        gens = plan.topological_generations()
        parts.append(f"Executes in {len(gens)} stage(s): " + " -> ".join("|".join(g) for g in gens))
        return " ".join(parts)
