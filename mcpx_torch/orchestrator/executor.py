"""Concurrent DAG executor with retry budgets, ordered fallbacks and traces.

PyTorch-port copy of ``mcpx/orchestrator/executor.py`` without the
resilience facade (circuit breakers, deadline budgets, hedged attempts),
which the factory refuses until it is ported, and without decision
provenance. The walk is recorded twice, as in the reference: the
``ExecutionTrace`` of the response, and the request trace's ``execute``
span with a ``node:<name>`` span per node and an ``attempt`` child per
attempt. ``metrics`` (the control plane's) counts ``service_calls`` and
``node_attempts``.

  - independent nodes in the same topological generation run concurrently
    under ``asyncio.gather``, bounded by one semaphore
    (``orchestrator.max_node_concurrency``);
  - per-node retry budget with full-jitter exponential backoff drawn from
    the injected ``rng``, then an *ordered* fallback-endpoint chain;
  - non-retryable 4xx statuses (everything but 408/429) skip the remaining
    retries of the same endpoint, and a 429's Retry-After is honored as the
    backoff floor;
  - ``errors`` records only *final* failures; per-attempt history lives in
    the structured trace;
  - a failed node *skips* its dependents but never aborts the walk: the
    response reports partial results.

Each declared input key resolves from accumulated upstream ``results``
first, then the request ``payload``.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field
from typing import Any, Optional

from mcpx_torch.core.config import OrchestratorConfig
from mcpx_torch.core.dag import DagNode, Plan
from mcpx_torch.core.trace import ExecutionTrace, NodeAttempt, NodeTrace
from mcpx_torch.orchestrator.transport import Transport, TransportError
from mcpx_torch.registry.base import RegistryBackend
from mcpx_torch.telemetry import tracing
from mcpx_torch.telemetry.stats import TelemetryStore


@dataclass
class ExecuteResult:
    results: dict[str, Any] = field(default_factory=dict)
    errors: dict[str, str] = field(default_factory=dict)
    trace: Optional[ExecutionTrace] = None
    status: str = "ok"  # ok | partial | failed

    def to_dict(self) -> dict[str, Any]:
        return {
            "results": self.results,
            "errors": self.errors,
            "status": self.status,
            **({"trace": self.trace.to_dict()} if self.trace else {}),
        }


class Orchestrator:
    def __init__(
        self,
        transport: Transport,
        config: Optional[OrchestratorConfig] = None,
        *,
        registry: Optional[RegistryBackend] = None,
        telemetry: Optional[TelemetryStore] = None,
        metrics: Any = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        self._transport = transport
        self._cfg = config or OrchestratorConfig()
        self._registry = registry
        self._telemetry = telemetry
        self._metrics = metrics
        # Injectable RNG: full-jitter backoff stays deterministic in tests.
        self._rng = rng or random.Random()
        self._sem = asyncio.Semaphore(self._cfg.max_node_concurrency)

    async def execute(
        self,
        plan: Plan,
        payload: dict[str, Any],
        trace: Optional[ExecutionTrace] = None,
    ) -> ExecuteResult:
        plan.validate()
        trace = trace or ExecutionTrace()
        results: dict[str, Any] = {}
        errors: dict[str, str] = {}
        failed: set[str] = set()  # failed or skipped node names
        by_name = {n.name: n for n in plan.nodes}
        preds: dict[str, list[str]] = {n.name: [] for n in plan.nodes}
        for e in plan.edges:
            preds[e.dst].append(e.src)

        with trace.span("execute"), tracing.span("execute", nodes=len(plan.nodes)):
            for generation in plan.topological_generations():
                runnable: list[DagNode] = []
                for name in generation:
                    node = by_name[name]
                    bad_preds = [p for p in preds[name] if p in failed]
                    if bad_preds:
                        failed.add(name)
                        errors[name] = f"skipped: upstream failed ({', '.join(sorted(bad_preds))})"
                        nt = trace.node(name, node.service)
                        nt.status = "skipped"
                        continue
                    runnable.append(node)
                if not runnable:
                    continue
                outcomes = await asyncio.gather(
                    *(self._run_node(node, results, payload, trace) for node in runnable)
                )
                for node, (ok, value) in zip(runnable, outcomes):
                    if ok:
                        results[node.name] = value
                    else:
                        failed.add(node.name)
                        errors[node.name] = value

        trace.finish()
        if not errors:
            status = "ok"
        elif results:
            status = "partial"
        else:
            status = "failed"
        return ExecuteResult(results=results, errors=errors, trace=trace, status=status)

    # ------------------------------------------------------------------ node
    async def _run_node(
        self,
        node: DagNode,
        results: dict[str, Any],
        payload: dict[str, Any],
        trace: ExecutionTrace,
    ) -> tuple[bool, Any]:
        """Returns ``(True, response)`` or ``(False, final_error_message)``.

        Never raises: any unexpected exception (registry backend down,
        malformed record) becomes a node failure so sibling nodes keep
        running and the partial-results contract holds.
        """
        nt = trace.node(node.name, node.service)
        try:
            nt.started_at = asyncio.get_event_loop().time()
            with tracing.span(f"node:{node.name}", service=node.service) as nsp:
                return await self._attempt_chain(node, results, payload, nt, nsp)
        except Exception as e:  # per-node isolation boundary: the error lands in the result
            nt.status = "failed"
            nt.finished_at = asyncio.get_event_loop().time()
            return False, f"internal error running node '{node.name}': {e}"

    async def _attempt_chain(
        self,
        node: DagNode,
        results: dict[str, Any],
        payload: dict[str, Any],
        nt: NodeTrace,
        nsp: Optional[tracing.Span] = None,
    ) -> tuple[bool, Any]:
        loop = asyncio.get_event_loop()
        endpoint, fallbacks = await self._resolve_endpoints(node)
        if not endpoint:
            nt.status = "failed"
            nt.finished_at = loop.time()
            if nsp is not None:
                nsp.status = "error"
                nsp.set(error=f"no endpoint for service '{node.service}'")
            return False, f"no endpoint for service '{node.service}'"

        body = dict(node.params)
        for param, src in node.inputs.items():
            if src in results:
                body[param] = results[src]
            elif src in payload:
                body[param] = payload[src]

        # Attempt chain: primary × (retries+1) with backoff, then each
        # fallback endpoint once, in declared order.
        attempts: list[tuple[str, str]] = [("primary", endpoint)]
        attempts += [("retry", endpoint)] * node.retries
        attempts += [("fallback", fb) for fb in fallbacks]

        def record(url: str, kind: str, status: str, t0: float, t1: float, error: str = "") -> None:
            """One attempt outcome into the trace, the telemetry EWMAs, the
            attempt metrics and the request trace's ``attempt`` span."""
            latency_ms = (t1 - t0) * 1e3
            nt.attempts.append(
                NodeAttempt(endpoint=url, kind=kind, status=status, latency_ms=latency_ms, error=error)
            )
            self._record(node.service, latency_ms, ok=status == "ok")
            if self._metrics is not None:
                self._metrics.node_attempts.labels(kind=kind, status=status).inc()
            if nsp is not None:
                extra = {"error": error} if error else {}
                nsp.child("attempt", t0=t0, t1=t1, kind=kind, status=status, endpoint=url, **extra)

        last_error = ""
        backoff = self._cfg.retry_backoff_s
        retry_after_s: Optional[float] = None
        no_retry = False  # a non-retryable 4xx condemned the primary endpoint
        for kind, url in attempts:
            if kind == "retry":
                if no_retry:
                    continue
                # Full jitter (uniform over [0, backoff]): synchronized
                # failures must not produce synchronized retry storms. A
                # 429's Retry-After floors the draw.
                delay = self._rng.uniform(0.0, backoff) if backoff > 0 else 0.0
                backoff *= self._cfg.retry_backoff_multiplier
                if retry_after_s is not None:
                    delay = max(delay, retry_after_s)
                if delay > 0:
                    await asyncio.sleep(delay)
            retry_after_s = None
            t0 = loop.time()
            try:
                response = await self._post(url, body, node.timeout_s)
            except TransportError as e:
                record(url, kind, "timeout" if e.timeout else "error", t0, loop.time(), error=str(e))
                last_error = str(e)
                if kind in ("primary", "retry") and not e.retryable:
                    # Deterministic 4xx rejection (not 408/429): replaying
                    # the same request at the same endpoint cannot succeed.
                    no_retry = True
                if e.status == 429 and e.retry_after_s is not None:
                    retry_after_s = e.retry_after_s
                continue
            record(url, kind, "ok", t0, loop.time())
            nt.status = "ok"
            nt.finished_at = loop.time()
            return True, response

        nt.status = "failed"
        nt.finished_at = loop.time()
        return False, last_error or "all attempts failed"

    async def _post(self, url: str, body: dict[str, Any], timeout_s: float):
        async with self._sem:
            return await self._transport.post(url, body, timeout_s)

    async def _resolve_endpoints(self, node: DagNode) -> tuple[str, list[str]]:
        """Endpoint resolution: the plan's endpoint if set, else the registry
        record (endpoints are control-plane data, never trusted from LLM
        output). Registry-declared fallbacks are appended after
        plan-declared ones."""
        endpoint = node.endpoint
        fallbacks = list(node.fallbacks)
        if self._registry is not None:
            record = await self._registry.get(node.service)
            if record is not None:
                if not endpoint:
                    endpoint = record.endpoint
                for fb in record.fallbacks:
                    if fb not in fallbacks:
                        fallbacks.append(fb)
        return endpoint, fallbacks

    async def aclose(self) -> None:
        """Release transport resources (HTTP sessions)."""
        await self._transport.close()

    def _record(self, service: str, latency_ms: float, *, ok: bool) -> None:
        if self._telemetry is not None:
            self._telemetry.record(service, latency_ms=latency_ms, ok=ok)
        if self._metrics is not None:
            self._metrics.service_calls.labels(service=service, status="ok" if ok else "error").inc()
