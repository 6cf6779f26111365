"""Concurrent DAG executor with retry budgets, ordered fallbacks and traces.

PyTorch-port copy of ``mcpx/orchestrator/executor.py``. The walk is
recorded three times, as in the reference: the ``ExecutionTrace`` of the
response, the request trace's ``execute`` span with a ``node:<name>`` span
per node and an ``attempt`` child per attempt, and, while a provenance
trail is active (``telemetry/provenance.py``), the ``resilience``
decisions: a breaker-open or budget-refused skip, a fallback that rescued
a node, a hedge launched and a hedge that won. ``metrics`` (the control plane's) counts ``service_calls`` and
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

With a ``Resilience`` facade wired (``mcpx_torch/resilience/``) the attempt
chain also consults per-endpoint circuit breakers (an open endpoint is
skipped straight to the next fallback), draws every attempt timeout from
the request's deadline budget (retries and backoffs the budget cannot
afford are skipped as ``status="budget"`` attempts; exhaustion fails the
node with a distinct error), and races tail-latency primaries against one
hedged duplicate to a fallback endpoint (first success wins, the loser is
cancelled, the outcome counted in ``mcpx_hedges_total``). Resilience off is
this module's attempt chain as it was, byte for byte.

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
from mcpx_torch.telemetry import provenance, tracing
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
        resilience: Any = None,  # mcpx_torch.resilience.Resilience (None = pass-through)
        rng: Optional[random.Random] = None,
    ) -> None:
        self._transport = transport
        self._cfg = config or OrchestratorConfig()
        self._registry = registry
        self._telemetry = telemetry
        self._metrics = metrics
        self._resilience = resilience
        # Injectable RNG: full-jitter backoff stays deterministic in tests.
        self._rng = rng or random.Random()
        self._sem = asyncio.Semaphore(self._cfg.max_node_concurrency)

    @property
    def resilience(self) -> Any:
        """The wired Resilience facade, or None (pass-through). Read by the
        /execute handler to decide whether the deadline header is live."""
        return self._resilience

    async def execute(
        self,
        plan: Plan,
        payload: dict[str, Any],
        trace: Optional[ExecutionTrace] = None,
        *,
        deadline_ms: Optional[float] = None,
    ) -> ExecuteResult:
        plan.validate()
        trace = trace or ExecutionTrace()
        # One monotonic budget per request, shared by every node's attempt
        # chain; None unless resilience is wired and a deadline applies
        # (the header or the configured default).
        budget = self._resilience.budget(deadline_ms) if self._resilience is not None else None
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
                    *(self._run_node(node, results, payload, trace, budget) for node in runnable)
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
        budget: Any = None,
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
                return await self._attempt_chain(node, results, payload, nt, nsp, budget)
        except Exception as e:  # mcpx: ignore[broad-except] - per-node isolation boundary; error lands in the result envelope, never swallowed
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
        budget: Any = None,
    ) -> tuple[bool, Any]:
        res = self._resilience
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
            """One attempt outcome into the trace, the telemetry EWMAs and
            the breaker window (real outcomes only: a skip or a cancellation
            observed nothing), the attempt metrics and the request trace's
            ``attempt`` span."""
            latency_ms = (t1 - t0) * 1e3
            nt.attempts.append(
                NodeAttempt(endpoint=url, kind=kind, status=status, latency_ms=latency_ms, error=error)
            )
            if status in ("ok", "error", "timeout"):
                self._record(node.service, latency_ms, ok=status == "ok")
                if res is not None:
                    res.breakers.record(url, status == "ok", service=node.service)
            if self._metrics is not None:
                self._metrics.node_attempts.labels(kind=kind, status=status).inc()
            if nsp is not None:
                extra = {"error": error} if error else {}
                nsp.child("attempt", t0=t0, t1=t1, kind=kind, status=status, endpoint=url, **extra)
            # A resilience skip is a decision, not an outcome: the chain
            # chose not to spend an attempt (no-op without a trail).
            if status == "open":
                provenance.emit(
                    "resilience", f"circuit breaker open: skipped {url}",
                    signals={"service": node.service}, kind=kind,
                )
            elif status == "budget":
                provenance.emit(
                    "resilience", f"deadline budget refused {kind} attempt at {url}",
                    signals={"service": node.service}, kind=kind,
                )

        last_error = ""
        backoff = self._cfg.retry_backoff_s
        retry_after_s: Optional[float] = None
        no_retry = False  # a non-retryable 4xx condemned the primary endpoint
        for kind, url in attempts:
            if kind == "retry" and no_retry:
                continue
            # Circuit breaker consult: an open endpoint is skipped straight
            # to the next attempt in the chain (usually the first fallback).
            # A refused primary condemns its queued retries too.
            if res is not None and not res.breakers.allow(url, service=node.service):
                now = loop.time()
                record(url, kind, "open", now, now, error="circuit breaker open")
                last_error = f"circuit breaker open for {url}"
                if kind == "primary":
                    no_retry = True
                continue
            if kind == "retry":
                # Full jitter (uniform over [0, backoff]): synchronized
                # failures must not produce synchronized retry storms. A
                # 429's Retry-After floors the draw; a wait the deadline
                # budget cannot afford (plus one minimum useful attempt)
                # skips this retry instead of sleeping through the SLO.
                delay = self._rng.uniform(0.0, backoff) if backoff > 0 else 0.0
                backoff *= self._cfg.retry_backoff_multiplier
                if retry_after_s is not None:
                    delay = max(delay, retry_after_s)
                if budget is not None and not budget.affords(delay + res.config.min_attempt_s):
                    now = loop.time()
                    record(
                        url, kind, "budget", now, now,
                        error="skipped: deadline budget cannot afford the retry backoff",
                    )
                    last_error = budget.exhausted_error()
                    continue
                if delay > 0:
                    await asyncio.sleep(delay)
            retry_after_s = None
            # Deadline budget: the attempt timeout is min(node timeout,
            # remaining budget); with less than one minimum attempt left the
            # node fails with the distinct budget error.
            timeout_s = node.timeout_s
            if budget is not None:
                remaining = budget.remaining_s()
                if remaining < res.config.min_attempt_s:
                    now = loop.time()
                    record(url, kind, "budget", now, now, error=budget.exhausted_error())
                    last_error = budget.exhausted_error()
                    break
                timeout_s = min(timeout_s, remaining)
            # Hedge eligibility: a primary attempt, resilience wired, a delay
            # from the service's telemetry, and a fallback endpoint whose
            # breaker is not open to duplicate to.
            hedge_url = hedge_delay = None
            if res is not None and kind == "primary":
                hedge_delay = res.hedge.delay_s(node.service)
                res.hedge.note_primary()
                if hedge_delay is not None and hedge_delay < timeout_s:
                    hedge_url = next((fb for fb in fallbacks if not res.breakers.is_open(fb)), None)
            t0 = loop.time()
            try:
                if hedge_url is not None:
                    response = await self._race_hedge(
                        url, hedge_url, body, timeout_s, hedge_delay, budget, record
                    )
                else:
                    try:
                        response = await self._post(url, body, timeout_s)
                    except TransportError as e:
                        record(url, kind, "timeout" if e.timeout else "error", t0, loop.time(), error=str(e))
                        raise
                    record(url, kind, "ok", t0, loop.time())
            except TransportError as e:
                last_error = str(e)
                if kind in ("primary", "retry") and not e.retryable:
                    # Deterministic 4xx rejection (not 408/429): replaying
                    # the same request at the same endpoint cannot succeed.
                    no_retry = True
                if e.status == 429 and e.retry_after_s is not None:
                    retry_after_s = e.retry_after_s
                continue
            nt.status = "ok"
            nt.finished_at = loop.time()
            if kind == "fallback":
                # The fallback chain rescuing a node: why it succeeded anyway.
                provenance.emit(
                    "resilience", f"fallback to {url} succeeded", signals={"service": node.service}
                )
            return True, response

        nt.status = "failed"
        nt.finished_at = loop.time()
        return False, last_error or "all attempts failed"

    async def _post(self, url: str, body: dict[str, Any], timeout_s: float):
        async with self._sem:
            return await self._transport.post(url, body, timeout_s)

    async def _race_hedge(
        self,
        url: str,
        hedge_url: str,
        body: dict[str, Any],
        timeout_s: float,
        hedge_delay: float,
        budget: Any,
        record,
    ) -> dict[str, Any]:
        """Race the primary attempt against one delayed duplicate to a
        fallback endpoint. The first success wins; the loser is cancelled
        (recorded as ``status="cancelled"``). The duplicate launches only
        once ``hedge_delay`` passes with the primary still in flight and the
        hedge budget grants it. Both legs failing raises the primary's error
        (else the hedge's) into the attempt chain."""
        res = self._resilience
        loop = asyncio.get_event_loop()
        flight: dict[asyncio.Task, tuple[str, str, float]] = {}

        def launch(u: str, kind: str) -> asyncio.Task:
            # Re-capped at launch: the hedge starts hedge_delay into the
            # attempt, and the full pre-race timeout would let the node
            # outlive the deadline by two capped attempts.
            to = timeout_s
            if budget is not None:
                to = min(to, max(res.config.min_attempt_s, budget.remaining_s()))
            t = asyncio.ensure_future(self._post(u, body, to))
            flight[t] = (u, kind, loop.time())
            return t

        primary_t0 = flight[launch(url, "primary")][2]
        hedge_decided = False
        primary_exc: Optional[TransportError] = None
        last_exc: Optional[TransportError] = None
        try:
            while flight:
                timeout = None if hedge_decided else max(0.0, hedge_delay - (loop.time() - primary_t0))
                done, _ = await asyncio.wait(set(flight), timeout=timeout, return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    # The hedge delay passed with the primary in flight:
                    # launch the one duplicate, if the budgets allow.
                    hedge_decided = True
                    if budget is not None and not budget.affords(res.config.min_attempt_s):
                        continue
                    if res.hedge.try_acquire():
                        res.record_hedge("launched")
                        provenance.emit(
                            "resilience", f"hedge launched to {hedge_url}",
                            signals={"hedge_delay_s": round(hedge_delay, 4)},
                        )
                        launch(hedge_url, "hedge")
                    else:
                        res.record_hedge("denied")
                    continue
                for t in done:
                    u, kind, t0 = flight.pop(t)
                    exc = t.exception()
                    t1 = loop.time()
                    if exc is None:
                        record(u, kind, "ok", t0, t1)
                        if kind == "hedge":
                            res.record_hedge("win")
                            provenance.emit("resilience", f"hedge to {u} won the race")
                        return t.result()
                    if not isinstance(exc, TransportError):
                        raise exc  # a transport bug: the node-isolation boundary reports it
                    record(u, kind, "timeout" if exc.timeout else "error", t0, t1, error=str(exc))
                    if kind == "hedge":
                        res.record_hedge("loss")
                    else:
                        primary_exc = exc
                    last_exc = exc
            raise primary_exc or last_exc or TransportError("hedged attempt produced no outcome")
        finally:
            t1 = loop.time()
            for t, (u, kind, t0) in flight.items():
                if t.done() and not t.cancelled():
                    # A loser that completed in the winner's tick: its
                    # outcome is real, so it feeds the breaker window and
                    # telemetry like any other attempt.
                    exc2 = t.exception()
                    if exc2 is None:
                        record(u, kind, "ok", t0, t1)
                    else:
                        timed_out = isinstance(exc2, TransportError) and exc2.timeout
                        record(u, kind, "timeout" if timed_out else "error", t0, t1, error=str(exc2))
                    if kind == "hedge":
                        res.record_hedge("loss" if exc2 is not None else "cancelled")
                    continue
                t.cancel()
                if kind == "hedge":
                    res.record_hedge("cancelled")
                record(u, kind, "cancelled", t0, t1, error="hedge race: the other attempt won")

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
