"""Scheduler facade: the admission -> fairness -> degradation pipeline the
/plan handler crosses before ``ControlPlane.plan``.

Usage (server/app.py):

    ctx = scheduler.context_from_headers(request.headers)
    slot = await scheduler.acquire(ctx)     # raises ShedError -> 429
    try:
        ...plan (degraded when slot.degraded)...
    finally:
        scheduler.release(slot)

``acquire`` sheds synchronously when the request cannot possibly be served
in time (rate limit, queue cap, ETA past the deadline) — the cheap refusal
that protects the engine queue — and otherwise parks the caller in the
per-tenant fair queue until a dispatch slot frees. All state is event-loop
confined: no locks, single-threaded mutation, same discipline as the
engine's host-side allocator. The port's copy of
``mcpx/scheduler/scheduler.py``; ``engine_stats`` is the port engine's
``queue_stats`` (its ``eta_s`` floors the scheduler's own estimate).
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import time
from typing import Any, Callable, Optional

from mcpx_torch.scheduler.admission import (
    RequestContext,
    ShedError,
    TokenBucket,
    ewma_update,
)
from mcpx_torch.scheduler.degrade import DegradeController
from mcpx_torch.scheduler.fairness import FairQueue


@dataclasses.dataclass
class Slot:
    """A granted dispatch slot. ``degraded`` tells the handler which
    serving tier the ladder picked AT GRANT TIME (stable for the request's
    whole lifetime even if the ladder flips mid-flight)."""

    ctx: RequestContext
    degraded: bool
    granted_at: float
    queue_wait_s: float


class Scheduler:
    def __init__(
        self,
        config: Any,  # core.config.SchedulerConfig (duck-typed: tests pass stubs)
        metrics: Any = None,  # telemetry.metrics.Metrics
        *,
        engine_stats: Optional[Callable[[], dict]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._cfg = config
        self._metrics = metrics
        self._engine_stats = engine_stats
        self._clock = clock
        self._bucket = (
            TokenBucket(config.rate_limit, config.burst, clock=clock)
            if config.rate_limit > 0
            else None
        )
        self._queue = FairQueue()
        self._degrade = DegradeController(
            slo_s=config.slo_ms / 1e3,
            degrade_threshold=config.degrade_threshold,
            recover_threshold=config.recover_threshold,
            ewma_alpha=config.ewma_alpha,
            min_hold_s=config.degrade_min_hold_s,
            clock=clock,
        )
        self._inflight = 0
        # Burn-aware degradation (SchedulerConfig.burn_aware + the SLO
        # error-budget engine, telemetry/slo.py): while the attached
        # ``burning()`` callable reports the global fast-burn signal at or
        # over the page threshold, grants route to the degraded tier even
        # before the queue-wait EWMA crosses its own threshold — the SLO
        # budget, not just the queue, decides when overload stops paying
        # LLM decode. None / burn_aware=false = the blind ladder,
        # byte-identical to the pre-SLO controller (contrast-tested).
        self._burn_aware = bool(getattr(config, "burn_aware", False))
        self._slo_burning: Optional[Callable[[], bool]] = None
        # Per-tier EWMAs of observed /plan service time (slot grant ->
        # release), seconds. Separate because the tiers differ by ~1000x:
        # ms-scale degraded completions folded into the primary estimate
        # would blind the deadline gate right after recovery, and the
        # primary's ~1s folded into the degraded estimate would shed
        # requests the heuristic could trivially serve. Both start at 0: a
        # cold scheduler never deadline-sheds on a guess — the estimators
        # earn their pessimism from real completions.
        self._service_ewma_s = 0.0
        self._degraded_ewma_s = 0.0

    def attach_slo(self, burning: Callable[[], bool]) -> None:
        """Wire the SLO tracker's ``burning()`` into the ladder (the
        control plane calls this when scheduler.burn_aware is set)."""
        self._slo_burning = burning

    def _burn_degraded(self) -> bool:
        if not self._burn_aware or self._slo_burning is None:
            return False
        try:
            return bool(self._slo_burning())
        except Exception:  # a broken budget read must never refuse a grant; degrades to the blind ladder
            return False

    # ------------------------------------------------------------- context
    def context_from_headers(self, headers: Any) -> RequestContext:
        """Parse tenant/deadline/priority from request headers (config names
        the headers). Malformed numbers fall back to defaults rather than
        rejecting — scheduling hints must never 400 a valid intent."""
        cfg = self._cfg
        tenant = headers.get(cfg.tenant_header) or "default"
        now = self._clock()
        deadline_ms = cfg.default_deadline_ms
        raw = headers.get(cfg.deadline_header)
        if raw:
            try:
                deadline_ms = float(raw)
            except ValueError:
                pass
        weight = 1.0
        raw = headers.get(cfg.priority_header)
        if raw:
            try:
                weight = min(16.0, max(0.0625, float(raw)))
            except ValueError:
                pass
        deadline_at = now + deadline_ms / 1e3 if deadline_ms > 0 else None
        return RequestContext(
            tenant=tenant, deadline_at=deadline_at, weight=weight, enqueued_at=now
        )

    # ----------------------------------------------------------------- eta
    def queue_eta_s(self) -> float:
        """Estimated wait a request joining NOW pays before dispatch: this
        scheduler's own backlog in fair-share terms — costed at the tier
        the ladder would currently serve — floored by the engine's
        reported queue ETA (the engine sees decode work the scheduler's
        grant/release accounting hasn't absorbed yet)."""
        svc = (
            self._degraded_ewma_s if self._degrade.engaged else self._service_ewma_s
        )
        own = (self._queue.depth() + 1) * svc / max(1, self._cfg.max_parallel)
        if self._degrade.engaged:
            # Degraded requests never touch the engine — flooring by its
            # backlog would keep shedding exactly when the ladder has made
            # serving cheap again.
            return own
        eng = 0.0
        if self._engine_stats is not None:
            try:
                eng = float(self._engine_stats().get("eta_s", 0.0))
            except Exception:  # an estimator must never raise; degrades to 0 on the admission hot path
                eng = 0.0
        return max(own, eng)

    @property
    def degraded(self) -> bool:
        return self._degrade.engaged

    @property
    def service_ewma_s(self) -> float:
        return self._service_ewma_s

    # ------------------------------------------------------------- acquire
    async def acquire(self, ctx: RequestContext) -> Slot:
        now = self._clock()
        # Enqueue time is THIS moment on THIS scheduler's clock — never the
        # dataclass default (real time.monotonic), which would feed garbage
        # waits into the degrade EWMA whenever a custom clock is injected.
        ctx.enqueued_at = now
        if self._bucket is not None and not self._bucket.try_acquire():
            raise self._shed(
                "rate limit exceeded",
                retry_after_s=self._bucket.eta_s(),
                outcome="shed_rate",
            )
        # Both shed gates count queued entries — purge abandoned waiters
        # (cancelled while queued: client disconnects) before letting a
        # phantom backlog 429 a live request. Only when a shed is
        # otherwise imminent: the purge is O(queue).
        if self._queue.depth() >= self._cfg.max_queue_depth:
            self._purge_abandoned()
        if self._queue.depth() >= self._cfg.max_queue_depth:
            raise self._shed(
                f"queue full ({self._cfg.max_queue_depth} waiting)",
                retry_after_s=self.queue_eta_s(),
                outcome="shed_queue",
            )
        eta = self.queue_eta_s()
        if eta > ctx.remaining_s(now) and self._purge_abandoned():
            eta = self.queue_eta_s()
        if eta > ctx.remaining_s(now):
            # The load-shedding core: the estimated queue wait ALONE blows
            # the deadline, so serving this request would burn engine time
            # on an answer the caller has already given up on.
            raise self._shed(
                f"estimated queue wait {eta:.2f}s exceeds request deadline",
                retry_after_s=eta,
                outcome="shed_deadline",
            )
        fut: "asyncio.Future[float]" = asyncio.get_running_loop().create_future()
        self._queue.push(
            ctx.tenant, (ctx, fut), weight=ctx.weight, deadline_at=ctx.deadline_at
        )
        self._gauges()
        self._dispatch()
        try:
            granted_at = await fut
        except asyncio.CancelledError:
            # Caller abandoned while queued (client disconnect / server
            # timeout): the queue entry stays but _dispatch skips resolved/
            # cancelled futures, so it costs one skipped pop, not a slot.
            if fut.done() and not fut.cancelled():
                if fut.exception() is None:
                    # The grant raced the cancellation: the slot was already
                    # counted inflight — hand it straight to the next waiter
                    # (no release(): no service happened, nothing to learn).
                    self._inflight -= 1
                    self._dispatch()
                # (fut.exception() above also marks a raced ShedError as
                # retrieved, silencing the never-retrieved warning.)
            self._gauges()
            raise
        wait_s = granted_at - ctx.enqueued_at
        degraded = self._degrade.observe_wait(wait_s)
        if not degraded:
            # Burn-aware tier pick (config-gated): a fast-burning error
            # budget degrades the grant even while queue waits look fine —
            # the multi-window burn signal carries its own hysteresis, so
            # no extra hold state is needed here.
            degraded = self._burn_degraded()
        if self._metrics is not None:
            self._metrics.sched_queue_wait.observe(wait_s)
            self._metrics.sched_decisions.labels(
                outcome="degraded" if degraded else "admitted"
            ).inc()
        self._gauges()
        return Slot(
            ctx=ctx, degraded=degraded, granted_at=granted_at, queue_wait_s=wait_s
        )

    def release(self, slot: Slot) -> None:
        self._inflight -= 1
        service_s = self._clock() - slot.granted_at
        a = self._cfg.ewma_alpha
        if slot.degraded:
            self._degraded_ewma_s = ewma_update(self._degraded_ewma_s, service_s, a)
        else:
            self._service_ewma_s = ewma_update(self._service_ewma_s, service_s, a)
        self._dispatch()
        self._gauges()

    # ------------------------------------------------------------ internal
    def _purge_abandoned(self) -> int:
        n = self._queue.purge(lambda item: item[1].done() or item[1].cancelled())
        if n:
            self._gauges()
        return n

    def _dispatch(self) -> None:
        while self._inflight < self._cfg.max_parallel:
            # Abandoned entries are discarded by the queue WITHOUT a
            # fair-share charge (they were granted no service).
            item = self._queue.pop(
                dead=lambda it: it[1].done() or it[1].cancelled()
            )
            if item is None:
                return
            ctx, fut = item
            now = self._clock()
            if ctx.deadline_at is not None and now > ctx.deadline_at:
                # Deadline expired IN the queue (the ETA estimate was too
                # optimistic): shed at dispatch rather than serve a corpse.
                # The wait this request DID endure is a real queue-pressure
                # observation — feed the ladder, or sustained overload
                # whose every victim sheds at dispatch would never engage
                # degradation (grants alone only see sub-deadline waits).
                self._degrade.observe_wait(now - ctx.enqueued_at)
                fut.set_exception(
                    self._shed(
                        "deadline expired while queued",
                        retry_after_s=self.queue_eta_s(),
                        outcome="shed_deadline",
                    )
                )
                continue
            self._inflight += 1
            fut.set_result(now)

    def _shed(self, message: str, *, retry_after_s: float, outcome: str) -> ShedError:
        floor = self._cfg.shed_retry_after_s
        err = ShedError(
            message,
            retry_after_s=max(floor, retry_after_s)
            if math.isfinite(retry_after_s)
            else floor,
            outcome=outcome,
        )
        if self._metrics is not None:
            self._metrics.sched_decisions.labels(outcome=outcome).inc()
        return err

    def _gauges(self) -> None:
        if self._metrics is not None:
            self._metrics.sched_queue_depth.set(self._queue.depth())
            self._metrics.sched_degraded.set(1.0 if self._degrade.engaged else 0.0)
