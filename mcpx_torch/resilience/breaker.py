"""Per-endpoint circuit breakers: closed → open → half-open state machines
driven by passive outcome recording.

The executor records every attempt outcome (``BreakerRegistry.record``) and
consults ``allow`` before dispatching to an endpoint. A breaker trips open
on either signal:

  - **consecutive failures**: ``breaker_consecutive_failures`` in a row
    (fast trip for a hard-down endpoint), or
  - **rolling error rate**: failure share over the last ``breaker_window``
    outcomes reaches ``breaker_error_threshold`` (with at least
    ``breaker_min_samples`` observed — two cold failures must not condemn
    an endpoint for ``breaker_open_s``).

Open breakers refuse all traffic for ``breaker_open_s``; after the
cool-down each arrival probes the endpoint with probability
``breaker_half_open_probe_p`` (half-open). A probe success closes the
breaker; a probe failure re-opens it with a fresh cool-down. Everything is
event-loop confined (single-threaded mutation, same discipline as the
scheduler) and clock/RNG-injectable for deterministic tests. The port's
copy of ``mcpx/resilience/breaker.py``.
"""

from __future__ import annotations

import random
import time
from collections import deque
from typing import Any, Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# Gauge encoding for mcpx_breaker_state{service}: 0 healthy, 2 refusing.
STATE_VALUE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:
    def __init__(
        self,
        config: Any,  # core.config.ResilienceConfig (duck-typed: tests pass stubs)
        *,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ) -> None:
        self._cfg = config
        self._clock = clock
        self._rng = rng or random.Random()
        self.state = CLOSED
        self.opened_at = 0.0
        self._window: deque[bool] = deque(maxlen=config.breaker_window)
        self._consecutive = 0

    # ------------------------------------------------------------- consult
    def allow(self) -> bool:
        """May an attempt be dispatched to this endpoint right now?"""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._clock() - self.opened_at < self._cfg.breaker_open_s:
                return False
            # Cool-down elapsed: probe mode. The transition happens here (on
            # consult) so is_open() stays truthful without its own timer.
            self.state = HALF_OPEN
        # Half-open: probabilistic probes — a fraction of arrivals test the
        # endpoint, the rest keep falling back (no thundering probe herd).
        return self._rng.random() < self._cfg.breaker_half_open_probe_p

    def is_open(self) -> bool:
        """Still inside an open cool-down (the ReplanPolicy exclusion
        signal: half-open endpoints are probing and stay plannable)."""
        return (
            self.state == OPEN
            and self._clock() - self.opened_at < self._cfg.breaker_open_s
        )

    def effective_state(self) -> str:
        """Clock-aware state for reporting: an OPEN breaker whose cool-down
        has elapsed is half-open in effect (the .state field only flips on
        the next allow() consult) — the gauge must not call a cooled-down
        idle endpoint 'refusing'."""
        if self.state == OPEN and not self.is_open():
            return HALF_OPEN
        return self.state

    # -------------------------------------------------------------- record
    def record(self, ok: bool) -> None:
        if self.state != CLOSED:
            # A probe outcome (or a straggler dispatched before the trip):
            # success is live evidence the endpoint serves again — close;
            # failure re-opens with a fresh cool-down.
            if ok:
                self._close()
            else:
                self._trip()
            return
        self._window.append(ok)
        self._consecutive = 0 if ok else self._consecutive + 1
        if self._consecutive >= self._cfg.breaker_consecutive_failures:
            self._trip()
            return
        if len(self._window) >= self._cfg.breaker_min_samples:
            errors = sum(1 for o in self._window if not o)
            if errors / len(self._window) >= self._cfg.breaker_error_threshold:
                self._trip()

    def _trip(self) -> None:
        self.state = OPEN
        self.opened_at = self._clock()
        self._window.clear()
        self._consecutive = 0

    def _close(self) -> None:
        self.state = CLOSED
        self._window.clear()
        self._consecutive = 0


class BreakerRegistry:
    """Endpoint URL → ``CircuitBreaker``, created on first consult.

    ``service`` tags the Prometheus gauge (``mcpx_breaker_state{service}``)
    with the registry service the endpoint was consulted under — the
    operator-facing identity; breaker state itself is per endpoint URL so a
    service's fallbacks trip independently of its primary.
    """

    def __init__(
        self,
        config: Any,
        *,
        metrics: Any = None,  # telemetry.metrics.Metrics
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ) -> None:
        self._cfg = config
        self._metrics = metrics
        self._clock = clock
        self._rng = rng or random.Random()
        self._breakers: dict[str, CircuitBreaker] = {}
        # service label -> endpoints consulted under it, for the gauge.
        self._by_service: dict[str, set[str]] = {}

    def _get(self, endpoint: str, service: str = "") -> CircuitBreaker:
        if service:
            self._by_service.setdefault(service, set()).add(endpoint)
        b = self._breakers.get(endpoint)
        if b is None:
            b = self._breakers[endpoint] = CircuitBreaker(
                self._cfg, clock=self._clock, rng=self._rng
            )
        return b

    def allow(self, endpoint: str, *, service: str = "") -> bool:
        out = self._get(endpoint, service).allow()
        self._gauge(service)
        return out

    def record(self, endpoint: str, ok: bool, *, service: str = "") -> None:
        b = self._get(endpoint, service)
        before = b.state
        b.record(ok)
        if b.state != before and self._metrics is not None:
            self._metrics.breaker_transitions.labels(state=b.state).inc()
        self._gauge(service)

    def state(self, endpoint: str) -> str:
        b = self._breakers.get(endpoint)
        return b.state if b is not None else CLOSED

    def is_open(self, endpoint: str) -> bool:
        b = self._breakers.get(endpoint)
        return b.is_open() if b is not None else False

    def snapshot(self) -> dict[str, str]:
        """endpoint -> effective state, for observability surfaces (the
        flight recorder's breaker signal and diagnostic bundles). One
        dict copy — safe against concurrent consults inserting."""
        return {
            e: b.effective_state() for e, b in list(self._breakers.items())
        }

    def open_services(self, records: dict[str, Any]) -> set[str]:
        """Service names whose PRIMARY endpoint breaker is open — the
        ReplanPolicy exclusion feed (``records``: name → ServiceRecord)."""
        return {
            name
            for name, rec in records.items()
            if getattr(rec, "endpoint", "") and self.is_open(rec.endpoint)
        }

    def _gauge(self, service: str) -> None:
        """mcpx_breaker_state{service} = the WORST (most open) state across
        every endpoint consulted under the service: a healthy fallback must
        never mask the primary's open breaker."""
        if self._metrics is None or not service:
            return
        worst = max(
            (
                STATE_VALUE[self._breakers[e].effective_state()]
                for e in self._by_service.get(service, ())
                if e in self._breakers
            ),
            default=0.0,
        )
        self._metrics.breaker_state.labels(service=service).set(worst)
