"""Hedged attempts: a speculative duplicate for tail-latency primaries.

When a primary attempt has been in flight longer than a per-service hedge
delay — ``hedge_latency_factor`` × the service's EWMA latency from the
existing ``TelemetryStore``, floored by ``hedge_min_delay_s`` — the
executor launches ONE duplicate to a fallback endpoint; first success wins
and the loser is cancelled. ``HedgePolicy`` owns the two guards:

  - **cold services never hedge**: no delay until the service has
    ``hedge_min_calls`` telemetry observations (a guess would double a cold
    service's traffic exactly when nothing is known about it);
  - **hedge budget**: duplicates never exceed ``hedge_max_fraction`` of
    primary attempts, so hedging stays a tail tool, not a traffic doubler.

The port's copy of ``mcpx/resilience/hedge.py``.
"""

from __future__ import annotations

from typing import Any, Optional


class HedgePolicy:
    def __init__(self, config: Any, *, telemetry: Any = None) -> None:
        self._cfg = config
        self._telemetry = telemetry  # mcpx_torch.telemetry.stats.TelemetryStore
        self._primaries = 0
        self._hedges = 0

    def note_primary(self) -> None:
        """Count a primary attempt (the hedge budget's denominator)."""
        self._primaries += 1

    def delay_s(self, service: str) -> Optional[float]:
        """Hedge delay for ``service``; None = do not hedge this attempt."""
        if not self._cfg.hedge_enabled or self._telemetry is None:
            return None
        stats = self._telemetry.get(service)
        if stats is None or stats.calls < self._cfg.hedge_min_calls:
            return None
        return max(
            self._cfg.hedge_min_delay_s,
            stats.ewma_latency_ms / 1e3 * self._cfg.hedge_latency_factor,
        )

    def try_acquire(self) -> bool:
        """Claim hedge budget for one duplicate (called when the delay has
        actually elapsed, so denied hedges cost nothing)."""
        if self._hedges + 1 > self._cfg.hedge_max_fraction * max(1, self._primaries):
            return False
        self._hedges += 1
        return True

    @property
    def hedges_launched(self) -> int:
        return self._hedges
