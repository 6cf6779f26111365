"""Fault-domain resilience: circuit breakers, deadline-budget propagation,
hedged attempts, and chaos injection. The port's copy of
``mcpx/resilience/``, with no import of the reference package.

``Resilience`` is the facade the factory wires into the executor: it owns
the per-endpoint ``BreakerRegistry`` and the ``HedgePolicy``, and mints one
``DeadlineBudget`` per /execute request. With ``ResilienceConfig.enabled``
false the factory wires None and the executor's attempt chain is the
byte-identical pre-resilience pass-through (same contract as
``SchedulerConfig``/``TracingConfig``).
"""

from __future__ import annotations

import math
import random
import time
from typing import Any, Callable, Optional

from mcpx_torch.resilience.breaker import BreakerRegistry, CircuitBreaker
from mcpx_torch.resilience.budget import DeadlineBudget
from mcpx_torch.resilience.chaos import ChaosProfile, ChaosTransport
from mcpx_torch.resilience.hedge import HedgePolicy

__all__ = [
    "Resilience",
    "BreakerRegistry",
    "CircuitBreaker",
    "DeadlineBudget",
    "HedgePolicy",
    "ChaosProfile",
    "ChaosTransport",
]


class Resilience:
    def __init__(
        self,
        config: Any,  # core.config.ResilienceConfig
        *,
        telemetry: Any = None,  # telemetry.stats.TelemetryStore (hedge delays)
        metrics: Any = None,  # telemetry.metrics.Metrics
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.config = config
        self.metrics = metrics
        self._clock = clock
        self.breakers = BreakerRegistry(
            config, metrics=metrics, clock=clock, rng=rng
        )
        self.hedge = HedgePolicy(config, telemetry=telemetry)

    def budget(self, deadline_ms: Optional[float]) -> Optional[DeadlineBudget]:
        """One budget per /execute request; None = unbudgeted (no header
        and no configured default). Non-finite deadlines (a "nan"/"inf"
        header survives float() parsing) fall back to the default — a NaN
        budget would skip every retry as unaffordable while never
        declaring exhaustion."""
        if deadline_ms is None or not math.isfinite(deadline_ms):
            deadline_ms = self.config.default_execute_deadline_ms
        if not deadline_ms or deadline_ms <= 0 or not math.isfinite(deadline_ms):
            return None
        return DeadlineBudget(deadline_ms / 1e3, clock=self._clock)

    def record_hedge(self, outcome: str) -> None:
        """Hedge accounting for mcpx_hedges_total{outcome}: launched | win
        | loss | denied."""
        if self.metrics is not None:
            self.metrics.hedges.labels(outcome=outcome).inc()
