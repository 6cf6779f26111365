"""Deadline-budget propagation: one monotonic budget per request.

The deadline the scheduler already parses for /plan (``X-MCPX-Deadline-Ms``)
becomes, for /execute, a budget every attempt in the request's DAG draws
from: each attempt's timeout is ``min(node.timeout_s, remaining)``, retries
and backoffs the budget cannot afford are skipped, and exhaustion fails the
node with a distinct error instead of silently overshooting the SLO. The
budget is shared across a plan's concurrently-running nodes — it measures
the REQUEST's wall clock, not per-node effort. The port's copy of
``mcpx/resilience/budget.py``.
"""

from __future__ import annotations

import time
from typing import Callable


class DeadlineBudget:
    def __init__(
        self, deadline_s: float, *, clock: Callable[[], float] = time.monotonic
    ) -> None:
        self.deadline_s = deadline_s
        self._clock = clock
        self._deadline_at = clock() + deadline_s

    def remaining_s(self) -> float:
        """Seconds left; negative once the deadline has passed."""
        return self._deadline_at - self._clock()

    def affords(self, cost_s: float) -> bool:
        return self.remaining_s() >= cost_s

    def exhausted_error(self) -> str:
        """The distinct node-failure message for budget exhaustion (tested
        by prefix — keep it stable)."""
        return (
            f"deadline budget exhausted ({self.deadline_s * 1e3:.0f}ms "
            "request deadline)"
        )
