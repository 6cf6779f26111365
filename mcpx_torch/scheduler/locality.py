"""Prefix-locality admission ordering, EDF-safe by construction.

A copy of ``mcpx/scheduler/locality.py`` for the port.

The engine worker forms admission cohorts from its pending line; with the
radix prefix cache (engine/prefix_cache.py) the cost of admitting a
request depends on how much of its prompt is already resident as KV pages.
Sorting cohort admits by shared-prefix depth maximises co-resident sharing
(deep-match requests prefill almost nothing and their pins keep the shared
subtree warm for the next wave) — but a reorder must never sacrifice the
deadline work the serving scheduler's EDF fair queue already did
upstream.

The rule, as a pure function so the property is testable in isolation:

  1. **Urgent requests keep strict EDF order, ahead of everything.** A
     request is urgent when its age exceeds ``age_cap_s`` (the engine's
     ``fairness_timeout_s`` — the existing anti-starvation bound) or its
     deadline is within ``deadline_slack_s`` of now (it cannot afford to
     wait out a locality regroup). Urgent requests sort by (deadline,
     arrival): earliest deadline first, deadline-less FIFO behind them —
     exactly the fair queue's within-tenant order.
  2. **Everything else sorts by matched-prefix depth, descending,** FIFO
     within equal depth (stable: an empty tree reproduces arrival order
     byte-for-byte, which is what keeps ``prefix_cache=off`` admission
     identical).

A non-urgent request by definition has slack >= deadline_slack_s, and a
locality regroup delays it by at most one cohort wave — so the sort can
reorder only requests whose deadlines tolerate it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, TypeVar

T = TypeVar("T")


def locality_order(
    items: Sequence[T],
    *,
    now: float,
    depth_of: Callable[[T], int],
    enqueued_of: Callable[[T], float],
    deadline_of: Callable[[T], Optional[float]],
    age_cap_s: float,
    deadline_slack_s: float,
) -> list[T]:
    """Return ``items`` reordered per the module rule. Pure and stable;
    callers pass accessors so GenerateRequest (engine) and test stubs
    share one implementation."""
    urgent: list[T] = []
    rest: list[T] = []
    for it in items:
        dl = deadline_of(it)
        if (now - enqueued_of(it)) > age_cap_s or (
            dl is not None and dl - now <= deadline_slack_s
        ):
            urgent.append(it)
        else:
            rest.append(it)
    urgent.sort(
        key=lambda it: (
            deadline_of(it) if deadline_of(it) is not None else math.inf,
            enqueued_of(it),
        )
    )
    rest.sort(key=lambda it: (-depth_of(it), enqueued_of(it)))
    return urgent + rest
