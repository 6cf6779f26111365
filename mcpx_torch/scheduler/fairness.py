"""Weighted per-tenant fair queuing with earliest-deadline-first ordering
inside each tenant.

Start-time fair queuing over tenants: each tenant carries a virtual finish
tag that advances by ``1/weight`` per dispatched item, and ``pop()`` always
serves the non-empty tenant with the smallest tag. A hot tenant that floods
the queue only advances its OWN tag — a quiet tenant's first request enters
at the global virtual time and dispatches ahead of the flood's backlog, so
one hot API key cannot starve the rest (the fairness layer of the
admission -> fairness -> degradation pipeline). The port's copy of
``mcpx/scheduler/fairness.py``.

Within a tenant, items pop earliest-deadline-first (deadline-less items
rank last, FIFO among themselves): when a tenant's own requests contend,
the one closest to blowing its SLO goes first.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class _Tenant:
    # Virtual finish tag: when this tenant's NEXT dispatch would complete
    # in fair-share time. min-tag across tenants picks who pops.
    tag: float = 0.0
    # (deadline, seq, item) min-heap — EDF within the tenant.
    heap: list = field(default_factory=list)
    # Fair-share weight; the tenant's most recent push wins.
    weight: float = 1.0


class FairQueue:
    def __init__(self) -> None:
        self._tenants: dict[str, _Tenant] = {}
        self._vtime = 0.0  # global virtual time: max tag ever dispatched at
        self._seq = 0  # FIFO tiebreak within equal deadlines
        self._depth = 0

    def push(
        self,
        tenant: str,
        item: Any,
        *,
        weight: float = 1.0,
        deadline_at: Optional[float] = None,
    ) -> None:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = _Tenant(tag=self._vtime)
        elif not t.heap:
            # Idle tenant re-entering: it must not cash in virtual time
            # banked while absent (that would let an on/off tenant burst
            # ahead), nor be charged for the idle gap. Rejoin at now.
            t.tag = max(t.tag, self._vtime)
        self._seq += 1
        key = deadline_at if deadline_at is not None else math.inf
        heapq.heappush(t.heap, (key, self._seq, item))
        self._depth += 1
        # pop() charges the tenant's CURRENT weight; the last writer wins,
        # which is the behavior a client changing its priority header
        # mid-stream would expect.
        t.weight = max(1e-3, float(weight))

    def pop(self, dead=None) -> Optional[Any]:
        """Dispatch the next item (None when empty): min-tag tenant, EDF
        head within it. Advances that tenant's tag by 1/weight. Items for
        which ``dead(item)`` is true are discarded WITHOUT the fair-share
        charge — an abandoned request granted no service must not push its
        tenant's live requests behind everyone else's."""
        while True:
            best: Optional[str] = None
            best_tag = math.inf
            for name, t in self._tenants.items():
                if t.heap and t.tag < best_tag:
                    best, best_tag = name, t.tag
            if best is None:
                return None
            t = self._tenants[best]
            _, _, item = heapq.heappop(t.heap)
            self._depth -= 1
            if dead is not None and dead(item):
                continue
            self._vtime = max(self._vtime, t.tag)
            t.tag += 1.0 / t.weight
            if not t.heap and len(self._tenants) > 64:
                # Bound the tenant map: idle tenants cost a dict entry
                # forever otherwise (API keys are unbounded). Tag fairness
                # across the drop is preserved by the rejoin clamp in
                # push().
                del self._tenants[best]
            return item

    def purge(self, dead) -> int:
        """Drop queued items for which ``dead(item)`` is true (abandoned
        waiters: cancelled futures); returns how many were removed. O(n) —
        callers invoke it only when a shed decision is otherwise imminent,
        so phantom entries can cost a scan but never a 429."""
        removed = 0
        for t in self._tenants.values():
            kept = [e for e in t.heap if not dead(e[2])]
            if len(kept) != len(t.heap):
                removed += len(t.heap) - len(kept)
                heapq.heapify(kept)
                t.heap = kept
        self._depth -= removed
        return removed

    def depth(self) -> int:
        return self._depth

    def tenant_depths(self) -> dict[str, int]:
        return {n: len(t.heap) for n, t in self._tenants.items() if t.heap}
