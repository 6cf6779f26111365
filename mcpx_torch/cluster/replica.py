"""Replica handles: one engine instance + its pool-side bookkeeping.

A copy of ``mcpx/cluster/replica.py`` for the port. The scoreboard
(``stats``) holds the reference's queue names (``depth``, ``active``): the
pool writes them from the port engine's ``queue_stats()``.

A handle owns everything the pool knows about a replica that the engine
itself does not: lifecycle state as the POOL sees it (an engine that was
killed abruptly is "dead" here even though its own ``state`` says
"closed"), a rolling outcome window behind the breaker-adjacent error
rate, routed/affinity tallies, and the most recent ``queue_stats()``
snapshot the scoreboard refresh pulled off the request path.

All state is event-loop-confined (the repo's no-locks discipline): the
pool mutates handles from the serving loop only; the scoreboard refresh
task runs on the same loop.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Optional

from mcpx_torch.utils.ownership import owned_by

# Pool-side lifecycle. "ready" is the only routable state; "draining"
# finishes in-flight rows but takes no new traffic; "dead" replicas keep
# their slot (index identity matters for rendezvous hashing and for the
# per-replica warm-restart snapshot they rejoin from).
_ROUTABLE = ("ready",)


@owned_by("event_loop")
class ReplicaHandle:
    def __init__(self, index: int, engine: Any, *, error_window: int = 32) -> None:
        self.index = index
        self.engine = engine
        # Pool-side state: spawning -> warming -> ready -> draining -> dead.
        self.state = "spawning"  # mcpx: owner[event_loop]
        # How many times this slot has been (re)joined — generation 0 is
        # the original spawn; each rejoin bumps it so the scoreboard and
        # GET /cluster can show churn.
        self.generation = 0
        self.routed = 0
        self.affinity_hits = 0
        self.resteered_away = 0
        self.failed = 0
        # Rolling 0/1 outcome window (1 = error) behind error_rate().
        self._outcomes: deque[int] = deque(maxlen=max(1, error_window))
        # Grammar-slot residency proxy for the affinity tiebreak: the last
        # few grammar identities routed here (bounded; identity is stable
        # while the planner's grammar cache holds the object).
        self._grammars: "OrderedDict[int, None]" = OrderedDict()
        # In-flight generates routed here (drain waits on this, not on the
        # engine's own slab occupancy, which excludes queued admissions).
        self.inflight = 0
        # Last queue_stats() snapshot the scoreboard refresh captured, and
        # the monotonic timestamp it was taken at.
        self.stats: dict[str, Any] = {}
        self.stats_at: float = 0.0
        self._startup_error: Optional[BaseException] = None

    # ------------------------------------------------------------- routing
    @property
    def routable(self) -> bool:
        return self.state in _ROUTABLE and getattr(self.engine, "state", None) == "ready"

    @owned_by("event_loop")
    def note_result(self, ok: bool) -> None:
        # Marked: called only from EnginePool.generate (a coroutine) via
        # a routing result the index can't type (Optional unwrap).
        self._outcomes.append(0 if ok else 1)
        if not ok:
            self.failed += 1

    def error_rate(self) -> float:
        if not self._outcomes:
            return 0.0
        return sum(self._outcomes) / len(self._outcomes)

    @owned_by("event_loop")
    def note_grammar(self, key: Optional[int], *, cap: int = 16) -> None:
        if key is None:
            return
        self._grammars[key] = None
        self._grammars.move_to_end(key)
        while len(self._grammars) > cap:
            self._grammars.popitem(last=False)

    def holds_grammar(self, key: Optional[int]) -> bool:
        return key is not None and key in self._grammars

    # ---------------------------------------------------------- scoreboard
    def snapshot(self) -> dict[str, Any]:
        """Scoreboard row: what GET /cluster and mcpx_cluster_* publish."""
        st = self.stats
        return {
            "replica": self.index,
            "state": self.state,
            "generation": self.generation,
            "depth": int(st.get("depth", 0)),
            "active": int(st.get("active", 0)),
            "eta_s": float(st.get("eta_s", 0.0)),
            "service_ewma_s": float(st.get("service_ewma_s", 0.0)),
            "error_rate": self.error_rate(),
            "routed": self.routed,
            "affinity_hits": self.affinity_hits,
            "inflight": self.inflight,
            "failed": self.failed,
            "prefix_token_hit_rate": float(st.get("prefix_token_hit_rate", 0.0)),
            "resident_grammars": int(st.get("resident_grammars", 0)),
        }
