"""Per-service rolling telemetry: EWMA latency, error rate, observed cost.

PyTorch-port copy of ``mcpx/telemetry/stats.py``. The orchestrator records
every attempt; the planner reads ``snapshot()`` into its prompt features
(``err=`` and ``p50=``); the replan policy (``mcpx_torch.telemetry.replan``)
reads it to decide when observed behaviour has drifted from the plan's
assumptions.

Pure in-process and lock-free under asyncio (single event loop writer).
Peer replicas' snapshots are held SEPARATELY from local observations and
blended call-weighted at read time, so re-importing a peer snapshot is
idempotent. The Redis mirror that feeds them (``telemetry.redis_url``,
``mcpx_torch/telemetry/mirror.py``) imports them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class ServiceStats:
    service: str
    ewma_latency_ms: float = 0.0
    ewma_error_rate: float = 0.0
    ewma_cost: float = 0.0
    calls: int = 0
    errors: int = 0
    last_update: float = 0.0

    def to_dict(self) -> dict:
        return {
            "service": self.service,
            "ewma_latency_ms": round(self.ewma_latency_ms, 3),
            "ewma_error_rate": round(self.ewma_error_rate, 5),
            "ewma_cost": round(self.ewma_cost, 5),
            "calls": self.calls,
            "errors": self.errors,
        }


class TelemetryStore:
    def __init__(self, alpha: float = 0.2) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self._alpha = alpha
        self._stats: dict[str, ServiceStats] = {}
        # replica id -> {service -> ServiceStats} imported by the mirror.
        self._peers: dict[str, dict[str, ServiceStats]] = {}

    def record(
        self,
        service: str,
        *,
        latency_ms: float,
        ok: bool,
        cost: float = 0.0,
    ) -> None:
        s = self._stats.get(service)
        a = self._alpha
        if s is None:
            s = self._stats[service] = ServiceStats(
                service=service,
                ewma_latency_ms=latency_ms,
                ewma_error_rate=0.0 if ok else 1.0,
                ewma_cost=cost,
            )
        else:
            s.ewma_latency_ms = (1 - a) * s.ewma_latency_ms + a * latency_ms
            s.ewma_error_rate = (1 - a) * s.ewma_error_rate + a * (0.0 if ok else 1.0)
            s.ewma_cost = (1 - a) * s.ewma_cost + a * cost
        s.calls += 1
        if not ok:
            s.errors += 1
        s.last_update = time.monotonic()

    def get(self, service: str) -> Optional[ServiceStats]:
        """Blended view: local observations + peer replicas' snapshots,
        weighted by call counts (a peer that has called a service 100x
        dominates our 2 local calls)."""
        entries = []
        local = self._stats.get(service)
        if local is not None:
            entries.append(local)
        for peer in self._peers.values():
            s = peer.get(service)
            if s is not None:
                entries.append(s)
        return _blend(service, entries)

    def snapshot(self) -> dict[str, ServiceStats]:
        names = set(self._stats)
        for peer in self._peers.values():
            names.update(peer)
        out: dict[str, ServiceStats] = {}
        for name in names:
            s = self.get(name)
            if s is not None:
                out[name] = s
        return out

    def local_snapshot(self) -> dict[str, ServiceStats]:
        """This replica's own observations only — what the mirror exports
        (each replica exports local, so nothing is double-counted)."""
        return dict(self._stats)

    def set_peer(self, replica_id: str, stats: dict[str, ServiceStats]) -> None:
        self._peers[replica_id] = stats

    def prune_peers(self, keep) -> None:
        for rid in list(self._peers):
            if rid not in keep:
                del self._peers[rid]

    def reset(self) -> None:
        self._stats.clear()
        self._peers.clear()


def _blend(service: str, entries: list[ServiceStats]) -> Optional[ServiceStats]:
    if not entries:
        return None
    if len(entries) == 1:
        return entries[0]
    total = sum(max(1, e.calls) for e in entries)
    w = [max(1, e.calls) / total for e in entries]
    return ServiceStats(
        service=service,
        ewma_latency_ms=sum(wi * e.ewma_latency_ms for wi, e in zip(w, entries)),
        ewma_error_rate=sum(wi * e.ewma_error_rate for wi, e in zip(w, entries)),
        ewma_cost=sum(wi * e.ewma_cost for wi, e in zip(w, entries)),
        calls=sum(e.calls for e in entries),
        errors=sum(e.errors for e in entries),
        last_update=max(e.last_update for e in entries),
    )
