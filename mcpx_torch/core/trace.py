"""Structured execution traces and timing spans.

PyTorch-port copy of ``mcpx/core/trace.py``; ``ExecutionTrace.to_dict()``
is part of the ``/execute`` and ``/plan_and_execute`` wire format. Every
request gets a trace ID; every node records each attempt (endpoint, status,
latency); ``errors`` means *final* failures only, with per-attempt history
preserved in the trace.
"""

from __future__ import annotations

import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class NodeAttempt:
    endpoint: str
    # "primary" | "retry" | "fallback" | "hedge" (speculative duplicate)
    kind: str
    # "ok" | "error" | "timeout", plus the resilience skip statuses:
    # "open" (circuit breaker refused), "budget" (deadline budget could not
    # afford it), "cancelled" (hedge race: the other attempt won).
    status: str
    latency_ms: float = 0.0
    error: str = ""


@dataclass
class NodeTrace:
    name: str
    service: str = ""
    attempts: list[NodeAttempt] = field(default_factory=list)
    status: str = "pending"  # pending | ok | failed | skipped
    started_at: float = 0.0
    finished_at: float = 0.0

    @property
    def latency_ms(self) -> float:
        if self.finished_at and self.started_at:
            return (self.finished_at - self.started_at) * 1e3
        return 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "service": self.service,
            "status": self.status,
            "latency_ms": round(self.latency_ms, 3),
            "attempts": [
                {
                    "endpoint": a.endpoint,
                    "kind": a.kind,
                    "status": a.status,
                    "latency_ms": round(a.latency_ms, 3),
                    **({"error": a.error} if a.error else {}),
                }
                for a in self.attempts
            ],
        }


@dataclass
class Span:
    name: str
    started_at: float
    finished_at: float = 0.0

    @property
    def latency_ms(self) -> float:
        return (self.finished_at - self.started_at) * 1e3 if self.finished_at else 0.0


@dataclass
class ExecutionTrace:
    trace_id: str = field(default_factory=new_trace_id)
    nodes: dict[str, NodeTrace] = field(default_factory=dict)
    spans: list[Span] = field(default_factory=list)
    started_at: float = field(default_factory=time.monotonic)
    finished_at: float = 0.0
    replans: int = 0

    def node(self, name: str, service: str = "") -> NodeTrace:
        if name not in self.nodes:
            self.nodes[name] = NodeTrace(name=name, service=service)
        return self.nodes[name]

    @contextmanager
    def span(self, name: str) -> Iterator[Span]:
        s = Span(name=name, started_at=time.monotonic())
        self.spans.append(s)
        try:
            yield s
        finally:
            s.finished_at = time.monotonic()

    def finish(self) -> None:
        self.finished_at = time.monotonic()

    @property
    def total_ms(self) -> float:
        end = self.finished_at or time.monotonic()
        return (end - self.started_at) * 1e3

    def to_dict(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "total_ms": round(self.total_ms, 3),
            "replans": self.replans,
            "nodes": [t.to_dict() for t in self.nodes.values()],
            "spans": [
                {"name": s.name, "latency_ms": round(s.latency_ms, 3)} for s in self.spans
            ],
        }


@contextmanager
def timed() -> Iterator[dict[str, float]]:
    """Tiny timing helper: ``with timed() as t: ...; t["ms"]``."""
    out = {"ms": 0.0}
    t0 = time.monotonic()
    try:
        yield out
    finally:
        out["ms"] = (time.monotonic() - t0) * 1e3
