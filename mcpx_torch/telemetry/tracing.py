"""End-to-end request tracing: cross-layer spans, ring-buffer retention,
W3C ``traceparent`` propagation and Perfetto-loadable export.

PyTorch-port copy of ``mcpx/telemetry/tracing.py`` (standard library
only), so a trace from the port reads like one from the reference package:

  - **Span**: trace_id / span_id / parent_id, monotonic-clock start/end,
    typed attributes. Children are created either through the contextvar
    (``span(...)`` below: server, planner, orchestrator) or explicitly via
    ``parent.child(...)`` with caller-supplied timestamps, which is how the
    engine's worker THREAD attributes queue-wait / prefill / per-segment
    decode without any contextvar crossing threads. ``list.append`` onto
    the record's span list is the only cross-thread mutation (GIL-atomic),
    and the worker always appends before the request future resolves, so a
    finished record is immutable by construction.
  - **Tracer**: per-request head sampling decides whether a completed trace
    is retained; error and SLO-breach traces are ALWAYS kept (tail
    sampling). Retained traces live in a bounded in-memory ring served by
    ``GET /traces``.
  - **Export**: Chrome trace-event JSON (``ph:"X"`` complete events with
    greedy lane assignment so concurrent siblings never half-overlap on one
    track); loads directly in Perfetto / chrome://tracing.
  - Disabled (``tracing.enabled=false``) the whole spine is a no-op:
    ``start_request`` returns None, the contextvar stays None, ``span()``
    yields None without creating anything, and the engine's per-request
    guard (``GenerateRequest.span is None``) keeps the decode hot path free
    of tracing work entirely.
"""

from __future__ import annotations

import contextvars
import json
import logging
import random
import re
import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Iterator, Optional

__all__ = [
    "Span",
    "TraceRecord",
    "Tracer",
    "TraceLogFilter",
    "JsonLogFormatter",
    "activate",
    "configure_logging",
    "current_span",
    "current_trace_id",
    "format_traceparent",
    "parse_traceparent",
    "span",
]

# W3C trace-context: version "00" — 32-hex trace id, 16-hex parent span id,
# 2-hex flags. All-zero ids are invalid per spec.
_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def parse_traceparent(header: Optional[str]) -> Optional[tuple[str, str]]:
    """(trace_id, parent_span_id) from a ``traceparent`` header, or None on
    anything malformed — a bad header must never fail the request it rides."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, parent_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return trace_id, parent_id


def format_traceparent(sp: "Span") -> str:
    # Sampled flag always 01: a span we emit a header for exists.
    return f"00-{sp.record.trace_id}-{sp.span_id}-01"


class Span:
    """One timed operation in a trace. ``t0``/``t1`` are ``time.monotonic``
    seconds; ``t1 == 0.0`` means still open. Mutation is single-writer per
    span (whichever layer created it), so no lock."""

    __slots__ = ("record", "name", "span_id", "parent_id", "t0", "t1", "attrs", "status")

    def __init__(
        self,
        record: "TraceRecord",
        name: str,
        parent_id: Optional[str],
        t0: Optional[float] = None,
    ) -> None:
        self.record = record
        self.name = name
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.t0 = time.monotonic() if t0 is None else t0
        self.t1 = 0.0
        self.attrs: dict[str, Any] = {}
        self.status = "ok"

    @property
    def trace_id(self) -> str:
        return self.record.trace_id

    @property
    def duration_ms(self) -> float:
        end = self.t1 or time.monotonic()
        return (end - self.t0) * 1e3

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def child(
        self,
        name: str,
        *,
        t0: Optional[float] = None,
        t1: Optional[float] = None,
        **attrs: Any,
    ) -> "Span":
        """Create (and register) a child span. Explicit ``t0``/``t1`` let a
        layer that already measured an interval (the engine worker) record
        it after the fact; the append is GIL-atomic, safe from any thread."""
        s = Span(self.record, name, self.span_id, t0=t0)
        if t1 is not None:
            s.t1 = t1
        if attrs:
            s.attrs.update(attrs)
        # A sealed record (request already finished — timeout, disconnect)
        # drops late spans: the caller gets a valid detached Span to write
        # to, but the retained trace stays immutable.
        if not self.record.sealed:
            self.record.spans.append(s)
        return s

    def end(self, t1: Optional[float] = None) -> None:
        if self.t1 == 0.0:
            self.t1 = time.monotonic() if t1 is None else t1

    def to_dict(self) -> dict[str, Any]:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_ms": round((self.t0 - self.record.spans[0].t0) * 1e3, 3),
            "duration_ms": round(self.duration_ms, 3),
            "status": self.status,
            **({"attrs": self.attrs} if self.attrs else {}),
        }


class TraceRecord:
    """A whole request's span tree. ``spans[0]`` is the root; ``remote_parent``
    preserves an ingested ``traceparent``'s span id so the caller's tracer
    can stitch our tree under its own."""

    __slots__ = (
        "trace_id", "name", "spans", "t0_wall", "error", "sampled",
        "remote_parent", "sealed",
    )

    def __init__(
        self,
        trace_id: Optional[str] = None,
        *,
        sampled: bool = True,
        remote_parent: Optional[str] = None,
    ) -> None:
        self.trace_id = trace_id or new_trace_id()
        self.name = ""
        self.spans: list[Span] = []
        self.t0_wall = time.time()
        self.error = False
        self.sampled = sampled
        self.remote_parent = remote_parent
        # Set by Tracer.finish: a sealed record accepts no more spans.
        # Matters for the timeout/disconnect race — the response (and the
        # finish) can land while the engine worker still holds row spans
        # for the abandoned request; its late child() calls must not mutate
        # a record the ring may already be serving.
        self.sealed = False

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def total_ms(self) -> float:
        return self.root.duration_ms

    def summary(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "started_at": round(self.t0_wall, 3),
            "total_ms": round(self.total_ms, 3),
            "spans": len(self.spans),
            "error": self.error,
        }

    def to_dict(self) -> dict[str, Any]:
        return {
            **self.summary(),
            **({"remote_parent": self.remote_parent} if self.remote_parent else {}),
            "tree": [s.to_dict() for s in sorted(self.spans, key=lambda s: s.t0)],
        }

    # ----------------------------------------------------- chrome trace-event
    def to_chrome(self) -> dict[str, Any]:
        """Chrome trace-event JSON (the object form, ``traceEvents`` +
        ``displayTimeUnit``) that loads in Perfetto / chrome://tracing.
        Complete ("X") events; ``ts`` microseconds from the root's start.
        Concurrent sibling spans get distinct ``tid`` lanes (greedy
        assignment, containment-aware) because Chrome nests slices on one
        track by containment and renders partial overlaps wrong."""
        root_t0 = self.root.t0
        end_fallback = max((s.t1 or s.t0) for s in self.spans)
        ordered = sorted(self.spans, key=lambda s: (s.t0, -((s.t1 or end_fallback) - s.t0)))
        by_id = {s.span_id: s for s in self.spans}

        def is_ancestor(candidate: Span, s: Span) -> bool:
            pid = s.parent_id
            while pid is not None:
                if pid == candidate.span_id:
                    return True
                parent = by_id.get(pid)
                pid = parent.parent_id if parent is not None else None
            return False

        lanes: list[list[tuple[float, float, Span]]] = []
        events: list[dict[str, Any]] = [
            {
                "ph": "M",
                "pid": 1,
                "tid": 0,
                "name": "process_name",
                "args": {"name": f"mcpx trace {self.trace_id}"},
            }
        ]
        for s in ordered:
            a, b = s.t0, (s.t1 or end_fallback)
            tid = None
            for i, ivs in enumerate(lanes):
                # A lane fits when every resident interval either ended
                # before this span starts or is an ANCESTOR containing it
                # (real nesting). Mere containment is not enough: two
                # concurrent siblings starting together would otherwise
                # render as nested.
                if all(
                    e <= a or (p <= a and b <= e and is_ancestor(other, s))
                    for p, e, other in ivs
                ):
                    tid = i
                    ivs.append((a, b, s))
                    break
            if tid is None:
                tid = len(lanes)
                lanes.append([(a, b, s)])
            events.append(
                {
                    "ph": "X",
                    "pid": 1,
                    "tid": tid,
                    "cat": "mcpx",
                    "name": s.name,
                    "ts": round((a - root_t0) * 1e6, 1),
                    "dur": round(max(0.0, b - a) * 1e6, 1),
                    "args": {
                        "span_id": s.span_id,
                        "parent_id": s.parent_id or "",
                        "status": s.status,
                        **s.attrs,
                    },
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "trace_id": self.trace_id,
                "name": self.name,
                "started_at_unix_s": round(self.t0_wall, 6),
            },
        }


class Tracer:
    """Owns sampling policy and the bounded ring of completed traces.

    Head sampling (``sample_rate``) decides retention *intent* up front;
    the tree is still recorded for every request while tracing is enabled
    (host-side dicts and floats — noise next to a model forward), so tail
    sampling can ALWAYS keep error/SLO-breach traces the head decision
    would have dropped."""

    def __init__(self, config: Any = None, **overrides: Any) -> None:
        def knob(name: str, default: Any) -> Any:
            if name in overrides:
                return overrides[name]
            return getattr(config, name, default) if config is not None else default

        self.enabled: bool = bool(knob("enabled", True))
        self.sample_rate: float = float(knob("sample_rate", 1.0))
        self.ring_size: int = int(knob("ring_size", 256))
        self.keep_errors: bool = bool(knob("keep_errors", True))
        self.slo_breach_ms: float = float(knob("slo_breach_ms", 0.0))
        self._ring: "OrderedDict[str, TraceRecord]" = OrderedDict()
        self._lock = threading.Lock()
        self._rng = random.Random()

    # --------------------------------------------------------------- lifecycle
    def start_request(
        self, name: str, *, traceparent: Optional[str] = None, **attrs: Any
    ) -> Optional[Span]:
        """Open a root span for one request; None when tracing is disabled.
        An inbound W3C ``traceparent`` donates its trace id (distributed
        callers see one trace across hops) and is preserved as the root's
        remote parent."""
        if not self.enabled:
            return None
        parsed = parse_traceparent(traceparent)
        trace_id, remote_parent = parsed if parsed is not None else (None, None)
        sampled = self.sample_rate >= 1.0 or self._rng.random() < self.sample_rate
        rec = TraceRecord(trace_id, sampled=sampled, remote_parent=remote_parent)
        rec.name = name
        root = Span(rec, name, None)
        if attrs:
            root.attrs.update(attrs)
        rec.spans.append(root)
        return root

    def finish(self, root: Optional[Span], *, error: bool = False) -> bool:
        """Close a request's root span and decide retention: head-sampled,
        or error (keep_errors), or total latency >= slo_breach_ms. Returns
        whether the trace landed in the ring."""
        if root is None:
            return False
        root.end()
        rec = root.record
        rec.sealed = True
        rec.error = rec.error or error
        if error:
            root.status = "error"
        keep = rec.sampled
        if not keep and self.keep_errors and rec.error:
            keep = True
        if not keep and self.slo_breach_ms > 0 and rec.total_ms >= self.slo_breach_ms:
            keep = True
        if keep:
            with self._lock:
                self._ring[rec.trace_id] = rec
                self._ring.move_to_end(rec.trace_id)
                while len(self._ring) > self.ring_size:
                    self._ring.popitem(last=False)
        return keep

    # ------------------------------------------------------------------- ring
    def get(self, trace_id: str) -> Optional[TraceRecord]:
        with self._lock:
            return self._ring.get(trace_id)

    def traces(self) -> list[TraceRecord]:
        """Retained traces, newest first."""
        with self._lock:
            return list(reversed(self._ring.values()))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# --------------------------------------------------------------- propagation
_CURRENT: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "mcpx_current_span", default=None
)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    sp = _CURRENT.get()
    return sp.record.trace_id if sp is not None else None


@contextmanager
def activate(sp: Optional[Span]) -> Iterator[Optional[Span]]:
    """Make ``sp`` the context's current span for the block (middleware
    root-span installation). None deactivates cleanly (disabled tracing)."""
    token = _CURRENT.set(sp)
    try:
        yield sp
    finally:
        _CURRENT.reset(token)


@contextmanager
def span(name: str, **attrs: Any) -> Iterator[Optional[Span]]:
    """Child span under the context's current span; yields None (and records
    nothing) when no trace is active, so call sites need no enabled-checks.
    An escaping exception marks the span failed but is never swallowed."""
    parent = _CURRENT.get()
    if parent is None:
        yield None
        return
    s = parent.child(name, **attrs)
    token = _CURRENT.set(s)
    try:
        yield s
    except BaseException as e:
        s.status = "error"
        s.attrs.setdefault("error", f"{type(e).__name__}: {e}")
        raise
    finally:
        _CURRENT.reset(token)
        s.end()


# ------------------------------------------------------------ structured logs
class TraceLogFilter(logging.Filter):
    """Stamps every log record with the active trace/span ids (empty strings
    outside a request) so JSON log lines are greppable straight to their
    trace — attach to a handler, works with any formatter."""

    def filter(self, record: logging.LogRecord) -> bool:
        sp = _CURRENT.get()
        record.trace_id = sp.record.trace_id if sp is not None else ""
        record.span_id = sp.span_id if sp is not None else ""
        return True


class JsonLogFormatter(logging.Formatter):
    """One JSON object per log line; ``trace_id``/``span_id`` included when
    the record carries them (TraceLogFilter) and non-empty."""

    def format(self, record: logging.LogRecord) -> str:
        out: dict[str, Any] = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for key in ("trace_id", "span_id"):
            val = getattr(record, key, "")
            if val:
                out[key] = val
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, ensure_ascii=False)


def configure_logging(*, json_logs: bool = False, level: int = logging.INFO) -> None:
    """Root-logger setup for a serving process: trace-id stamping always,
    JSON lines when asked."""
    handler = logging.StreamHandler()
    handler.addFilter(TraceLogFilter())
    if json_logs:
        handler.setFormatter(JsonLogFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(levelname)s %(name)s %(trace_id)s %(message)s")
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(level)
