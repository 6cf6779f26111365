"""Per-request cost ledger & per-tenant usage attribution.

PyTorch-port copy of ``mcpx/telemetry/ledger.py``: the same bill, tenant
fold and contextvar, under the same names and JSON keys.

  - **RequestBill**: one itemized bill per serving-path request: scheduler
    queue wait, engine queue / prefill / decode walls, planner overhead
    outside the engine, tool-execution wall, suffix tokens prefilled vs
    prefix tokens served from the radix cache, decode tokens / forwards /
    accepted speculative tokens, FLOPs and HBM bytes apportioned from the
    engine's cost registry, KV page-seconds resident (readmit copy tokens
    included) and tool attempts by kind (primary/retry/fallback/hedge).
    The bill rides a contextvar through the request task; the engine
    worker contributes its items through ``GenerateResult.bill`` (a fresh
    dict built at retirement, handed across the thread by value), which
    ``InferenceEngine.generate`` folds in back on the request task.
  - **UsageLedger**: per-tenant roll-up with bounded cardinality (tenants
    past ``max_tenants`` fold into ``"other"``) and a bounded ring of
    recent bills. Tenant totals are plain ``+=`` folds of member bills in
    completion order, so a tenant's aggregate is the sum of its member
    bills folded in that order.

One declared difference: a port bill's ``flops`` and ``hbm_bytes`` are the
engine's analytic costs (``telemetry/costs.py``, ``cost_basis:
"analytic"``) where the reference's are XLA's ``cost_analysis()``, so those
two items differ between the packages by design; every other item is the
reference's. The port apportions whole FLOPs and bytes (integer shares,
the remainder to the first rows), so the bills of a burst add up exactly to
the engine's ``ledger_totals()`` and to the cost registry's executed
totals.

Off (the default) is a pass-through: no contextvar is set, the engine's
per-row accumulators are never written and ``GenerateResult.bill`` stays
None. Every duration in a bill is a monotonic-clock delta.
"""

from __future__ import annotations

import collections
import contextvars
import dataclasses
import time
from typing import Any, Optional

from mcpx_torch.utils.ownership import owned_by

__all__ = [
    "RequestBill",
    "UsageLedger",
    "activate",
    "build_ledger",
    "count_tool_attempts",
    "current_bill",
    "deactivate",
]

# The bill's wall-time items (milliseconds). They TILE the request: the
# conservation test gates their sum at >= 95% of the root span's wall.
WALL_ITEMS = (
    "sched_queue_ms",   # serving-scheduler fair-queue wait (grant latency)
    "engine_queue_ms",  # engine enqueue -> admission-prefill start
    "prefill_ms",       # admission-cohort prefill attributed to the request
    "decode_ms",        # admission -> final token (pipeline lag included)
    "plan_other_ms",    # planner wall OUTSIDE the engine: retrieval,
                        # grammar build, prompt render, cache lookups
    "tool_ms",          # DAG execution wall (tool attempts, all nodes)
)
# Unit-count items (tokens / events).
UNIT_ITEMS = (
    "prefill_tokens",        # suffix tokens actually prefilled
    "prefix_saved_tokens",   # prompt tokens served from radix-tree KV
    "decode_tokens",
    "decode_forwards",       # decode forwards the request was resident for
    "spec_accepted_tokens",  # draft tokens that survived verification
    "spill_copy_tokens",     # host->device readmit tokens its match pulled
    "kv_page_seconds",       # resident KV pages x residency seconds
    "tool_attempts",         # total executor attempts across kinds
)
# Accelerator-cost items apportioned from the cost observatory.
COST_ITEMS = ("flops", "hbm_bytes")


@dataclasses.dataclass
class RequestBill:
    """One request's itemized bill. Mutated only on the event loop inside
    the owning request's task (the engine contributes via a fresh dict on
    ``GenerateResult``); folded into the UsageLedger exactly once, at the
    middleware's finalize."""

    tenant: str = "default"
    endpoint: str = ""
    t0: float = 0.0  # monotonic, middleware entry
    status: str = "ok"
    degraded: bool = False  # served by the degradation ladder's tier
    origin: str = ""        # which planner authored the final plan
    generates: int = 0      # engine generations folded in (replans > 1)
    # -- wall items (ms) --
    sched_queue_ms: float = 0.0
    engine_queue_ms: float = 0.0
    prefill_ms: float = 0.0
    decode_ms: float = 0.0
    plan_other_ms: float = 0.0
    tool_ms: float = 0.0
    # -- unit items --
    prefill_tokens: int = 0
    prefix_saved_tokens: int = 0
    decode_tokens: int = 0
    decode_forwards: int = 0
    spec_accepted_tokens: int = 0
    spill_copy_tokens: int = 0
    kv_page_seconds: float = 0.0
    tool_attempts: int = 0
    # -- accelerator cost items --
    flops: float = 0.0
    hbm_bytes: float = 0.0
    # -- finalize --
    total_ms: float = 0.0
    other_ms: float = 0.0  # total - attributed: middleware/serialize residue
    tool_attempts_by_kind: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------ accumulate
    def engine_wall_ms(self) -> float:
        return self.engine_queue_ms + self.prefill_ms + self.decode_ms

    def add_engine(self, item: dict) -> None:
        """Fold one engine retirement's bill dict (GenerateResult.bill) —
        a replanning request generates more than once and pays for each."""
        self.generates += 1
        self.engine_queue_ms += item.get("engine_queue_ms", 0.0)
        self.prefill_ms += item.get("prefill_ms", 0.0)
        self.decode_ms += item.get("decode_ms", 0.0)
        self.prefill_tokens += item.get("prefill_tokens", 0)
        self.prefix_saved_tokens += item.get("prefix_saved_tokens", 0)
        self.decode_tokens += item.get("decode_tokens", 0)
        self.decode_forwards += item.get("decode_forwards", 0)
        self.spec_accepted_tokens += item.get("spec_accepted_tokens", 0)
        self.spill_copy_tokens += item.get("spill_copy_tokens", 0)
        self.kv_page_seconds += item.get("kv_page_seconds", 0.0)
        self.flops += item.get("flops", 0.0)
        self.hbm_bytes += item.get("hbm_bytes", 0.0)

    def note_plan(self, latency_ms: float, engine_delta_ms: float) -> None:
        """Planner wall outside the engine: the /plan handler passes the
        control plane's plan latency and the engine wall this bill gained
        during it; the difference is retrieval + grammar + prompt render +
        cache machinery."""
        self.plan_other_ms += max(0.0, latency_ms - engine_delta_ms)

    def add_tools(self, trace: Optional[dict], wall_ms: float) -> None:
        """Tool-execution accounting from an ExecutionTrace wire dict:
        attempt counts by kind (primary/retry/fallback/hedge) plus the
        execution WALL the handler measured (attempt latencies overlap
        across parallel DAG nodes, so their sum is not a wall time)."""
        self.tool_ms += max(0.0, wall_ms)
        for kind, n in count_tool_attempts(trace).items():
            self.tool_attempts_by_kind[kind] = (
                self.tool_attempts_by_kind.get(kind, 0) + n
            )
            self.tool_attempts += n

    # -------------------------------------------------------------- finalize
    def attributed_ms(self) -> float:
        return sum(getattr(self, k) for k in WALL_ITEMS)

    def finalize(self, *, status: str, total_ms: float) -> None:
        self.status = status
        self.total_ms = total_ms
        self.other_ms = max(0.0, total_ms - self.attributed_ms())

    def to_dict(self) -> dict:
        out: dict[str, Any] = {
            "tenant": self.tenant,
            "endpoint": self.endpoint,
            "status": self.status,
            "degraded": self.degraded,
            "origin": self.origin,
            "generates": self.generates,
            "total_ms": round(self.total_ms, 3),
            "other_ms": round(self.other_ms, 3),
            "attributed_frac": (
                round(self.attributed_ms() / self.total_ms, 4)
                if self.total_ms > 0
                else 0.0
            ),
        }
        for k in WALL_ITEMS:
            out[k] = round(getattr(self, k), 3)
        for k in UNIT_ITEMS:
            v = getattr(self, k)
            out[k] = round(v, 6) if isinstance(v, float) else v
        for k in COST_ITEMS:
            out[k] = float(getattr(self, k))
        if self.tool_attempts_by_kind:
            out["tool_attempts_by_kind"] = dict(self.tool_attempts_by_kind)
        return out


def count_tool_attempts(trace: Optional[dict]) -> dict[str, int]:
    """Attempt counts by kind from an ExecutionTrace wire dict (the shape
    both ``/execute`` responses and ``plan_and_execute`` results carry).
    Malformed/absent traces yield {} — billing must never fail a request."""
    counts: dict[str, int] = {}
    if not isinstance(trace, dict):
        return counts
    for node in trace.get("nodes") or []:
        if not isinstance(node, dict):
            continue
        for att in node.get("attempts") or []:
            if not isinstance(att, dict):
                continue
            kind = str(att.get("kind", "primary"))
            counts[kind] = counts.get(kind, 0) + 1
    return counts


# ------------------------------------------------------------- contextvar
# The active request's bill, propagated through the request task like the
# tracing spine's span stack. The engine worker NEVER touches this (it is
# a different thread); engine items return via GenerateResult.bill and are
# folded in by engine.generate() back on the request task.
_bill_var: "contextvars.ContextVar[Optional[RequestBill]]" = contextvars.ContextVar(
    "mcpx_request_bill", default=None
)


def current_bill() -> Optional[RequestBill]:
    return _bill_var.get()


def activate(bill: RequestBill) -> "contextvars.Token":
    return _bill_var.set(bill)


def deactivate(token: "contextvars.Token") -> None:
    _bill_var.reset(token)


# ------------------------------------------------------------ usage ledger
_AGG_FIELDS = WALL_ITEMS + UNIT_ITEMS + COST_ITEMS + ("total_ms", "other_ms")


@owned_by("event_loop")
class UsageLedger:
    """Per-tenant usage roll-up. Event-loop confined (observe() runs in
    the request middleware's finalize — the class-level mark plus the
    mark on ``observe`` itself, whose middleware call site is a nested
    def the index can't see); ``snapshot()`` is a plain dict build, safe
    from any task."""

    def __init__(self, config: Any, metrics: Any = None) -> None:
        self.config = config
        self._metrics = metrics
        self.max_tenants = int(config.max_tenants)
        self._tenants: dict[str, dict] = {}  # mcpx: owner[event_loop]
        # Bounded ring of recent finalized bills (tests/debug surface):
        # the conservation test checks tenant totals against these.
        self.recent: "collections.deque[dict]" = collections.deque(
            maxlen=max(0, int(config.recent))
        )
        self.requests = 0  # mcpx: owner[event_loop]

    def fold(self, tenant: str) -> str:
        """Bounded tenant cardinality, the cache governor's discipline:
        past ``max_tenants`` distinct names, new tenants fold into
        'other' so per-tenant aggregates (and the mcpx_ledger_* label
        space) stay bounded under tenant-id churn."""
        if tenant in self._tenants or len(self._tenants) < self.max_tenants:
            return tenant
        return "other"

    def _acct(self, tenant: str) -> dict:
        t = self.fold(tenant)
        acct = self._tenants.get(t)
        if acct is None:
            acct = {k: 0.0 for k in _AGG_FIELDS}
            acct.update(
                requests=0, errors=0, degraded=0, generates=0,
                tool_attempts_by_kind={},
            )
            self._tenants[t] = acct
        return acct

    @owned_by("event_loop")
    def observe(self, bill: RequestBill) -> None:
        """Fold one finalized bill into its tenant's aggregate, the recent
        ring, and the mcpx_ledger_* metric families. Plain ``+=`` in
        completion order: a tenant's totals are EXACTLY the sum of its
        member bills (the conservation contract)."""
        self.requests += 1
        acct = self._acct(bill.tenant)
        acct["requests"] += 1
        if bill.status not in ("ok", "throttled"):
            acct["errors"] += 1
        if bill.degraded:
            acct["degraded"] += 1
        acct["generates"] += bill.generates
        for k in _AGG_FIELDS:
            acct[k] += getattr(bill, k)
        for kind, n in bill.tool_attempts_by_kind.items():
            by_kind = acct["tool_attempts_by_kind"]
            by_kind[kind] = by_kind.get(kind, 0) + n
        if self.recent.maxlen:
            self.recent.append(bill.to_dict())
        m = self._metrics
        if m is not None:
            t = self.fold(bill.tenant)
            m.ledger_requests.labels(tenant=t, status=bill.status).inc()
            for k in WALL_ITEMS:
                v = getattr(bill, k)
                if v > 0:
                    m.ledger_wall_ms.labels(tenant=t, phase=k).inc(v)
            for k in UNIT_ITEMS:
                v = getattr(bill, k)
                if v > 0:
                    m.ledger_units.labels(tenant=t, item=k).inc(v)
            if bill.flops > 0:
                m.ledger_flops.labels(tenant=t).inc(bill.flops)
            if bill.hbm_bytes > 0:
                m.ledger_hbm_bytes.labels(tenant=t).inc(bill.hbm_bytes)

    # ---------------------------------------------------------------- views
    def tenant_totals(self, tenant: str) -> Optional[dict]:
        return self._tenants.get(self.fold(tenant))

    def snapshot(self) -> dict:
        """GET /usage: per-tenant aggregates + grand totals + the recent
        ring's size (bills themselves ship under ``recent`` so operators
        and tests can audit attribution per request)."""
        tenants = {}
        for t, acct in sorted(self._tenants.items()):
            tenants[t] = {
                k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in acct.items()
            }
        totals = {k: 0.0 for k in _AGG_FIELDS}
        totals.update(requests=0, errors=0, degraded=0, generates=0)
        for acct in self._tenants.values():
            for k in totals:
                totals[k] += acct[k]
        return {
            "enabled": True,
            "requests": self.requests,
            "tenant_count": len(self._tenants),
            "max_tenants": self.max_tenants,
            "tenants": tenants,
            "totals": {
                k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in totals.items()
            },
            "recent": list(self.recent),
        }


def build_ledger(config: Any, metrics: Any = None) -> Optional[UsageLedger]:
    """UsageLedger from MCPXConfig (None while telemetry.ledger.enabled is
    false — the serving path then never sees a bill)."""
    lcfg = config.telemetry.ledger
    if not lcfg.enabled:
        return None
    return UsageLedger(lcfg, metrics=metrics)
