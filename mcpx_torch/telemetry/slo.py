"""SLO error-budget engine: declarative objectives, multi-window
multi-burn-rate tracking, per-tenant and global budget state.

PyTorch-port copy of ``mcpx/telemetry/slo.py``, over the port's own
``LATENCY_BUCKETS`` (the same edges as the reference's).

  - **Objectives** are declarative (``slo.objectives``, defaults below): a
    latency quantile ("99% of serving-path requests under 1 s"),
    availability ("99.9% non-5xx") and a plan-quality floor ("90% of plans
    served by the primary tier, not the degradation ladder"). A latency
    threshold snaps up to an edge of the request-latency histogram, so a
    window's good-count is exactly a histogram bucket delta, per tenant.
  - **Multi-window, multi-burn-rate**: each objective tracks burn over fast
    (default 5 m / 1 h) and slow (6 h / 3 d) windows. The fast-burn signal
    is ``min(burn_5m, burn_1h)`` (both must burn, so a short blip does not
    page), and the budget period is the slowest window. Burn rate 1.0
    spends exactly the budget; the default page threshold is 14.4.
  - **Wired into the stack**: the flight recorder's ``slo_burn`` detector
    watches the fast-burn signal (``telemetry/flight.py``), and with
    ``scheduler.burn_aware`` the scheduler's degradation ladder consults
    ``burning()``.

Event-loop confined: ``observe()`` runs once per finished request in the
server middleware; reads are dict math over the bounded bucket rings. All
timing is monotonic; the injectable clock keeps the window math
deterministic in tests.
"""

from __future__ import annotations

import bisect
import time
from typing import Any, Callable, Optional

from mcpx_torch.telemetry.metrics import LATENCY_BUCKETS
from mcpx_torch.utils.ownership import owned_by

__all__ = [
    "DEFAULT_OBJECTIVES",
    "SLOObjective",
    "SLOTracker",
    "build_slo_tracker",
]

# Endpoints whose outcomes count toward plan-quality (the ladder only
# routes these); latency/availability objectives cover every limited
# endpoint the middleware feeds.
_PLAN_ENDPOINTS = ("/plan", "/plan_and_execute")

DEFAULT_OBJECTIVES: tuple[dict, ...] = (
    # 99% of serving-path requests complete within 1 s.
    {"name": "latency_p99", "kind": "latency", "threshold_ms": 1000.0,
     "target": 0.99},
    # 99.9% of serving-path requests do not 5xx/timeout.
    {"name": "availability", "kind": "availability", "target": 0.999},
    # 90% of plans served by the primary planner tier (not the ladder).
    {"name": "plan_quality", "kind": "plan_quality", "target": 0.9},
)

_KINDS = ("latency", "availability", "plan_quality")


class SLOObjective:
    """One declarative objective: which events it applies to, what makes
    an event good, and how much failure the target budgets."""

    def __init__(self, spec: dict) -> None:
        self.name = str(spec["name"])
        self.kind = str(spec["kind"])
        if self.kind not in _KINDS:
            raise ValueError(f"objective kind {self.kind!r} not in {_KINDS}")
        self.target = float(spec["target"])
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"objective target {self.target} not in (0, 1)")
        self.threshold_ms: Optional[float] = None
        if self.kind == "latency":
            raw = float(spec.get("threshold_ms", 0.0))
            if raw <= 0:
                raise ValueError("latency objective requires threshold_ms > 0")
            # Snap UP to the request-latency histogram's bucket grid: the
            # good-count is then exactly what the existing histogram's
            # le-bucket counts over the same window (bucket-delta
            # semantics, but kept per tenant).
            edges_ms = [e * 1e3 for e in LATENCY_BUCKETS]
            i = bisect.bisect_left(edges_ms, raw)
            self.threshold_ms = edges_ms[i] if i < len(edges_ms) else raw

    @property
    def budget(self) -> float:
        """The error budget: the failure fraction the target allows."""
        return 1.0 - self.target

    def applies(self, endpoint: str) -> bool:
        if self.kind == "plan_quality":
            return endpoint in _PLAN_ENDPOINTS
        return True

    def good(self, *, latency_ms: float, error: bool, degraded: bool) -> bool:
        if self.kind == "latency":
            return latency_ms <= self.threshold_ms
        if self.kind == "availability":
            return not error
        return not degraded  # plan_quality

    def spec(self) -> dict:
        out = {"name": self.name, "kind": self.kind, "target": self.target}
        if self.threshold_ms is not None:
            out["threshold_ms"] = self.threshold_ms
        return out


@owned_by("event_loop")
class SLOTracker:
    """Good/total event counts per (tenant, objective) in bounded time
    buckets; burn rates and budget remaining derived on read over the
    configured windows. Tenant cardinality folds at ``max_tenants`` (the
    cache governor's discipline); the global series is tracked under its
    own key so it never depends on the fold.

    Loop-confined (the class-level mark + the mark on ``observe``, whose
    middleware call site is a nested def the index can't see): bucket
    series are mutated only by ``observe`` on the serving loop; reads
    are plain dict math over GIL-atomic snapshots."""

    GLOBAL = "__global__"

    def __init__(
        self, config: Any, clock: Callable[[], float] = time.monotonic
    ) -> None:
        self.config = config
        self._clock = clock
        specs = list(config.objectives) or [dict(s) for s in DEFAULT_OBJECTIVES]
        self.objectives = [SLOObjective(s) for s in specs]
        self.windows_s = [float(w) for w in config.windows_s]
        self.bucket_s = float(config.bucket_s)
        self.fast_burn_threshold = float(config.fast_burn_threshold)
        self.max_tenants = int(config.max_tenants)
        # tenant -> list of buckets [t_start, {obj_name: [good, total]}],
        # oldest first, pruned past the budget period on append.
        self._buckets: dict[str, list] = {}  # mcpx: owner[event_loop]
        self.events = 0  # mcpx: owner[event_loop]

    # -------------------------------------------------------------- observe
    def fold(self, tenant: str) -> str:
        if tenant in self._buckets or len(self._buckets) < self.max_tenants + 1:
            return tenant  # +1: the GLOBAL series never competes for a slot
        return "other"

    def _series(self, tenant: str) -> list:
        return self._buckets.setdefault(tenant, [])

    def _bucket_for(self, series: list, now: float) -> dict:
        t0 = (now // self.bucket_s) * self.bucket_s
        if series and series[-1][0] == t0:
            return series[-1][1]
        counts: dict[str, list] = {}
        series.append((t0, counts))
        # Prune past the budget period (the slowest window) — amortized
        # O(1): each bucket is appended once and popped once.
        horizon = now - self.windows_s[-1] - self.bucket_s
        while series and series[0][0] < horizon:
            series.pop(0)
        return counts

    @owned_by("event_loop")
    def observe(
        self,
        *,
        tenant: str,
        endpoint: str,
        latency_ms: float,
        error: bool,
        degraded: bool = False,
    ) -> None:
        """Feed one finished serving-path request (event loop, middleware
        finalize). One call updates the tenant's series and the global."""
        self.events += 1
        now = self._clock()
        for key in (self.GLOBAL, self.fold(tenant or "default")):
            counts = self._bucket_for(self._series(key), now)
            for obj in self.objectives:
                if not obj.applies(endpoint):
                    continue
                c = counts.setdefault(obj.name, [0, 0])
                c[1] += 1
                if obj.good(
                    latency_ms=latency_ms, error=error, degraded=degraded
                ):
                    c[0] += 1

    # ---------------------------------------------------------------- reads
    def _scan(
        self,
        key: str,
        now: float,
        windows: Optional[list[float]] = None,
    ) -> dict[float, dict[str, tuple[int, int]]]:
        """ONE reversed pass over a series (newest bucket first),
        snapshotting the cumulative per-objective (good, total) counts at
        each window boundary — every window of every objective from a
        single scan, and an early break once the widest requested window
        is crossed (``windows=self.windows_s[:2]`` makes the per-grant
        ``burning()`` read touch only the fast pair's buckets)."""
        windows = list(self.windows_s if windows is None else windows)
        cum: dict[str, list] = {}
        out: dict[float, dict[str, tuple[int, int]]] = {}
        for t0, counts in reversed(self._buckets.get(key, [])):
            while windows and t0 + self.bucket_s <= now - windows[0]:
                # This bucket (and everything older) is outside the
                # narrowest remaining window: freeze its snapshot.
                out[windows.pop(0)] = {
                    k: (v[0], v[1]) for k, v in cum.items()
                }
            if not windows:
                break
            for name, (good, total) in counts.items():
                c = cum.setdefault(name, [0, 0])
                c[0] += good
                c[1] += total
        for w in windows:  # windows wider than the whole series
            out[w] = {k: (v[0], v[1]) for k, v in cum.items()}
        return out

    def _burn(self, obj: SLOObjective, good: int, total: int) -> Optional[float]:
        if total <= 0:
            return None  # no traffic in the window: burn is undefined
        bad_frac = 1.0 - good / total
        return bad_frac / obj.budget

    def _fast_burn_from(
        self, scan: dict, obj: SLOObjective
    ) -> Optional[float]:
        """min(burn) over the two FAST windows — the multi-window AND: a
        burst must sustain across both before it reads as a fast burn.
        None when either window saw no traffic."""
        burns = []
        for w in self.windows_s[:2]:
            good, total = scan[w].get(obj.name, (0, 0))
            b = self._burn(obj, good, total)
            if b is None:
                return None
            burns.append(b)
        return min(burns)

    def _objective_state(self, scan: dict, obj: SLOObjective) -> dict:
        windows = {}
        for w in self.windows_s:
            good, total = scan[w].get(obj.name, (0, 0))
            windows[f"{int(w)}s"] = {
                "good": good,
                "total": total,
                "burn_rate": (
                    round(self._burn(obj, good, total), 4)
                    if total > 0
                    else None
                ),
            }
        # Budget over the slowest window (the budget period): consumed =
        # bad events / (total * budget). remaining < 0 = overspent.
        good, total = scan[self.windows_s[-1]].get(obj.name, (0, 0))
        if total > 0:
            consumed = (total - good) / (total * obj.budget)
            remaining = round(1.0 - consumed, 4)
        else:
            remaining = 1.0
        fast = self._fast_burn_from(scan, obj)
        return {
            **obj.spec(),
            "windows": windows,
            "budget_remaining": remaining,
            "fast_burn": round(fast, 4) if fast is not None else None,
            "breaching": (
                fast is not None and fast >= self.fast_burn_threshold
            ),
        }

    def fast_burn(self, tenant: Optional[str] = None) -> Optional[float]:
        """The flight recorder's ``slo_fast_burn`` signal: the worst
        objective's multi-window fast burn (global by default). None when
        no objective has traffic in both fast windows. Scans only the
        fast window pair's buckets (early break), so the per-grant
        burn-aware ladder read stays cheap."""
        key = self.GLOBAL if tenant is None else self.fold(tenant)
        scan = self._scan(key, self._clock(), windows=self.windows_s[:2])
        burns = [
            b
            for b in (
                self._fast_burn_from(scan, obj) for obj in self.objectives
            )
            if b is not None
        ]
        return max(burns) if burns else None

    def burning(self) -> bool:
        """Whether any objective's global fast burn is at/over the page
        threshold — the budget state the burn-aware degradation ladder
        consults (scheduler.burn_aware)."""
        b = self.fast_burn()
        return b is not None and b >= self.fast_burn_threshold

    def status(self) -> dict:
        """GET /slo: per-objective burn/budget, global + per tenant —
        one bucket-ring pass per series (the global fast-burn/breaching
        block reuses the per-objective states instead of rescanning)."""
        now = self._clock()
        tenants = {}
        for key in sorted(self._buckets):
            if key == self.GLOBAL:
                continue
            scan = self._scan(key, now)
            tenants[key] = {
                "objectives": [
                    self._objective_state(scan, obj)
                    for obj in self.objectives
                ]
            }
        gscan = self._scan(self.GLOBAL, now)
        gobjs = [self._objective_state(gscan, obj) for obj in self.objectives]
        fasts = [o["fast_burn"] for o in gobjs if o["fast_burn"] is not None]
        fast = max(fasts) if fasts else None
        return {
            "enabled": True,
            "events": self.events,
            "windows_s": self.windows_s,
            "fast_burn_threshold": self.fast_burn_threshold,
            "global": {
                "objectives": gobjs,
                "fast_burn": fast,
                "breaching": (
                    fast is not None and fast >= self.fast_burn_threshold
                ),
            },
            "tenants": tenants,
        }

    def update_gauges(self, metrics: Any) -> None:
        """Refresh the mcpx_slo_* gauges (called at scrape time, like the
        HBM gauges): global budget-remaining per objective and burn rate
        per (objective, window). A window with no traffic exports 0 —
        never the last burst's stale spike (a Gauge keeps its last set
        value, so an idle server would otherwise alarm forever)."""
        scan = self._scan(self.GLOBAL, self._clock())
        for obj in self.objectives:
            st = self._objective_state(scan, obj)
            metrics.slo_budget_remaining.labels(objective=obj.name).set(
                st["budget_remaining"]
            )
            for wname, w in st["windows"].items():
                metrics.slo_burn_rate.labels(
                    objective=obj.name, window=wname
                ).set(w["burn_rate"] if w["burn_rate"] is not None else 0.0)


def build_slo_tracker(
    config: Any, clock: Callable[[], float] = time.monotonic
) -> Optional[SLOTracker]:
    """SLOTracker from MCPXConfig (None while slo.enabled is false)."""
    if not config.slo.enabled:
        return None
    return SLOTracker(config.slo, clock=clock)
