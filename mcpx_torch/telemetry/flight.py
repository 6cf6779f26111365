"""The decode-loop host profiler (``WorkerProfiler``).

PyTorch-port copy of the profiler part of ``mcpx/telemetry/flight.py``
(``PROFILE_PHASES``, the histogram edges and ``WorkerProfiler``). It tiles
the engine worker thread's wall time into named phases (admit /
locality-sort / prefix-match / dispatch / sync / harvest / host
bookkeeping / idle) with ``lap()`` timestamps between loop sections and
``carve()`` for nested sub-phases, aggregated into streaming log-bucketed
histograms. Because laps tile the loop, attribution is ~100% by
construction. Detached (the default) the worker loop takes no clock reads
at all. The flight recorder, its detectors and bundles are not ported yet.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Optional

__all__ = ["PROFILE_PHASES", "WorkerProfiler"]


# Worker-loop phases. Names are the contract surfaced in queue_stats(),
# span attrs and chip_smoke.py's telemetry phases; the reference's tuple,
# unchanged.
PROFILE_PHASES = (
    "idle",              # blocking waits for work (queue.get / gather window)
    "drain",             # moving queued requests into the pending line
    "host_bookkeeping",  # gauge publish, counter folds, cancelled-row reaping
    "poll",              # admission-chain completion polls (is_ready scans)
    "spill_copy",        # spill-tier device<->host copy completion drain
    "admit",             # cohort assembly, geometry, page alloc, prefill dispatch
    "locality_sort",     # prefix-locality reorder of the pending line
    "prefix_match",      # radix-tree probes/fix-point during admission
    # Dispatch is split in two: submit is the host's cost of enqueueing a
    # segment (on the card: replaying its captured windows), sync is the
    # blocking device wait carved out of dispatch and harvest (time spent
    # waiting on compute, not on dispatch overhead). A profile where sync
    # grows as submit shrinks means the host stopped being the bottleneck.
    "dispatch_submit",   # decode-segment dispatch (window replays enqueued, host cost)
    "sync",              # blocking event waits (carved out of dispatch and harvest)
    "harvest",           # lagged flag/out_buf fetch + retirement bookkeeping
)

# Log-ish bucket edges (seconds) for the per-phase streaming histograms:
# 10 us .. 10 s, roughly x3 per step — enough resolution to split "clock
# noise" from "milliseconds on the hot loop" without per-lap allocation.
_HIST_EDGES = (
    1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0,
)


class WorkerProfiler:
    """Phase timer for the engine worker loop. Single writer (the worker
    thread);
    ``snapshot()`` is a cross-thread read of GIL-atomic scalars,
    approximate by design like ``queue_stats()``.

    Usage (worker thread): ``loop_tick()`` once at the top of each
    iteration, ``lap(phase)`` after each section — the interval since the
    previous lap is attributed to ``phase`` — and ``mark()``/``carve()``
    for a nested sub-phase carved OUT of the enclosing lap (the carved
    time is subtracted from the next lap so nothing double-counts).
    Because consecutive laps tile the loop, total attributed time equals
    wall time between the first and last lap."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter) -> None:
        self._clock = clock
        self.totals = {p: 0.0 for p in PROFILE_PHASES}
        self.counts = {p: 0 for p in PROFILE_PHASES}
        self._hist = {p: [0] * (len(_HIST_EDGES) + 1) for p in PROFILE_PHASES}
        self._t_last: Optional[float] = None
        self._carved = 0.0
        self.t_start: Optional[float] = None
        self.t_end = 0.0
        self.iterations = 0

    # ------------------------------------------------------- worker thread
    def loop_tick(self) -> None:
        if self._t_last is None:
            self._t_last = self._clock()
            self.t_start = self._t_last
        self.iterations += 1

    def lap(self, phase: str) -> None:
        now = self._clock()
        d = now - self._t_last - self._carved
        self._carved = 0.0
        self._t_last = now
        self.t_end = now
        if d > 0:
            self._add(phase, d)

    def mark(self) -> float:
        return self._clock()

    def carve(self, phase: str, t0: float) -> None:
        d = self._clock() - t0
        if d > 0:
            self._add(phase, d)
            self._carved += d

    def _add(self, phase: str, d: float) -> None:
        self.totals[phase] += d
        self.counts[phase] += 1
        self._hist[phase][bisect.bisect_right(_HIST_EDGES, d)] += 1

    def totals_copy(self) -> dict:
        return dict(self.totals)

    # --------------------------------------------------------- any thread
    @staticmethod
    def delta_ms(before: dict, after: dict) -> dict:
        """Per-phase milliseconds between two ``totals_copy`` snapshots
        (span attribution: the worker-loop breakdown during one request's
        residency). Zero phases are dropped."""
        out = {}
        for p, v in after.items():
            d = (v - before.get(p, 0.0)) * 1e3
            if d > 0.005:
                out[p] = round(d, 3)
        return out

    def _phase_p50_us(self, phase: str) -> Optional[float]:
        h = self._hist[phase]
        n = sum(h)
        if not n:
            return None
        half, acc = n / 2.0, 0
        for i, c in enumerate(h):
            acc += c
            if acc >= half:
                edge = _HIST_EDGES[min(i, len(_HIST_EDGES) - 1)]
                return round(edge * 1e6, 1)
        return round(_HIST_EDGES[-1] * 1e6, 1)

    def snapshot(self) -> dict:
        """Cross-thread profile snapshot: per-phase totals/shares/counts +
        a histogram-derived p50 lap, and the attribution fraction the
        profile's readers gate on (attributed / wall between first and
        last lap — ~1.0 by construction because laps tile the loop)."""
        t0, t1 = self.t_start, self.t_end
        wall = max(0.0, (t1 - t0)) if t0 is not None else 0.0
        totals = dict(self.totals)  # one snapshot; shares sum to 1
        attributed = sum(totals.values())
        phases = {}
        for p in PROFILE_PHASES:
            t = totals[p]
            phases[p] = {
                "total_s": round(t, 6),
                "share": round(t / attributed, 4) if attributed else 0.0,
                "count": self.counts[p],
                "p50_us": self._phase_p50_us(p),
            }
        return {
            "phases": phases,
            "wall_s": round(wall, 6),
            "attributed_s": round(attributed, 6),
            "attributed_frac": round(attributed / wall, 4) if wall else 0.0,
            "iterations": self.iterations,
        }
