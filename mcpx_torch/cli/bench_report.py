"""``python -m mcpx_torch.cli bench report`` — regression tracking over the BENCH_r*.json series.

The repo accumulates one bench artifact per round (BENCH_r01.json …), each
either the bench's own one-line JSON or a runner's wrapper
(``{"cmd", "rc", "parsed", ...}`` with the bench line under ``parsed``).
Until now the series was write-only: nothing compared run N to the runs
before it, so a regression had to be spotted by a human diffing JSON
(ROADMAP item 5's "regression tracking across BENCH_r*.json"). This module
closes the loop:

  - **Scenario keying**: runs are only compared within the same scenario —
    (model, backend, vocab, quantize, registry mode, n_services,
    measurement basis). A CPU proxy run never regresses against a TPU
    run; mismatched runs are listed as excluded, not silently mixed. The
    measurement basis (jnp-proxy / interpret-kernel / real-TPU) is a
    first-class dimension since r10 — r09's interpreter switch changed
    what the numbers MEASURE, and such a shift must read as a new series,
    not a regression. Artifacts predating the field get the basis derived
    from what they recorded (backend, pallas flag, pallas_paths presence).
  - **Noise bands**: per metric, the relative spread of the PRIOR runs
    (median absolute deviation, doubled) sets the band; with fewer than
    three priors the band falls back to ``DEFAULT_BAND`` (25% — the CPU
    proxy's observed run-to-run jitter). A delta inside the band is noise
    by definition.
  - **Verdict**: per metric ``ok | improved | regressed | new | missing``
    against the median of prior runs, in the metric's good direction;
    overall ``regressed`` iff any tracked metric regressed beyond its
    band.

bench.py embeds the same report into every new run's output JSON (the
``regression`` block), so the artifact carries its own verdict; the CLI
recomputes it offline over any file set. Stdlib-only by design — the CLI
must run without jax.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
from typing import Any, Optional

# Tracked metrics: (dotted path into the bench JSON, good direction,
# optional basis path). "value" is the headline plans_per_sec (bench prints
# it under metric/value). A metric with a basis path is only compared
# against prior runs whose basis matches the latest run's — mfu changed
# measurement basis across rounds (analytic datasheet/measured-matmul ->
# XLA cost_analysis), and a basis shift is a measurement change, not a
# performance change.
TRACKED_METRICS: tuple[tuple[str, str, Optional[str]], ...] = (
    ("value", "higher", None),
    ("p50_ms", "lower", None),
    ("p99_ms", "lower", None),
    ("sat_p50_ms", "lower", None),
    ("decode_tok_s", "higher", None),
    ("tok_per_forward", "higher", None),
    ("mfu", "higher", "mfu_basis"),
    ("mixed.speedup", "higher", None),
    ("spec_speedup", "higher", None),
    ("prefill_tokens_per_request", "lower", None),
    ("prefix_hit_rate", "higher", None),
    ("replan_p50_warm_ms", "lower", None),
    ("replan_warm_sat_p50_ms", "lower", None),
    ("flight_overhead_frac", "lower", None),
    ("ledger_overhead_frac", "lower", None),
    ("provenance_overhead_frac", "lower", None),
    ("explanation_coverage", "higher", None),
    ("decode_dispatches_per_token", "lower", None),
    ("fused_decode_speedup", "higher", None),
    ("attribution.wall_attributed_frac", "higher", None),
    ("tier_token_hit_rate", "higher", None),
    ("tier_hit_ratio", "higher", None),
    ("victim_token_hit_rate", "higher", None),
    ("warm_restart_prefill_ratio", "higher", None),
    ("chaos_success_rate", "higher", None),
    ("deadline_overrun_share", "lower", None),
    ("cluster_scaling_linearity", "higher", None),
    ("cluster_p99_one_down_ratio", "lower", None),
    ("cluster_routed_token_hit_rate", "higher", None),
    ("cluster_affinity_hit_margin", "higher", None),
    ("cluster_warm_rejoin_prefill_ratio", "higher", None),
    ("plan_quality_trained.score", "higher", None),
)

# Fallback relative noise band when the series is too short to estimate
# one (< 3 prior values): the CPU proxy's bench numbers routinely move
# ~this much run-to-run with no code change.
DEFAULT_BAND = 0.25
# Floor under estimated bands: even a freakishly-stable series should not
# flag 1% wiggles on a shared-core host.
MIN_BAND = 0.05

# Absolute noise floors for paired-difference fractions whose TRUE value
# is ~0 (overhead of a feature vs. the same run without it, share of
# requests past a deadline). A relative band is meaningless against a
# near-zero median — r08..r10 flagged flight_overhead_frac "regressed"
# for moving 0.018 -> 0.054 when both numbers are timer jitter. When the
# latest value AND the prior median both sit within the floor of zero,
# the metric reads ``ok`` regardless of the relative delta; a value that
# ESCAPES its floor is judged by the usual band. Floors are calibrated
# from the observed run-to-run scatter of the CPU-proxy series.
NOISE_FLOORS: dict[str, float] = {
    "flight_overhead_frac": 0.06,
    "ledger_overhead_frac": 0.10,
    "provenance_overhead_frac": 0.06,
    "deadline_overrun_share": 0.02,
}

_SCENARIO_KEYS = (
    "model", "backend", "vocab", "quantize", "registry", "n_services",
    "measurement_basis",
)


def _derive_basis(run: dict) -> str:
    """Measurement basis for artifacts that predate the explicit field:
    the TPU backend is real hardware; on the CPU proxy, ``pallas_paths``
    appeared in the same round (r09) the interpreter became the kernel
    route, so pallas=true WITH the block means interpret-kernel and
    everything earlier is the fused-jnp reference."""
    if run.get("backend") == "tpu":
        return "real-TPU"
    if run.get("pallas") and run.get("pallas_paths") is not None:
        return "interpret-kernel"
    return "jnp-proxy"


def _unwrap(obj: dict) -> Optional[dict]:
    """The bench payload from either a raw bench line or a runner's
    ``{"parsed": ...}`` wrapper; None when neither shape matches. Backfills
    ``measurement_basis`` on pre-r10 artifacts so the scenario key never
    wildcards across a basis change."""
    if not isinstance(obj, dict):
        return None
    if isinstance(obj.get("parsed"), dict):
        obj = obj["parsed"]
    if obj.get("metric") != "plans_per_sec":
        return None
    obj.setdefault("measurement_basis", _derive_basis(obj))
    return obj


def _scenario(run: dict) -> tuple:
    return tuple(str(run.get(k)) for k in _SCENARIO_KEYS)


def _scenario_matches(a: dict, b: dict) -> bool:
    """Same scenario, with ABSENT keys as wildcards: older rounds predate
    some scenario fields (r03 has no ``vocab``), and a missing key means
    'the then-only default', not 'a different workload'."""
    for k in _SCENARIO_KEYS:
        va, vb = a.get(k), b.get(k)
        if va is not None and vb is not None and va != vb:
            return False
    return True


def _get_path_raw(obj: Any, dotted: str) -> Any:
    cur = obj
    for part in dotted.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


def _get_path(obj: Any, dotted: str) -> Optional[float]:
    cur = _get_path_raw(obj, dotted)
    return float(cur) if isinstance(cur, (int, float)) and not isinstance(cur, bool) else None


def load_runs(paths: list[str]) -> list[tuple[str, dict]]:
    """(name, payload) per readable bench artifact, input order preserved
    (the series is ordered by round number via sorted filenames)."""
    out: list[tuple[str, dict]] = []
    for p in paths:
        try:
            with open(p) as f:
                obj = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        run = _unwrap(obj)
        if run is not None:
            out.append((os.path.basename(p), run))
    return out


def default_series(root: str = ".") -> list[str]:
    return sorted(glob.glob(os.path.join(root, "BENCH_r*.json")))


def _band(priors: list[float]) -> float:
    """Relative noise band from prior values: 2x the median absolute
    deviation over the median, floored — or the default on a short series."""
    if len(priors) < 3:
        return DEFAULT_BAND
    med = statistics.median(priors)
    if med == 0:
        return DEFAULT_BAND
    mad = statistics.median(abs(v - med) for v in priors)
    return max(MIN_BAND, 2.0 * mad / abs(med))


def _metric_verdict(
    latest: Optional[float],
    priors: list[float],
    direction: str,
    floor: Optional[float] = None,
) -> dict:
    if latest is None and not priors:
        return {"verdict": "missing"}
    if latest is None:
        # The metric existed in prior rounds and vanished: surfaced loudly
        # (the report's top-level `missing` list) but NOT counted as a
        # performance regression — optional phases are legitimately
        # skippable per run (MCPX_BENCH_SPEC=0 nulls spec_speedup), and
        # silently-dropped FIELDS are the schema gate's job
        # (tests/test_bench_schema.py), which fails tier-1, not a verdict.
        return {"verdict": "missing", "previous_median": statistics.median(priors)}
    if not priors:
        return {"verdict": "new", "latest": latest}
    med = statistics.median(priors)
    band = _band(priors)
    delta = (latest - med) / abs(med) if med != 0 else (0.0 if latest == 0 else 1.0)
    worse = -delta if direction == "higher" else delta
    if floor is not None and abs(latest) <= floor and abs(med) <= floor:
        # Both sides of the comparison are within the absolute noise
        # floor of zero: the relative delta is jitter over jitter.
        verdict = "ok"
    elif worse > band:
        verdict = "regressed"
    elif -worse > band:
        verdict = "improved"
    else:
        verdict = "ok"
    mv = {
        "verdict": verdict,
        "latest": latest,
        "previous_median": med,
        "delta_frac": round(delta, 4),
        "band_frac": round(band, 4),
        "n_priors": len(priors),
    }
    if floor is not None:
        mv["floor_abs"] = floor
    return mv


def build_report(
    runs: list[tuple[str, dict]], current: Optional[dict] = None
) -> dict:
    """Regression report for the newest run (``current`` if given, else the
    last of ``runs``) against the prior runs of the SAME scenario."""
    if current is not None:
        runs = list(runs) + [("<current>", current)]
    if not runs:
        return {"verdict": "no_series", "runs": [], "metrics": {}}
    latest_name, latest = runs[-1]
    scenario = _scenario(latest)
    comparable = [(n, r) for n, r in runs[:-1] if _scenario_matches(r, latest)]
    excluded = [n for n, r in runs[:-1] if not _scenario_matches(r, latest)]
    metrics: dict[str, dict] = {}
    regressions: list[str] = []
    missing: list[str] = []
    for path, direction, basis_path in TRACKED_METRICS:
        pool = comparable
        if basis_path is not None:
            latest_basis = _get_path_raw(latest, basis_path)
            pool = [
                (n, r) for n, r in comparable
                if _get_path_raw(r, basis_path) == latest_basis
            ]
        priors = [
            v for v in (_get_path(r, path) for _, r in pool) if v is not None
        ]
        mv = _metric_verdict(
            _get_path(latest, path), priors, direction,
            floor=NOISE_FLOORS.get(path),
        )
        mv["direction"] = direction
        if basis_path is not None:
            mv["basis"] = _get_path_raw(latest, basis_path)
        metrics[path] = mv
        if mv["verdict"] == "regressed":
            regressions.append(path)
        elif mv["verdict"] == "missing" and "previous_median" in mv:
            missing.append(path)
    if not comparable:
        verdict = "no_comparable_series"
    elif regressions:
        verdict = "regressed"
    else:
        verdict = "ok"
    return {
        "verdict": verdict,
        "latest": latest_name,
        "scenario": dict(zip(_SCENARIO_KEYS, scenario)),
        "compared_against": [n for n, _ in comparable],
        "excluded_scenario_mismatch": excluded,
        "regressions": regressions,
        # Tracked metrics present in prior rounds but absent from the
        # latest run — visibility, not a verdict (see _metric_verdict).
        "missing": missing,
        "metrics": metrics,
    }


def render_text(report: dict) -> str:
    lines = [
        f"verdict: {report['verdict']}"
        + (f"  (latest: {report.get('latest')})" if report.get("latest") else "")
    ]
    if report.get("compared_against"):
        lines.append("compared against: " + ", ".join(report["compared_against"]))
    if report.get("excluded_scenario_mismatch"):
        lines.append(
            "excluded (scenario mismatch): "
            + ", ".join(report["excluded_scenario_mismatch"])
        )
    for name, mv in report.get("metrics", {}).items():
        if mv["verdict"] == "missing" and "previous_median" not in mv:
            continue  # never-present metric: noise in a text report
        bits = [f"{name}: {mv['verdict']}"]
        if "latest" in mv:
            bits.append(f"latest={mv['latest']:g}")
        if "previous_median" in mv:
            bits.append(f"prev_median={mv['previous_median']:g}")
        if "delta_frac" in mv:
            bits.append(f"delta={mv['delta_frac']:+.1%} band=±{mv['band_frac']:.1%}")
        if "floor_abs" in mv:
            bits.append(f"floor=±{mv['floor_abs']:g} abs")
        lines.append("  " + "  ".join(bits))
    return "\n".join(lines)


def run_report(
    paths: list[str],
    *,
    fmt: str = "text",
    fail_on_regression: bool = False,
    out=None,
) -> int:
    import sys

    out = out or sys.stdout
    if not paths:
        paths = default_series()
    runs = load_runs(paths)
    if len(runs) < 2:
        print(
            json.dumps(
                {
                    "verdict": "no_series",
                    "error": f"need >= 2 readable bench artifacts, got {len(runs)}",
                    "paths": paths,
                }
            ),
            file=out,
        )
        return 2
    report = build_report(runs)
    if fmt == "json":
        print(json.dumps(report, indent=2), file=out)
    else:
        print(render_text(report), file=out)
    if fail_on_regression and report["verdict"] == "regressed":
        return 1
    return 0
