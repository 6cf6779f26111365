"""The flight recorder in the port, held against the reference package on
the CPU (the cases of the reference's ``tests/test_flight.py``):

  - ``AnomalyDetector`` on seeded synthetic series (``random.Random``):
    the same trips, states and baselines sample for sample;
  - ``WorkerProfiler`` laps and carves under an injected clock, and the
    engine's profile: attached, it tiles the worker loop and rides the
    ``engine.decode`` span; detached, no key and the same tokens;
  - ``FlightRecorder`` under an injected clock: window worker shares, the
    late hit-rate collapse, the compile-burst bundle, cooldown and
    retention give the reference's ring, trips and bundle ids;
    ``_scrape_metrics`` reads the port's registry as the reference reads
    its own, after the same increments;
  - end to end: a seeded chaos transport slows ``/execute`` through each
    package's app; ``p99_shift`` trips at the same sample in both, the
    bundle is valid, names the slow requests' traces and is served over
    ``/debug/anomalies``; off, the recorder is absent and the routes answer
    as the reference's; ``validate_bundle`` rejects the same payloads;
  - the cluster: the routing journal's window deltas become the same
    decision-outcome signals, and with a replica pool attached (over the
    fake engines of ``tests/test_torch_cluster.py``) the recorder samples
    its skew and journal counts and a bundle carries the same scoreboard
    and per-replica attribution as the reference's.
"""

import asyncio
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.orchestrator.transport import LocalTransport as JLocalTransport
from mcpx.orchestrator.transport import RouterTransport as JRouterTransport
from mcpx.resilience.chaos import ChaosProfile as JChaosProfile
from mcpx.resilience.chaos import ChaosTransport as JChaosTransport
from mcpx.server.app import build_app as jbuild_app
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.telemetry import flight as jflight
from mcpx.telemetry.metrics import Metrics as JMetrics
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.orchestrator.transport import LocalTransport, RouterTransport
from mcpx_torch.resilience.chaos import ChaosProfile, ChaosTransport
from mcpx_torch.server.app import build_app
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.telemetry import flight
from mcpx_torch.telemetry.metrics import Metrics

PKGS = {
    "reference": SimpleNamespace(
        flight=jflight, config=JConfig, metrics=JMetrics, build=jbuild, app=jbuild_app,
        local=JLocalTransport, router=JRouterTransport, chaos=(JChaosProfile, JChaosTransport),
    ),
    "port": SimpleNamespace(
        flight=flight, config=MCPXConfig, metrics=Metrics,
        build=lambda cfg, **kw: build_control_plane(cfg, device="cpu", **kw), app=build_app,
        local=LocalTransport, router=RouterTransport, chaos=(ChaosProfile, ChaosTransport),
    ),
}
BOTH = ["reference", "port"]


# ------------------------------------------------------------------ detectors
def _det(pkg: str, **kw):
    base = dict(direction="high", alpha=0.3, k=5.0, min_samples=10, hysteresis=3, floor=5.0)
    base.update(kw)
    return PKGS[pkg].flight.AnomalyDetector("d", "s", **base)


def _series(pkg: str, kind: str) -> list:
    """One seeded series through a detector: every observe() result and the
    final state."""
    if kind == "stationary":
        det, rng = _det(pkg), random.Random(7)
        xs = [100.0 + rng.uniform(-3.0, 3.0) for _ in range(400)]
    elif kind == "excursions":
        det, rng = _det(pkg, hysteresis=3), random.Random(11)
        xs = [100.0 + rng.uniform(-1.0, 1.0) for _ in range(50)] + [300.0] * 20 + [100.0] * 5 + [300.0] * 10
    elif kind == "spikes":
        det = _det(pkg, hysteresis=3)
        xs = [100.0] * 30 + [500.0, 100.0, 500.0, 500.0]
    else:  # low direction, with a skipped None
        det = _det(pkg, direction="low", floor=0.1, hysteresis=2, min_samples=5)
        xs = [0.8] * 10 + [None, 0.2, 0.2]
    fired = [det.observe(x) for x in xs]
    return fired, det.state(), det.mean


@pytest.mark.parametrize("kind", ["stationary", "excursions", "spikes", "low"])
def test_detector_series_match_reference(kind):
    port = _series("port", kind)
    assert port == _series("reference", kind)
    fired, state, mean = port
    if kind == "stationary":
        assert state["trips"] == 0 and mean == pytest.approx(100.0, abs=3.0)
    elif kind == "excursions":
        # Trips once per excursion on the 3rd out-of-band sample, with the
        # baseline frozen meanwhile, and re-arms in between.
        assert fired[50:53] == [False, False, True] and fired.count(True) == 2
        assert state["trips"] == 2 and mean == pytest.approx(100.0, abs=2.0)
    elif kind == "spikes":
        assert state["trips"] == 0 and not state["active"]
    else:
        assert fired[-2:] == [False, True] and state["active"] and state["direction"] == "low"


# ------------------------------------------------------------------- profiler
def _laps(pkg: str):
    t = {"now": 0.0}
    prof = PKGS[pkg].flight.WorkerProfiler(clock=lambda: t["now"])
    prof.loop_tick()
    t["now"] = 1.0
    prof.lap("drain")
    t0 = prof.mark()
    t["now"] = 1.4
    prof.carve("prefix_match", t0)
    t["now"] = 2.0
    prof.lap("admit")
    return prof.snapshot(), PKGS[pkg].flight.WorkerProfiler.delta_ms({"admit": 0.0}, prof.totals)


def test_profiler_laps_tile_and_carves_subtract():
    port = _laps("port")
    assert port == _laps("reference")
    snap, delta = port
    assert snap["phases"]["admit"]["total_s"] == pytest.approx(0.6)
    assert snap["attributed_frac"] == pytest.approx(1.0) and delta["drain"] == pytest.approx(1000.0)


def test_engine_worker_profile_attribution_and_pass_through():
    from mcpx_torch.engine.engine import InferenceEngine
    from mcpx_torch.telemetry import tracing
    from mcpx_torch.telemetry.tracing import Tracer

    def cfg(profile):
        return MCPXConfig.from_dict({
            "model": {"size": "test", "max_seq_len": 256},
            "engine": {"max_batch_size": 4, "max_decode_len": 12, "warmup_compile": False},
            "telemetry": {"flight": {"profile_worker": profile}},
        })

    async def go():
        torch.manual_seed(0)
        eng_on = InferenceEngine(cfg(True), device="cpu")
        torch.manual_seed(0)
        eng_off = InferenceEngine(cfg(False), device="cpu")
        await eng_on.start()
        await eng_off.start()
        try:
            ids = eng_on.tokenizer.encode("profile this plan please")
            tracer = Tracer(None, enabled=True, sample_rate=1.0)
            root = tracer.start_request("/plan")
            with tracing.activate(root):
                r_on = await eng_on.generate(ids, max_new_tokens=8, constrained=False, temperature=0.0)
            tracer.finish(root)
            r_off = await eng_off.generate(ids, max_new_tokens=8, constrained=False, temperature=0.0)
            assert r_on.token_ids == r_off.token_ids
            assert "worker_profile" not in eng_off.queue_stats()
            wp = eng_on.queue_stats()["worker_profile"]
            assert set(wp["phases"]) == set(jflight.PROFILE_PHASES) == set(flight.PROFILE_PHASES)
            assert wp["attributed_frac"] >= 0.95 and wp["phases"]["dispatch_submit"]["total_s"] > 0
            assert wp["phases"]["harvest"]["count"] >= 1
            decode = [s for s in tracer.get(root.record.trace_id).spans if s.name == "engine.decode"]
            assert decode and decode[0].attrs["worker_phases_ms"]
        finally:
            await eng_on.aclose()
            await eng_off.aclose()

    asyncio.run(go())


# ---------------------------------------------------------- recorder mechanics
def _flight_cfg(pkg: str, tmp_path, **kw):
    base = dict(enabled=True, interval_s=1.0, min_samples=3, hysteresis=2, cooldown_s=0.0,
                bundle_dir=str(tmp_path / pkg), max_bundles=2)
    base.update(kw)
    return PKGS[pkg].config.from_dict({"telemetry": {"flight": base}}).telemetry.flight


def _ring(rec) -> list:
    return [s["signals"] for s in rec.ring]


def _worker_shares(pkg: str, tmp_path) -> list:
    raw = {"worker_phase_totals": {"idle": 0.0, "dispatch": 0.0}}
    clock = {"now": 0.0}
    rec = PKGS[pkg].flight.FlightRecorder(_flight_cfg(pkg, tmp_path), lambda: dict(raw), clock=lambda: clock["now"])
    rec.sample()
    for totals in ({"idle": 10.0, "dispatch": 990.0}, {"idle": 11.0, "dispatch": 990.0}):
        raw["worker_phase_totals"] = totals
        clock["now"] += 1.0
        rec.sample()
    return _ring(rec)


def test_recorder_derives_window_worker_shares(tmp_path):
    port = _worker_shares("port", tmp_path)
    assert port == _worker_shares("reference", tmp_path)
    assert "worker_idle_share" not in port[0]
    assert port[1]["worker_dispatch_share"] == 0.99 and port[2]["worker_idle_share"] == 1.0


async def _collapse(pkg: str, tmp_path) -> tuple:
    raw = {"prefix_matched_tokens_total": 0.0, "prefill_tokens_total": 0.0}
    clock = {"now": 0.0}
    rec = PKGS[pkg].flight.FlightRecorder(
        _flight_cfg(pkg, tmp_path, ring_size=512), lambda: dict(raw), clock=lambda: clock["now"],
        bundle_sources={"traces": lambda: []},
    )
    healthy = []
    for _ in range(60):
        clock["now"] += 1.0
        raw["prefix_matched_tokens_total"] += 80.0
        raw["prefill_tokens_total"] += 20.0
        healthy += await rec.tick()
    frozen = []
    for _ in range(6):
        clock["now"] += 1.0
        raw["prefill_tokens_total"] += 100.0
        frozen += await rec.tick()
    return healthy, frozen, _ring(rec), {d.name: d.state() for d in rec.detectors}


def test_recorder_window_ratio_catches_late_collapse(tmp_path):
    port = asyncio.run(_collapse("port", tmp_path))
    assert port == asyncio.run(_collapse("reference", tmp_path))
    healthy, frozen, ring, states = port
    assert healthy == [] and len(frozen) == 1
    assert ring[-1]["prefix_token_hit_rate"] == 0.0 and states["token_hit_collapse"]["trips"] == 1


async def _compile_burst(pkg: str, tmp_path) -> tuple:
    f = PKGS[pkg].flight
    raw = {"compiles_total": 0.0}
    clock = {"now": 0.0}
    rec = f.FlightRecorder(
        _flight_cfg(pkg, tmp_path, ring_size=8), lambda: dict(raw), clock=lambda: clock["now"],
        bundle_sources={"traces": lambda: [{"trace_id": "t1"}]},
    )
    bundles = []
    for _ in range(8):
        clock["now"] += 1.0
        bundles += await rec.tick()
    for _ in range(6):
        clock["now"] += 1.0
        raw["compiles_total"] += 10.0
        bundles += await rec.tick()
    bundle = await rec.load_bundle(bundles[0])
    keep = {k: bundle[k] for k in ("version", "bundle_id", "detectors", "traces")}
    keep["trigger"] = {k: v for k, v in bundle["trigger"].items() if k != "ts"}
    keep["window"] = [s["signals"] for s in bundle["window"]]
    status = rec.status()
    return bundles, f.validate_bundle(bundle), keep, len(rec.ring), [b["bundle_id"] for b in status["bundles"]]


def test_recorder_rates_ring_and_compile_burst_bundle(tmp_path):
    port = asyncio.run(_compile_burst("port", tmp_path))
    assert port == asyncio.run(_compile_burst("reference", tmp_path))
    bundles, problems, bundle, ring_len, listed = port
    assert len(bundles) == 1 and problems == [] and ring_len == 8 and listed == bundles
    assert bundle["trigger"]["detector"] == "recompile_burst" and bundle["traces"] == [{"trace_id": "t1"}]


async def _cooldown(pkg: str, tmp_path) -> tuple:
    raw = {"compiles_total": 0.0}
    clock = {"now": 0.0}
    rec = PKGS[pkg].flight.FlightRecorder(
        _flight_cfg(pkg, tmp_path, cooldown_s=1000.0, hysteresis=1), lambda: dict(raw), clock=lambda: clock["now"]
    )
    for _ in range(4):
        clock["now"] += 1.0
        await rec.tick()
    bundles = []
    for burst in (True, False, True):
        for _ in range(3):
            clock["now"] += 1.0
            raw["compiles_total"] += 10.0 if burst else 0.0
            bundles += await rec.tick()
    det = {d.name: d for d in rec.detectors}["recompile_burst"]
    return det.trips, det.suppressed_trips, bundles


async def _retention(pkg: str, tmp_path) -> tuple:
    """Three trips past ``max_bundles=2``: the oldest bundle's file goes."""
    f = PKGS[pkg].flight
    rec = f.FlightRecorder(_flight_cfg(pkg, tmp_path / "keep"), lambda: {})
    ids = [await rec.capture_bundle({"detector": f"d{i}", "signal": "s", "direction": "high", "value": 1.0,
                                     "mean": 0.0, "band": 0.5}) for i in range(3)]
    return ids, [b["bundle_id"] for b in rec.bundles], await rec.load_bundle(ids[0]) is None


def test_recorder_cooldown_suppresses_and_retention_prunes(tmp_path):
    port = asyncio.run(_cooldown("port", tmp_path))
    assert port == asyncio.run(_cooldown("reference", tmp_path))
    assert port[:2] == (2, 1) and len(port[2]) == 1
    kept = asyncio.run(_retention("port", tmp_path))
    assert kept == asyncio.run(_retention("reference", tmp_path))
    assert kept[1] == kept[0][1:] and kept[2] is True


def _bump(metrics, seed: int) -> None:
    """The same seeded increments on either package's registry."""
    rng = np.random.default_rng(seed)
    metrics.plans.labels(planner="LLMPlanner", origin="llm", status="ok").inc(int(rng.integers(1, 9)))
    metrics.engine_compiles.labels(executable="window").inc(int(rng.integers(1, 4)))
    metrics.decode_tokens.inc(int(rng.integers(10, 99)))
    metrics.segments.inc(int(rng.integers(1, 9)))
    metrics.prefix_matched_tokens.inc(int(rng.integers(0, 64)))
    metrics.prefill_tokens.inc(int(rng.integers(1, 64)))
    metrics.spec_drafted.labels(cls="free").inc(int(rng.integers(4, 40)))
    metrics.spec_accepted.labels(cls="free").inc(int(rng.integers(0, 4)))
    for endpoint in ("/plan", "/execute", "/healthz"):
        for v in rng.uniform(0.0005, 3.0, 12):
            metrics.request_latency.labels(endpoint=endpoint).observe(float(v))


@pytest.mark.parametrize("seed", [0, 1])
def test_scrape_metrics_reads_the_registry_as_the_reference(seed):
    ms = {}
    for pkg in BOTH:
        ms[pkg] = PKGS[pkg].metrics()
        _bump(ms[pkg], seed)
    port = flight._scrape_metrics(ms["port"])
    assert port == jflight._scrape_metrics(ms["reference"])
    assert port["plans_total"] > 0 and port["latency_buckets"][-1] == 24.0


# ------------------------------------------------------------- e2e chaos trip
class _Svc:
    async def __call__(self, payload):
        return {"ok": True}


GRAPH = {"nodes": [{"name": "a", "service": "svc", "endpoint": "local://svc", "retries": 0, "timeout_s": 2.0}],
         "edges": []}


async def _chaos_trip(pkg: str, tmp_path) -> dict:
    p = PKGS[pkg]
    local = p.local()
    local.register("svc", _Svc())
    transport = p.router(local=local)
    config = p.config.from_dict({"telemetry": {"flight": {
        "enabled": True, "interval_s": 3600.0, "min_samples": 3, "hysteresis": 2, "cooldown_s": 0.0,
        "bundle_dir": str(tmp_path / pkg),
    }}})
    cp = p.build(config, transport=transport)
    profile_cls, chaos_cls = p.chaos
    chaos = chaos_cls(transport, profile_cls.from_dict({"seed": 99, "endpoints": {"local://svc": {"latency_ms": 250}}}))
    client = TestClient(TestServer(p.app(cp)))
    await client.start_server()
    try:
        fl = cp.flight

        async def burst(n=3):
            tids = []
            for _ in range(n):
                resp = await client.post("/execute", json={"graph": GRAPH, "payload": {}})
                assert resp.status == 200
                tids.append(resp.headers["X-Trace-Id"])
            return tids

        quiet = []
        for _ in range(6):
            await burst()
            quiet += await fl.tick()
        cp.orchestrator._transport = chaos
        slow, ids, trips_at = [], [], []
        for k in range(3):
            slow += await burst()
            new = await fl.tick()
            ids += new
            trips_at += [k] * len(new)
        bundle = await fl.load_bundle(ids[0])
        status = await (await client.get("/debug/anomalies")).json()
        one = await client.get(f"/debug/anomalies/{ids[0]}")
        missing = (await client.get("/debug/anomalies/nope")).status
        return dict(
            quiet=quiet, ids=ids, trips_at=trips_at, problems=p.flight.validate_bundle(bundle),
            detector=bundle["trigger"]["detector"], slow_named=bool({t["trace_id"] for t in bundle["traces"]} & set(slow)),
            p99=bundle["window"][-1]["signals"]["request_p99_ms"], keys=set(bundle),
            active=status["detectors"]["p99_shift"]["active"], listed=[b["bundle_id"] for b in status["bundles"]],
            served=(one.status, (await one.json())["bundle_id"]), missing=missing,
        )
    finally:
        cp.orchestrator._transport = transport
        await client.close()


def test_chaos_trips_detector_and_bundle_names_offending_traces(tmp_path):
    ref = asyncio.run(_chaos_trip("reference", tmp_path))
    port = asyncio.run(_chaos_trip("port", tmp_path))
    assert port == ref
    assert port["quiet"] == [] and port["ids"] and port["detector"] == "p99_shift"
    assert port["problems"] == [] and port["slow_named"] and port["p99"] >= 200
    assert port["active"] and port["listed"] == port["ids"] and port["missing"] == 404


async def _off(pkg: str) -> tuple:
    p = PKGS[pkg]
    local = p.local()
    local.register("svc", _Svc())
    cp = p.build(p.config(), transport=p.router(local=local))
    client = TestClient(TestServer(p.app(cp)))
    await client.start_server()
    try:
        body = await (await client.get("/debug/anomalies")).json()
        return cp.flight, body, (await client.get("/debug/anomalies/any")).status
    finally:
        await client.close()


def test_recorder_off_is_pass_through():
    port = asyncio.run(_off("port"))
    assert port == asyncio.run(_off("reference"))
    assert port == (None, {"enabled": False, "detectors": {}, "bundles": []}, 404)


@pytest.mark.parametrize("bundle", [
    None, {"version": 0}, {"version": 1, "trigger": "x", "window": []},
    {"version": 1, "bundle_id": "b", "captured_at": 0, "detectors": {}, "log_tail": [], "traces": [],
     "trigger": {"detector": "d"}, "window": [{"ts": 1}]},
], ids=["none", "old_version", "bad_trigger_window", "partial"])
def test_bundle_schema_validator_rejects_malformed(bundle):
    problems = flight.validate_bundle(bundle)
    assert problems == jflight.validate_bundle(bundle)
    assert problems


# -------------------------------------------------------------------- cluster
def _cluster_signals(pkg: str, tmp_path) -> list:
    raw = {}
    clock = {"now": 0.0}
    rec = PKGS[pkg].flight.FlightRecorder(_flight_cfg(pkg, tmp_path), lambda: dict(raw), clock=lambda: clock["now"])
    rec.sample()
    # A pool appears, then a window of 100 more routes: 20 affinity hits,
    # 30 degraded placements, 2 resteers.
    for counts in ((100.0, 80.0, 10.0, 0.0), (200.0, 100.0, 40.0, 2.0)):
        raw.update(zip(("cluster_routed_total", "cluster_affinity_hit_total", "cluster_degraded_route_total",
                        "cluster_resteer_total"), counts))
        clock["now"] += 1.0
        rec.sample()
    return _ring(rec), sorted(d.signal for d in rec.detectors)


def test_recorder_derives_cluster_decision_outcome_signals(tmp_path):
    port = _cluster_signals("port", tmp_path)
    assert port == _cluster_signals("reference", tmp_path)
    ring, watched = port
    assert "affinity_hit_rate" not in ring[0]
    assert ring[-1]["affinity_hit_rate"] == 0.2 and ring[-1]["degraded_route_share"] == 0.3
    assert ring[-1]["resteer_rate"] == 2.0
    assert {"affinity_hit_rate", "resteer_rate", "degraded_route_share", "replica_skew"} <= set(watched)


async def _cluster_bundle(pkg: str, tmp_path) -> dict:
    from tests.test_torch_cluster import PKGS as CLUSTER, _pool, _strip

    p = PKGS[pkg]
    local = p.local()
    local.register("svc", _Svc())
    cfg = p.config.from_dict(
        {"telemetry": {"flight": {"enabled": True, "interval_s": 3600.0, "bundle_dir": str(tmp_path / pkg)}}}
    )
    cp = p.build(cfg, transport=p.router(local=local))
    pool, _ = _pool(CLUSTER[pkg], 2)
    await pool.start()
    for _ in range(3):
        await pool.generate([1, 2, 3])
    await pool.kill(1)
    cp.cluster = pool
    fl = p.flight.build_flight_recorder(cp)
    fl.sample()
    bundle = fl._assemble({"detector": "replica_skew", "signal": "replica_skew", "direction": "high",
                           "value": 3.0, "mean": 1.0, "band": 0.2})
    await pool.aclose()
    return _strip({
        "signals": _ring(fl)[-1], "attribution": bundle["cluster_attribution"], "cluster": bundle["cluster"],
        "problems": p.flight.validate_bundle(bundle),
    })


def test_bundle_carries_cluster_attribution(tmp_path):
    port = asyncio.run(_cluster_bundle("port", tmp_path))
    assert port == asyncio.run(_cluster_bundle("reference", tmp_path))
    attr = port["attribution"]
    assert set(attr["replicas"]) == {"0", "1"} and sum(r["routed"] for r in attr["replicas"].values()) == 3
    assert attr["journal_counts"]["kill"] == 1 and any(e["kind"] == "kill" for e in attr["journal"])
    assert "journal_counts" in port["cluster"] and port["problems"] == []
    assert "replica_skew" in port["signals"]
