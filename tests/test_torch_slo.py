"""The SLO error-budget engine in the port, held against the reference
package on the CPU (the cases of the reference's ``tests/test_slo.py``):
objective semantics, the multi-window multi-burn-rate math and the tenant
fold under one injected clock, the ``mcpx_slo_*`` gauges, the burn-aware
ladder against the blind one, and the end-to-end overload: seeded slow
traffic through each package's app burns the latency budget, the flight
recorder's ``slo_burn`` detector trips at the same sample in both, its
bundle is valid and carries the SLO and usage state, and ``GET /slo``
shows the burn. The overload runs each app on one injected clock (its
latency clock, the tracker's and the recorder's), which only the chaos
latency moves, so no wall time or host load enters what is compared."""

import asyncio
import importlib
import time
from types import SimpleNamespace

import pytest
from aiohttp.test_utils import TestClient, TestServer

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.core.config import SchedulerConfig as JSchedulerConfig
from mcpx.orchestrator.transport import LocalTransport as JLocalTransport
from mcpx.orchestrator.transport import RouterTransport as JRouterTransport
from mcpx.resilience.chaos import ChaosProfile as JChaosProfile
from mcpx.resilience.chaos import ChaosTransport as JChaosTransport
from mcpx.scheduler import Scheduler as JScheduler
from mcpx.server.app import build_app as jbuild_app
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.telemetry import slo as jslo
from mcpx.telemetry.flight import validate_bundle as jvalidate_bundle
from mcpx.telemetry.metrics import Metrics as JMetrics
from mcpx_torch.core.config import MCPXConfig, SchedulerConfig
from mcpx_torch.orchestrator.transport import LocalTransport, RouterTransport
from mcpx_torch.resilience.chaos import ChaosProfile, ChaosTransport
from mcpx_torch.scheduler import Scheduler
from mcpx_torch.server.app import build_app
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.telemetry import slo
from mcpx_torch.telemetry.flight import validate_bundle
from mcpx_torch.telemetry.metrics import Metrics

PKGS = {
    "reference": SimpleNamespace(
        slo=jslo, config=JConfig, sched_config=JSchedulerConfig, scheduler=JScheduler, metrics=JMetrics,
        build=jbuild, app=jbuild_app, local=JLocalTransport, router=JRouterTransport,
        chaos=(JChaosProfile, JChaosTransport), validate=jvalidate_bundle,
    ),
    "port": SimpleNamespace(
        slo=slo, config=MCPXConfig, sched_config=SchedulerConfig, scheduler=Scheduler, metrics=Metrics,
        build=lambda cfg, **kw: build_control_plane(cfg, device="cpu", **kw), app=build_app,
        local=LocalTransport, router=RouterTransport, chaos=(ChaosProfile, ChaosTransport),
        validate=validate_bundle,
    ),
}


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _tracker(pkg: str, clock, **kw):
    p = PKGS[pkg]
    cfg = p.config.from_dict({"slo": {"enabled": True, "windows_s": [10.0, 60.0, 120.0, 240.0], "bucket_s": 1.0, **kw}})
    return p.slo.SLOTracker(cfg.slo, clock=clock)


# -------------------------------------------------------------- objectives
@pytest.mark.parametrize("threshold", [0.5, 1.0, 120, 150, 999, 20000])
def test_latency_objective_snaps_threshold_to_histogram_bucket_grid(threshold):
    spec = {"name": "p99", "kind": "latency", "target": 0.99, "threshold_ms": threshold}
    port, ref = slo.SLOObjective(spec), jslo.SLOObjective(spec)
    assert port.threshold_ms == ref.threshold_ms
    for ms in (port.threshold_ms - 1.0, port.threshold_ms, port.threshold_ms + 1.0):
        assert port.good(latency_ms=ms, error=True, degraded=True) == ref.good(
            latency_ms=ms, error=True, degraded=True
        )
    if threshold == 120:
        assert port.threshold_ms == 150.0  # snapped up to the next edge


def test_objective_kinds_and_scoping():
    for spec in ({"name": "a", "kind": "availability", "target": 0.999},
                 {"name": "q", "kind": "plan_quality", "target": 0.9}):
        port, ref = slo.SLOObjective(spec), jslo.SLOObjective(spec)
        assert port.spec() == ref.spec() and port.budget == ref.budget
        for endpoint in ("/plan", "/execute", "/plan_and_execute"):
            assert port.applies(endpoint) == ref.applies(endpoint)
        for error in (False, True):
            for degraded in (False, True):
                kw = dict(latency_ms=1.0, error=error, degraded=degraded)
                assert port.good(**kw) == ref.good(**kw)
    for bad in ({"name": "x", "kind": "vibes", "target": 0.9}, {"name": "x", "kind": "availability", "target": 1.0},
                {"name": "x", "kind": "latency", "target": 0.9}):
        with pytest.raises(ValueError):
            slo.SLOObjective(bad)


def test_default_objectives_cover_the_three_kinds():
    assert slo.DEFAULT_OBJECTIVES == jslo.DEFAULT_OBJECTIVES
    assert {o["kind"] for o in slo.DEFAULT_OBJECTIVES} == {"latency", "availability", "plan_quality"}


# ---------------------------------------------------------- window math
def _burn_sequence(pkg: str) -> list:
    clock = FakeClock()
    t = _tracker(pkg, clock, objectives=[{"name": "avail", "kind": "availability", "target": 0.9}])
    seen = []
    for _ in range(40):
        t.observe(tenant="a", endpoint="/plan", latency_ms=5.0, error=False, degraded=False)
        clock.advance(1.0)
    seen.append((t.status(), t.fast_burn(), t.burning()))
    for _ in range(10):
        t.observe(tenant="a", endpoint="/plan", latency_ms=5.0, error=True, degraded=False)
        clock.advance(0.1)
    seen.append((t.status(), t.fast_burn(), t.burning()))
    clock.advance(500.0)
    t.observe(tenant="a", endpoint="/plan", latency_ms=5.0, error=False, degraded=False)
    seen.append((t.status(), t.fast_burn(), t.burning()))
    return seen


def test_burn_rates_budget_and_multiwindow_and():
    port = _burn_sequence("port")
    assert port == _burn_sequence("reference")
    healthy, burst, aged = (s[0]["global"]["objectives"][0] for s in port)
    assert healthy["windows"]["10s"]["burn_rate"] == 0.0 and healthy["budget_remaining"] == 1.0
    assert burst["windows"]["10s"]["burn_rate"] > burst["windows"]["60s"]["burn_rate"] > 0
    # fast_burn is the min over the fast pair (the multi-window AND).
    assert port[1][1] == pytest.approx(burst["windows"]["60s"]["burn_rate"])
    assert burst["budget_remaining"] < 1.0
    assert aged["windows"]["240s"]["total"] == 1 and aged["budget_remaining"] == 1.0


def test_no_traffic_windows_report_none_not_zero():
    port, ref = _tracker("port", FakeClock()), _tracker("reference", FakeClock())
    assert port.status() == ref.status()
    assert port.fast_burn() is None and not port.burning()
    st = port.status()["global"]["objectives"][0]
    assert st["windows"]["10s"]["burn_rate"] is None and st["budget_remaining"] == 1.0


def test_tenant_fold_and_per_tenant_status():
    out = []
    for pkg in ("reference", "port"):
        t = _tracker(pkg, FakeClock(), max_tenants=2)
        for tenant in ("a", "b", "c", "d"):
            t.observe(tenant=tenant, endpoint="/plan", latency_ms=5.0, error=tenant in ("c", "d"), degraded=False)
        out.append(t.status())
    assert out[1] == out[0]
    assert set(out[1]["tenants"]) == {"a", "b", "other"}
    avail = next(o for o in out[1]["tenants"]["other"]["objectives"] if o["kind"] == "availability")
    assert avail["windows"]["10s"]["total"] == 2 and avail["windows"]["10s"]["good"] == 0


def test_slo_gauges_update():
    lines = []
    for pkg in ("reference", "port"):
        t = _tracker(pkg, FakeClock())
        m = PKGS[pkg].metrics()
        t.observe(tenant="a", endpoint="/plan", latency_ms=5.0, error=False, degraded=False)
        t.update_gauges(m)
        lines.append(sorted(line for line in m.render().decode().splitlines() if line.startswith("mcpx_slo_")))
    assert lines[1] == lines[0]
    assert 'mcpx_slo_budget_remaining{objective="latency_p99"} 1.0' in lines[1]
    assert 'mcpx_slo_burn_rate{objective="latency_p99",window="10s"} 0.0' in lines[1]


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_build_slo_tracker_disabled_returns_none(pkg):
    p = PKGS[pkg]
    assert p.slo.build_slo_tracker(p.config()) is None
    assert isinstance(p.slo.build_slo_tracker(p.config.from_dict({"slo": {"enabled": True}})), p.slo.SLOTracker)


# --------------------------------------------------- burn-aware ladder
async def _ladder(pkg: str) -> list:
    p = PKGS[pkg]
    burning = {"v": True}
    blind = p.scheduler(p.sched_config(enabled=True))
    aware = p.scheduler(p.sched_config(enabled=True, burn_aware=True))
    aware.attach_slo(lambda: burning["v"])
    gated_off = p.scheduler(p.sched_config(enabled=True))
    gated_off.attach_slo(lambda: True)
    out = []

    async def grant(s):
        slot = await s.acquire(s.context_from_headers({}))
        out.append(slot.degraded)
        s.release(slot)

    for s in (blind, aware, gated_off):
        await grant(s)
    burning["v"] = False
    await grant(aware)

    def boom() -> bool:
        raise RuntimeError("budget backend down")

    aware.attach_slo(boom)
    await grant(aware)
    return out


def test_burn_aware_ladder_contrast_with_blind_ladder():
    port = asyncio.run(_ladder("port"))
    assert port == asyncio.run(_ladder("reference"))
    assert port == [False, True, False, False, False]


# ------------------------------------------------------------ e2e overload
class _Svc:
    def __init__(self) -> None:
        self.calls = 0

    async def __call__(self, payload):
        self.calls += 1
        return {"ok": True}


GRAPH = {
    "nodes": [{"name": "a", "service": "svc", "endpoint": "local://svc", "retries": 0, "timeout_s": 2.0}],
    "edges": [],
}


def _one_clock(monkeypatch, pkg: str) -> FakeClock:
    """One clock for a package's overload run: the latency its app records
    (the middleware's ``time.monotonic``) reads it, and only the chaos's
    injected latency moves it (its sleeps advance the clock and yield), so
    a baseline request takes 0 ms and a chaos one exactly 250 ms however
    loaded the host is. ``_overload`` gives the same clock to the SLO
    tracker and the flight recorder."""
    p, clock = PKGS[pkg], FakeClock()

    def proxy(module, **over):
        return SimpleNamespace(**{**{k: getattr(module, k) for k in dir(module) if not k.startswith("__")}, **over})

    async def sleep(delay, result=None):
        clock.advance(delay)
        return await asyncio.sleep(0, result)

    monkeypatch.setattr(importlib.import_module(p.app.__module__), "time", proxy(time, monotonic=clock))
    monkeypatch.setattr(importlib.import_module(p.chaos[1].__module__), "asyncio", proxy(asyncio, sleep=sleep))
    return clock


async def _overload(pkg: str, tmp_path, clock: FakeClock) -> dict:
    p = PKGS[pkg]
    local = p.local()
    local.register("svc", _Svc())
    transport = p.router(local=local)
    config = p.config.from_dict({
        "planner": {"kind": "heuristic"},
        "telemetry": {
            "ledger": {"enabled": True},
            "flight": {"enabled": True, "interval_s": 3600.0, "min_samples": 3, "hysteresis": 2,
                       "cooldown_s": 0.0, "bundle_dir": str(tmp_path / pkg)},
        },
        "slo": {
            "enabled": True, "windows_s": [10.0, 60.0, 120.0, 240.0], "bucket_s": 0.5,
            "objectives": [{"name": "latency_p99", "kind": "latency", "target": 0.99, "threshold_ms": 100.0}],
        },
    })
    cp = p.build(config, transport=transport)
    cp.slo._clock = cp.flight._clock = clock
    profile_cls, chaos_cls = p.chaos
    chaos = chaos_cls(transport, profile_cls.from_dict({"seed": 7, "endpoints": {"local://svc": {"latency_ms": 250}}}))
    client = TestClient(TestServer(p.app(cp)))
    await client.start_server()
    try:
        fl = cp.flight
        assert "slo_burn" in {d.name for d in fl.detectors}

        async def burst(n=4):
            for _ in range(n):
                resp = await client.post(
                    "/execute", json={"graph": GRAPH, "payload": {}}, headers={"X-MCPX-Tenant": "acme"}
                )
                assert resp.status == 200

        for _ in range(6):
            await burst()
            await fl.tick()
        baseline = cp.slo.fast_burn()
        cp.orchestrator._transport = chaos
        det = {d.name: d for d in fl.detectors}["slo_burn"]
        tripped_at = None
        for k in range(12):
            await burst()
            await fl.tick()
            if det.trips:
                tripped_at = k
                break
        ids = [b["bundle_id"] for b in fl.bundles if b["trigger"]["detector"] == "slo_burn"]
        bundle = await fl.load_bundle(ids[0]) if ids else None
        status = await (await client.get("/slo")).json()
        usage = await (await client.get("/usage")).json()
        anomalies = await (await client.get("/debug/anomalies")).json()
        return dict(baseline=baseline, tripped_at=tripped_at, trips=det.trips, active=det.active, ids=ids,
                    bundle=bundle, problems=p.validate(bundle) if bundle else None, status=status,
                    usage=usage, anomalies=anomalies)
    finally:
        cp.orchestrator._transport = transport
        await client.close()


def test_overload_trips_slo_burn_bundle_and_endpoint(tmp_path, monkeypatch):
    ref = asyncio.run(_overload("reference", tmp_path, _one_clock(monkeypatch, "reference")))
    port = asyncio.run(_overload("port", tmp_path, _one_clock(monkeypatch, "port")))
    assert port["baseline"] == ref["baseline"] == 0.0
    assert port["trips"] == 1 and port["active"], port["status"]
    assert port["tripped_at"] == ref["tripped_at"]
    assert port["ids"] == ref["ids"] and port["ids"]
    assert port["problems"] == []
    bundle = port["bundle"]
    assert bundle["trigger"]["detector"] == "slo_burn"
    assert bundle["slo"]["enabled"] and bundle["usage"]["enabled"]
    assert bundle["slo"]["global"]["objectives"][0]["breaching"] is True
    assert set(bundle) == set(ref["bundle"])
    st = port["status"]
    obj = st["global"]["objectives"][0]
    assert st["global"]["breaching"] is True and obj["budget_remaining"] < 1.0
    assert obj["fast_burn"] >= st["fast_burn_threshold"]
    assert set(st["tenants"]) == set(ref["status"]["tenants"]) == {"acme"}
    for key in ("good", "total"):
        assert [w[key] for w in obj["windows"].values()] == [
            w[key] for w in ref["status"]["global"]["objectives"][0]["windows"].values()
        ]
    assert port["usage"]["tenants"]["acme"]["requests"] == ref["usage"]["tenants"]["acme"]["requests"]
    assert port["usage"]["tenants"]["acme"]["tool_attempts"] == ref["usage"]["tenants"]["acme"]["tool_attempts"]
    assert set(port["anomalies"]["detectors"]) == set(ref["anomalies"]["detectors"])
    assert [b["bundle_id"] for b in port["anomalies"]["bundles"]] == [
        b["bundle_id"] for b in ref["anomalies"]["bundles"]
    ]
