"""The Redis telemetry mirror in the port, held against the reference
package on the CPU (the cases of the reference's
``tests/test_telemetry_mirror.py``), over the in-memory ``FakeAsyncRedis``
each package ships:

  - two replicas share EWMA stats through Redis: the same peer counts and
    blended stats after every step, re-syncing never double counts;
  - a peer whose snapshot outlives its TTL is pruned;
  - ``telemetry.redis_url`` builds a mirror in the factory and the app's
    background loop syncs it (an injected client), and without the
    ``redis`` package the mirror's first sync raises naming the option,
    in both packages alike.
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
from aiohttp.test_utils import TestServer

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.server.app import build_app as jbuild_app
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.telemetry import mirror as jmirror
from mcpx.telemetry.stats import TelemetryStore as JTelemetryStore
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.server.app import build_app
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.telemetry import mirror
from mcpx_torch.telemetry.stats import TelemetryStore

PKGS = {
    "reference": SimpleNamespace(mirror=jmirror, store=JTelemetryStore, config=JConfig, build=jbuild, app=jbuild_app),
    "port": SimpleNamespace(
        mirror=mirror, store=TelemetryStore, config=MCPXConfig,
        build=lambda cfg, **kw: build_control_plane(cfg, device="cpu", **kw), app=build_app,
    ),
}


def _view(store, name: str):
    s = store.get(name)
    return None if s is None else s.to_dict()


async def _two_replicas(pkg: str, seed: int) -> list:
    p = PKGS[pkg]
    redis = p.mirror.FakeAsyncRedis()
    a_store, b_store = p.store(), p.store()
    a = p.mirror.RedisTelemetryMirror(a_store, client=redis, replica_id="a")
    b = p.mirror.RedisTelemetryMirror(b_store, client=redis, replica_id="b")
    rng = np.random.default_rng(seed)
    seen = []
    for ok in rng.random(4) < 0.5:
        a_store.record("svc-x", latency_ms=float(rng.uniform(300, 500)), ok=bool(ok))
    await a.sync()
    seen.append(_view(b_store, "svc-x"))
    seen.append(await b.sync())
    seen.append(_view(b_store, "svc-x"))
    for v in rng.uniform(5, 20, 12):
        b_store.record("svc-x", latency_ms=float(v), ok=True)
    seen.append(_view(b_store, "svc-x"))
    await b.merge()  # idempotent: no double counting
    seen.append(_view(b_store, "svc-x"))
    await b.export()
    await a.merge()
    seen.append(_view(a_store, "svc-x"))
    return seen


@pytest.mark.parametrize("seed", [0, 5])
def test_two_replicas_share_stats_through_redis(seed):
    port = asyncio.run(_two_replicas("port", seed))
    assert port == asyncio.run(_two_replicas("reference", seed))
    before, peers, imported, blended, again, a_view = port
    assert before is None and peers == 1 and imported["calls"] == 4
    assert blended["calls"] == again["calls"] == 16 and blended == again
    assert a_view["calls"] == 16


async def _stale(pkg: str) -> list:
    p = PKGS[pkg]
    redis = p.mirror.FakeAsyncRedis()
    a_store, b_store = p.store(), p.store()
    a = p.mirror.RedisTelemetryMirror(a_store, client=redis, replica_id="a", ttl_s=0.2)
    b = p.mirror.RedisTelemetryMirror(b_store, client=redis, replica_id="b", ttl_s=0.2)
    a_store.record("svc-y", latency_ms=5.0, ok=True)
    await a.export()
    out = [await b.merge(), _view(b_store, "svc-y") is not None]
    await asyncio.sleep(0.25)  # A's snapshot expires (not re-exported)
    out += [await b.merge(), _view(b_store, "svc-y")]
    return out


def test_stale_peer_pruned():
    port = asyncio.run(_stale("port"))
    assert port == asyncio.run(_stale("reference")) == [1, True, 0, None]


async def _served(pkg: str) -> tuple:
    p = PKGS[pkg]
    redis = p.mirror.FakeAsyncRedis()
    cfg = p.config.from_dict(
        {"planner": {"kind": "heuristic"}, "telemetry": {"redis_url": "redis://unused", "mirror_interval_s": 0.05}}
    )
    cp1, cp2 = p.build(cfg), p.build(cfg)
    assert isinstance(cp1.telemetry_mirror, p.mirror.RedisTelemetryMirror)
    cp1.telemetry_mirror._client = redis
    cp2.telemetry_mirror._client = redis
    cp1.telemetry.record("svc-z", latency_ms=123.0, ok=True)
    s1, s2 = TestServer(p.app(cp1)), TestServer(p.app(cp2))
    await s1.start_server()
    await s2.start_server()
    try:
        for _ in range(100):
            if cp2.telemetry.get("svc-z") is not None:
                break
            await asyncio.sleep(0.05)
        return _view(cp2.telemetry, "svc-z")
    finally:
        await s1.close()
        await s2.close()


def test_mirror_loop_through_server_config():
    port = asyncio.run(_served("port"))
    assert port == asyncio.run(_served("reference"))
    assert port is not None and abs(port["ewma_latency_ms"] - 123.0) < 1e-6


async def _no_redis(pkg: str) -> str:
    p = PKGS[pkg]
    m = p.mirror.RedisTelemetryMirror(p.store(), "redis://unused")
    try:
        await m.sync()
    except RuntimeError as e:
        return str(e)
    return "synced"


def test_mirror_without_redis_raises_naming_the_option():
    port = asyncio.run(_no_redis("port"))
    assert port == asyncio.run(_no_redis("reference"))
    assert "telemetry.redis_url" in port
