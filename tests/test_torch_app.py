"""The port's HTTP surface (``mcpx_torch.server.app``) against the
reference's (``mcpx.server.app``) through aiohttp's test client, on the CPU:

  - one scripted session of requests over every ported route (``/plan``,
    ``/execute``, ``/plan_and_execute`` with a replan, ``/services`` CRUD,
    ``/cache``, ``/telemetry``, ``/healthz``, and the 400, 404 and 422
    paths) gives equal status codes and equal JSON bodies in both apps,
    with wall-clock fields and trace ids masked; every 200 carries an
    ``X-Trace-Id`` header;
  - the ``server.max_concurrency`` 429 and the ``server.request_timeout_s``
    504, in both apps;
  - the observability surface: the session above includes ``/traces``,
    ``/traces/{id}`` and ``/costs``; ``/metrics`` as text and as OpenMetrics
    holds the same request, plan and attempt counters in both apps, with
    the exemplar naming the request's trace; the ``traceparent`` round trip
    (``X-Trace-Id`` equal to the trace's id); tail sampling keeps 5xx and
    drops 4xx; tracing off leaves no ``traceparent`` and no trace ids in
    error bodies; ``/profile/start`` and ``/profile/stop`` on
    ``torch.profiler`` with their 409 paths; ``/costs`` of a CPU engine;
  - ``/cache`` with ``engine.kv_tier`` on carries the spill tier's and the
    governor's blocks under the reference's keys;
  - the 504 of a ``/plan`` frees the engine row the abandoned request held
    (the port of ``tests/test_server_limits.py``'s reaping test, on the
    port's CPU engine), and the engine serves again;
  - ``/cluster``: ``{"enabled": false}`` without a pool; with one (over the
    fake engines of ``tests/test_torch_cluster.py``) the same scoreboard as
    the reference's, refreshed by a loop that runs from the app's startup
    to its cleanup.
"""

import asyncio
import threading

from aiohttp.test_utils import TestClient, TestServer

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.orchestrator.transport import LocalTransport as JLocal
from mcpx.orchestrator.transport import RouterTransport as JRouter
from mcpx.orchestrator.transport import TransportError as JTransportError
from mcpx.server.app import build_app as jbuild_app
from mcpx.server.factory import build_control_plane as jbuild
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.orchestrator.transport import LocalTransport, RouterTransport, TransportError
from mcpx_torch.registry import ServiceRecord
from mcpx_torch.server.app import build_app
from mcpx_torch.server.factory import build_control_plane

REF = dict(build=jbuild, app=jbuild_app, Config=JConfig, Local=JLocal, Router=JRouter, Error=JTransportError)
PORT = dict(
    build=lambda cfg, **kw: build_control_plane(cfg, device="cpu", **kw), app=build_app,
    Config=MCPXConfig, Local=LocalTransport, Router=RouterTransport, Error=TransportError,
)
WALL_CLOCK = ("latency_ms", "total_ms", "trace_id", "ewma_latency_ms", "started_at")


def masked(obj):
    if isinstance(obj, dict):
        return {k: None if k in WALL_CLOCK else masked(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [masked(v) for v in obj]
    return obj


async def with_client(app, fn):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        return await fn(client)
    finally:
        await client.close()


def _transport(ns, latencies=None, failing=()):
    local = ns["Local"]()

    def handler(name):
        async def call(payload):
            if name in failing:
                raise ns["Error"](f"{name} is down", status=503)
            return {"service": name, "got": sorted(payload)}

        return call

    for name in ("search", "summarize", "rank-broken", "rank-healthy", "slow"):
        local.register(name, handler(name), latency_s=(latencies or {}).get(name, 0.0))
    return ns["Router"](local=local)


RECORDS = [
    {"name": "search", "endpoint": "local://search", "description": "search documents by query",
     "input_schema": {"query": "str"}, "output_schema": {"document": "str"}},
    {"name": "summarize", "endpoint": "local://summarize", "description": "summarize a document",
     "input_schema": {"document": "str"}, "output_schema": {"summary": "str"}},
    {"name": "rank-broken", "endpoint": "local://rank-broken", "description": "rank items by score quality",
     "input_schema": {"query": "str"}, "output_schema": {"score": "str"}},
    {"name": "rank-healthy", "endpoint": "local://rank-healthy", "description": "rank items by score quality",
     "input_schema": {"query": "str"}, "output_schema": {"score": "str"}},
]
GRAPH = {
    "nodes": [{"name": "search", "inputs": {"query": "query"}},
              {"name": "summarize", "inputs": {"document": "search"}}],
    "edges": [{"from": "search", "to": "summarize"}],
}
# (method, path, json body or raw bytes)
SESSION = [
    ("post", "/plan", {"intent": ""}),
    ("post", "/plan", b"{not json"),
    ("post", "/plan", b"[1, 2]"),
    ("post", "/plan", {"intent": "do something"}),  # empty registry: 422
    ("post", "/execute", {"graph": {"nodes": [{"name": "a"}], "edges": [{"from": "a", "to": "ghost"}]}}),
    ("post", "/execute", {"graph": 5}),
    ("post", "/execute", {"graph": GRAPH, "payload": [1]}),
    ("post", "/plan_and_execute", {"intent": "  "}),
    ("post", "/plan_and_execute", {"intent": "x", "payload": "y"}),
    *[("post", "/services", r) for r in RECORDS],
    ("post", "/services", {"endpoint": "local://nameless"}),
    ("get", "/services", None),
    ("get", "/services/search", None),
    ("get", "/services/nope", None),
    ("post", "/plan", {"intent": "search documents and summarize"}),
    ("post", "/plan", {"intent": "search documents and summarize"}),
    ("post", "/execute", {"graph": GRAPH, "payload": {"query": "q"}}),
    ("post", "/execute", {"graph": GRAPH}),
    ("post", "/plan_and_execute", {"intent": "search documents and summarize", "payload": {"query": "q"}}),
    ("post", "/plan_and_execute", {"intent": "rank items by score quality", "payload": {"query": "q"}}),
    ("get", "/cache", None),
    ("get", "/telemetry", None),
    ("get", "/healthz", None),
    ("get", "/traces", None),
    ("get", "/traces/deadbeef", None),
    ("get", "/costs", None),
    ("delete", "/services/summarize", None),
    ("delete", "/services/summarize", None),
    ("get", "/services", None),
]


async def _session(ns):
    cfg = ns["Config"].from_dict({
        "planner": {"kind": "heuristic", "shortlist_top_k": 2},
        "orchestrator": {"retry_backoff_s": 0.0, "default_retries": 0},
    })
    cp = ns["build"](cfg, transport=_transport(ns, failing={"rank-broken"}))
    # Calls are recorded at 0 ms: the heuristic planner ranks and explains
    # with the EWMA latency, which would otherwise come from the wall clock.
    record = cp.telemetry.record
    cp.telemetry.record = lambda service, *, latency_ms, ok, cost=0.0: record(
        service, latency_ms=0.0, ok=ok, cost=cost
    )

    async def drive(client):
        out = []
        for method, path, body in SESSION:
            kw = {"data": body} if isinstance(body, bytes) else {"json": body} if body is not None else {}
            r = await getattr(client, method)(path, **kw)
            payload = await r.json()
            out.append((method, path, r.status, masked(payload), r.status != 200 or bool(r.headers.get("X-Trace-Id"))))
        return out

    return await with_client(ns["app"](cp), drive)


def test_app_session_matches_reference():
    ref = asyncio.run(_session(REF))
    port = asyncio.run(_session(PORT))
    for want, got in zip(ref, port):
        assert got == want
    statuses = [s for _, _, s, _, _ in port]
    assert {400, 404, 422, 200, 201} <= set(statuses)
    replanned = port[SESSION.index(("post", "/plan_and_execute", {
        "intent": "rank items by score quality", "payload": {"query": "q"}}))][3]
    assert replanned["replans"] == 1 and replanned["status"] == "ok"


async def _saturate(ns):
    cfg = ns["Config"].from_dict({"server": {"max_concurrency": 1}, "planner": {"kind": "heuristic"}})
    cp = ns["build"](cfg, transport=_transport(ns, latencies={"slow": 0.3}))

    async def drive(client):
        graph = {"nodes": [{"name": "slow", "endpoint": "local://slow"}], "edges": []}
        r1, r2 = await asyncio.gather(
            client.post("/execute", json={"graph": graph}),
            client.post("/execute", json={"graph": graph}),
        )
        ok, refused = (r1, r2) if r1.status == 200 else (r2, r1)
        # Non-limited endpoints stay available while saturated.
        health = await client.get("/healthz")
        return (
            sorted([r1.status, r2.status]), bool(ok.headers.get("X-Trace-Id")),
            masked(await refused.json()), health.status,
        )

    return await with_client(ns["app"](cp), drive)


def test_max_concurrency_429_matches_reference():
    ref = asyncio.run(_saturate(REF))
    port = asyncio.run(_saturate(PORT))
    assert port == ref
    assert port[0] == [200, 429] and port[1] and port[3] == 200
    assert port[2] == {"error": "server at max concurrency, retry later", "trace_id": None}


async def _timeout(ns):
    cfg = ns["Config"].from_dict({"server": {"request_timeout_s": 0.05}, "planner": {"kind": "heuristic"}})
    cp = ns["build"](cfg, transport=_transport(ns, latencies={"slow": 0.5}))

    async def drive(client):
        graph = {"nodes": [{"name": "slow", "endpoint": "local://slow", "timeout_s": 2.0}], "edges": []}
        r = await client.post("/execute", json={"graph": graph})
        return r.status, masked(await r.json())

    return await with_client(ns["app"](cp), drive)


def test_request_timeout_504_matches_reference():
    ref = asyncio.run(_timeout(REF))
    port = asyncio.run(_timeout(PORT))
    assert port == ref
    assert port[0] == 504 and "exceeded" in port[1]["error"]


def test_plan_timeout_reaps_engine_row_and_capacity_recovers():
    """The 504 of an abandoned /plan cancels the engine future; the worker
    reaps the row and its pages, and a later request gets the capacity.
    Each decode window (one token: ``decode_steps_per_tick=1``, no
    fast-forward) is slowed by 0.3 s, so a plan of 40-odd tokens cannot end
    inside the 2 s timeout, which lands while the row decodes."""

    async def go():
        cfg = MCPXConfig.from_dict({
            "model": {"size": "test", "max_seq_len": 256},
            "server": {"request_timeout_s": 2.0},
            "planner": {"kind": "llm", "max_plan_retries": 0},
            "retrieval": {"enabled": False},
            "engine": {
                "max_batch_size": 1,  # a single row: a zombie would block ALL capacity
                "max_decode_len": 96, "kv_page_size": 16, "max_pages_per_seq": 16,
                "temperature": 0.0, "decode_steps_per_tick": 1, "speculate_k": 0,
            },
        })
        cp = build_control_plane(cfg, device="cpu")
        await cp.registry.put(ServiceRecord(name="svc-a", endpoint="local://svc-a"))
        await cp.startup()
        eng = cp.planner.engine
        windows = []
        real_run = eng._run_window

        def slow_run(slab, key, dfa):
            windows.append(key)
            real_run(slab, key, dfa)
            __import__("time").sleep(0.3)

        eng._run_window = slow_run

        async def drive(client):
            r = await client.post("/plan", json={"intent": "slow plan please"})
            assert r.status == 504
            assert windows, "the row never reached a decode window"

            def row_seqs():
                return eng._allocator.stats().sequences - len(eng._prefix_cache)

            for _ in range(200):
                await asyncio.sleep(0.05)
                if row_seqs() == 0 and eng._slab.n_active == 0:
                    break
            assert row_seqs() == 0 and eng._slab.n_active == 0
            eng._run_window = real_run
            res = await eng.generate(eng.tokenizer.encode("quick"), max_new_tokens=4)
            assert res.generated_tokens > 0

        await with_client(build_app(cp), drive)
        assert eng.state == "closed"  # the app's cleanup closed the engine

    asyncio.run(go())


def test_main_serves_the_configured_app(tmp_path, monkeypatch):
    from mcpx_torch.server import app as app_mod

    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"planner": {"kind": "heuristic"}, "server": {"host": "127.0.0.1"}}')
    served = {}
    monkeypatch.setattr(app_mod.web, "run_app", lambda app, host, port: served.update(app=app, host=host, port=port))
    assert app_mod.main(["--config", str(cfg), "--port", "8123", "--device", "cpu"]) == 0
    assert (served["host"], served["port"]) == ("127.0.0.1", 8123)
    routes = {(r.method, r.resource.canonical) for r in served["app"].router.routes()}
    assert {("POST", "/plan"), ("POST", "/execute"), ("POST", "/plan_and_execute"),
            ("GET", "/healthz"), ("DELETE", "/services/{name}")} <= routes


# ------------------------------------------------------------ observability
def _scrape(text: str, openmetrics: bool = False) -> dict:
    from prometheus_client.openmetrics.parser import text_string_to_metric_families as parse_om
    from prometheus_client.parser import text_string_to_metric_families as parse_text

    out = {}
    for fam in (parse_om if openmetrics else parse_text)(text):
        for s in fam.samples:
            out[(s.name, tuple(sorted(s.labels.items())))] = (s.value, s.exemplar)
    return out


COUNTED = ("mcpx_requests_total", "mcpx_plans_total", "mcpx_plan_cache_total",
           "mcpx_node_attempts_total", "mcpx_service_calls_total", "mcpx_replans_total")


async def _observe(ns):
    cfg = ns["Config"].from_dict({
        "planner": {"kind": "heuristic", "shortlist_top_k": 2},
        "orchestrator": {"retry_backoff_s": 0.0, "default_retries": 0},
    })
    cp = ns["build"](cfg, transport=_transport(ns, failing={"rank-broken"}))
    for rec in RECORDS:
        await cp.registry.put(ns["Record"].from_dict(rec))
    upstream_trace, upstream_span = "f" * 31 + "e", "a" * 16

    async def drive(client):
        r = await client.post("/plan", json={"intent": "search documents and summarize"})
        tid = r.headers["X-Trace-Id"]
        assert r.headers["traceparent"].split("-")[1] == tid and cp.tracer.get(tid) is not None
        r2 = await client.post(
            "/plan", json={"intent": "search documents"},
            headers={"traceparent": f"00-{upstream_trace}-{upstream_span}-01"},
        )
        assert r2.headers["X-Trace-Id"] == upstream_trace
        assert r2.headers["traceparent"].split("-")[1] == upstream_trace
        assert cp.tracer.get(upstream_trace).remote_parent == upstream_span
        await client.post("/plan_and_execute", json={"intent": "rank items by score quality", "payload": {"query": "q"}})
        # The last observation of a bucket holds its exemplar: the 400 is
        # the last /plan before the scrape, and its trace is kept.
        bad = await client.post("/plan", json={"intent": " "})
        bad_tid = bad.headers["X-Trace-Id"]
        full = await (await client.get(f"/traces/{tid}")).json()
        chrome = await (await client.get(f"/traces/{tid}?format=chrome")).json()
        text = await client.get("/metrics")
        om = await client.get("/metrics", headers={"Accept": "application/openmetrics-text"})
        scraped = _scrape(await text.text())
        om_scraped = _scrape(await om.text(), openmetrics=True)
        exemplars = {ex.labels["trace_id"] for v, ex in om_scraped.values() if ex is not None}
        counters = {k: v for k, (v, _) in scraped.items() if k[0] in COUNTED}
        names = [s["name"] for s in full["tree"]]
        n_listed = len((await (await client.get("/traces")).json())["traces"])
        return dict(
            text_type=text.headers["Content-Type"], om_type=om.headers["Content-Type"],
            counters=counters, tid_exemplar=bad_tid in exemplars,
            exemplars_kept=all(cp.tracer.get(t) is not None for t in exemplars), names=names,
            chrome=sorted(e["name"] for e in chrome["traceEvents"] if e["ph"] == "X"),
            n_listed=n_listed,
        )

    return await with_client(ns["app"](cp), drive)


def test_metrics_traces_and_traceparent_match_reference():
    from mcpx.registry.base import ServiceRecord as JRecord

    ref = asyncio.run(_observe(dict(REF, Record=JRecord)))
    port = asyncio.run(_observe(dict(PORT, Record=ServiceRecord)))
    assert port == ref
    assert port["text_type"].startswith("text/plain") and "openmetrics" in port["om_type"]
    assert port["tid_exemplar"] and port["exemplars_kept"]
    assert port["names"] == ["/plan", "plan", "plan.context"]
    assert port["counters"][("mcpx_requests_total", (("endpoint", "/plan"), ("status", "ok")))] == 2
    assert port["counters"][("mcpx_replans_total", ())] == 1
    assert port["n_listed"] == 4  # the 400 is kept: head sampling keeps everything


async def _tail_sampling(ns):
    cfg = ns["Config"].from_dict({"planner": {"kind": "heuristic"}, "tracing": {"sample_rate": 0.0}})
    cp = ns["build"](cfg, transport=_transport(ns))

    async def drive(client):
        bad = await client.post("/plan", json={"intent": "   "})
        missing = await client.post("/no-such-route", json={})
        kept_before = len(cp.tracer.traces())
        cp.orchestrator.execute = None  # the handler fails with a 500
        boom = await client.post("/execute", json={"graph": GRAPH})
        return bad.status, missing.status, kept_before, boom.status, len(cp.tracer.traces())

    return await with_client(ns["app"](cp), drive)


def test_tail_sampling_keeps_5xx_and_drops_4xx_as_reference():
    ref = asyncio.run(_tail_sampling(REF))
    port = asyncio.run(_tail_sampling(PORT))
    assert port == ref == (400, 404, 0, 500, 1)


async def _untraced(ns):
    cfg = ns["Config"].from_dict({"planner": {"kind": "heuristic"}, "tracing": {"enabled": False}})
    cp = ns["build"](cfg, transport=_transport(ns))
    await cp.registry.put(ns["Record"].from_dict(RECORDS[0]))

    async def drive(client):
        ok = await client.post("/plan", json={"intent": "search documents"})
        bad = await client.post("/plan", json={"intent": "   "})
        listing = await (await client.get("/traces")).json()
        return ("traceparent" in ok.headers, bool(ok.headers["X-Trace-Id"]), await bad.json(), listing)

    return await with_client(ns["app"](cp), drive)


def test_tracing_disabled_surface_matches_reference():
    from mcpx.registry.base import ServiceRecord as JRecord

    ref = asyncio.run(_untraced(dict(REF, Record=JRecord)))
    port = asyncio.run(_untraced(dict(PORT, Record=ServiceRecord)))
    assert port == ref == (False, True, {"error": "'intent' must be a non-empty string"}, {"traces": []})


def test_profile_routes_write_a_torch_profiler_trace(tmp_path):
    cfg = MCPXConfig.from_dict({"planner": {"kind": "heuristic"}, "server": {"profile_dir": str(tmp_path / "d")}})
    cp = build_control_plane(cfg, device="cpu", transport=_transport(PORT))

    async def drive(client):
        out = [await client.post("/profile/stop")]
        out.append(await client.post("/profile/start", json={"dir": 5}))
        out.append(await client.post("/profile/start"))
        out.append(await client.post("/profile/start"))
        out.append(await client.post("/execute", json={"graph": GRAPH, "payload": {"query": "q"}}))
        out.append(await client.post("/profile/stop"))
        out.append(await client.post("/profile/stop"))
        return [(r.status, await r.json()) for r in out]

    res = asyncio.run(with_client(build_app(cp), drive))
    d = str(tmp_path / "d")
    assert [s for s, _ in res] == [409, 400, 200, 409, 200, 200, 409]
    assert res[0][1]["error"] == "profiling not active"
    assert res[2][1] == {"profiling": "started", "dir": d}
    assert res[3][1]["error"] == f"profiling already active (dir={d})"
    assert res[5][1] == {"profiling": "stopped", "dir": d}
    traces = list((tmp_path / "d").glob("*.json"))
    assert len(traces) == 1 and '"traceEvents"' in traces[0].read_text()


def test_costs_and_metrics_of_a_cpu_engine():
    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 256},
        "planner": {"kind": "llm"},
        "engine": {"max_batch_size": 2, "max_decode_len": 16, "kv_page_size": 16, "max_pages_per_seq": 16},
    })
    cp = build_control_plane(cfg, device="cpu")
    # The app starts the engine in the background: its setup waits until the
    # cold read is made, so the read cannot race a fast startup.
    engine, cold_read = cp.planner.engine, threading.Event()
    setup = engine._setup
    engine._setup = lambda: (cold_read.wait(30), setup())

    async def drive(client):
        await cp.registry.put(ServiceRecord(name="svc-a", endpoint="local://svc-a"))
        cold = await (await client.get("/costs")).json()
        cold_read.set()
        await cp.startup()
        r = await client.post("/plan", json={"intent": "do a"})
        assert r.status == 200
        costs = await (await client.get("/costs")).json()
        text = await (await client.get("/metrics")).text()
        rec = cp.tracer.get(r.headers["X-Trace-Id"])
        return cold, costs, text, sorted({s.name for s in rec.spans})

    cold, costs, text, names = asyncio.run(with_client(build_app(cp), drive))
    assert cold["device"] is None and cold["reason"] == "engine not ready; device stats deferred"
    assert set(costs) == {"engine", "engine_state", "pallas", "device"}
    assert costs["engine_state"] == "ready"
    assert {"prefill", "admit", "window"} <= set(costs["engine"]["executables"])
    assert costs["engine"]["totals"]["flops_executed"] > 0
    assert costs["pallas"]["paths"]["decode"]["dispatches"] > 0
    assert costs["pallas"]["paths"]["decode"]["engaged"] is False  # CPU tensors: the plain version
    assert costs["device"]["peaks"]["flops_per_chip"] is None
    assert costs["device"]["hbm"] == [{"device": "cpu", "available": False}]
    assert 'mcpx_engine_compiles_total{executable="window"}' in text
    assert 'mcpx_build_info{backend="cpu",torch="' in text
    assert {"engine.generate", "engine.queue_wait", "engine.prefill", "engine.decode", "engine.segment"} <= set(names)


def test_cache_route_shows_the_tier_and_governor_blocks():
    """``GET /cache`` with ``engine.kv_tier`` on: the prefix-cache block
    carries the spill tier's counters and the governor's per-tenant block
    under the reference's keys (its control plane read cold, the port's
    after its start-up generations and again after a few plans)."""
    raw = {
        "model": {"size": "test", "max_seq_len": 256},
        "planner": {"kind": "llm"},
        "engine": {
            "max_batch_size": 2, "max_decode_len": 16, "kv_page_size": 16, "max_pages_per_seq": 16,
            "kv_tier": {"enabled": True, "host_mb": 8.0},
        },
    }
    ref = jbuild(JConfig.from_dict(raw)).cache_stats()["prefix_cache"]
    cp = build_control_plane(MCPXConfig.from_dict(raw), device="cpu")

    async def drive(client):
        await cp.registry.put(ServiceRecord(name="svc-a", endpoint="local://svc-a", description="do a"))
        await cp.startup()
        try:
            cold = await (await client.get("/cache")).json()
            for intent in ("do a", "do a now", "please do a"):
                assert (await client.post("/plan", json={"intent": intent})).status == 200
            return cold, await (await client.get("/cache")).json()
        finally:
            await cp.planner.engine.aclose()

    cold, warm = asyncio.run(with_client(build_app(cp), drive))
    assert set(cold["prefix_cache"]) == set(ref)
    assert cold["prefix_cache"]["tier"] == ref["tier"]
    assert ref["tier"]["enabled"] is True and ref["governor"] == {}
    tenant = warm["prefix_cache"]["governor"]["default"]
    assert set(tenant) == {"weight", "resident_tokens", "host_tokens", "quota_tokens", "hits", "misses",
                           "hit_rate", "token_hit_rate"}
    lookups = tenant["hits"] + tenant["misses"]
    assert tenant["resident_tokens"] > 0 and lookups > sum(
        cold["prefix_cache"]["governor"].get("default", {}).get(k, 0) for k in ("hits", "misses")
    )
    assert warm["prefix_cache"]["tier"]["host_bytes_budget"] == 8 << 20


async def _cluster_route(ns, pkg: str):
    from tests.test_torch_cluster import PKGS as CLUSTER, _pool, _strip

    out = {}
    cp = ns["build"](ns["Config"].from_dict({"planner": {"kind": "heuristic"}}), transport=_transport(ns))

    async def get(client):
        return (await client.get("/cluster")).status, await (await client.get("/cluster")).json()

    out["disabled"] = await with_client(ns["app"](cp), get)
    pool, _ = _pool(CLUSTER[pkg], 2)
    await pool.start()
    for ids in ([1, 2, 3], [4, 5], [1, 2, 3]):
        await pool.generate(ids)
    await pool.kill(1)
    cp = ns["build"](ns["Config"].from_dict({"planner": {"kind": "heuristic"}}), transport=_transport(ns))
    cp.cluster = pool

    async def refreshed(client):
        before = len(pool._rings[0].ring)
        await asyncio.sleep(0.3)  # the loop refreshes every 0.05 s
        status, body = await get(client)
        return status, body, len(pool._rings[0].ring) > before

    status, body, grew = await with_client(ns["app"](cp), refreshed)
    after = len(pool._rings[0].ring)
    await asyncio.sleep(0.15)
    out["enabled"] = (status, _strip(body), grew, len(pool._rings[0].ring) == after)
    await pool.aclose()
    return out


def test_cluster_route_matches_reference():
    port = asyncio.run(_cluster_route(PORT, "port"))
    ref = asyncio.run(_cluster_route(REF, "reference"))
    assert port["disabled"] == ref["disabled"] == (200, {"enabled": False})
    status, body, grew, stopped = port["enabled"]
    assert status == 200 and grew and stopped
    assert body["enabled"] is True and body["ready"] == 1 and body["total"] == 2
    assert [e["kind"] for e in body["journal"]] == ["routed", "routed", "routed", "kill"]
    assert port["enabled"][:2] == ref["enabled"][:2]
