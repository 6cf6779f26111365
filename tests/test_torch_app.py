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
  - the 504 of a ``/plan`` frees the engine row the abandoned request held
    (the port of ``tests/test_server_limits.py``'s reaping test, on the
    port's CPU engine), and the engine serves again.
"""

import asyncio

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
WALL_CLOCK = ("latency_ms", "total_ms", "trace_id", "ewma_latency_ms")


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
