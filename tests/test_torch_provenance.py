"""Decision provenance in the port, held against the reference package on
the CPU (the cases of the reference's ``tests/test_provenance.py``):

  - ``emit`` needs a trail and a span, the per-trace cap drops and says so,
    an empty trail explains honestly, ``validate_explanation`` rejects the
    same malformed payloads, an unknown layer folds into ``other``: the
    same explanations and metric lines in both packages;
  - app parity: with provenance on, the explanations of ``/plan`` (an
    admission verdict and the plan's origin with its retrieval scores),
    ``/execute`` (a fallback that rescued a node) and
    ``/plan_and_execute`` (a breaker opening inside the attempt chain,
    then a replan around it) are equal field by field in both packages,
    apart from times and ids, narratives included; and the chaos case's
    routing leg: on a replica pool whose first generate kills its replica,
    the route, the resteer and the re-route lead the same trail, the
    decision ring and the failover journal name the request's trace;
  - off is a pass-through: no recorder, the same response, and the span
    tree with provenance on less its ``decision.*`` spans; tail sampling
    keeps the trail of a timed-out request.
"""

import asyncio
import copy
import re
from types import SimpleNamespace

import pytest
from aiohttp.test_utils import TestClient, TestServer

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.core.dag import Plan as JPlan
from mcpx.orchestrator.transport import LocalTransport as JLocalTransport
from mcpx.orchestrator.transport import RouterTransport as JRouterTransport
from mcpx.orchestrator.transport import TransportError as JTransportError
from mcpx.planner.mock import MockPlanner as JMockPlanner
from mcpx.resilience.chaos import ChaosProfile as JChaosProfile
from mcpx.resilience.chaos import ChaosTransport as JChaosTransport
from mcpx.server.app import build_app as jbuild_app
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.telemetry import provenance as jprov
from mcpx.telemetry import tracing as jtracing
from mcpx.telemetry.metrics import Metrics as JMetrics
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.dag import Plan
from mcpx_torch.orchestrator.transport import LocalTransport, RouterTransport, TransportError
from mcpx_torch.resilience.chaos import ChaosProfile, ChaosTransport
from mcpx_torch.server.app import build_app
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.telemetry import provenance as prov
from mcpx_torch.telemetry import tracing
from mcpx_torch.telemetry.metrics import Metrics


class MockPlanner:
    """The reference's canned test planner (``mcpx/planner/mock.py``), for
    the port's control plane: a fixed plan, or a factory of the context."""

    def __init__(self, plan=None, factory=None) -> None:
        self._plan, self._factory = plan, factory

    async def plan(self, intent, context):
        out = self._factory(intent, context) if self._factory is not None else self._plan
        if hasattr(out, "__await__"):
            out = await out
        plan = copy.deepcopy(out)
        plan.validate()
        plan.intent = intent
        plan.origin = plan.origin or "mock"
        return plan


PKGS = {
    "reference": SimpleNamespace(
        prov=jprov, tracing=jtracing, config=JConfig, metrics=JMetrics, plan=JPlan, build=jbuild,
        app=jbuild_app, local=JLocalTransport, router=JRouterTransport, error=JTransportError,
        mock=JMockPlanner, chaos=(JChaosProfile, JChaosTransport),
    ),
    "port": SimpleNamespace(
        prov=prov, tracing=tracing, config=MCPXConfig, metrics=Metrics, plan=Plan,
        build=lambda cfg, **kw: build_control_plane(cfg, device="cpu", **kw), app=build_app,
        local=LocalTransport, router=RouterTransport, error=TransportError, mock=MockPlanner,
        chaos=(ChaosProfile, ChaosTransport),
    ),
}
BOTH = ["reference", "port"]


def _recorder(pkg: str, max_records=64, metrics=None):
    p = PKGS[pkg]
    cfg = p.config().telemetry.provenance
    cfg.enabled = True
    cfg.max_records_per_trace = max_records
    return p.prov.ProvenanceRecorder(cfg, metrics=metrics)


def _tracer(pkg: str):
    return PKGS[pkg].tracing.Tracer(None, enabled=True, sample_rate=1.0)


def _norm(exp: dict) -> dict:
    """An explanation less its times and ids (narrative included)."""
    out = {k: v for k, v in exp.items() if k not in ("trace_id", "started_at", "total_ms")}
    out["decisions"] = []
    for d in exp["decisions"]:
        d = {k: v for k, v in d.items() if k != "t_ms"}
        if "signals" in d:  # a measured wait is a time too
            d["signals"] = {k: "<ms>" if k.endswith("_ms") else v for k, v in d["signals"].items()}
        out["decisions"].append(d)
    out["narrative"] = [
        re.sub(r"\(\w{12}\)", "(<id>)", re.sub(r"_ms=[\d.]+", "_ms=<ms>", re.sub(r"[+]?\d+\.\d+ ?ms", "<ms>", line)))
        for line in exp["narrative"]
    ]
    return out


# ------------------------------------------------------------------ unit: emit
def _emit_story(pkg: str) -> tuple:
    p = PKGS[pkg]
    rec = _recorder(pkg)
    results = [p.prov.emit("plan", "x")]
    token = p.prov.begin(rec)
    try:
        results += [p.prov.active(), p.prov.emit("plan", "x")]
        tracer = _tracer(pkg)
        root = tracer.start_request("/plan")
        with p.tracing.activate(root):
            results += [p.prov.active(), p.prov.emit("plan", "picked A", alternatives=["B"], signals={"s": 1})]
        tracer.finish(root)
        got = tracer.get(root.record.trace_id)
    finally:
        p.prov.end(token)
    results += [p.prov.begin(None), rec.records_emitted]
    p.prov.end(None)
    return results, [s.name for s in got.spans], _norm(p.prov.build_explanation(got))


def test_emit_requires_trail_and_span():
    port = _emit_story("port")
    assert port == _emit_story("reference")
    assert port[0] == [False, False, False, True, True, None, 1]
    assert "decision.plan" in port[1]


def _capped(pkg: str) -> tuple:
    p = PKGS[pkg]
    rec = _recorder(pkg, max_records=3)
    tracer = _tracer(pkg)
    root = tracer.start_request("/plan")
    token = p.prov.begin(rec)
    try:
        with p.tracing.activate(root):
            results = [p.prov.emit("plan", f"d{i}") for i in range(5)]
    finally:
        p.prov.end(token)
    tracer.finish(root)
    exp = p.prov.build_explanation(tracer.get(root.record.trace_id))
    return results, p.prov.validate_explanation(exp), _norm(exp)


def test_emit_cap_drops_and_explanation_reports_it():
    port = _capped("port")
    assert port == _capped("reference")
    results, problems, exp = port
    assert results == [True, True, True, False, False] and problems == []
    assert exp["dropped"] == 2 and [d["seq"] for d in exp["decisions"]] == [1, 2, 3]
    assert any("dropped" in line for line in exp["narrative"])


def _empty(pkg: str) -> dict:
    p = PKGS[pkg]
    tracer = _tracer(pkg)
    root = tracer.start_request("/plan")
    tracer.finish(root)
    exp = p.prov.build_explanation(tracer.get(root.record.trace_id))
    assert p.prov.validate_explanation(exp) == []
    return _norm(exp)


def test_empty_trail_explains_honestly():
    port = _empty("port")
    assert port == _empty("reference")
    assert port["decisions"] == [] and port["layers"] == []
    assert any("no decision records" in line for line in port["narrative"])


@pytest.mark.parametrize("obj", [
    None, [], {"decisions": [{"layer": "plan"}]},
    {"trace_id": "t", "name": "/plan", "total_ms": 1.0, "error": False, "layers": ["plan"], "narrative": ["x"],
     "decisions": [{"seq": 2, "layer": "plan", "choice": "b", "t_ms": 0.0},
                   {"seq": 1, "layer": "plan", "choice": "a", "t_ms": 0.0}]},
    {"trace_id": "t", "name": "/plan", "total_ms": 1.0, "error": False, "layers": [], "narrative": [],
     "decisions": "nope"},
    {"trace_id": "t", "name": "/plan", "total_ms": 1.0, "error": False, "layers": [], "narrative": [3],
     "decisions": [7]},
], ids=["none", "list", "missing_keys", "order", "empty_narrative", "bad_types"])
def test_validate_explanation_rejects_malformed(obj):
    problems = prov.validate_explanation(obj)
    assert problems == jprov.validate_explanation(obj)
    assert problems


def _provenance_lines(metrics) -> list:
    """The provenance counter's samples (the port writes no ``_created``
    samples, which the exposition formats leave optional)."""
    return sorted(
        line for line in metrics.render().decode().splitlines()
        if line.startswith("mcpx_provenance_records_total")
    )


def _unknown_layer(pkg: str) -> list:
    p = PKGS[pkg]
    m = p.metrics()
    rec = _recorder(pkg, metrics=m)
    tracer = _tracer(pkg)
    root = tracer.start_request("/plan")
    token = p.prov.begin(rec)
    try:
        with p.tracing.activate(root):
            p.prov.emit("plan", "ok")
            p.prov.emit("not-a-layer", "typo'd layer")
    finally:
        p.prov.end(token)
    tracer.finish(root)
    return _provenance_lines(m)


def test_unknown_layer_folds_into_other_metric_label():
    port = _unknown_layer("port")
    assert port == _unknown_layer("reference")
    assert 'mcpx_provenance_records_total{layer="other"} 1.0' in port


# --------------------------------------------------------------- app parity
class _Svc:
    def __init__(self, name: str, error_cls=None) -> None:
        self.name, self._error_cls = name, error_cls

    async def __call__(self, payload):
        if self._error_cls is not None:
            raise self._error_cls(f"{self.name} injected failure", status=500)
        return {"ok": True, "service": self.name}


def _services(pkg: str):
    p = PKGS[pkg]
    local = p.local()
    for name in ("stable", "flaky", "primary-down", "backup"):
        local.register(name, _Svc(name, p.error if name == "primary-down" else None))
    return local


def _wire(nodes: list) -> dict:
    return {"nodes": nodes, "edges": []}


FLAKY = _wire([{"name": "f", "service": "flaky", "endpoint": "local://flaky", "retries": 2, "timeout_s": 2.0}])
STABLE = _wire([{"name": "s", "service": "stable", "endpoint": "local://stable", "retries": 0, "timeout_s": 2.0}])
RESCUE = _wire([{"name": "r", "service": "primary-down", "endpoint": "local://primary-down", "retries": 0,
                 "timeout_s": 2.0, "fallbacks": ["local://backup"]}])
RECORDS = [
    {"name": n, "endpoint": f"local://{n}", "description": d, "input_schema": {}, "output_schema": {}}
    for n, d in (("stable", "stable data service"), ("flaky", "flaky compose service"),
                 ("backup", "backup data service"))
]


async def _app_story(pkg: str) -> dict:
    p = PKGS[pkg]
    base = p.router(local=_services(pkg))
    profile_cls, chaos_cls = p.chaos
    chaos = chaos_cls(base, profile_cls.from_dict(
        {"seed": 42, "endpoints": {"local://flaky": {"error_rate": 1.0, "error_status": 500}}}
    ))
    config = p.config.from_dict({
        "telemetry": {"provenance": {"enabled": True}},
        "scheduler": {"enabled": True},
        "resilience": {"enabled": True, "breaker_consecutive_failures": 2, "breaker_min_samples": 50,
                       "hedge_enabled": False},
    })
    flaky, stable = p.plan.from_wire(FLAKY), p.plan.from_wire(STABLE)

    def factory(intent, context):
        return stable if "flaky" in context.exclude else flaky

    cp = p.build(config, transport=chaos, planner=p.mock(factory=factory))
    client = TestClient(TestServer(p.app(cp)))
    await client.start_server()
    try:
        for rec in RECORDS:
            assert (await client.post("/services", json=rec)).status == 201
        out = {}
        for path, body in (
            ("/plan", {"intent": "compose flaky data"}),
            ("/execute", {"graph": RESCUE, "payload": {}}),
            ("/plan_and_execute", {"intent": "compose flaky then recover", "payload": {}}),
        ):
            resp = await client.post(path, json=body)
            assert resp.status == 200, await resp.text()
            reply = await resp.json()
            exp = await (await client.get(f"/explain/{resp.headers['X-Trace-Id']}")).json()
            assert p.prov.validate_explanation(exp) == []
            out[path] = (reply.get("status"), reply.get("replans"), _norm(exp))
        out["missing"] = (await client.get("/explain/nope")).status
        out["metrics"] = _provenance_lines(cp.metrics)
        return out
    finally:
        await client.close()


@pytest.fixture(scope="module")
def app_runs():
    return asyncio.run(_app_story("reference")), asyncio.run(_app_story("port"))


@pytest.mark.parametrize("path", ["/plan", "/execute", "/plan_and_execute"])
def test_explanations_match_reference_field_by_field(app_runs, path):
    ref, port = app_runs
    assert port[path] == ref[path]
    status, replans, exp = port[path]
    choices = [d["choice"] for d in exp["decisions"]]
    if path == "/plan":
        assert exp["layers"] == ["plan", "sched"]
        assert choices[0] == "admitted (primary tier)" and choices[1].startswith("planned via MockPlanner")
    elif path == "/execute":
        assert status == "ok" and choices == ["fallback to local://backup succeeded"]
    else:
        # Plan, the breaker opening inside the attempt chain, the replan
        # naming the exclusion, the second plan: in that order.
        assert status == "ok" and replans == 1
        at = {k: next(i for i, c in enumerate(choices) if k in c) for k in (
            "planned via MockPlanner", "circuit breaker open: skipped local://flaky", "replan attempt 1")}
        assert at["planned via MockPlanner"] < at["circuit breaker open: skipped local://flaky"] < at["replan attempt 1"]
        replan = exp["decisions"][at["replan attempt 1"]]
        assert replan["detail"]["excluded"] == ["flaky"]
        assert any("planned via MockPlanner" in c for c in choices[at["replan attempt 1"] + 1:])


def test_explain_unknown_trace_and_layer_counters_match(app_runs):
    ref, port = app_runs
    assert port["missing"] == ref["missing"] == 404
    assert port["metrics"] == ref["metrics"]
    assert any('layer="resilience"' in line for line in port["metrics"])


# ------------------------------------------------------------------ parity
async def _off_on(pkg: str) -> dict:
    p = PKGS[pkg]
    out = {}
    for enabled in (False, True):
        cfg = p.config()
        cfg.telemetry.provenance.enabled = enabled
        local = p.local()
        local.register("svc", _Svc("svc"))
        cp = p.build(cfg, transport=p.router(local=local))
        assert (cp.provenance is not None) == enabled
        client = TestClient(TestServer(p.app(cp)))
        await client.start_server()
        try:
            await client.post("/services", json={
                "name": "svc", "endpoint": "local://svc", "description": "canned data service",
                "input_schema": {}, "output_schema": {},
            })
            resp = await client.post("/plan", json={"intent": "use svc"})
            assert resp.status == 200
            body = await resp.json()
            body.pop("latency_ms")
            rec = cp.tracer.get(resp.headers["X-Trace-Id"])
            out[enabled] = (body, [s.name for s in rec.spans], _norm(p.prov.build_explanation(rec)))
        finally:
            await client.close()
    return out


@pytest.mark.parametrize("pkg", BOTH)
def test_provenance_off_is_pass_through(pkg):
    out = asyncio.run(_off_on(pkg))
    (body_off, names_off, exp_off), (body_on, names_on, _) = out[False], out[True]
    assert body_off == body_on
    assert names_off == [n for n in names_on if not n.startswith("decision.")]
    assert any(n.startswith("decision.") for n in names_on)
    assert exp_off["decisions"] == []
    if pkg == "port":
        assert out == asyncio.run(_off_on("reference"))


async def _timed_out(pkg: str) -> tuple:
    p = PKGS[pkg]
    cfg = p.config.from_dict({
        "telemetry": {"provenance": {"enabled": True}},
        "tracing": {"sample_rate": 0.0, "keep_errors": True},
        "server": {"request_timeout_s": 0.15},
    })
    local = p.local()
    local.register("svc", _Svc("svc"), latency_s=0.5)
    plan = p.plan.from_wire(_wire([{"name": "s", "service": "svc", "endpoint": "local://svc", "retries": 0,
                                    "timeout_s": 2.0}]))
    cp = p.build(cfg, transport=p.router(local=local), planner=p.mock(plan=plan))
    client = TestClient(TestServer(p.app(cp)))
    await client.start_server()
    try:
        resp = await client.post("/plan", json={"intent": "quick"})
        assert resp.status == 200
        unsampled = (await client.get(f"/explain/{resp.headers['X-Trace-Id']}")).status
        resp = await client.post("/plan_and_execute", json={"intent": "slow", "payload": {}})
        assert resp.status == 504
        tid = (await resp.json())["trace_id"]
        exp = await (await client.get(f"/explain/{tid}")).json()
        return unsampled, p.prov.validate_explanation(exp), exp["error"], [d["layer"] for d in exp["decisions"]]
    finally:
        await client.close()


def test_tail_sampling_keeps_decision_trail_on_error():
    port = asyncio.run(_timed_out("port"))
    assert port == asyncio.run(_timed_out("reference"))
    unsampled, problems, error, layers = port
    assert unsampled == 404 and problems == [] and error is True and "plan" in layers


# ------------------------------------------------------------ cluster routing
class _DyingEngine:
    """A pool replica (the reference test's ``DyingClusterEngine``): the
    first generate anywhere in the pool kills its replica mid-request, so
    the pool resteers; every later generate succeeds at once."""

    def __init__(self, index, first, port):
        self.index, self.first, self.port = index, first, port
        self.state = "cold"
        self.tokenizer = self.metrics = self.costs = None

    async def start(self):
        self.state = "ready"

    async def aclose(self):
        self.state = "closed"

    async def generate(self, prompt_ids, **kw):
        if self.state != "ready":
            raise self.first["error"](f"engine not ready (state={self.state})")
        if self.first["pending"]:
            self.first["pending"] = False
            self.state = "failed"
            raise self.first["error"]("chaos: replica killed mid-request")
        return {"replica": self.index}

    def queue_stats(self):
        names = ("queue_depth", "active_rows") if self.port else ("depth", "active")
        return {names[0]: 0, names[1]: 0, "service_ewma_s": 0.01, "eta_s": 0.0}


async def _routing_story(pkg: str) -> dict:
    from mcpx.cluster import EnginePool as JPool
    from mcpx.core.errors import EngineError as JEngineError
    from mcpx_torch.cluster import EnginePool
    from mcpx_torch.core.errors import EngineError

    p = PKGS[pkg]
    port = pkg == "port"
    base = p.router(local=_services(pkg))
    profile_cls, chaos_cls = p.chaos
    chaos = chaos_cls(base, profile_cls.from_dict(
        {"seed": 42, "endpoints": {"local://flaky": {"error_rate": 1.0, "error_status": 500}}}
    ))
    config = p.config.from_dict({
        "telemetry": {"provenance": {"enabled": True}},
        "resilience": {"enabled": True, "breaker_consecutive_failures": 2, "breaker_min_samples": 50,
                       "hedge_enabled": False},
    })
    flaky, stable = p.plan.from_wire(FLAKY), p.plan.from_wire(STABLE)
    holder = {}

    async def factory(intent, context):
        # One pool generate per plan (the decode an LLM planner would run),
        # then a canned plan around the excluded services.
        await holder["pool"].generate([1, 2, 3, 4], max_new_tokens=4)
        return stable if "flaky" in context.exclude else flaky

    cp = p.build(config, transport=chaos, planner=p.mock(factory=factory))
    pool_cfg = p.config()
    pool_cfg.cluster.replicas = 2
    pool_cfg.telemetry.provenance.enabled = True
    first = {"pending": True, "error": EngineError if port else JEngineError}
    pool = (EnginePool if port else JPool)(
        pool_cfg, metrics=cp.metrics, engine_factory=lambda i, _cfg: _DyingEngine(i, first, port)
    )
    holder["pool"] = pool
    await pool.start()
    client = TestClient(TestServer(p.app(cp)))
    await client.start_server()
    try:
        resp = await client.post("/plan_and_execute", json={"intent": "compose flaky then recover", "payload": {}})
        assert resp.status == 200, await resp.text()
        body = await resp.json()
        tid = resp.headers["X-Trace-Id"]
        exp = await (await client.get(f"/explain/{tid}")).json()
        ring = pool._pipeline.recent_decisions()
        journal = pool.journal.tail()
        resteer = next(e for e in journal if e["kind"] == "resteer")
        text = cp.metrics.render().decode()
        return {
            "reply": (body["status"], body["replans"]), "problems": p.prov.validate_explanation(exp),
            "explanation": _norm(exp), "ring_names_trace": any(d["trace_id"] == tid for d in ring),
            "journal": [(e["kind"], e["replica"]) for e in journal], "resteer_names_trace": resteer["trace_id"] == tid,
            "resteered_away": pool.attribution()["replicas"][str(resteer["replica"])]["resteered_away"],
            "route_lines": sorted(
                line for line in text.splitlines()
                if line.startswith(("mcpx_route_decisions_total", 'mcpx_provenance_records_total{layer="route"}'))
            ),
        }
    finally:
        await client.close()
        await pool.aclose()


def test_chaos_request_explains_its_routing_as_reference():
    port = asyncio.run(_routing_story("port"))
    assert port == asyncio.run(_routing_story("reference"))
    assert port["reply"] == ("ok", 1) and port["problems"] == []
    exp = port["explanation"]
    assert {"plan", "route", "resilience", "replan"} <= set(exp["layers"])
    choices = [d["choice"] for d in exp["decisions"]]

    def at(substr):
        return next(i for i, c in enumerate(choices) if substr in c)

    # route -> the replica dies -> resteer -> plan -> breaker -> replan
    assert at("routed to replica") < at("resteer away from replica") < at("planned via MockPlanner")
    assert at("planned via MockPlanner") < at("circuit breaker open: skipped local://flaky") < at("replan attempt 1")
    assert "queue" in "".join(exp["decisions"][at("routed to replica")]["contributions"])
    assert port["ring_names_trace"] and port["resteer_names_trace"] and port["resteered_away"] == 1
    assert ("resteer", 0) in port["journal"] or ("resteer", 1) in port["journal"]
    assert any(line.startswith("mcpx_route_decisions_total") for line in port["route_lines"])
