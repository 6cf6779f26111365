"""The execute path's pieces held against the reference package on the CPU:

  - the orchestrator: the cases of ``tests/test_orchestrator.py`` (and the
    retryability cases: a 4xx that skips retries, a 429's Retry-After,
    jittered backoff), each run through both packages' ``Orchestrator``
    over in-process fake services with one seeded ``random.Random`` each;
    ``ExecuteResult.to_dict()`` equal with timing fields and trace ids
    masked, the services' calls equal, the telemetry snapshots equal
    (calls, errors, EWMA error rate), and the original test's own check;
  - ``TransportError.retryable`` over a table of statuses, and
    ``RouterTransport``'s dispatch by scheme;
  - ``ReplanPolicy.assess`` over a grid of execution results and telemetry;
  - ``TelemetryStore``: the EWMAs, the blend of peer snapshots, pruning.
"""

import asyncio
import random
import time

import pytest

from mcpx.core.config import OrchestratorConfig as JOrchestratorConfig
from mcpx.core.config import TelemetryConfig as JTelemetryConfig
from mcpx.core.dag import Plan as JPlan
from mcpx.orchestrator import executor as jexecutor
from mcpx.orchestrator import transport as jtransport
from mcpx.registry import InMemoryRegistry as JRegistry
from mcpx.registry import ServiceRecord as JRecord
from mcpx.telemetry.replan import ReplanPolicy as JReplanPolicy
from mcpx.telemetry.stats import TelemetryStore as JTelemetryStore
from mcpx_torch.core.config import OrchestratorConfig, TelemetryConfig
from mcpx_torch.core.dag import Plan
from mcpx_torch.orchestrator import executor, transport
from mcpx_torch.registry import InMemoryRegistry, ServiceRecord
from mcpx_torch.telemetry.replan import ReplanPolicy
from mcpx_torch.telemetry.stats import TelemetryStore

# One namespace per package: the same scenario is built from each.
REF = dict(
    Plan=JPlan, Orchestrator=jexecutor.Orchestrator, Config=JOrchestratorConfig,
    TransportError=jtransport.TransportError, LocalTransport=jtransport.LocalTransport,
    RouterTransport=jtransport.RouterTransport, Transport=jtransport.Transport,
    Registry=JRegistry, Record=JRecord, Telemetry=JTelemetryStore,
    ReplanPolicy=JReplanPolicy, TelemetryConfig=JTelemetryConfig,
)
PORT = dict(
    Plan=Plan, Orchestrator=executor.Orchestrator, Config=OrchestratorConfig,
    TransportError=transport.TransportError, LocalTransport=transport.LocalTransport,
    RouterTransport=transport.RouterTransport, Transport=transport.Transport,
    Registry=InMemoryRegistry, Record=ServiceRecord, Telemetry=TelemetryStore,
    ReplanPolicy=ReplanPolicy, TelemetryConfig=TelemetryConfig,
)


class FakeService:
    """The reference tests' scriptable fake microservice, raising the given
    package's ``TransportError``: ``fail_times`` fails the first N calls,
    ``always_fail`` every call."""

    def __init__(self, error_cls, name, *, fail_times=0, always_fail=False, result=None,
                 error_status=0, retry_after_s=None):
        self.error_cls, self.name = error_cls, name
        self.calls = []
        self._fail_times, self._always_fail, self._result = fail_times, always_fail, result
        self._error_status, self._retry_after_s = error_status, retry_after_s

    async def __call__(self, payload):
        self.calls.append(payload)
        if self._always_fail or len(self.calls) <= self._fail_times:
            raise self.error_cls(
                f"{self.name} injected failure #{len(self.calls)}",
                status=self._error_status, retry_after_s=self._retry_after_s,
            )
        if self._result is not None:
            return self._result
        return {"service": self.name, "echo": payload}


def masked(obj):
    """``obj`` with wall-clock fields and trace ids replaced by None."""
    if isinstance(obj, dict):
        return {
            k: None if k in ("latency_ms", "total_ms", "trace_id") else masked(v)
            for k, v in obj.items()
        }
    if isinstance(obj, list):
        return [masked(v) for v in obj]
    return obj


def _node(name, **kw):
    return {"name": name, "endpoint": f"local://{name}", **kw}


# (services {name: FakeService options}, latencies, plan wire, payload,
#  registry records, backoff s, the original test's check on the result)
CASES = {
    "linear_chain": (
        {"a": {"result": {"doc": "D"}}, "b": {}}, {},
        {"nodes": [_node("a", inputs={"q": "query"}), _node("b", inputs={"doc": "a"})],
         "edges": [{"src": "a", "dst": "b"}]},
        {"query": "hello"}, None, 0.0,
        lambda res, svc: res.status == "ok" and svc["b"].calls == [{"doc": {"doc": "D"}}],
    ),
    "generation_concurrency": (
        {"l": {}, "r": {}}, {"l": 0.06, "r": 0.06},
        {"nodes": [_node("l"), _node("r")], "edges": []}, {}, None, 0.0,
        lambda res, svc: res.status == "ok",
    ),
    "retry_budget": (
        {"flaky": {"fail_times": 2}}, {}, {"nodes": [_node("flaky", retries=2)], "edges": []},
        {}, None, 0.0,
        lambda res, svc: res.status == "ok" and len(svc["flaky"].calls) == 3 and res.errors == {}
        and [a.kind for a in res.trace.nodes["flaky"].attempts] == ["primary", "retry", "retry"],
    ),
    "ordered_fallbacks": (
        {"p": {"always_fail": True}, "fb1": {"always_fail": True}, "fb2": {"result": {"ok": True}}}, {},
        {"nodes": [{"name": "n", "endpoint": "local://p", "retries": 0,
                    "fallbacks": ["local://fb1", "local://fb2"]}], "edges": []},
        {}, None, 0.0,
        lambda res, svc: res.results["n"] == {"ok": True}
        and [a.kind for a in res.trace.nodes["n"].attempts] == ["primary", "fallback", "fallback"],
    ),
    "partial_failure_skips_dependents": (
        {"good": {"result": {"v": 1}}, "bad": {"always_fail": True}, "down": {}}, {},
        {"nodes": [_node("good"), _node("bad", retries=0), _node("down", inputs={"x": "bad"})],
         "edges": [{"src": "bad", "dst": "down"}]},
        {}, None, 0.0,
        lambda res, svc: res.status == "partial" and res.errors["down"].startswith("skipped:")
        and svc["down"].calls == [] and res.trace.nodes["down"].status == "skipped",
    ),
    "all_failed": (
        {"bad": {"always_fail": True}}, {}, {"nodes": [_node("bad", retries=0)], "edges": []},
        {}, None, 0.0, lambda res, svc: res.status == "failed" and res.results == {},
    ),
    "registry_resolution": (
        {"svc": {"always_fail": True}, "svc-fb": {"result": {"via": "fallback"}}}, {},
        {"nodes": [{"name": "svc", "retries": 0}], "edges": []}, {},
        [{"name": "svc", "endpoint": "local://svc", "fallbacks": ["local://svc-fb"]}], 0.0,
        lambda res, svc: res.status == "ok" and res.results["svc"] == {"via": "fallback"},
    ),
    "timeout": (
        {"slow": {}}, {"slow": 0.2},
        {"nodes": [_node("slow", retries=0, timeout_s=0.05)], "edges": []}, {}, None, 0.0,
        lambda res, svc: res.status == "failed"
        and res.trace.nodes["slow"].attempts[0].status == "timeout",
    ),
    "telemetry_recorded": (
        {"good": {}}, {}, {"nodes": [_node("good")], "edges": []}, {}, None, 0.0,
        lambda res, svc: res.status == "ok",
    ),
    "non_retryable_4xx_skips_retries": (
        {"gone": {"always_fail": True, "error_status": 404}, "alt": {"result": {"v": 2}}}, {},
        {"nodes": [{"name": "n", "endpoint": "local://gone", "retries": 3,
                    "fallbacks": ["local://alt"]}], "edges": []},
        {}, None, 0.0,
        lambda res, svc: len(svc["gone"].calls) == 1
        and [a.kind for a in res.trace.nodes["n"].attempts] == ["primary", "fallback"],
    ),
    "retry_after_429_and_jittered_backoff": (
        {"busy": {"fail_times": 2, "error_status": 429, "retry_after_s": 0.01}}, {},
        {"nodes": [_node("busy", retries=2)], "edges": []}, {}, None, 0.02,
        lambda res, svc: res.status == "ok" and len(svc["busy"].calls) == 3,
    ),
}


async def _run_case(ns, case, seed: int):
    services, latencies, wire, payload, records, backoff, _check = case
    local = ns["LocalTransport"]()
    svc = {}
    for name, opts in services.items():
        svc[name] = FakeService(ns["TransportError"], name, **opts)
        local.register(name, svc[name], latency_s=latencies.get(name, 0.0))
    registry = None
    if records is not None:
        registry = ns["Registry"]()
        for r in records:
            await registry.put(ns["Record"](**r))
    telemetry = ns["Telemetry"]()
    rng = random.Random(seed)
    orch = ns["Orchestrator"](
        local, ns["Config"](retry_backoff_s=backoff), registry=registry, telemetry=telemetry, rng=rng,
    )
    t0 = time.monotonic()
    res = await orch.execute(ns["Plan"].from_wire(wire), payload)
    elapsed = time.monotonic() - t0
    snap = {
        k: (s.calls, s.errors, round(s.ewma_error_rate, 12)) for k, s in telemetry.snapshot().items()
    }
    return res, svc, snap, rng.random(), elapsed


@pytest.mark.parametrize("name", sorted(CASES))
def test_orchestrator_matches_reference(name):
    case = CASES[name]
    ref, rsvc, rsnap, rnext, _ = asyncio.run(_run_case(REF, case, seed=7))
    port, psvc, psnap, pnext, elapsed = asyncio.run(_run_case(PORT, case, seed=7))
    assert masked(port.to_dict()) == masked(ref.to_dict())
    assert {k: s.calls for k, s in psvc.items()} == {k: s.calls for k, s in rsvc.items()}
    assert psnap == rsnap and psnap
    # The backoff drew as many numbers from the seeded rng in both.
    assert pnext == rnext
    assert case[-1](port, psvc), port.to_dict()
    if name == "generation_concurrency":
        # Two independent 60 ms nodes run concurrently, not serially.
        assert elapsed < 0.11, f"parallel generation took {elapsed:.3f}s (serial?)"


@pytest.mark.parametrize(
    "timeout,status,want",
    [(True, 0, True), (False, 0, True), (False, 400, False), (False, 404, False),
     (False, 408, True), (False, 429, True), (False, 499, False), (False, 500, True),
     (False, 503, True), (True, 404, True)],
)
def test_transport_error_retryable_matches_reference(timeout, status, want):
    port = transport.TransportError("x", timeout=timeout, status=status).retryable
    ref = jtransport.TransportError("x", timeout=timeout, status=status).retryable
    assert port == ref == want


@pytest.mark.parametrize("ns", [REF, PORT], ids=["reference", "port"])
def test_router_transport_dispatches_by_scheme(ns):
    class Http(ns["Transport"]):
        def __init__(self):
            self.urls = []
            self.closed = False

        async def post(self, url, payload, timeout_s):
            self.urls.append(url)
            return {"http": url}

        async def close(self):
            self.closed = True

    async def go():
        local = ns["LocalTransport"]()

        async def echo(payload):
            return {"local": payload}

        local.register("a", echo)
        http = Http()
        router = ns["RouterTransport"](local=local, http=http)
        out = [
            await router.post("local://a", {"k": 1}, 1.0),
            await router.post("http://svc/x", {"k": 2}, 1.0),
        ]
        with pytest.raises(ns["TransportError"]):
            await router.post("local://missing", {}, 1.0)
        await router.close()
        return out, http.urls, http.closed

    out, urls, closed = asyncio.run(go())
    assert out == [{"local": {"k": 1}}, {"http": "http://svc/x"}]
    assert urls == ["http://svc/x"] and closed


# ------------------------------------------------------------- replan policy
RESULTS = {
    "ok": ({"a": {}, "b": {}, "c": {}}, {}, "ok"),
    "partial": ({"a": {}}, {"b": "boom", "c": "skipped: upstream failed (b)"}, "partial"),
    "failed": ({}, {"a": "boom", "b": "skipped: upstream failed (a)", "c": "skipped: x"}, "failed"),
    "unknown_node": ({"a": {}}, {"ghost": "boom"}, "partial"),
}
# (service, latency_ms, ok) records into the telemetry store.
TELEMETRY = {
    "none": [],
    "error_rate": [("a", 1.0, False), ("a", 1.0, False), ("c", 1.0, True)],
    "slow": [("b", 900.0, True), ("c", 10.0, True)],
    "mixed": [("a", 5.0, True), ("a", 5.0, False), ("b", 300.0, False), ("c", 40.0, True)],
}


def _assess(ns, result_key, telemetry_key):
    plan = ns["Plan"].from_wire({
        "nodes": [{"name": "a"}, {"name": "b", "service": "svc-b"}, {"name": "c"}],
        "edges": [{"src": "a", "dst": "b"}, {"src": "b", "dst": "c"}],
    })
    results, errors, status = RESULTS[result_key]
    result = (jexecutor if ns is REF else executor).ExecuteResult(
        results=dict(results), errors=dict(errors), status=status
    )
    store = ns["Telemetry"]()
    for service, ms, ok in TELEMETRY[telemetry_key]:
        store.record("svc-b" if service == "b" else service, latency_ms=ms, ok=ok)
    records = {
        "svc-b": ns["Record"](name="svc-b", endpoint="local://b", cost_profile={"latency_ms": 100.0}),
        "c": ns["Record"](name="c", endpoint="local://c", cost_profile={"latency_ms": 20.0}),
    }
    policy = ns["ReplanPolicy"](ns["TelemetryConfig"](replan_error_rate=0.3, replan_latency_factor=2.0))
    d = policy.assess(plan, result, store, records)
    return d.should_replan, sorted(d.exclude), d.reasons, policy.max_replans


@pytest.mark.parametrize("telemetry_key", sorted(TELEMETRY))
@pytest.mark.parametrize("result_key", sorted(RESULTS))
def test_replan_policy_matches_reference(result_key, telemetry_key):
    ref = _assess(REF, result_key, telemetry_key)
    port = _assess(PORT, result_key, telemetry_key)
    assert port == ref
    if result_key == "ok":
        assert port[0] is False


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_telemetry_store_and_peer_blend_match_reference(alpha):
    """EWMAs, the call-weighted blend of peer replicas' snapshots (held apart
    from local observations, so a re-import is idempotent) and pruning."""
    from mcpx.telemetry.stats import ServiceStats as JStats
    from mcpx_torch.telemetry.stats import ServiceStats

    def run(store_cls, stats_cls):
        store = store_cls(alpha)
        rng = random.Random(11)
        for _ in range(40):
            store.record(rng.choice("abc"), latency_ms=rng.uniform(1, 90), ok=rng.random() < 0.7,
                         cost=rng.uniform(0, 2))
        peer = {"b": stats_cls("b", 50.0, 0.5, 1.0, calls=100, errors=50),
                "d": stats_cls("d", 5.0, 0.0, 0.1, calls=3, errors=0)}
        out = []
        for _ in range(2):  # a second import of the same snapshot changes nothing
            store.set_peer("r2", dict(peer))
            out.append({k: s.to_dict() for k, s in sorted(store.snapshot().items())})
        out.append(sorted(store.local_snapshot()))
        store.prune_peers({"r3"})
        out.append({k: s.to_dict() for k, s in sorted(store.snapshot().items())})
        store.reset()
        out.append(store.snapshot())
        return out

    port = run(TelemetryStore, ServiceStats)
    assert port == run(JTelemetryStore, JStats)
    assert port[0] == port[1] and "d" in port[0] and "d" not in port[3] and port[4] == {}
    with pytest.raises(ValueError):
        TelemetryStore(0.0)
