"""Fault-domain resilience in the port (``mcpx_torch/resilience/``), held
against the reference package on the CPU:

  - the cases of the reference's ``tests/test_resilience.py``, run against
    the port: the circuit-breaker lifecycle, deadline-budget attempt
    truncation, hedged attempts, the executor's retryability rules, chaos
    determinism, and the pass-through of ``/execute`` with resilience off
    (the app cases through aiohttp's test client);
  - the same seed gives the same fault stream from both packages'
    ``ChaosTransport``;
  - with resilience on, a seeded ``/execute`` set gives equal result
    statuses and attempt kinds and statuses in both packages, under an
    injected clock.
"""

import asyncio
import random
import time
from typing import Any

import pytest
from aiohttp.test_utils import TestClient, TestServer

from mcpx.core.config import OrchestratorConfig as JOrchestratorConfig
from mcpx.core.config import ResilienceConfig as JResilienceConfig
from mcpx.core.dag import DagNode as JDagNode
from mcpx.core.dag import Plan as JPlan
from mcpx.orchestrator.executor import Orchestrator as JOrchestrator
from mcpx.orchestrator.transport import LocalTransport as JLocalTransport
from mcpx.orchestrator.transport import TransportError as JTransportError
from mcpx.resilience import Resilience as JResilience
from mcpx.resilience.chaos import ChaosProfile as JChaosProfile
from mcpx.resilience.chaos import ChaosTransport as JChaosTransport
from mcpx.telemetry.stats import TelemetryStore as JTelemetryStore
from mcpx_torch.core.config import (
    MCPXConfig,
    OrchestratorConfig,
    ResilienceConfig,
    TelemetryConfig,
)
from mcpx_torch.core.dag import DagNode, Plan
from mcpx_torch.core.errors import ConfigError
from mcpx_torch.orchestrator.executor import Orchestrator
from mcpx_torch.orchestrator.transport import LocalTransport, RouterTransport, TransportError
from mcpx_torch.registry.base import ServiceRecord
from mcpx_torch.resilience import Resilience
from mcpx_torch.resilience.breaker import BreakerRegistry, CircuitBreaker
from mcpx_torch.resilience.chaos import ChaosProfile, ChaosTransport
from mcpx_torch.server.app import build_app
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.telemetry.metrics import Metrics
from mcpx_torch.telemetry.replan import ReplanPolicy
from mcpx_torch.telemetry.stats import TelemetryStore


class FakeService:
    """In-process microservice with scriptable failures (the reference
    tests' ``tests/helpers.py`` fake, raising the given package's
    ``TransportError``)."""

    def __init__(
        self,
        name: str,
        *,
        fail_times: int = 0,
        always_fail: bool = False,
        result: "dict[str, Any] | None" = None,
        error_status: int = 0,
        retry_after_s: "float | None" = None,
        error_cls=TransportError,
    ) -> None:
        self.name = name
        self.calls: list[dict[str, Any]] = []
        self._fail_times = fail_times
        self._always_fail = always_fail
        self._result = result
        self._error_status = error_status
        self._retry_after_s = retry_after_s
        self._error_cls = error_cls

    async def __call__(self, payload: dict[str, Any]) -> dict[str, Any]:
        self.calls.append(payload)
        if self._always_fail or len(self.calls) <= self._fail_times:
            raise self._error_cls(
                f"{self.name} injected failure #{len(self.calls)}",
                status=self._error_status,
                retry_after_s=self._retry_after_s,
            )
        if self._result is not None:
            return self._result
        return {"service": self.name, "echo": payload}


def make_transport(*services: FakeService, latencies: "dict[str, float] | None" = None, cls=LocalTransport):
    transport = cls()
    for svc in services:
        transport.register(svc.name, svc, latency_s=(latencies or {}).get(svc.name, 0.0))
    return transport


def make_app(*services: FakeService, config=None):
    transport = RouterTransport(local=make_transport(*services))
    config = config or MCPXConfig.from_dict({"planner": {"kind": "heuristic"}})
    cp = build_control_plane(config, transport=transport, device="cpu")
    return cp, build_app(cp)


async def with_client(app, fn):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        return await fn(client)
    finally:
        await client.close()


def run(coro):
    return asyncio.run(coro)


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


class FixedRng:
    """random.Random stand-in: fixed draws, recorded uniform() calls."""

    def __init__(self, random_value: float = 0.0, uniform_value=None):
        self.random_value = random_value
        self.uniform_value = uniform_value
        self.uniform_calls: list[tuple[float, float]] = []

    def random(self) -> float:
        return self.random_value

    def uniform(self, a: float, b: float) -> float:
        self.uniform_calls.append((a, b))
        return b if self.uniform_value is None else self.uniform_value


def orch(transport, *, resilience=None, rng=None, **cfg_kw):
    cfg_kw.setdefault("retry_backoff_s", 0.0)
    cfg = OrchestratorConfig(**cfg_kw)
    return Orchestrator(transport, cfg, resilience=resilience, rng=rng)


def res_cfg(**kw) -> ResilienceConfig:
    return ResilienceConfig(enabled=True, **kw)


# ------------------------------------------------------------------ breaker
def test_breaker_trips_on_consecutive_failures():
    clock = FakeClock()
    b = CircuitBreaker(res_cfg(breaker_consecutive_failures=3,
                               breaker_min_samples=100), clock=clock)
    for _ in range(2):
        b.record(False)
    assert b.state == "closed" and b.allow()
    b.record(False)
    assert b.state == "open" and not b.allow() and b.is_open()


def test_breaker_trips_on_error_rate():
    clock = FakeClock()
    b = CircuitBreaker(
        res_cfg(
            breaker_window=10,
            breaker_min_samples=4,
            breaker_error_threshold=0.5,
            breaker_consecutive_failures=100,
        ),
        clock=clock,
    )
    # Interleaved outcomes: never 100 consecutive, but 50% over the window.
    for ok in (True, False, True, False):
        b.record(ok)
        if b.state == "open":
            break
    assert b.state == "open"


def test_breaker_half_open_probe_recovers_and_reopens():
    clock = FakeClock()
    probe = FixedRng(random_value=0.0)  # every arrival probes
    b = CircuitBreaker(
        res_cfg(breaker_consecutive_failures=1, breaker_open_s=5.0,
                breaker_half_open_probe_p=0.3),
        clock=clock,
        rng=probe,
    )
    b.record(False)
    assert b.state == "open" and not b.allow()
    clock.t += 5.0
    # Cool-down elapsed: consult transitions to half-open, probe granted.
    assert b.allow() and b.state == "half_open"
    b.record(False)  # probe failed: fresh cool-down
    assert b.state == "open" and not b.allow()
    clock.t += 5.0
    assert b.allow()
    b.record(True)  # probe succeeded: closed
    assert b.state == "closed" and b.allow()


def test_breaker_half_open_probes_are_probabilistic():
    clock = FakeClock()
    no_probe = FixedRng(random_value=0.99)
    b = CircuitBreaker(
        res_cfg(breaker_consecutive_failures=1, breaker_open_s=1.0,
                breaker_half_open_probe_p=0.3),
        clock=clock,
        rng=no_probe,
    )
    b.record(False)
    clock.t += 1.0
    # Above the probe probability: this arrival keeps falling back.
    assert not b.allow() and b.state == "half_open"
    no_probe.random_value = 0.1
    assert b.allow()


def test_breaker_registry_gauge_and_transitions():
    m = Metrics()
    reg = BreakerRegistry(res_cfg(breaker_consecutive_failures=1),
                          metrics=m, clock=FakeClock())
    reg.record("local://down", False, service="svc-down")
    assert reg.is_open("local://down")
    text = m.render().decode()
    assert 'mcpx_breaker_state{service="svc-down"} 2.0' in text
    assert 'mcpx_breaker_transitions_total{state="open"} 1.0' in text


# ------------------------------------------------- breaker through executor
def test_executor_skips_open_endpoint_to_fallback():
    primary = FakeService("down", always_fail=True)
    fb = FakeService("fb", result={"via": "fallback"})
    t = make_transport(primary, fb)
    res = Resilience(
        res_cfg(breaker_consecutive_failures=2, breaker_min_samples=100,
                hedge_enabled=False)
    )
    o = orch(t, resilience=res)
    plan = Plan(nodes=[DagNode(name="n", endpoint="local://down", retries=0,
                               fallbacks=["local://fb"])])

    async def go():
        outs = []
        for _ in range(3):
            outs.append(await o.execute(plan, {}))
        return outs

    r1, r2, r3 = run(go())
    assert all(r.status == "ok" for r in (r1, r2, r3))
    # Two real failures tripped the breaker; the third run never dials the
    # dead endpoint — its primary attempt is recorded as "open".
    assert len(primary.calls) == 2
    a3 = r3.trace.nodes["n"].attempts
    assert a3[0].status == "open" and a3[0].kind == "primary"
    assert a3[-1].status == "ok" and a3[-1].kind == "fallback"


def test_breaker_state_feeds_replan_exclusions():
    reg = BreakerRegistry(res_cfg(breaker_consecutive_failures=1),
                          clock=FakeClock())
    reg.record("local://down", False, service="svc-down")
    policy = ReplanPolicy(TelemetryConfig(), breakers=reg)
    plan = Plan(nodes=[DagNode(name="n", service="svc-down",
                               endpoint="local://down")])
    from mcpx_torch.orchestrator.executor import ExecuteResult

    result = ExecuteResult(errors={"n": "boom"}, status="failed")
    records = {"svc-down": ServiceRecord(name="svc-down", endpoint="local://down")}
    decision = policy.assess(plan, result, TelemetryStore(), records)
    assert decision.should_replan
    assert "svc-down" in decision.exclude
    assert any("circuit breaker open" in r for r in decision.reasons)


# ----------------------------------------------------------- deadline budget
def test_deadline_budget_truncates_attempts_and_bounds_overrun():
    slow = FakeService("slow")
    t = make_transport(slow, latencies={"slow": 10.0})  # always times out
    res = Resilience(res_cfg(hedge_enabled=False))
    o = orch(t, resilience=res)
    deadline_ms = 300.0
    plan = Plan(nodes=[DagNode(name="n", endpoint="local://slow", retries=5,
                               timeout_s=0.2)])

    async def go():
        t0 = time.monotonic()
        r = await o.execute(plan, {}, deadline_ms=deadline_ms)
        return r, time.monotonic() - t0

    r, elapsed = run(go())
    assert r.status == "failed"
    # The distinct budget error, not a generic timeout.
    assert "deadline budget exhausted" in r.errors["n"]
    attempts = r.trace.nodes["n"].attempts
    assert attempts[0].status == "timeout"
    assert attempts[-1].status == "budget"
    # Later attempt timeouts were capped to the remaining budget: the
    # request overruns its deadline by at most ONE capped attempt timeout.
    assert elapsed <= deadline_ms / 1e3 + 0.2 + 0.1, elapsed
    # And not every configured retry ran: the budget truncated the chain.
    real = [a for a in attempts if a.status in ("ok", "error", "timeout")]
    assert len(real) < 6


def test_budget_skips_unaffordable_backoff_straight_to_fallback():
    primary = FakeService("p", always_fail=True)
    fb = FakeService("fb", result={"via": "fallback"})
    t = make_transport(primary, fb)
    res = Resilience(res_cfg(hedge_enabled=False))
    # Full backoff draw of 10s against a 200ms budget: unaffordable.
    o = orch(t, resilience=res, rng=FixedRng(), retry_backoff_s=10.0)
    plan = Plan(nodes=[DagNode(name="n", endpoint="local://p", retries=2,
                               fallbacks=["local://fb"])])

    async def go():
        t0 = time.monotonic()
        r = await o.execute(plan, {}, deadline_ms=200.0)
        return r, time.monotonic() - t0

    r, elapsed = run(go())
    assert r.status == "ok"
    assert r.results["n"] == {"via": "fallback"}
    assert elapsed < 1.0  # never slept through the 10s backoff
    statuses = [(a.kind, a.status) for a in r.trace.nodes["n"].attempts]
    assert ("retry", "budget") in statuses
    assert statuses[-1] == ("fallback", "ok")
    assert len(primary.calls) == 1


def test_no_budget_without_resilience():
    # Resilience unwired: deadline_ms is inert and the full retry chain
    # runs (the pre-resilience pass-through).
    flaky = FakeService("f", fail_times=2)
    t = make_transport(flaky)
    o = orch(t)
    plan = Plan(nodes=[DagNode(name="n", endpoint="local://f", retries=2)])
    r = run(o.execute(plan, {}, deadline_ms=0.001))
    assert r.status == "ok"
    assert len(flaky.calls) == 3


# ------------------------------------------------------------------- hedging
def test_hedge_first_success_wins_and_loser_cancelled():
    cancelled = {"primary": False}

    async def slow_primary(payload):
        try:
            await asyncio.sleep(0.3)
        except asyncio.CancelledError:
            cancelled["primary"] = True
            raise
        return {"via": "primary"}

    async def fast_fb(payload):
        return {"via": "fallback"}

    t = LocalTransport()
    t.register("slow-p", slow_primary)
    t.register("fast-fb", fast_fb)
    ts = TelemetryStore()
    for _ in range(3):
        ts.record("svc", latency_ms=10.0, ok=True)  # EWMA -> ~20ms hedge delay
    res = Resilience(res_cfg(hedge_max_fraction=1.0, hedge_min_delay_s=0.02),
                     telemetry=ts)
    o = orch(t, resilience=res)
    plan = Plan(nodes=[DagNode(name="n", service="svc",
                               endpoint="local://slow-p", retries=0,
                               fallbacks=["local://fast-fb"], timeout_s=2.0)])

    async def go():
        t0 = time.monotonic()
        r = await o.execute(plan, {})
        return r, time.monotonic() - t0

    r, elapsed = run(go())
    assert r.status == "ok"
    assert r.results["n"] == {"via": "fallback"}  # the hedge won
    assert elapsed < 0.25, elapsed  # did not wait out the slow primary
    assert cancelled["primary"]  # loser cancelled, not abandoned
    by_kind = {a.kind: a.status for a in r.trace.nodes["n"].attempts}
    assert by_kind["hedge"] == "ok"
    assert by_kind["primary"] == "cancelled"


def test_hedge_budget_denies_speculation():
    async def slow_primary(payload):
        await asyncio.sleep(0.15)
        return {"via": "primary"}

    t = LocalTransport()
    t.register("slow-p", slow_primary)
    t.register("fb", FakeService("fb"))
    ts = TelemetryStore()
    for _ in range(3):
        ts.record("svc", latency_ms=10.0, ok=True)
    res = Resilience(res_cfg(hedge_max_fraction=0.0), telemetry=ts)
    o = orch(t, resilience=res)
    plan = Plan(nodes=[DagNode(name="n", service="svc",
                               endpoint="local://slow-p", retries=0,
                               fallbacks=["local://fb"], timeout_s=2.0)])
    r = run(o.execute(plan, {}))
    assert r.status == "ok"
    assert r.results["n"] == {"via": "primary"}
    assert [a.kind for a in r.trace.nodes["n"].attempts] == ["primary"]


def test_cold_service_never_hedges():
    res = Resilience(res_cfg(), telemetry=TelemetryStore())
    assert res.hedge.delay_s("never-seen") is None


def test_hedge_leg_capped_by_remaining_budget():
    """The hedge launches hedge_delay INTO the attempt: its timeout must be
    re-capped to the remaining budget at launch, or a slow hedge would keep
    the node alive past the at-most-one-capped-attempt overrun bound."""

    async def hang(payload):
        await asyncio.sleep(10.0)
        return {}

    t = LocalTransport()
    t.register("slow-p", hang)
    t.register("slow-fb", hang)
    ts = TelemetryStore()
    for _ in range(3):
        ts.record("svc", latency_ms=100.0, ok=True)  # EWMA -> 0.2s hedge delay
    res = Resilience(res_cfg(hedge_max_fraction=1.0), telemetry=ts)
    o = orch(t, resilience=res)
    deadline_ms = 250.0
    plan = Plan(nodes=[DagNode(name="n", service="svc",
                               endpoint="local://slow-p", retries=0,
                               fallbacks=["local://slow-fb"], timeout_s=10.0)])

    async def go():
        t0 = time.monotonic()
        r = await o.execute(plan, {}, deadline_ms=deadline_ms)
        return r, time.monotonic() - t0

    r, elapsed = run(go())
    assert r.status == "failed"
    # Hedge launched at ~0.2s with only ~0.05s of budget left: the race
    # ends with the budget, not 0.2 + 0.25 later.
    assert elapsed < 0.40, elapsed


def test_non_finite_deadline_header_builds_no_budget():
    res = Resilience(res_cfg())
    assert res.budget(float("nan")) is None
    assert res.budget(float("inf")) is None
    assert res.budget(None) is None  # no default configured
    assert res.budget(100.0) is not None


def test_breaker_effective_state_is_clock_aware():
    clock = FakeClock()
    b = CircuitBreaker(res_cfg(breaker_consecutive_failures=1,
                               breaker_open_s=5.0), clock=clock)
    b.record(False)
    assert b.effective_state() == "open"
    clock.t += 5.0
    # Cool-down elapsed with no consult: reporting must say half-open even
    # though .state only flips on the next allow().
    assert b.state == "open" and b.effective_state() == "half_open"


# ------------------------------------------------- executor retryability fix
def test_non_retryable_4xx_skips_retries_goes_to_fallback():
    primary = FakeService("p", always_fail=True, error_status=404)
    fb = FakeService("fb", result={"via": "fallback"})
    t = make_transport(primary, fb)
    o = orch(t)  # resilience OFF: this is a plain executor bugfix
    plan = Plan(nodes=[DagNode(name="n", endpoint="local://p", retries=3,
                               fallbacks=["local://fb"])])
    r = run(o.execute(plan, {}))
    assert r.status == "ok"
    assert len(primary.calls) == 1  # a 404 is deterministic: no retries
    assert [a.kind for a in r.trace.nodes["n"].attempts] == ["primary", "fallback"]


def test_408_and_429_stay_retryable():
    for status in (408, 429):
        svc = FakeService("p", fail_times=1, error_status=status)
        t = make_transport(svc)
        o = orch(t)
        plan = Plan(nodes=[DagNode(name="n", endpoint="local://p", retries=2)])
        r = run(o.execute(plan, {}))
        assert r.status == "ok", status
        assert len(svc.calls) == 2, status


def test_429_retry_after_floors_the_backoff():
    svc = FakeService("p", fail_times=1, error_status=429, retry_after_s=0.08)
    t = make_transport(svc)
    o = orch(t)  # retry_backoff_s=0: any wait comes from Retry-After

    async def go():
        t0 = time.monotonic()
        plan = Plan(nodes=[DagNode(name="n", endpoint="local://p", retries=2)])
        r = await o.execute(plan, {})
        return r, time.monotonic() - t0

    r, elapsed = run(go())
    assert r.status == "ok"
    assert elapsed >= 0.08  # honored the server's Retry-After


def test_retry_backoff_uses_full_jitter_from_injected_rng():
    svc = FakeService("p", fail_times=1)
    t = make_transport(svc)
    rng = FixedRng(uniform_value=0.0)
    o = orch(t, rng=rng, retry_backoff_s=0.05)
    plan = Plan(nodes=[DagNode(name="n", endpoint="local://p", retries=1)])
    r = run(o.execute(plan, {}))
    assert r.status == "ok"
    # Full jitter: the draw is uniform over [0, backoff], not fixed backoff.
    assert rng.uniform_calls == [(0.0, 0.05)]


# --------------------------------------------------------------------- chaos
def _chaos_profile(**faults):
    return ChaosProfile.from_dict(
        {"seed": 7, "endpoints": {"local://svc": faults}}
    )


def test_chaos_transport_deterministic_under_seed():
    async def outcomes():
        t = LocalTransport()
        t.register("svc", FakeService("svc"))
        chaos = ChaosTransport(t, _chaos_profile(error_rate=0.5))
        seen = []
        for _ in range(30):
            try:
                await chaos.post("local://svc", {}, 1.0)
                seen.append("ok")
            except TransportError:
                seen.append("err")
        return seen

    first = run(outcomes())
    second = run(outcomes())
    assert first == second
    assert "ok" in first and "err" in first  # both outcomes actually occur


def test_chaos_transport_reseed_rewinds_the_fault_stream():
    async def go():
        t = LocalTransport()
        t.register("svc", FakeService("svc"))
        chaos = ChaosTransport(t, _chaos_profile(error_rate=0.5))

        async def seq(n):
            out = []
            for _ in range(n):
                try:
                    await chaos.post("local://svc", {}, 1.0)
                    out.append("ok")
                except TransportError:
                    out.append("err")
            return out

        a = await seq(20)
        chaos.reseed()
        b = await seq(20)
        return a, b

    a, b = run(go())
    assert a == b


def test_chaos_transport_flapping_windows():
    clock = FakeClock()
    t = LocalTransport()
    t.register("svc", FakeService("svc"))
    chaos = ChaosTransport(
        t, _chaos_profile(flap_period_s=10.0, flap_down_s=3.0), clock=clock
    )

    async def post_ok():
        try:
            await chaos.post("local://svc", {}, 1.0)
            return True
        except TransportError:
            return False

    clock.t = 1.0  # inside the down window
    assert run(post_ok()) is False
    clock.t = 5.0  # up
    assert run(post_ok()) is True
    clock.t = 11.0  # next period's down window
    assert run(post_ok()) is False


def test_chaos_transport_passthrough_for_unmatched_endpoints():
    t = LocalTransport()
    svc = FakeService("other")
    t.register("other", svc)
    chaos = ChaosTransport(t, _chaos_profile(error_rate=1.0))
    out = run(chaos.post("local://other", {"x": 1}, 1.0))
    assert out == {"service": "other", "echo": {"x": 1}}


def test_chaos_profile_rejects_unknown_keys():
    with pytest.raises(ConfigError, match="unknown key"):
        ChaosProfile.from_dict({"endpoints": {"u": {"error_rat": 0.5}}})
    with pytest.raises(ConfigError, match="unknown top-level"):
        ChaosProfile.from_dict({"endpoint": {}})


# --------------------------------------------- config-off pass-through parity
def test_execute_pass_through_when_resilience_disabled():
    flaky = FakeService("f", fail_times=2)
    cp, app = make_app(flaky)
    assert cp.orchestrator.resilience is None  # default config: unwired

    async def go():
        graph = {
            "nodes": [{"name": "n", "endpoint": "local://f", "retries": 2}],
            "edges": [],
        }

        async def drive(client):
            # An absurd 1ms deadline header: with resilience disabled it is
            # not even parsed — the full retry chain still runs and the
            # request succeeds, byte-identical envelope included.
            r = await client.post(
                "/execute",
                json={"graph": graph, "payload": {}},
                headers={"X-MCPX-Deadline-Ms": "1"},
            )
            assert r.status == 200
            body = await r.json()
            assert body["status"] == "ok"
            assert len(flaky.calls) == 3  # nothing truncated the chain
            # The wire envelope carries only pre-resilience vocabulary.
            assert set(body) == {"results", "errors", "status", "trace"}
            for node in body["trace"]["nodes"]:
                for a in node["attempts"]:
                    assert a["kind"] in ("primary", "retry", "fallback")
                    assert a["status"] in ("ok", "error", "timeout")
            return body

        return await with_client(app, drive)

    run(go())


def test_execute_deadline_header_enforced_when_enabled():
    flaky = FakeService("f", fail_times=2)
    cfg = MCPXConfig.from_dict(
        {"resilience": {"enabled": True, "hedge_enabled": False},
         "retrieval": {"enabled": False}, "planner": {"kind": "heuristic"}}
    )
    # A 50ms budget against retries spaced by a 10s full-backoff draw: the
    # budget skips them and the node fails with the distinct budget error.
    cfg.orchestrator.retry_backoff_s = 10.0
    cp, app = make_app(flaky, config=cfg)
    assert cp.orchestrator.resilience is not None
    cp.orchestrator._rng = FixedRng()  # deterministic full-jitter draws

    async def go():
        graph = {
            "nodes": [{"name": "n", "endpoint": "local://f", "retries": 2}],
            "edges": [],
        }

        async def drive(client):
            r = await client.post(
                "/execute",
                json={"graph": graph, "payload": {}},
                headers={"X-MCPX-Deadline-Ms": "50"},
            )
            assert r.status == 200
            body = await r.json()
            assert body["status"] == "failed"
            assert "deadline budget exhausted" in body["errors"]["n"]
            statuses = {
                a["status"]
                for node in body["trace"]["nodes"]
                for a in node["attempts"]
            }
            assert "budget" in statuses

        return await with_client(app, drive)

    run(go())


def test_config_sections_round_trip():
    cfg = MCPXConfig.from_dict(
        {"resilience": {"enabled": True, "breaker_open_s": "2.5",
                        "hedge_max_fraction": "0.25"}}
    )
    assert cfg.resilience.enabled is True
    assert cfg.resilience.breaker_open_s == 2.5
    assert cfg.resilience.hedge_max_fraction == 0.25
    with pytest.raises(ConfigError):
        MCPXConfig.from_dict({"resilience": {"breaker_error_threshold": 1.5}})


# ----------------------------------------------------- parity with mcpx
PORT = dict(Local=LocalTransport, Error=TransportError, Chaos=ChaosTransport, Profile=ChaosProfile,
            Orchestrator=Orchestrator, OrchCfg=OrchestratorConfig, ResCfg=ResilienceConfig,
            Resilience=Resilience, Plan=Plan, Node=DagNode, Telemetry=TelemetryStore)
REF = dict(Local=JLocalTransport, Error=JTransportError, Chaos=JChaosTransport, Profile=JChaosProfile,
           Orchestrator=JOrchestrator, OrchCfg=JOrchestratorConfig, ResCfg=JResilienceConfig,
           Resilience=JResilience, Plan=JPlan, Node=JDagNode, Telemetry=JTelemetryStore)

CHAOS = {
    "seed": 31,
    "endpoints": {
        "local://flap": {"error_rate": 0.1, "flap_period_s": 1.0, "flap_down_s": 0.3},
        "local://err": {"error_rate": 0.4, "error_status": 503, "timeout_rate": 0.2},
        "local://spike": {"latency_ms": 0.1, "spike_ms": 5000.0, "spike_rate": 0.3},
    },
    "default": {"error_rate": 0.25, "error_status": 502},
}


async def _fault_stream(ns) -> list:
    """A seeded sequential call stream through ``ChaosTransport`` over four
    endpoints (one unmatched, served by the default faults), the flap phase
    on an injected clock: each call's outcome, status and timeout flag."""
    clock = FakeClock(100.0)
    inner = ns["Local"]()
    for name in ("flap", "err", "spike", "other"):
        inner.register(name, FakeService(name, error_cls=ns["Error"]))
    chaos = ns["Chaos"](inner, ns["Profile"].from_dict(CHAOS), clock=clock)
    rng = random.Random(4)
    seen = []
    for i in range(240):
        url = f"local://{rng.choice(['flap', 'err', 'spike', 'other'])}"
        clock.t += rng.uniform(0.0, 0.25)
        try:
            # A short timeout: an injected hang or a spike past it costs
            # a millisecond, not the spike.
            await chaos.post(url, {"i": i}, 0.001)
            seen.append((url, "ok"))
        except ns["Error"] as e:
            seen.append((url, "error", e.status, e.timeout))
        if i == 120:
            chaos.reseed()
    return seen


def test_chaos_fault_stream_matches_reference():
    ref, port = run(_fault_stream(REF)), run(_fault_stream(PORT))
    assert port == ref
    kinds = {s[1] if s[1] == "ok" else ("timeout" if s[3] else s[2]) for s in port}
    assert {"ok", "timeout", 503, 502}.issubset(kinds), kinds


async def _execute_set(ns) -> list:
    """Seeded /execute traffic with resilience on, run sequentially: a
    primary that is always down (its breaker trips, cools down and probes
    on a seeded RNG), a flaky one that heals on retry, a 404 that goes
    straight to its fallback, and a slow one whose every call advances the
    injected clock by 0.3 s against a 500 ms deadline budget. Returns each
    request's status, errors and attempts as (node, kind, status)."""
    clock = FakeClock(0.0)
    services = {
        "down": FakeService("down", always_fail=True, error_cls=ns["Error"]),
        "down-fb": FakeService("down-fb", result={"via": "fb"}, error_cls=ns["Error"]),
        "flaky": FakeService("flaky", fail_times=1, error_cls=ns["Error"]),
        "reject": FakeService("reject", always_fail=True, error_status=404, error_cls=ns["Error"]),
        "reject-fb": FakeService("reject-fb", error_cls=ns["Error"]),
    }
    slow_calls = []

    async def slow(payload):
        slow_calls.append(payload)
        clock.t += 0.3
        raise ns["Error"]("slow: upstream failed", status=500)

    transport = make_transport(*services.values(), cls=ns["Local"])
    transport.register("slow", slow)
    res = ns["Resilience"](
        ns["ResCfg"](enabled=True, hedge_enabled=False, breaker_consecutive_failures=3,
                     breaker_min_samples=100, breaker_open_s=1.0, breaker_half_open_probe_p=0.5),
        telemetry=ns["Telemetry"](), clock=clock, rng=random.Random(9),
    )
    o = ns["Orchestrator"](transport, ns["OrchCfg"](retry_backoff_s=0.0), resilience=res,
                           rng=random.Random(2))
    N = ns["Node"]

    def plan_for(k):
        if k == 0:
            return ns["Plan"].from_wire({"nodes": [
                {"name": "a", "service": "down", "endpoint": "local://down", "retries": 1,
                 "fallbacks": ["local://down-fb"]},
                {"name": "b", "service": "flaky", "endpoint": "local://flaky", "retries": 2,
                 "inputs": {"x": "a"}},
            ], "edges": [{"src": "a", "dst": "b"}]})
        return ns["Plan"](nodes=[
            N(name="r", service="reject", endpoint="local://reject", retries=2, fallbacks=["local://reject-fb"]),
            N(name="s", service="slow", endpoint="local://slow", retries=3),
        ])

    out = []
    for i in range(12):
        k = i % 2
        plan = plan_for(k)
        services["flaky"]._fail_times = len(services["flaky"].calls) + 1  # fail once a request
        result = await o.execute(plan, {"i": i}, deadline_ms=500.0 if k == 1 else None)
        clock.t += 0.4
        attempts = [
            (name, a.kind, a.status)
            for name in sorted(result.trace.nodes)
            for a in result.trace.nodes[name].attempts
        ]
        errors = {n: e.split(" (")[0] for n, e in result.errors.items()}
        out.append((result.status, errors, attempts))
    return out, len(services["down"].calls), len(slow_calls)


def test_resilient_execute_matches_reference():
    ref, port = run(_execute_set(REF)), run(_execute_set(PORT))
    assert port == ref
    runs, down_calls, _ = port
    statuses = {s for r in runs for _, _, s in r[2]}
    # The set reaches every resilience verdict it is built to reach.
    assert {"ok", "error", "open", "budget"}.issubset(statuses), statuses
    assert down_calls < 12  # the breaker kept requests off the dead primary
