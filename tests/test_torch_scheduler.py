"""The /plan admission scheduler in the port (``mcpx_torch/scheduler/``),
held against the reference package on the CPU:

  - the cases of the reference's ``tests/test_scheduler.py`` (token bucket,
    fair queue, degradation hysteresis, shedding, the per-tier service
    EWMAs, the config) and ``tests/test_scheduler_integration.py`` (429 with
    ``Retry-After``, the ladder tagging ``planner: "degraded"``, the
    pass-through with the scheduler off, degraded plans never cached, the
    app cases through aiohttp's test client), run against the port; the
    reference's cold-engine ``queue_stats`` case is held on the port
    engine's keys (``queue_depth``, ``service_ewma_s``, ``eta_s``);
  - step for step: one seeded arrival schedule under an injected clock
    gives the same admitted, degraded and shed verdicts, shed outcomes and
    ``Retry-After`` values from both packages' ``Scheduler``.
"""

import asyncio
import math
import random

import pytest
from aiohttp.test_utils import TestClient, TestServer

from mcpx.core.config import SchedulerConfig as JSchedulerConfig
from mcpx.scheduler import Scheduler as JScheduler
from mcpx.scheduler import ShedError as JShedError
from mcpx_torch.core.config import MCPXConfig, SchedulerConfig
from mcpx_torch.core.dag import Plan
from mcpx_torch.core.errors import ConfigError
from mcpx_torch.registry.base import ServiceRecord
from mcpx_torch.scheduler import (
    DegradeController,
    FairQueue,
    RequestContext,
    Scheduler,
    ShedError,
    TokenBucket,
)
from mcpx_torch.server.app import build_app
from mcpx_torch.server.factory import build_control_plane


async def with_client(app, fn):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        return await fn(client)
    finally:
        await client.close()


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ----------------------------------------------------------- token bucket
def test_token_bucket_burst_drain_and_refill():
    clock = FakeClock()
    b = TokenBucket(rate=10.0, burst=3, clock=clock)
    assert [b.try_acquire() for _ in range(3)] == [True, True, True]
    assert not b.try_acquire()  # burst exhausted, no time passed
    assert b.eta_s() == pytest.approx(0.1)  # one token at 10/s
    clock.advance(0.05)
    assert not b.try_acquire()  # half a token
    clock.advance(0.06)
    assert b.try_acquire()
    # Refill caps at burst: a long idle gap doesn't bank unlimited tokens.
    clock.advance(100.0)
    assert b.tokens == pytest.approx(3.0)


def test_token_bucket_rejects_nonpositive_rate():
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0, burst=1)


# ------------------------------------------------------------- fair queue
def test_fair_queue_quiet_tenant_jumps_hot_backlog():
    q = FairQueue()
    for i in range(5):
        q.push("hot", f"h{i}")
    q.push("cold", "c0")
    order = [q.pop() for _ in range(6)]
    # The cold tenant's single item dispatches ahead of the hot tenant's
    # backlog (entered at the global virtual time, not behind 5 tags).
    assert "c0" in order[:2], order
    assert order.count(None) == 0
    assert q.pop() is None


def test_fair_queue_weight_shares():
    q = FairQueue()
    for i in range(4):
        q.push("big", f"b{i}", weight=2.0)
        q.push("small", f"s{i}", weight=1.0)
    first6 = [q.pop() for _ in range(6)]
    n_big = sum(1 for x in first6 if x.startswith("b"))
    # weight 2 vs 1 -> a 2:1 dispatch share under contention.
    assert n_big == 4, first6


def test_fair_queue_edf_within_tenant():
    q = FairQueue()
    q.push("t", "late", deadline_at=300.0)
    q.push("t", "soon", deadline_at=100.0)
    q.push("t", "never")  # deadline-less ranks last
    q.push("t", "mid", deadline_at=200.0)
    assert [q.pop() for _ in range(4)] == ["soon", "mid", "late", "never"]


def test_fair_queue_depths():
    q = FairQueue()
    q.push("a", 1)
    q.push("a", 2)
    q.push("b", 3)
    assert q.depth() == 3
    assert q.tenant_depths() == {"a": 2, "b": 1}


# ------------------------------------------------------------ degradation
def test_degrade_hysteresis():
    clock = FakeClock()
    d = DegradeController(
        slo_s=0.1,
        degrade_threshold=0.5,  # engage above 50 ms EWMA wait
        recover_threshold=0.25,  # recover below 25 ms
        ewma_alpha=1.0,  # no smoothing: thresholds hit exactly
        min_hold_s=2.0,
        clock=clock,
    )
    assert not d.observe_wait(0.04)  # below hi: stays normal
    assert d.observe_wait(0.2)  # overload: engages
    # Pressure drops immediately — but the hold keeps the ladder engaged
    # (no flapping at the boundary).
    assert d.observe_wait(0.0)
    clock.advance(1.0)
    assert d.observe_wait(0.0)  # still inside min_hold_s
    clock.advance(1.5)
    assert not d.observe_wait(0.0)  # held long enough AND below lo: recovers
    # Between lo and hi after recovery: stays normal (hysteresis band).
    assert not d.observe_wait(0.04)


def test_degrade_requires_ordered_thresholds():
    with pytest.raises(ValueError):
        DegradeController(slo_s=1.0, degrade_threshold=0.2, recover_threshold=0.5)


# -------------------------------------------------------------- scheduler
def _sched(clock=None, **overrides) -> Scheduler:
    cfg = SchedulerConfig(enabled=True, **overrides)
    return Scheduler(cfg, None, clock=clock or FakeClock())


def test_scheduler_deadline_shed_at_enqueue():
    async def go():
        clock = FakeClock()
        s = _sched(clock, max_parallel=1)
        # A learned service time of 10s/request means a 100ms-deadline
        # request cannot possibly be served: shed synchronously.
        s._service_ewma_s = 10.0
        ctx = RequestContext(tenant="t", deadline_at=clock() + 0.1, enqueued_at=clock())
        with pytest.raises(ShedError) as ei:
            await s.acquire(ctx)
        assert ei.value.outcome == "shed_deadline"
        assert ei.value.retry_after_s >= 1.0
        assert int(ei.value.retry_after_header()) >= 1

    asyncio.run(go())


def test_scheduler_no_deadline_never_deadline_sheds():
    async def go():
        clock = FakeClock()
        s = _sched(clock, max_parallel=1)
        s._service_ewma_s = 10.0
        # deadline_at=None: remaining budget is infinite, never shed.
        slot = await s.acquire(RequestContext(tenant="t", enqueued_at=clock()))
        assert not slot.degraded
        s.release(slot)

    asyncio.run(go())


def test_scheduler_queue_cap_sheds():
    async def go():
        s = _sched(max_parallel=1, max_queue_depth=1)
        held = await s.acquire(RequestContext(tenant="t"))  # occupies the slot
        waiter = asyncio.ensure_future(s.acquire(RequestContext(tenant="t")))
        await asyncio.sleep(0)  # waiter enqueued (depth 1 = cap)
        with pytest.raises(ShedError) as ei:
            await s.acquire(RequestContext(tenant="t"))
        assert ei.value.outcome == "shed_queue"
        s.release(held)
        s.release(await waiter)

    asyncio.run(go())


def test_scheduler_dispatch_time_deadline_shed():
    """A request admitted on an optimistic ETA whose deadline expires while
    queued is shed at dispatch, not served as a corpse."""

    async def go():
        clock = FakeClock()
        s = _sched(clock, max_parallel=1)
        held = await s.acquire(RequestContext(tenant="t", enqueued_at=clock()))
        waiter = asyncio.ensure_future(
            s.acquire(
                RequestContext(tenant="t", deadline_at=clock() + 0.5, enqueued_at=clock())
            )
        )
        await asyncio.sleep(0)
        clock.advance(1.0)  # deadline passes while queued
        s.release(held)
        with pytest.raises(ShedError) as ei:
            await waiter
        assert ei.value.outcome == "shed_deadline"

    asyncio.run(go())


def test_scheduler_rate_limit_sheds_with_retry_after():
    async def go():
        clock = FakeClock()
        s = _sched(clock, rate_limit=10.0, burst=1, max_parallel=4)
        slot = await s.acquire(RequestContext(tenant="t"))
        s.release(slot)
        with pytest.raises(ShedError) as ei:
            await s.acquire(RequestContext(tenant="t"))
        assert ei.value.outcome == "shed_rate"
        assert ei.value.retry_after_s > 0

    asyncio.run(go())


def test_scheduler_service_ewma_and_engine_eta_floor():
    async def go():
        clock = FakeClock()
        eng = {"eta_s": 7.5}
        s = Scheduler(
            SchedulerConfig(enabled=True, max_parallel=1),
            None,
            engine_stats=lambda: eng,
            clock=clock,
        )
        slot = await s.acquire(RequestContext(tenant="t", enqueued_at=clock()))
        clock.advance(2.0)
        s.release(slot)
        assert s.service_ewma_s == pytest.approx(2.0)  # first sample seeds
        # Own estimate is (0+1)*2.0/1 = 2.0; engine's 7.5 floors it up.
        assert s.queue_eta_s() == pytest.approx(7.5)
        eng["eta_s"] = 0.0
        assert s.queue_eta_s() == pytest.approx(2.0)

    asyncio.run(go())


def test_scheduler_context_from_headers():
    clock = FakeClock()
    s = _sched(clock, default_deadline_ms=2000.0)
    ctx = s.context_from_headers(
        {"X-MCPX-Tenant": "acme", "X-MCPX-Deadline-Ms": "150", "X-MCPX-Priority": "4"}
    )
    assert ctx.tenant == "acme"
    assert ctx.deadline_at == pytest.approx(clock() + 0.15)
    assert ctx.weight == 4.0
    # Absent/malformed headers: defaults, never a rejection.
    ctx = s.context_from_headers({"X-MCPX-Deadline-Ms": "soon", "X-MCPX-Priority": "x"})
    assert ctx.tenant == "default"
    assert ctx.deadline_at == pytest.approx(clock() + 2.0)
    assert ctx.weight == 1.0


def test_scheduler_purges_abandoned_waiters_before_shedding():
    """Cancelled-while-queued entries (client disconnects) must not count
    as backlog: a full-of-phantoms queue purges instead of 429ing a live
    request."""
    import contextlib

    async def go():
        s = _sched(max_parallel=1, max_queue_depth=2)
        held = await s.acquire(RequestContext(tenant="t"))
        w1 = asyncio.ensure_future(s.acquire(RequestContext(tenant="t")))
        w2 = asyncio.ensure_future(s.acquire(RequestContext(tenant="t")))
        await asyncio.sleep(0)  # both enqueued: depth == cap
        w1.cancel()
        w2.cancel()
        for w in (w1, w2):
            with contextlib.suppress(asyncio.CancelledError):
                await w
        # Queue still holds the two dead entries — a live arrival purges
        # them instead of shedding shed_queue.
        live = asyncio.ensure_future(s.acquire(RequestContext(tenant="t")))
        await asyncio.sleep(0)
        s.release(held)
        slot = await live
        s.release(slot)

    asyncio.run(go())


def test_scheduler_per_tier_service_ewma():
    """Degraded (~ms) completions must not blind the primary-tier ETA
    estimate — each tier learns its own EWMA, and queue_eta_s costs the
    backlog at the tier the ladder would currently serve."""
    from mcpx_torch.scheduler import Slot

    async def go():
        clock = FakeClock()
        s = _sched(clock, max_parallel=1)
        slot = await s.acquire(RequestContext(tenant="t", enqueued_at=clock()))
        clock.advance(1.0)
        s.release(slot)  # primary tier: 1.0s
        fake = Slot(
            ctx=RequestContext(tenant="t", enqueued_at=clock()),
            degraded=True,
            granted_at=clock(),
            queue_wait_s=0.0,
        )
        s._inflight += 1
        clock.advance(0.002)
        s.release(fake)  # degraded tier: 2ms
        assert s.service_ewma_s == pytest.approx(1.0)  # unpolluted
        assert s._degraded_ewma_s == pytest.approx(0.002)
        # Ladder off: ETA priced at the primary tier.
        assert s.queue_eta_s() == pytest.approx(1.0)
        # Ladder on: priced at the degraded tier (the tier that would
        # actually serve), so recovery-adjacent requests aren't shed on
        # the primary tier's cost.
        s._degrade.observe_wait(10.0)
        assert s.degraded
        assert s.queue_eta_s() == pytest.approx(0.002)

    asyncio.run(go())


# ---------------------------------------------------------- config wiring
def test_scheduler_config_validation():
    cfg = MCPXConfig.from_dict({"scheduler": {"enabled": True, "slo_ms": 100}})
    assert cfg.scheduler.enabled and cfg.scheduler.slo_ms == 100
    with pytest.raises(ConfigError):
        MCPXConfig.from_dict(
            {"scheduler": {"degrade_threshold": 0.2, "recover_threshold": 0.5}}
        )
    with pytest.raises(ConfigError):
        MCPXConfig.from_dict({"scheduler": {"slo_ms": 0}})
    with pytest.raises(ConfigError):
        MCPXConfig.from_dict({"scheduler": {"max_parallel": 0}})


def test_engine_queue_stats_surface():
    """queue_stats is readable on a cold engine (a scheduler attaches before
    or without start) and does the reference's fair-share ETA arithmetic on
    the service EWMA."""
    from mcpx_torch.engine.engine import InferenceEngine

    cfg = MCPXConfig.from_dict(
        {"model": {"size": "test", "max_seq_len": 256}, "engine": {"max_batch_size": 4}}
    )
    eng = InferenceEngine(cfg, device="cpu")
    st = eng.queue_stats()
    assert (st["queue_depth"], st["active_rows"], st["service_ewma_s"], st["eta_s"]) == (0, 0, 0.0, 0.0)
    eng._ewma_service_s = 2.0
    for _ in range(5):  # 4 fit the free slab rows; 1 overflows = 1 drain
        eng._queue.put(object())
    st = eng.queue_stats()
    assert st["queue_depth"] == 5
    assert st["eta_s"] == pytest.approx(math.ceil(1 / 4) * 2.0)


class SlowPlanner:
    """Mock primary planner with a fixed service delay — stands in for the
    LLM under overload (build_app never learns the difference)."""

    def __init__(self, delay_s: float) -> None:
        self.delay_s = delay_s
        self.calls = 0

    async def plan(self, intent: str, context) -> Plan:
        self.calls += 1
        await asyncio.sleep(self.delay_s)
        from mcpx_torch.core.dag import DagNode

        p = Plan(
            nodes=[DagNode(name="svc-a", service="svc-a", endpoint="local://svc-a")],
            edges=[],
            intent=intent,
        )
        p.origin = "llm"
        return p


def _cp(scheduler_cfg: dict, delay_s: float):
    cfg = MCPXConfig.from_dict(
        {"scheduler": scheduler_cfg, "retrieval": {"enabled": False}}
    )
    planner = SlowPlanner(delay_s)
    cp = build_control_plane(cfg, planner=planner, device="cpu")
    return cp, planner


def _seed(cp):
    # The degraded path plans heuristically over the registry — it needs a
    # real service to chain.
    return cp.registry.put(
        ServiceRecord(
            name="svc-a",
            endpoint="local://svc-a",
            description="plan anything about svc",
            input_schema={"q": "str"},
            output_schema={"r": "str"},
        )
    )


def test_queue_full_sheds_429_with_retry_after():
    async def go():
        cp, planner = _cp(
            {
                "enabled": True,
                "max_parallel": 1,
                "max_queue_depth": 1,
                "default_deadline_ms": 0,  # no deadlines: isolate the queue cap
            },
            delay_s=0.3,
        )
        await _seed(cp)

        async def drive(client):
            async def one(delay):
                await asyncio.sleep(delay)
                r = await client.post("/plan", json={"intent": "plan svc"})
                return r

            # Staggered so arrival order is deterministic: r1 dispatches,
            # r2 queues (depth = cap), r3 sheds.
            rs = await asyncio.gather(one(0.0), one(0.05), one(0.1))
            statuses = [r.status for r in rs]
            assert sorted(statuses) == [200, 200, 429], statuses
            shed = rs[statuses.index(429)]
            assert int(shed.headers["Retry-After"]) >= 1
            body = await shed.json()
            assert "admission refused" in body["error"]
            ok = rs[statuses.index(200)]
            ok_body = await ok.json()
            # Scheduler on, ladder not engaged: primary tier, tagged.
            assert ok_body["planner"] == "primary"
            assert ok_body["origin"] == "llm"
            # Shed decisions are visible on /metrics.
            m = await (await client.get("/metrics")).text()
            assert 'mcpx_sched_decisions_total{outcome="shed_queue"}' in m

        await with_client(build_app(cp), drive)

    asyncio.run(go())


def test_sustained_overload_degrades_to_shortlist_planner_and_tags():
    async def go():
        cp, planner = _cp(
            {
                "enabled": True,
                "max_parallel": 1,
                "default_deadline_ms": 0,
                "slo_ms": 20.0,  # 10 ms queue-wait EWMA engages the ladder
                "degrade_threshold": 0.5,
                "recover_threshold": 0.25,
                "degrade_min_hold_s": 60.0,  # no mid-test recovery
            },
            delay_s=0.25,
        )
        await _seed(cp)

        async def drive(client):
            async def one(delay, i):
                # Distinct intents: a shared intent would let the degraded
                # tier answer from the plan cache (by design) and mask the
                # heuristic path this test exercises.
                await asyncio.sleep(delay)
                r = await client.post("/plan", json={"intent": f"plan svc {i}"})
                return r.status, await r.json()

            # r1 dispatches instantly (wait ~0, stays primary); r2 waits
            # out r1's 250 ms service -> queue-wait EWMA blows the 10 ms
            # threshold at ITS OWN grant -> r2 and r3 serve degraded.
            out = await asyncio.gather(one(0.0, 0), one(0.05, 1), one(0.1, 2))
            assert all(status == 200 for status, _ in out), out
            tiers = [body["planner"] for _, body in out]
            assert tiers[0] == "primary"
            assert tiers[1] == "degraded" and tiers[2] == "degraded", tiers
            for _, body in out[1:]:
                # Degraded = served by the shortlist/heuristic planner.
                assert body["origin"] == "heuristic"
                assert body["graph"]["nodes"]
            # Only the primary tier paid the (mock) LLM cost.
            assert planner.calls == 1
            m = await (await client.get("/metrics")).text()
            assert "mcpx_sched_degraded_mode 1.0" in m
            assert 'mcpx_sched_decisions_total{outcome="degraded"} 2.0' in m

        await with_client(build_app(cp), drive)

    asyncio.run(go())


def test_scheduler_disabled_is_passthrough():
    async def go():
        cp, planner = _cp({"enabled": False}, delay_s=0.0)
        await _seed(cp)
        assert cp.scheduler is None  # factory builds no scheduler when off

        async def drive(client):
            r = await client.post("/plan", json={"intent": "plan svc"})
            assert r.status == 200
            body = await r.json()
            # Pass-through response shape: no scheduler field leaks in.
            assert "planner" not in body
            assert set(body) == {"graph", "explanation", "origin", "latency_ms"}
            # And no scheduler series move (gauges exist but stay zero).
            m = await (await client.get("/metrics")).text()
            assert 'mcpx_sched_decisions_total{outcome="admitted"}' not in m

        await with_client(build_app(cp), drive)

    asyncio.run(go())


def test_degraded_plans_never_written_to_cache():
    """A cache hit after recovery must not serve a heuristic plan the
    degraded tier authored."""

    async def go():
        cp, planner = _cp({"enabled": True}, delay_s=0.0)
        await _seed(cp)
        plan, _ = await cp.plan("plan svc cached", degraded=True)
        assert plan.origin == "heuristic"
        assert len(cp._plan_cache) == 0
        # The same intent planned normally afterwards hits the primary.
        plan2, _ = await cp.plan("plan svc cached")
        assert plan2.origin == "llm"
        assert len(cp._plan_cache) == 1

    asyncio.run(go())


# ----------------------------------------------------- parity with mcpx
SCHED = dict(
    enabled=True, slo_ms=400.0, default_deadline_ms=400.0, max_parallel=2, max_queue_depth=6,
    rate_limit=40.0, burst=6, degrade_threshold=0.25, recover_threshold=0.1,
    degrade_min_hold_s=0.3, ewma_alpha=0.5,
)


async def _verdicts(Sched, Cfg, Shed) -> list:
    """One seeded open-loop arrival schedule (three tenants, some with a
    deadline header or a priority, some arriving after a lull) through a
    scheduler on an injected clock. A granted request is served for a
    seeded time (about 80 ms primary, 2 ms degraded) and released; the
    engine's ETA floor is a seeded function of the clock. Events run in
    time order; after each, the loop settles. Returns every verdict in
    the order it was taken: (request, "admitted" | "degraded" | "shed",
    the shed's outcome and Retry-After header, the grant's queue wait)."""
    clock = FakeClock(50.0)
    engine_eta = random.Random(8)
    sched = Sched(Cfg(**SCHED), None, clock=clock,
                  engine_stats=lambda: {"eta_s": 0.05 * engine_eta.random()})
    rng = random.Random(17)
    events = []  # (time, seq, kind, payload)
    t = clock.t
    for i in range(160):
        t += rng.expovariate(40.0) if i % 40 else 1.0  # a lull every 40 arrivals
        headers = {"X-MCPX-Tenant": rng.choice(["a", "b", "c"])}
        if rng.random() < 0.3:
            headers["X-MCPX-Deadline-Ms"] = str(rng.choice([30, 150, 900]))
        if rng.random() < 0.2:
            headers["X-MCPX-Priority"] = str(rng.choice([0.5, 2.0, 4.0]))
        events.append((t, i, "arrive", headers))
    out: list = []
    tasks = []

    async def one(i, headers):
        ctx = sched.context_from_headers(headers)
        try:
            slot = await sched.acquire(ctx)
        except Shed as e:
            out.append((i, "shed", e.outcome, e.retry_after_header()))
            return
        out.append((i, "degraded" if slot.degraded else "admitted", round(slot.queue_wait_s, 9)))
        svc = 0.002 if slot.degraded else rng.uniform(0.05, 0.11)
        seq = 1000 + len(events)
        events.append((clock.t + svc, seq, "release", slot))
        events.sort(key=lambda e: (e[0], e[1]))

    events.sort(key=lambda e: (e[0], e[1]))
    while events:
        when, _, kind, payload = events.pop(0)
        clock.t = max(clock.t, when)
        if kind == "arrive":
            tasks.append(asyncio.ensure_future(one(_, payload)))
        else:
            sched.release(payload)
        for _ in range(4):
            await asyncio.sleep(0)
    await asyncio.gather(*tasks)
    return out


def test_scheduler_verdicts_match_reference_step_for_step():
    ref = asyncio.run(_verdicts(JScheduler, JSchedulerConfig, JShedError))
    port = asyncio.run(_verdicts(Scheduler, SchedulerConfig, ShedError))
    assert port == ref
    kinds = {v[1] for v in port}
    assert kinds == {"admitted", "degraded", "shed"}, kinds
    assert len(port) == 160
    outcomes = {v[2] for v in port if v[1] == "shed"}
    assert len(outcomes) >= 2, outcomes
