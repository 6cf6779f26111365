"""The slice as a whole with the reference's default-on observability: the
same concurrent ``/plan`` burst through both packages' HTTP apps, tracing
on, on the committed checkpoint at the reference's default decode loop
(the reference on one device, ``data_axis=1, model_axis=1``, and its jnp
attention, as in the other parity tests):

  - the burst's requests reach each engine at once (held and enqueued
    together), so both form one admission cohort;
  - every request's trace holds the same span names, as a multiset, in
    both packages (``/plan``, ``plan``, ``plan.context``,
    ``planner.grammar``, ``engine.generate``, ``engine.queue_wait``,
    ``engine.prefill``, ``engine.segment``s, ``engine.decode``);
  - the scraped counters agree: requests, plans by origin, prefill tokens,
    admissions, admitted rows, decode tokens, decode forwards and the
    prefix cache's hits, misses and matched tokens;
  - the port's engine, built with ``telemetry.flight.profile_worker``,
    reports a ``worker_profile`` whose phases tile the worker loop;
  - greedy plans are byte-identical to a port run with tracing, cost
    accounting and the profiler off.
"""

import asyncio
import copy
import os
import random

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families as parse_text

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.server.app import build_app as jbuild_app
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.server.app import build_app
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.telemetry.flight import PROFILE_PHASES
from mcpx_torch.utils.synth import synth_registry

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)
N_SERVICES, N_INTENTS = 200, 8
CONFIG = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": CKPT},
    "engine": {
        "max_batch_size": 16, "max_decode_len": 64, "kv_page_size": 64, "max_pages_per_seq": 4,
        "temperature": 0.0, "speculate_k": 8, "draft_mode": "prompt", "pipeline_depth": 2,
        "prefix_cache": True, "use_pallas": False, "data_axis": 1, "model_axis": 1,
    },
    "planner": {"kind": "llm"},
    "telemetry": {"flight": {"profile_worker": True}},
}
COUNTERS = (
    ("mcpx_requests_total", {"endpoint": "/plan", "status": "ok"}),
    ("mcpx_plans_total", {"planner": "LLMPlanner", "origin": "llm", "status": "ok"}),
    ("mcpx_engine_prefill_tokens_total", {}),
    ("mcpx_engine_admissions_total", {}),
    ("mcpx_engine_admitted_rows_total", {}),
    ("mcpx_engine_decode_tokens_total", {}),
    ("mcpx_engine_decode_forwards_total", {}),
    ("mcpx_kv_prefix_hits_total", {}),
    ("mcpx_kv_prefix_misses_total", {}),
    ("mcpx_kv_prefix_matched_tokens_total", {}),
)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Small CPU forwards run fastest on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scrape(text: str) -> dict:
    return {
        (s.name, tuple(sorted(s.labels.items()))): s.value
        for fam in parse_text(text)
        for s in fam.samples
    }


def _counter(scraped: dict, name: str, labels: dict) -> float:
    return scraped.get((name, tuple(sorted(labels.items()))), 0.0)


async def _idle_after_warm(cp) -> None:
    """Wait until the app's startup task has served the planner's warm
    request (one decoded token) and the engine is idle: the burst then
    forms the same cohort in both packages."""
    engine = cp.planner.engine
    for _ in range(3000):
        scraped = _scrape(cp.metrics.render().decode())
        if engine.state == "ready" and _counter(scraped, "mcpx_engine_decode_tokens_total", {}) >= 1:
            break
        await asyncio.sleep(0.02)
    await asyncio.sleep(0.3)


def _enqueue_together(engine, n: int):
    """Hold the engine's next ``n`` generate requests and enqueue them at
    once: the burst then forms one admission cohort in both packages,
    however the handlers' host work spreads their arrivals. Returns the
    restore function."""
    q = engine._queue
    real_put = q.put
    held = []

    def put(item, *args, **kwargs):
        if hasattr(item, "prompt_ids") and len(held) < n:
            held.append(item)
            if len(held) == n:
                for it in held:
                    real_put(it)
            return
        real_put(item, *args, **kwargs)

    q.put = put
    return lambda: setattr(q, "put", real_put)


async def _burst(cp, app, records, intents, port: bool):
    for rec in records:
        await cp.registry.put(rec)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        await _idle_after_warm(cp)
        restore = _enqueue_together(cp.planner.engine, len(intents))
        try:
            resps = await asyncio.gather(*(client.post("/plan", json={"intent": i}) for i in intents))
        finally:
            restore()
        out = []
        for r in resps:
            assert r.status == 200, await r.text()
            body = await r.json()
            tid = r.headers["X-Trace-Id"]
            assert r.headers["traceparent"].split("-")[1] == tid
            out.append((body["graph"], tid))
        # The worker folds the prefix cache's counters into the metrics
        # once an iteration: let it run one after the last retirement.
        await asyncio.sleep(0.3)
        scraped = _scrape(await (await client.get("/metrics")).text())
        spans = [sorted(s.name for s in cp.tracer.get(tid).spans) for _, tid in out]
        listing = (await (await client.get("/traces")).json())["traces"]
        assert {t["trace_id"] for t in listing} >= {tid for _, tid in out}
        profile = cp.planner.engine.queue_stats()["worker_profile"] if port else None
        return [g for g, _ in out], spans, scraped, profile
    finally:
        await client.close()


@pytest.fixture(scope="module")
def runs():
    records = jsynth(N_SERVICES, seed=0)
    rng = random.Random(0)
    intents = [intent_for(records, rng) for _ in range(N_INTENTS)]
    jcp = jbuild(JConfig.from_dict(CONFIG))
    ref = asyncio.run(_burst(jcp, jbuild_app(jcp), records, intents, port=False))
    cp = build_control_plane(MCPXConfig.from_dict(CONFIG), device="cpu")
    port = asyncio.run(_burst(cp, build_app(cp), synth_registry(N_SERVICES, seed=0), intents, port=True))
    off_cfg = copy.deepcopy(CONFIG)
    off_cfg["tracing"] = {"enabled": False}
    off_cfg["telemetry"] = {"cost_accounting": False, "flight": {"profile_worker": False}}

    async def off_run():
        cp = build_control_plane(MCPXConfig.from_dict(off_cfg), device="cpu")
        for rec in synth_registry(N_SERVICES, seed=0):
            await cp.registry.put(rec)
        await cp.startup()
        try:
            assert cp.tracer.start_request("/plan") is None
            assert "worker_profile" not in cp.planner.engine.queue_stats()
            assert cp.planner.engine.costs.snapshot()["executables"] == {}
            return [p.to_wire() for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
        finally:
            await cp.aclose()

    return ref, port, asyncio.run(off_run())


def test_trace_span_names_match_reference(runs):
    (ref_plans, ref_spans, _, _), (plans, spans, _, _), _ = runs
    assert plans == ref_plans
    assert spans == ref_spans
    for names in spans:
        assert {"/plan", "plan", "plan.context", "planner.grammar", "engine.generate",
                "engine.queue_wait", "engine.prefill", "engine.decode", "engine.segment"} <= set(names)


def test_scraped_counters_match_reference(runs):
    (_, _, ref_scraped, _), (_, _, scraped, _), _ = runs
    got = {name: _counter(scraped, name, labels) for name, labels in COUNTERS}
    want = {name: _counter(ref_scraped, name, labels) for name, labels in COUNTERS}
    assert got == want
    assert got["mcpx_requests_total"] == N_INTENTS
    assert got["mcpx_plans_total"] == N_INTENTS
    assert got["mcpx_kv_prefix_hits_total"] + got["mcpx_kv_prefix_misses_total"] >= N_INTENTS


def test_worker_profile_tiles_the_loop(runs):
    _, (_, _, _, profile), _ = runs
    assert set(profile["phases"]) == set(PROFILE_PHASES)
    assert profile["iterations"] > 0 and profile["wall_s"] > 0
    assert 0.95 <= profile["attributed_frac"] <= 1.0 + 1e-6
    for phase in ("drain", "admit", "dispatch_submit", "harvest"):
        assert profile["phases"][phase]["count"] > 0, phase


def test_plans_equal_with_telemetry_off(runs):
    _, (plans, _, _, _), off_plans = runs
    assert plans == off_plans
