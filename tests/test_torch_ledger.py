"""The cost ledger in the port, held against the reference package on the
CPU (the cases of the reference's ``tests/test_ledger.py``):

  - ``RequestBill`` itemization, ``count_tool_attempts`` on malformed
    traces, the contextvar trio and ``UsageLedger``'s tenant fold give the
    reference's dicts on the same inputs; over seeded mixed-tenant traffic
    (``random.Random`` and numpy) the two ledgers' snapshots are equal, and
    each tenant's totals are exactly its member bills folded with ``+=`` in
    completion order;
  - the engine, at the test preset on the committed checkpoint in float32
    with ``data_axis=1, model_axis=1``: every bill item but ``flops`` and
    ``hbm_bytes`` (analytic in the port, XLA's in the reference) and the
    wall items equals the reference's, request for request, with
    speculation off (a cohort sharing a prompt head, then one request
    reusing it) and on, and over the KV tier (readmit copy tokens); in the
    port the bills' FLOPs and bytes, folded
    with ``+=`` in completion order, equal the ``ledger_totals()`` delta
    and the cost registry's executed-totals delta exactly; with the ledger
    off the tokens are the same and no bill exists;
  - the full stack: a ``/plan`` through each package's app with the LLM
    planner bills the request on its root span with the reference's items,
    ``/usage`` rolls it up the same, and the wall items tile the request;
    with the ledger off ``/usage`` and ``/slo`` answer ``enabled: false``.
"""

import asyncio
import copy
import dataclasses
import os
import random

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.engine.engine import InferenceEngine as JEngine
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.planner.llm import LLMPlanner as JPlanner
from mcpx.server.app import build_app as jbuild_app
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.telemetry import ledger as jledger
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.planner.llm import LLMPlanner
from mcpx_torch.server.app import build_app
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.telemetry import ledger
from mcpx_torch.utils.synth import synth_registry

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)
PKGS = {"reference": (jledger, JConfig), "port": (ledger, MCPXConfig)}
# The bill items that depend on the clock or on the cost basis.
TIMED = {"engine_queue_ms", "prefill_ms", "decode_ms", "kv_page_seconds"}
COST = {"flops", "hbm_bytes"}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lcfg(pkg: str, **kw):
    return PKGS[pkg][1].from_dict({"telemetry": {"ledger": {"enabled": True, **kw}}}).telemetry.ledger


# ------------------------------------------------------------------- bill
def _itemized(pkg: str) -> dict:
    mod = PKGS[pkg][0]
    bill = mod.RequestBill(tenant="acme", endpoint="/plan")
    bill.sched_queue_ms += 5.0
    bill.add_engine({
        "engine_queue_ms": 2.0, "prefill_ms": 10.0, "decode_ms": 80.0, "prefill_tokens": 30,
        "prefix_saved_tokens": 16, "decode_tokens": 12, "decode_forwards": 12, "spec_accepted_tokens": 4,
        "spill_copy_tokens": 16, "kv_page_seconds": 0.5, "flops": 1e9, "hbm_bytes": 2e9,
    })
    # A replanning request generates twice and pays for both.
    bill.add_engine({"decode_ms": 20.0, "decode_tokens": 3, "flops": 1e8})
    bill.note_plan(120.0, 112.0)
    bill.add_tools({"nodes": [{"attempts": [
        {"kind": "primary", "status": "error"}, {"kind": "retry", "status": "ok"},
        {"kind": "hedge", "status": "cancelled"},
    ]}]}, 40.0)
    bill.finalize(status="ok", total_ms=200.0)
    assert bill.generates == 2 and bill.tool_attempts == 3
    return bill.to_dict()


def test_bill_itemization_finalize_and_to_dict():
    port = _itemized("port")
    assert port == _itemized("reference")
    assert port["other_ms"] == pytest.approx(200.0 - 165.0)
    assert port["tool_attempts_by_kind"] == {"primary": 1, "retry": 1, "hedge": 1}


@pytest.mark.parametrize("trace", [
    None, {"nodes": "garbage"}, {"nodes": [{"attempts": [None, 7]}]},
    {"nodes": [{"attempts": [{"kind": "fallback"}]}, "junk"]},
    {"nodes": [{"attempts": [{"kind": "primary"}, {}, {"kind": "retry"}]}, {"attempts": None}]},
    "not a trace",
], ids=["none", "nodes_str", "bad_attempts", "junk_node", "default_kind", "str"])
def test_count_tool_attempts_survives_malformed_traces(trace):
    assert ledger.count_tool_attempts(trace) == jledger.count_tool_attempts(trace)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_contextvar_activate_deactivate(pkg):
    mod = PKGS[pkg][0]
    assert mod.current_bill() is None
    bill = mod.RequestBill()
    token = mod.activate(bill)
    assert mod.current_bill() is bill
    mod.deactivate(token)
    assert mod.current_bill() is None


# ---------------------------------------------------------------- usage fold
def _fold(pkg: str) -> dict:
    mod = PKGS[pkg][0]
    led = mod.UsageLedger(_lcfg(pkg, max_tenants=2))
    for i, tenant in enumerate(["a", "b", "c", "d", "a"]):
        bill = mod.RequestBill(tenant=tenant)
        bill.add_engine({"decode_tokens": i})
        bill.finalize(status="ok", total_ms=1.0)
        led.observe(bill)
    return led.snapshot()


def test_usage_ledger_folds_tenant_cardinality():
    snap = _fold("port")
    assert snap == _fold("reference")
    assert set(snap["tenants"]) == {"a", "b", "other"}
    assert snap["tenants"]["other"]["requests"] == 2


def _traffic(seed: int) -> list[dict]:
    """Seeded mixed-tenant bill inputs (random.Random for the choices, numpy
    for the amounts), the same for both packages."""
    rng, gen = random.Random(seed), np.random.default_rng(seed)
    out = []
    for _ in range(300):
        engine = []
        for _g in range(rng.randint(1, 3)):
            u = gen.uniform(0, 1, 7)
            engine.append({
                "engine_queue_ms": float(2 * u[0]), "prefill_ms": float(20 * u[1]),
                "decode_ms": float(200 * u[2]), "prefill_tokens": rng.randint(0, 64),
                "prefix_saved_tokens": rng.randint(0, 32), "decode_tokens": rng.randint(1, 48),
                "decode_forwards": rng.randint(1, 48), "flops": float(1e9 * u[3]),
                "hbm_bytes": float(1e9 * u[4]), "kv_page_seconds": float(3 * u[5]),
            })
        out.append({
            "tenant": rng.choice(["t0", "t1", "t2", "t3", "t4"]), "degraded": rng.random() < 0.2,
            "sched": float(gen.uniform(0, 5)), "engine": engine,
            "plan": (float(gen.uniform(0, 50)), float(gen.uniform(0, 10))),
            "total": float(gen.uniform(1, 400)),
            "status": rng.choice(["ok", "ok", "ok", "error", "throttled"]),
        })
    return out


def _roll(pkg: str, traffic: list[dict]):
    mod = PKGS[pkg][0]
    led = mod.UsageLedger(_lcfg(pkg, max_tenants=8, recent=512))
    bills = []
    for t in traffic:
        bill = mod.RequestBill(tenant=t["tenant"], endpoint="/plan", degraded=t["degraded"])
        bill.sched_queue_ms += t["sched"]
        for item in t["engine"]:
            bill.add_engine(item)
        bill.note_plan(*t["plan"])
        bill.finalize(status=t["status"], total_ms=t["total"])
        led.observe(bill)
        bills.append(bill)
    return led, bills


@pytest.mark.parametrize("seed", [1234, 7])
def test_tenant_rollups_exactly_sum_member_bills(seed):
    traffic = _traffic(seed)
    port, bills = _roll("port", traffic)
    ref, _ = _roll("reference", traffic)
    snap = port.snapshot()
    assert snap == ref.snapshot()
    assert len(snap["recent"]) == 300
    for tenant in {b.tenant for b in bills}:
        acct = port.tenant_totals(tenant)
        member = [b for b in bills if b.tenant == tenant]
        assert acct["requests"] == len(member)
        for key in ("decode_tokens", "prefill_tokens", "decode_forwards", "flops", "hbm_bytes",
                    "decode_ms", "kv_page_seconds", "total_ms"):
            # The ledger's own fold: += in completion order, bit for bit.
            folded = 0.0 if isinstance(getattr(member[0], key), float) else 0
            for b in member:
                folded += getattr(b, key)
            assert acct[key] == folded, (tenant, key)


# ------------------------------------------------------------- engine side
ENGINE = {
    "max_batch_size": 8, "max_decode_len": 24, "kv_page_size": 16, "max_pages_per_seq": 16,
    "temperature": 0.0, "use_pallas": False, "data_axis": 1, "model_axis": 1, "warmup_compile": False,
}
CONFIG = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 256, "checkpoint_path": CKPT},
    "engine": ENGINE,
    "tracing": {"enabled": False},
    "telemetry": {"ledger": {"enabled": True}},
}
SPEC = {"hetero_batch": True, "speculative": {"enabled": True, "k": 4}}
HEAD = "shared planner header with a long common prompt prefix for every request. "
COHORT = 4


def _cfg(cls, spec: bool, ledger_on: bool):
    raw = copy.deepcopy(CONFIG)
    if spec:
        raw["engine"].update(SPEC)
    raw["telemetry"]["ledger"]["enabled"] = ledger_on
    return cls.from_dict(raw)


def float32(cls):
    return dataclasses.replace(cls.named("test", vocab_size=3072, max_seq_len=256), dtype="float32")


def _hold(engine, n: int):
    """Hold the engine's next ``n`` generate requests and enqueue them at
    once: they form one admission cohort in both packages. Returns the
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


async def _stream(eng, spec: bool, port: bool) -> dict:
    """A cohort of COHORT greedy requests sharing a prompt head, submitted
    at once, then (speculation off) the first again alone, its head now
    in the tree. Returns each result's tokens and bill, and (port) the
    ledger, cost-registry and accepted-count deltas over the stream."""
    await eng.start()
    try:
        tok = eng.tokenizer
        calls = [
            (tok.encode(f"{HEAD}request {i}: compose the services. JSON:"),
             dict(max_new_tokens=24, constrained=not spec or i % 2 == 0))
            for i in range(COHORT)
        ]
        before = (eng.ledger_totals(), eng.costs.executed(), eng.queue_stats()) if port else None
        restore = _hold(eng, COHORT)
        try:
            results = list(await asyncio.gather(*(eng.generate(p, **kw) for p, kw in calls)))
        finally:
            restore()
        if not spec:
            results.append(await eng.generate(calls[0][0], **calls[0][1]))
        out = {"ids": [r.token_ids for r in results], "bills": [r.bill for r in results],
               "tokens": [r.generated_tokens for r in results]}
        if port:
            t1, ex1, qs1 = eng.ledger_totals(), eng.costs.executed(), eng.queue_stats()
            t0, ex0, qs0 = before
            out["totals"] = (t1["flops"] - t0["flops"], t1["bytes"] - t0["bytes"])
            out["executed"] = tuple(
                sum(v[k] for v in ex1.values()) - sum(v[k] for v in ex0.values()) for k in (0, 1)
            )
            out["accepted"] = qs1["accepted"] - qs0["accepted"]
        return out
    finally:
        await eng.aclose()


@pytest.fixture(scope="module")
def engine_runs():
    out = {}
    for spec in (False, True):
        ref = asyncio.run(_stream(JEngine(_cfg(JConfig, spec, True), model_cfg=float32(JGemmaConfig)), spec, False))
        port = asyncio.run(_stream(
            InferenceEngine(_cfg(MCPXConfig, spec, True), model_cfg=float32(GemmaConfig), device="cpu"), spec, True
        ))
        out[spec] = (ref, port)
    out["off"] = asyncio.run(_stream(
        InferenceEngine(_cfg(MCPXConfig, False, False), model_cfg=float32(GemmaConfig), device="cpu"), False, True
    ))
    return out


@pytest.mark.parametrize("spec", [False, True], ids=["spec_off", "spec_on"])
def test_engine_bills_match_reference_request_for_request(engine_runs, spec):
    ref, port = engine_runs[spec]
    assert port["ids"] == ref["ids"]
    for i, (rb, pb) in enumerate(zip(ref["bills"], port["bills"])):
        assert pb is not None and rb is not None
        assert set(pb) == set(rb), i
        want = {k: v for k, v in rb.items() if k not in TIMED | COST}
        got = {k: v for k, v in pb.items() if k not in TIMED | COST}
        assert got == want, i
        assert pb["decode_tokens"] == port["tokens"][i]
        assert pb["kv_pages"] > 0 and pb["kv_page_seconds"] > 0 and pb["flops"] > 0
        assert all(pb[k] >= 0 for k in TIMED)
    if spec:
        assert sum(b["spec_accepted_tokens"] for b in port["bills"]) > 0
    else:
        # Prefix reuse: the lone request is served from the tree.
        assert port["bills"][-1]["prefix_saved_tokens"] > 0
        assert port["bills"][-1]["prefill_tokens"] < port["bills"][0]["prefill_tokens"]


@pytest.mark.parametrize("spec", [False, True], ids=["spec_off", "spec_on"])
def test_engine_bills_conserve_exactly(engine_runs, spec):
    _, port = engine_runs[spec]
    flops = nbytes = 0.0
    for b in port["bills"]:  # completion order within the stream
        flops += b["flops"]
        nbytes += b["hbm_bytes"]
    assert flops > 0 and nbytes > 0
    assert (flops, nbytes) == port["totals"] == port["executed"]
    # Every accepted speculative token is on some bill.
    assert sum(b["spec_accepted_tokens"] for b in port["bills"]) == port["accepted"]


def test_engine_ledger_off_is_pass_through(engine_runs):
    _, on = engine_runs[False]
    off = engine_runs["off"]
    assert off["ids"] == on["ids"]
    assert all(b is None for b in off["bills"])
    assert off["totals"] == (0, 0)
    assert off["executed"] == on["executed"]


TIER = {
    "max_batch_size": 4, "max_pages_per_seq": 16, "kv_page_size": 16, "max_decode_len": 8,
    "temperature": 0.0, "prefix_cache": True, "prefix_cache_entries": 4096, "use_pallas": False,
    "data_axis": 1, "model_axis": 1, "warmup_compile": False,
    "kv_tier": {"enabled": True, "host_mb": 256.0, "copy_tokens_per_cycle": 4096},
}


async def _tier_bills(cls, gemma, port: bool) -> tuple:
    """The tier scenario's stream (16 prompts of 128 tokens against a
    512-token resident cap, one at a time, two rounds): the second round's
    matches readmit spilled runs. Returns every bill and (port) the ledger
    and cost-registry deltas."""
    cfg = cls.from_dict({
        "model": {"size": "test", "vocab": "bpe", "max_seq_len": 256, "checkpoint_path": CKPT},
        "engine": TIER, "telemetry": {"ledger": {"enabled": True}},
    })
    kw = {"device": "cpu"} if port else {}
    eng = (InferenceEngine if port else JEngine)(cfg, model_cfg=float32(gemma), **kw)
    await eng.start()
    try:
        ex0, t0 = (eng.costs.executed(), eng.ledger_totals()) if port else (None, None)
        prompts = [eng.tokenizer.encode(f"tier workload {i}: " + "compose rank fetch join " * 12)[:128]
                   for i in range(16)]
        bills = []
        for _ in range(2):
            for p in prompts:
                r = await eng.generate(p, max_new_tokens=2, constrained=False, temperature=0.0)
                bills.append(r.bill)
        if not port:
            return bills, None
        ex1, t1 = eng.costs.executed(), eng.ledger_totals()
        executed = tuple(sum(v[k] for v in ex1.values()) - sum(v[k] for v in ex0.values()) for k in (0, 1))
        return bills, (executed, (t1["flops"] - t0["flops"], t1["bytes"] - t0["bytes"]))
    finally:
        await eng.aclose()


def test_engine_bills_readmit_copies_as_the_reference_over_the_kv_tier():
    ref, _ = asyncio.run(_tier_bills(JConfig, JGemmaConfig, False))
    port, (executed, totals) = asyncio.run(_tier_bills(MCPXConfig, GemmaConfig, True))
    skip = TIMED | COST
    assert [{k: v for k, v in b.items() if k not in skip} for b in port] == [
        {k: v for k, v in b.items() if k not in skip} for b in ref
    ]
    assert sum(b["spill_copy_tokens"] for b in port) > 0
    flops = nbytes = 0.0
    for b in port:
        flops += b["flops"]
        nbytes += b["hbm_bytes"]
    # The tier's spill and readmit copies are billed too.
    assert (flops, nbytes) == executed == totals


# ---------------------------------------------------------- full-stack e2e
APP = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": CKPT},
    "engine": {
        "max_batch_size": 4, "max_decode_len": 64, "kv_page_size": 64, "max_pages_per_seq": 4,
        "temperature": 0.0, "use_pallas": False, "data_axis": 1, "model_axis": 1,
    },
    "planner": {"kind": "llm", "plan_cache_size": 0},
    "telemetry": {"ledger": {"enabled": True}},
}


async def _full_stack(cp, app, records, intents) -> tuple:
    for rec in records:
        await cp.registry.put(rec)
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        await cp.startup()
        r = await client.post("/plan", json={"intent": intents[0]})
        assert r.status == 200, await r.text()
        r = await client.post("/plan", json={"intent": intents[1]}, headers={"X-MCPX-Tenant": "acme"})
        assert r.status == 200, await r.text()
        rec = cp.tracer.get(r.headers["X-Trace-Id"])
        bill = rec.spans[0].attrs["bill"]
        usage = await (await client.get("/usage")).json()
        return bill, rec.total_ms, usage
    finally:
        await client.close()


def test_traced_request_bill_and_usage_match_reference_full_stack():
    records = jsynth(40, seed=0)
    rng = random.Random(0)
    intents = [intent_for(records, rng) for _ in range(2)]
    # Float32 forwards on both sides (bf16 leaves near-ties that flip).
    jcfg, cfg = JConfig.from_dict(APP), MCPXConfig.from_dict(APP)
    jmodel = dataclasses.replace(JGemmaConfig.named("test", vocab_size=3072, max_seq_len=2048), dtype="float32")
    model = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072, max_seq_len=2048), dtype="float32")
    jcp = jbuild(jcfg, planner=JPlanner(JEngine(jcfg, model_cfg=jmodel), jcfg.planner))
    ref = asyncio.run(_full_stack(jcp, jbuild_app(jcp), records, intents))
    cp = build_control_plane(cfg, planner=LLMPlanner(InferenceEngine(cfg, model_cfg=model, device="cpu"), cfg.planner),
                             device="cpu")
    port = asyncio.run(_full_stack(cp, build_app(cp), synth_registry(40, seed=0), intents))
    (rbill, _, rusage), (bill, total_ms, usage) = ref, port
    walls = {"sched_queue_ms", "plan_other_ms", "tool_ms", "total_ms", "other_ms", "attributed_frac"}
    assert set(bill) == set(rbill)
    skip = TIMED | COST | walls
    assert {k: v for k, v in bill.items() if k not in skip} == {k: v for k, v in rbill.items() if k not in skip}
    assert bill["tenant"] == "acme" and bill["decode_tokens"] > 0 and bill["generates"] == 1
    # The wall items tile the request's root span.
    parts = sum(bill[k] for k in ("sched_queue_ms", "engine_queue_ms", "prefill_ms", "decode_ms",
                                  "plan_other_ms", "tool_ms"))
    assert bill["total_ms"] == pytest.approx(total_ms, rel=0.05)
    assert parts >= 0.95 * total_ms
    assert set(usage["tenants"]) == set(rusage["tenants"]) == {"default", "acme"}
    for tenant in usage["tenants"]:
        a, b = usage["tenants"][tenant], rusage["tenants"][tenant]
        for key in ("requests", "errors", "degraded", "generates", "decode_tokens", "prefill_tokens",
                    "prefix_saved_tokens", "decode_forwards", "spec_accepted_tokens", "tool_attempts"):
            assert a[key] == b[key], (tenant, key)
    assert usage["requests"] == rusage["requests"] == 2
    assert usage["tenants"]["acme"]["flops"] == bill["flops"]


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_server_ledger_off_is_pass_through(pkg):
    cfg = {"planner": {"kind": "heuristic"}}
    if pkg == "reference":
        cp = jbuild(JConfig.from_dict(cfg))
        app = jbuild_app(cp)
    else:
        cp = build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
        app = build_app(cp)
    assert cp.ledger is None and cp.slo is None

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            for path in ("/usage", "/slo"):
                resp = await client.get(path)
                assert resp.status == 200
                assert await resp.json() == {"enabled": False}
        finally:
            await client.close()

    asyncio.run(go())
