"""Pieces of ``chip_smoke.py`` that run without a card: the kernel phase's
least-time count (``attention_bound``: it charges what the function needs,
no more), the execute phase's prompt checks, failing transport, rounds of
executions (``Lockstep``) and probe exclusion, the telemetry phase (its
exposition parser, its latency attribution against the reference bench's,
and the phase itself on a CPU control plane), the mixed, speculation and
heterogeneous ``/plan`` phases and the tiered-KV phase on CPU engines, and
the int8, overload, chaos, observatory, 100k-registry (at a small size) and
SentencePiece phases on CPU control planes, the offline phase (corpus,
training, evaluation) with its margin helpers on the CPU, the lint
phase's gate on a small tree, and the TP/DP phase on CPU engines."""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def test_attention_bound_counts_live_queries_and_visible_positions():
    B, S, K, G, hd, psz, p_max = 4, 8, 1, 8, 256, 64, 4
    q = torch.zeros((B, S, K, G, hd), dtype=torch.bfloat16)
    k_pages = torch.zeros((K, 2, B * p_max + 1, psz, hd), dtype=torch.bfloat16)
    table = torch.zeros((B, p_max), dtype=torch.int32)
    # One live row: 3 queries from position 70 (73 visible positions, 2
    # pages), one row whose window runs past the table (clamped to 256
    # positions, 4 pages), two idle rows.
    starts = torch.tensor([70, 0, 250, 5], dtype=torch.int32)
    q_lens = torch.tensor([3, 0, 8, 0], dtype=torch.int32)
    _, by, nbytes, flops = chip_smoke.attention_bound(q, k_pages, table, starts, q_lens)
    elt = 2
    want = (
        (3 + 8) * K * G * hd * elt  # live queries
        + (73 + 256) * K * hd * 2 * elt  # visible K and V positions
        + B * S * K * G * hd * elt  # out, written in full
        + 4 * ((2 + 4) + 2 * B)  # page-table entries, start_pos, q_lens
    )
    assert nbytes == want and by == "bytes"
    visible = [71, 72, 73] + [min(250 + i + 1, 256) for i in range(8)]
    assert flops == K * G * 4 * hd * sum(visible)


def test_execute_phase_prompt_checks():
    """``extends_block`` accepts a replan prompt that keeps the original's
    services block and adds an Avoid line, and refuses one whose block
    changed; ``latency_blind`` makes two prompts that differ only in a
    rendered tool latency equal, and no others; ``common_prefix`` and
    ``nearest_rank`` as the line reports them."""
    from mcpx_torch.models.tokenizer import make_tokenizer

    tok = make_tokenizer("bpe")
    head = "Compose a service DAG.\nServices:\na-svc in:x out:y\nb-svc in:y out:z"
    original = tok.encode(head + "\nIntent: do it\nJSON:")
    warm = tok.encode(head + "\nc-svc in:x out:z\nAvoid: a-svc\nIntent: do it\nJSON:")
    changed = tok.encode(head.replace("a-svc in:x out:y", "a-svc in:x out:y err=1.00 p50=0")
                         + "\nAvoid: a-svc\nIntent: do it\nJSON:")
    assert chip_smoke.extends_block(tok, original, warm)
    assert not chip_smoke.extends_block(tok, original, changed)
    assert not chip_smoke.extends_block(tok, original, original)  # no Avoid line
    slow = tok.encode(head.replace("a-svc in:x out:y", "a-svc in:x out:y err=1.00 p50=1") + "\nJSON:")
    fast = tok.encode(head.replace("a-svc in:x out:y", "a-svc in:x out:y err=1.00 p50=0") + "\nJSON:")
    assert slow != fast and chip_smoke.latency_blind(tok, slow) == chip_smoke.latency_blind(tok, fast)
    assert "p50=_" in chip_smoke.latency_blind(tok, slow)
    assert chip_smoke.latency_blind(tok, changed) != chip_smoke.latency_blind(tok, warm)
    assert chip_smoke.common_prefix([1, 2, 3], [1, 2, 4]) == 2
    assert chip_smoke.common_prefix([1, 2], [1, 2, 4]) == 2
    lat = sorted(float(i) for i in range(1, 17))
    assert (chip_smoke.nearest_rank(lat, 0.5), chip_smoke.nearest_rank(lat, 0.99)) == (8.0, 16.0)


def test_latency_flip_explains_only_a_latency_differing_replan():
    """``latency_flip`` explains a call whose passes part at a replan prompt
    that differs in the tools' latency alone, every execution before it
    equal: it names that execution, the first differing plan and the first
    differing token, and asks pass 1's margin there; a prompt that differs
    otherwise, a plan that differs under an equal prompt, or an earlier
    execution that differs is unexplained (None)."""
    from types import SimpleNamespace

    from mcpx_torch.models.tokenizer import make_tokenizer

    tok = make_tokenizer("bpe")
    head = "Compose a service DAG.\nServices:\na-svc in:x out:y"
    first = tok.encode(head + "\nJSON:")
    fast = tok.encode(head + " err=1.00 p50=0\nJSON:")
    slow = tok.encode(head + " err=1.00 p50=1\nJSON:")
    other = tok.encode(head + " err=0.50 p50=0\nJSON:")
    kw = {"temperature": 0.0, "constrained": True}
    served1 = {tuple(first): (kw, SimpleNamespace(token_ids=[1, 2])),
               tuple(fast): (kw, SimpleNamespace(token_ids=[5, 6, 7]))}
    served2 = {tuple(first): (kw, SimpleNamespace(token_ids=[1, 2])),
               tuple(slow): (kw, SimpleNamespace(token_ids=[5, 9])),
               tuple(other): (kw, SimpleNamespace(token_ids=[5, 9])),
               tuple(fast): (kw, SimpleNamespace(token_ids=[5, 9]))}
    asked = []

    def margin(*args):
        asked.append(args)
        return 2e-4

    runs1 = [("a", first), ("b", fast)]
    flip = chip_smoke.latency_flip(tok, runs1, [("a", first), ("c", slow)], served1, served2, margin)
    assert flip == {"prompt_differs_at": 1, "plan_differs_at": 1, "token": 1, "margin": 2e-4}
    assert asked == [(fast, kw, [5, 6, 7], 1)]
    assert chip_smoke.latency_flip(tok, runs1, [("a", first), ("c", other)], served1, served2, margin) is None
    assert chip_smoke.latency_flip(tok, runs1, [("a", first), ("c", fast)], served1, served2, margin) is None
    assert chip_smoke.latency_flip(tok, runs1, [("x", first), ("c", slow)], served1, served2, margin) is None
    assert chip_smoke.latency_flip(tok, runs1, [("a", first), ("b", slow)], served1, served2, margin) is None
    assert len(asked) == 1


def test_failing_transport_fails_every_endpoint_of_a_failing_service():
    import asyncio

    from mcpx_torch.orchestrator.transport import TransportError
    from mcpx_torch.utils.synth import synth_registry

    records = synth_registry(20, seed=0)
    bad = next(r for r in records if r.fallbacks)
    transport, calls = chip_smoke.failing_transport(records, {bad.name})

    async def go():
        ok = await transport.post(records[0].endpoint if records[0] is not bad else records[1].endpoint, {"b": 1, "a": 2}, 1.0)
        for ep in [bad.endpoint, *bad.fallbacks]:
            try:
                await transport.post(ep, {}, 1.0)
            except TransportError:
                continue
            raise AssertionError(f"{ep} answered")
        return ok

    ok = asyncio.run(go())
    assert ok["inputs"] == ["a", "b"] and len(calls) == 1 + 1 + len(bad.fallbacks)


def test_lockstep_runs_executions_in_rounds():
    """Calls that plan for different times before each execution (the
    slowest first): each round waits for every running call, runs its
    executions one at a time in call order after ``settle``, and releases
    none before all have run; each call's executions are kept under its
    trace id."""
    import asyncio
    from types import SimpleNamespace

    log = []

    class Inner:
        async def execute(self, plan, payload, trace=None):
            log.append(("start", trace.trace_id, payload["round"]))
            await asyncio.sleep(payload["hold"])
            log.append(("end", trace.trace_id, payload["round"]))
            return SimpleNamespace(trace=trace, errors={})

        async def aclose(self):
            pass

    settled = []

    async def settle():
        settled.append(len(log))

    lockstep = chip_smoke.Lockstep(Inner(), settle)

    async def call(name: str, planning: list):
        trace = SimpleNamespace(trace_id=name)
        for r, t in enumerate(planning):
            await asyncio.sleep(t)  # the plan or replan
            await lockstep.execute(None, {"round": r, "hold": 0.01 * (len(name) % 3)}, trace)
            log.append(("back", name, r))
        return name

    calls = {"a": [0.03], "bb": [0.02, 0.0], "ccc": [0.0, 0.05, 0.0]}
    done = asyncio.run(lockstep.run(call(n, p) for n, p in calls.items()))
    assert done == list(calls) and lockstep.running == 0
    assert {k: len(v) for k, v in lockstep.executions.items()} == {"a": 1, "bb": 2, "ccc": 3}
    # One round a settle; in a round the executions run one at a time in
    # call order, and the next round starts after the whole round.
    runs = [e for e in log if e[0] != "back"]
    assert runs == [
        ("start", "a", 0), ("end", "a", 0), ("start", "bb", 0), ("end", "bb", 0),
        ("start", "ccc", 0), ("end", "ccc", 0),
        ("start", "bb", 1), ("end", "bb", 1), ("start", "ccc", 1), ("end", "ccc", 1),
        ("start", "ccc", 2), ("end", "ccc", 2),
    ]
    for r in range(3):
        last_end = max(i for i, e in enumerate(log) if e[0] == "end" and e[2] == r)
        assert all(i > last_end for i, e in enumerate(log) if e[0] == "back" and e[2] == r)
        assert settled[r] == min(i for i, e in enumerate(log) if e[0] == "start" and e[2] == r)


def test_probe_excludes_a_service_the_prompt_renders():
    from mcpx_torch.core.dag import Plan

    def plan(services, rendered):
        p = Plan.from_wire({"nodes": [{"name": s} for s in services], "edges": []})
        p.prompt_services = rendered
        return p

    assert chip_smoke.rendered_exclusion(plan(["a", "b"], ["b", "a"])) == "a"
    assert chip_smoke.rendered_exclusion(plan(["x", "b"], ["c", "b"])) == "b"
    assert chip_smoke.rendered_exclusion(plan(["x", "y"], ["c", "b"])) == "c"
    assert chip_smoke.rendered_exclusion(plan(["x"], None)) == "x"


def test_parse_exposition_reads_the_port_metrics_and_refuses_garbage():
    import pytest

    from mcpx_torch.telemetry.metrics import Metrics

    m = Metrics()
    m.requests.labels(endpoint="/plan", status="ok").inc(3)
    m.grammar_fallbacks.labels(kind='a "quoted" \\ kind').inc()
    m.hol_wait.observe(7.0)
    parsed = chip_smoke.parse_exposition(m.render().decode())
    assert chip_smoke.metric(parsed, "mcpx_requests_total", '{endpoint="/plan",status="ok"}') == 3.0
    assert chip_smoke.metric(parsed, "mcpx_engine_hol_wait_ms_bucket", '{le="10.0"}') == 1.0
    assert chip_smoke.metric(parsed, "mcpx_engine_decode_forwards_total") == 0.0
    with pytest.raises(SystemExit, match="unparsable"):
        chip_smoke.parse_exposition("# TYPE x counter\nx{bad} 1\n")
    with pytest.raises(SystemExit, match="no TYPE line"):
        chip_smoke.parse_exposition("mcpx_orphan 1.0\n")


def test_attribution_matches_the_reference_bench():
    import bench

    from mcpx_torch.telemetry.tracing import Tracer

    tr = Tracer(enabled=True)
    recs = []
    for i in range(5):
        root = tr.start_request("/plan")
        t0 = root.t0
        plan = root.child("plan", t0=t0 + 0.001, t1=t0 + 0.099)
        plan.child("engine.generate", t0=t0 + 0.002, t1=t0 + 0.090 + 0.001 * i)
        root.child("engine.queue_wait", t0=t0 + 0.004, t1=t0 + 0.010)
        root.child("engine.prefill", t0=t0 + 0.010, t1=t0 + 0.030 + 0.002 * i)
        root.child("engine.decode", t0=t0 + 0.030, t1=t0 + 0.090)
        root.end(t0 + 0.100)
        tr.finish(root)
        recs.append(tr.get(root.trace_id))
    got = chip_smoke.attribution(recs)
    want = bench._attribution_from_traces(recs)
    assert got["traces"] == want["traces"] == 5
    for q in ("p50_ms", "p99_ms"):
        for k, v in want[q].items():
            assert round(got[q][k], 2) == v, (q, k)
    for k, v in want["share_p50"].items():
        assert round(got["share_p50"][k], 4) == v, k
    assert abs(got["p50_ms"]["planner_outside_engine"] - 8.0) < 0.1  # 98 ms less 88-92 ms


def test_one_cohort_holds_a_burst_and_releases_it_at_once():
    import queue
    import time
    import types

    engine = types.SimpleNamespace(_queue=queue.Queue())
    req = lambda ids: types.SimpleNamespace(prompt_ids=ids, enqueued_at=0.0)  # noqa: E731
    q = engine._queue
    with chip_smoke.one_cohort(engine, 3):
        q.put(req([5, 1]))
        q.put("pin")  # not a generate request: passes straight through
        q.put(req([2]))
        assert [q.get_nowait()] == ["pin"] and q.empty()
        t = time.monotonic()
        q.put(req([3, 9]))  # the third: all three at once, in prompt order
        assert [q.get_nowait().prompt_ids for _ in range(3)] == [[2], [3, 9], [5, 1]]
        q.put(req([0]))  # a retry beyond the cohort passes through
        got = q.get_nowait()
        assert got.prompt_ids == [0] and got.enqueued_at == 0.0
    assert q.empty() and q.put.__self__ is q
    # Fewer than n: the timer lets the held ones through, and later ones pass.
    with chip_smoke.one_cohort(engine, 3, timeout_s=0.05):
        q.put(req([1]))
        assert q.empty()
        first = q.get(timeout=5)
        assert first.prompt_ids == [1] and first.enqueued_at >= t
        q.put(req([4]))
        assert q.get_nowait().prompt_ids == [4]


def test_telemetry_phase_runs_on_a_cpu_control_plane():
    import asyncio
    import random

    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    async def go():
        cfg = chip_smoke.config("test", chip_smoke.CKPT, 8)
        cfg.engine.warmup_compile = False
        cp = build_control_plane(cfg, device="cpu")
        records = synth_registry(100, seed=0)
        for rec in records:
            await cp.registry.put(rec)
        await cp.startup()
        # The first burst as one cohort from an emptied tree, as the chip
        # script serves it; the phase serves it again the same way.
        await cp.planner.engine.drop_unpinned()
        try:
            rng = random.Random(0)
            intents = [intent_for(records, rng) for _ in range(3)]
            with chip_smoke.one_cohort(cp.planner.engine, len(intents)):
                plans = [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
            return await chip_smoke.telemetry_phase(cp, intents, plans, "test", "cpu")
        finally:
            await cp.aclose()

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stats = asyncio.run(go())
    finally:
        torch.set_num_threads(n)
    assert stats["captures"] == 0 and stats["families"] == 71
    assert stats["decode_forwards_metric"] == stats["live_forwards"] > 0
    assert stats["worker_profile"]["attributed_frac"] >= 0.95
    assert len(stats["p50_ms_on"]) == len(stats["p50_ms_off"]) == 3
    assert stats["roofline"]["achieved_flops_s"] > 0 and "mfu" not in stats["roofline"]


def test_mixed_spec_and_hetero_phases_run_on_a_cpu_engine():
    """The heterogeneous slab's phases on the CPU at a small size: the mixed
    phase on a serving control plane (both slabs, greedy rows equal), the
    ``/plan`` burst with the heterogeneous slab and speculation (plans equal
    the homogeneous burst's) and the speculation phase (off and on, greedy
    rows equal, the verify path run, the drafted counter equal to
    ``queue_stats``), each gating as on the card."""
    import asyncio
    import random

    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    async def serving():
        cfg = chip_smoke.config("test", chip_smoke.CKPT, 8)
        cfg.engine.warmup_compile = False
        cp = build_control_plane(cfg, device="cpu")
        records = synth_registry(1000, seed=0)
        for rec in records:
            await cp.registry.put(rec)
        await cp.startup()
        await cp.planner.engine.drop_unpinned()
        try:
            rng = random.Random(0)
            intents = [intent_for(records, rng) for _ in range(4)]
            with chip_smoke.one_cohort(cp.planner.engine, len(intents)):
                plans = [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
            return plans, await chip_smoke.mixed_phase(cp, "test", "cpu", n=20)
        finally:
            await cp.aclose()

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plans, mixed = asyncio.run(serving())
        hetero, _ = asyncio.run(
            chip_smoke.serve_hetero("test", chip_smoke.CKPT, 4, "cpu", plans, batch=8, device="cpu")
        )
        spec = asyncio.run(chip_smoke.spec_phase("test", chip_smoke.CKPT, "cpu", 12, batch=8, device="cpu"))
    finally:
        torch.set_num_threads(n)
    assert mixed["differing"] == 0 and mixed["hetero"]["captures"] == mixed["drain"]["captures"] == 0
    assert mixed["hetero"]["live_forwards"] > 0 and mixed["drain"]["decode_tokens"] > 0
    assert hetero["origins"] == {"llm": 4} and hetero["spec_verify"] > 0
    assert spec["differing"] == 0 and spec["on"]["spec_verify"] > 0 and spec["off"]["spec_verify"] == 0
    assert spec["on"]["tokens_per_live_forward"] > spec["off"]["tokens_per_live_forward"]
    assert 0 < spec["on"]["accept_rate"] <= 1


def test_observatory_phase_runs_on_cpu_control_planes():
    """Phase 19 on the CPU at a small size, on a serving control plane and
    on the heterogeneous slab with speculation (through ``serve_hetero``'s
    ``after``): three rounds of off, ledger, flight and all, the parts
    attached live, each gating as on the card (plans equal, nothing
    captured, the bills equal to the ledger and ``/costs`` deltas exactly,
    a valid bundle and explanations); the parts are detached again
    afterwards."""
    import asyncio
    import random

    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    async def serving():
        cfg = chip_smoke.config("test", chip_smoke.CKPT, 8)
        cfg.engine.warmup_compile = False
        cp = build_control_plane(cfg, device="cpu")
        records = synth_registry(1000, seed=0)
        for rec in records:
            await cp.registry.put(rec)
        await cp.startup()
        await cp.planner.engine.drop_unpinned()
        try:
            rng = random.Random(0)
            intents = [intent_for(records, rng) for _ in range(3)]
            with chip_smoke.one_cohort(cp.planner.engine, len(intents)):
                plans = [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
            stats = await chip_smoke.observatory_phase(cp, intents, plans, "test", "cpu")
            parts = (cp.ledger, cp.slo, cp.flight, cp.provenance, cp.config.telemetry.ledger.enabled)
            return plans, stats, parts
        finally:
            await cp.aclose()

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plans, stats, parts = asyncio.run(serving())
        _, spec = asyncio.run(chip_smoke.serve_hetero(
            "test", chip_smoke.CKPT, 3, "cpu", plans, batch=8, device="cpu",
            after=lambda cp, intents, p: chip_smoke.observatory_phase(cp, intents, p, "spec_test", "cpu"),
        ))
    finally:
        torch.set_num_threads(n)
    assert parts == (None, None, None, None, False)
    for st in (stats, spec):
        assert st["captures_on"] == [0] * 9 and len(st["plans_per_s"]["off"]) == 3
        assert set(st["plans_per_s"]) == {"off", "ledger", "flight", "all"} and len(st["decisions"]) == 3
        for c in st["conservation"]:
            assert c["bills"] == c["ledger_totals"] == c["costs"] and c["bills"][0] > 0
        assert st["usage_tenants"] == ["observatory"] and st["usage_requests"] == 6 * 3
        assert st["slo_objectives"] == ["latency_p99", "availability", "plan_quality"]
        assert st["flight_samples"] >= 1 and min(st["decisions"]) > 0
    assert all(ours > 0 and ours == engine for ours, engine in spec["spec_accepted"])


def test_tier_phase_runs_on_a_cpu_engine():
    """The tier phase on the CPU at 16 prompts (the card runs 64): single,
    tiered with its warm restart, thrash against victim and chaos, with
    every gate of the card (greedy round 1 equal across modes and for the
    warm request, a higher tiered hit rate, no destructive eviction in the
    clean run, chaos faults counted, a cheaper warm first request, no
    capture after round 1, empty host tiers after ``aclose``)."""
    import asyncio

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tier = asyncio.run(chip_smoke.tier_phase("test", chip_smoke.CKPT, "cpu", n_prompts=16, device="cpu"))
    finally:
        torch.set_num_threads(n)
    s = tier["summary"]
    assert s["round1_equal"] == {"tiered": True, "chaos": True, "warm": True}
    assert s["restored_runs"] > 0 and s["warm_readmits"] > 0
    assert s["warm_first_prefill_tokens"] < s["cold_first_prefill_tokens"]
    assert tier["tiered"]["spills"] > 0 and tier["tiered"]["readmits"] > 0
    assert tier["tiered"]["destructive_evictions"] == 0 and tier["single"]["evictions"] > 0
    assert tier["thrash"]["victim_token_hit_rate"] > tier["thrash"]["thrash_token_hit_rate"]
    assert tier["chaos"]["chaos_alloc_failures"] > 0
    assert all(tier[m]["captures_per_round"][1:] == [0] * (len(tier[m]["captures_per_round"]) - 1)
               for m in ("single", "tiered", "chaos"))


def test_int8_overload_and_chaos_phases_run_on_cpu_control_planes():
    """The int8, overload and chaos phases on the CPU: ``int8_phase`` at the
    test width (batch 8, four intents) against a bf16 burst of the same
    intents, with the chaos phase (the bench's profile, 160 requests, the
    400 ms deadline) on its control plane; ``overload_phase`` with three
    dozen requests on a serving control plane. Each gates as on the card."""
    import asyncio
    import random
    import time

    from mcpx_torch.models.gemma.params import n_bytes
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    async def bf16_burst():
        cfg = chip_smoke.config("test", chip_smoke.CKPT, 8)
        cfg.engine.warmup_compile = False
        cp = build_control_plane(cfg, device="cpu")
        records = synth_registry(1000, seed=0)
        for rec in records:
            await cp.registry.put(rec)
        await cp.startup()
        engine = cp.planner.engine
        await engine.drop_unpinned()
        try:
            rng = random.Random(0)
            intents = [intent_for(records, rng) for _ in range(4)]
            t0 = time.monotonic()
            with chip_smoke.one_cohort(engine, len(intents)):
                plans = [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
            rate = len(intents) / (time.monotonic() - t0)
            ovl = await chip_smoke.overload_phase(cp, records, "test", "cpu", rate, 36)
            return {"plans": plans, "weight_bytes": n_bytes(engine._params), "max_memory_allocated": None}, ovl
        finally:
            await cp.aclose()

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bf16, ovl = asyncio.run(bf16_burst())
        int8 = asyncio.run(chip_smoke.int8_phase(
            "test", chip_smoke.CKPT, 4, "cpu", bf16, batch=8, device="cpu",
            after=lambda cp: chip_smoke.chaos_phase(cp, "test", "cpu"),
        ))
    finally:
        torch.set_num_threads(n)
    assert ovl["admitted"] + ovl["degraded"] + ovl["shed"] == 36 and ovl["error"] == 0
    assert ovl["shed"] + ovl["degraded"] > 0 and ovl["pins_left"] == 0
    assert int8["weight_bytes"]["int8"] < 0.75 * int8["weight_bytes"]["bf16"]
    assert int8["quantized_param_bytes"]["2b"] < int8["quantized_param_bytes"]["7b"]
    assert int8["live_forwards"] > 0 and int8["origins"].get("llm", 0) > 0
    chaos = int8["after"]
    assert chaos["baseline"]["returned"] == chaos["resilient"]["returned"] == 160
    assert chaos["resilient"]["breaker_transitions"]["open"] >= 1
    assert chaos["resilient"]["hedges"]["launched"] >= 1


def test_config_surface_phases_run_on_cpu_control_planes():
    """Phase 20 at a small size (3,000 services, a table on the CPU from
    1,000 rows, one 4-intent burst at test) and phase 21 at test with random
    weights over 200 services: every gate passes, and the near-tie gate
    refuses a ranking that departs from the host's by more than a tie."""
    import asyncio

    import numpy as np

    runs = asyncio.run(chip_smoke.config_surface(
        "cpu", sizes=(("test", chip_smoke.CKPT, 4),), n=3000, batch=8, device="cpu", threshold=1000,
    ))
    (run,) = runs
    assert run["origins"] == {"llm": 4} and run["services"] == 3000 and not run["unknown_services"]
    assert run["table_bytes"] == 3000 * 256 * 4 and run["repeat_captures"] == 0
    assert run["grammar_builds"] >= 1 and run["repeat_grammar_builds"] == 0
    assert run["shortlist_ms"]["idle"]["device"]["n"] == 64
    sp = asyncio.run(chip_smoke.sp_phase("test", "", 8, "cpu", batch=8, device="cpu", n_services=200))
    assert sp["origins"] == {"llm": 8} and sp["vocab_size"] == 384 and sp["repeat_captures"] == 0

    class Index:
        embedder = type("E", (), {"embed": staticmethod(lambda s: np.ones(2, np.float32))})()
        _table_np = np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 0.0]], np.float32)

        def __init__(self, device_order):
            self.device_order = device_order

        def _device_topk(self, q, k):
            return None, self.device_order

        def _host_order(self, q, k):
            return [0, 1]

    assert chip_smoke.shortlist_agreement(Index([0, 1]), ["a"], 2) == ([], [])
    near, bad = chip_smoke.shortlist_agreement(Index([1, 0]), ["a"], 2)
    assert len(near) == 1 and not bad
    near, bad = chip_smoke.shortlist_agreement(Index([0, 2]), ["a"], 2)
    assert not near and bad[0]["max_gap"] == 1.0


def test_cluster_phase_runs_on_cpu_control_planes():
    """Phase 22 at a small size (the test preset, batch 8, 4 intents): the
    single engine's burst, then the pool's phase against its plans; every
    gate passes (the memory and launch gates read 0 on the CPU)."""
    import asyncio
    import random

    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    async def single(n):
        cp = build_control_plane(chip_smoke.config("test", chip_smoke.CKPT, 8), device="cpu")
        records = synth_registry(1000, seed=0)
        for rec in records:
            await cp.registry.put(rec)
        await cp.startup()
        try:
            rng = random.Random(0)
            served = await chip_smoke.timed_plans(cp, [intent_for(records, rng) for _ in range(n)])
        finally:
            await cp.aclose()
        return dict(plans_per_s=1.0, p50_ms=sorted(ms for _, ms in served)[n // 2]), [p for p, _ in served]

    stats, plans = asyncio.run(single(4))
    run = asyncio.run(chip_smoke.cluster_phase("test", chip_smoke.CKPT, 4, "cpu", stats, plans, batch=8,
                                               device="cpu"))
    assert run["plans_differing_from_single"] == [] and run["resteers"] >= 1
    assert run["generations"] == [1, 1] and run["pins"] == [0, 0] and run["repeat_captures"] == [0, 0]
    assert 0 < run["warm_prefill_tokens"] < run["warm_prompt_tokens"] and run["restored_host_pages"] > 0
    assert {"kill", "resteer", "drain", "rejoin"} <= set(run["journal_counts"])
    assert run["retriever"] == "ShardedRetrievalIndex" and run["shards"] == [500, 500]


def test_offline_phase_runs_on_the_cpu():
    """Phase 23 at a small size on the CPU (48 rows over 120 services, the
    test preset in the big run's place, 2 intents a tier): the corpus, the
    parity run (the CPU against itself), the loss-drop gate, the big run's
    gates and the evaluations at every tier; quality is gated on the card
    only, against the reference's figures at its full protocol."""
    out = chip_smoke.offline_phase("cpu", "cpu", n_examples=48, registry_size=120, parity_steps=2, test_steps=30,
                                   big="test", big_steps=3, eval_intents=2, eval_registry=120, serve_trained=False)
    assert out["train_test"]["final_loss"] < 0.7 * out["train_test"]["first_loss"]
    big = out["train_big"]
    assert big["n_params"] == 672384 and big["flop_per_step"] == 6 * 672384 * 8 * 192 and len(big["losses"]) == 3
    assert set(out["eval_test"]) == set(chip_smoke.EVAL_REFERENCE)
    for tier, q in out["eval_test"].items():
        assert q["n"] == 2 and q["llm_share"] == 1.0 and q["quantize"] == chip_smoke.EVAL_REFERENCE[tier]["quantize"]
        assert q["least_margin"] > 0 and all(t["margin"] < chip_smoke.NEAR_TIE for t in q["near_ties"])


def test_stream_margin_is_masked_margin_at_every_position():
    """``stream_margin``'s one prefill over a whole greedy stream gives, at
    each position, what ``masked_margin``'s prefill of the stream's head
    gives, and ``recording_margins`` puts the engine's method back."""
    import asyncio

    from mcpx_torch.engine.engine import InferenceEngine

    real = InferenceEngine.generate

    async def go():
        engine = InferenceEngine(chip_smoke.config("test", chip_smoke.CKPT, 8), device="cpu")
        await engine.start()
        try:
            prompt = engine.tokenizer.encode("Intent: fetch the user then score it\nJSON:")
            recorded: list = []
            with chip_smoke.recording_margins(recorded):
                res = await engine.generate(prompt)
            assert InferenceEngine.generate is real
            least, at = chip_smoke.stream_margin(engine, prompt, {}, res.token_ids)
            each = [chip_smoke.masked_margin(engine, prompt, {}, res.token_ids, k) for k in range(len(res.token_ids))]
            return recorded, (least, at), each, res
        finally:
            await engine.aclose()

    recorded, (least, at), each, res = asyncio.run(go())
    assert recorded == [(least, at, res.text)]
    assert at == min(range(len(each)), key=each.__getitem__)
    assert abs(least - each[at]) < 1e-4


def test_parallel_phase_runs_on_the_cpu():
    """Phase 24 at a small size on the CPU (``cpu`` coordinates in every
    virtual mesh, the test preset in the big run's place, T 256, 4 intents a
    burst, a 300-service table, 3 training steps at batch 8): every line's
    gates, among them the float32 plans byte for byte against a dense pass
    that rang nowhere, the ring count, and the radix build's ring, on a
    ``seq=4`` mesh and on a ``data=4`` one in float32 (there also against
    the dense pass with the prefill's rows whole)."""
    import asyncio
    import random

    from mcpx_torch.core.config import RetrievalConfig
    from mcpx_torch.registry.memory import InMemoryRegistry
    from mcpx_torch.retrieval.index import RetrievalIndex
    from mcpx_torch.utils.synth import intent_for, synth_registry

    async def table():
        registry, records = InMemoryRegistry(), synth_registry(300, seed=0)
        for rec in records:
            await registry.put(rec)
        index = RetrievalIndex(RetrievalConfig(compute="device"), device="cpu")
        await index.refresh(registry)
        rng = random.Random(0)
        return index, [intent_for(records, rng) for _ in range(8)]

    index, intents = asyncio.run(table())
    out = chip_smoke.parallel_phase("cpu", index, intents, device="cpu", T=256, big="test", n_test=4, n_big=4,
                                    batch=8, n_examples=48, registry_size=120, train_steps=3, train_batch=8)
    assert set(out["ring_attention"]["routes"]) == {"dense", *chip_smoke.RING_MESHES}
    st = out["ring_serve_test"]  # the big run's, at the test preset in bf16 here
    assert st["ring_prefills"] == st["expected_ring_prefills"] > 0 and st["short_rings"] == 0
    assert st["dense_ring_prefills"] == 0 and st["dense_full_prefills"]
    assert not any(ring for _, ring in st["dense_full_prefills"])
    assert st["radix_ring_prefills"] == 1 and st["radix_full_prefills"] == [(st["radix_threshold"], True)]
    assert st["threshold"] > max(w for w, _ in st["short_prefills"]) and st["repeat_captures"] == 0
    assert st["seq_mesh"] == {"data": 1, "seq": 4, "model": 1} and "holds no data" in st["other_device_refused"]
    assert st["row_blocks"] is None and st["whole_full_prefills"] == [] and st["blocking_plans_differing"] == []
    d4 = out["ring_serve_data4_test"]  # the data coordinates viewed as the seq axis
    assert d4["seq_mesh"] == {"data": 1, "seq": 4, "model": 1} and d4["row_blocks"] == 4
    assert d4["ring_prefills"] == d4["expected_ring_prefills"] > 0 and d4["radix_ring_prefills"] == 1
    assert d4["whole_ring_prefills"] == 0 and d4["whole_full_prefills"]
    assert not any(ring for _, ring in d4["whole_full_prefills"] + d4["dense_full_prefills"])
    assert d4["plans_differing"] == d4["blocking_plans_differing"] == [] and d4["repeat_captures"] == 0
    assert out["ring_probe"]["float32_ring_vs_dense"] <= 1e-3
    assert out["ring_probe"]["float32_blocked_vs_dense"] <= 1e-3
    assert out["ring_probe"]["float32_sharded_ring_vs_dense"] <= 1e-3
    assert out["retrieval_mesh"]["shards"] == [150, 150] and not out["retrieval_mesh"]["differing"]
    assert {n: r["shards"] for n, r in out["train_dp_test"]["runs"].items()} == {"none": 1, "data2": 2,
                                                                                 "hybrid2x2x1": 4}


def test_lint_phase_gates_on_new_and_stale_findings(tmp_path, capsys):
    """Phase 25 over a small tree laid out like the repository (its own
    ``mcpx_torch/`` and baseline): clean, then failing on a new finding,
    then on a stale baseline entry once the finding is gone."""
    import json
    import pytest

    pkg = tmp_path / "mcpx_torch"
    (pkg / "analysis").mkdir(parents=True)
    (pkg / "mod.py").write_text("def ok():\n    return 1\n")
    out = chip_smoke.lint_phase("cpu", root=str(tmp_path))
    assert (out["findings"], out["new"], out["stale"], out["files"]) == (0, 0, 0, 1)
    assert len(out["slowest_rules"]) == 5 and out["seconds"] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] == "lint"
    (pkg / "mod.py").write_text("import time\n\n\nasync def f():\n    time.sleep(1)\n")
    with pytest.raises(SystemExit, match="async-blocking"):
        chip_smoke.lint_phase("cpu", root=str(tmp_path))
    (pkg / "analysis" / "baseline.json").write_text(json.dumps({"version": 1, "entries": [
        {"path": "mcpx_torch/mod.py", "line": 5, "rule": "async-blocking", "message": ""},
    ]}))
    assert chip_smoke.lint_phase("cpu", root=str(tmp_path))["baselined"] == 1
    (pkg / "mod.py").write_text("def ok():\n    return 1\n")
    with pytest.raises(SystemExit, match="stale"):
        chip_smoke.lint_phase("cpu", root=str(tmp_path))


def test_tp_phase_runs_on_cpu_engines():
    """Phase 26's ``tp_serve`` at a small size on the CPU (4 intents over
    60 services, batch 8, the committed checkpoint in float32, ``cpu``
    coordinates): the
    meshed arm splits both axes and its weights, its plans equal the
    unmeshed arm's, the launch count each arm expects is ``n_layers`` per
    attention shard and row block, and the repeats capture nothing."""
    import asyncio

    out = asyncio.run(chip_smoke.tp_serve("test", chip_smoke.CKPT, 4, "cpu", batch=8, device="cpu", registry_size=60))
    plain, tp = out["plain"], out["tp"]
    assert tp["mesh"] == {"data": 2, "model": 2} and plain["mesh"] is None
    assert (tp["attention_shards"], tp["row_blocks"]) == (2, 2) and (plain["attention_shards"], plain["row_blocks"]) == (1, 1)
    assert tp["expected_launches_per_forward"] == 2 * 2 * 2 and plain["expected_launches_per_forward"] == 2
    assert set(tp["sharded_leaves"]) == {"embed", "wq", "wo", "w_gate", "w_up", "w_down"}
    assert tp["weight_bytes"] == plain["weight_bytes"] and tp["repeat_captures"] == plain["repeat_captures"] == 0
    for k in ("decode_forwards", "live_forwards", "decode_tokens"):
        assert tp[k] == plain[k], k
