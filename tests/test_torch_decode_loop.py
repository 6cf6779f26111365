"""The reference's default decode loop in the port: prompt drafting verified
against a compact unembed, and pipelined segments.

  - the slice as a whole: greedy ``/plan`` at the reference's defaults
    (``draft_mode="prompt"``, ``pipeline_depth=2``, prefix cache on) gives
    byte-identical plans in both packages, on the committed checkpoint;
  - drafting does real work, step for step: on a stream whose admission
    does not depend on timing (one cohort submitted at once, then one
    request alone) at depth 1, the port's ``live_forwards`` equals the
    reference's forward count with drafting off and on, drafting takes
    fewer forwards, and the port accepts drafted tokens;
  - ports of the reference engine's draft and pipelining tests;
  - the generation guard, shutdown with a segment in flight, no blocking
    tensor method inside a segment, and the options the port refuses (and
    the heterogeneous slab and speculation, which it now serves).
"""

import asyncio
import os
import random
import threading
import time
from collections import deque

import pytest
import torch

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.errors import EngineError
from mcpx_torch.engine.engine import GenerateRequest, InferenceEngine
from mcpx_torch.planner.grammar import build_plan_grammar
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.utils.synth import synth_registry

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)
N_SERVICES, N_INTENTS = 200, 8
# The reference's defaults for the decode loop (drafting, depth 2, prefix
# cache), at the parity set's geometry; the reference on one device and its
# jnp attention, as in the other parity tests.
CONFIG = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": CKPT},
    "engine": {
        "max_batch_size": 16, "max_decode_len": 64, "kv_page_size": 64, "max_pages_per_seq": 4,
        "temperature": 0.0, "speculate_k": 8, "draft_mode": "prompt", "pipeline_depth": 2,
        "prefix_cache": True, "use_pallas": False, "data_axis": 1, "model_axis": 1,
    },
    "planner": {"kind": "llm"},
    "tracing": {"enabled": False},
}
COHORT = 4


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The port's CPU forwards are a few small ops each; with one intra-op
    thread they take a third of the time they take with eight (and far less
    beside other test workers). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


async def _run(cp, records, intents, forwards):
    """Serve the intents through ``/plan`` at the defaults, recording the
    planner's calls into the engine; then, at depth 1, for draft off and on
    (each from an empty tree), the step-for-step stream: COHORT of those
    calls (sorted by prompt, so both packages take the same ones) submitted
    at once, then the first of them alone, whose page-aligned head now
    matches the tree (a suffix prefill: drafting from the suffix). Returns
    (plans, {mode: (texts, counter deltas)})."""
    for rec in records:
        await cp.registry.put(rec)
    await cp.startup()
    eng = cp.planner.engine
    ecfg = eng.config.engine
    calls = {}
    real_generate = eng.generate

    async def recording(prompt_ids, **kw):
        if kw.get("max_new_tokens", 0) != 1:  # not the planner's warm-up
            calls[tuple(prompt_ids)] = kw
        return await real_generate(prompt_ids, **kw)

    eng.generate = recording
    try:
        plans = [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
        eng.generate = real_generate
        stream = sorted(calls.items())[:COHORT]
        gen = lambda call: eng.generate(list(call[0]), **call[1])  # noqa: E731
        ecfg.pipeline_depth = 1
        steps = {}
        for mode in ("off", "prompt"):
            ecfg.draft_mode = mode
            cap = ecfg.prefix_cache_entries
            ecfg.prefix_cache_entries = 0  # an empty tree for each mode
            eng._evict_prefixes()
            ecfg.prefix_cache_entries = cap
            before = forwards(eng)
            texts = [r.text for r in await asyncio.gather(*(gen(c) for c in stream))]
            texts.append((await gen(stream[0])).text)
            after = forwards(eng)
            steps[mode] = (texts, {k: after[k] - before[k] for k in after})
        return plans, steps
    finally:
        await eng.aclose()


@pytest.fixture(scope="module")
def runs():
    records = jsynth(N_SERVICES, seed=0)
    rng = random.Random(0)
    intents = [intent_for(records, rng) for _ in range(N_INTENTS)]
    ref = asyncio.run(_run(
        jbuild(JConfig.from_dict(CONFIG)), records, intents,
        lambda e: {"forwards": e.metrics.decode_forwards._value.get()},
    ))
    port = asyncio.run(_run(
        build_control_plane(MCPXConfig.from_dict(CONFIG), device="cpu"),
        synth_registry(N_SERVICES, seed=0), intents,
        lambda e: {k: e.queue_stats()[k] for k in ("live_forwards", "decode_forwards", "accepted", "drafted")},
    ))
    return intents, ref, port


@pytest.mark.parametrize("i", range(N_INTENTS))
def test_plans_at_reference_defaults_are_byte_identical(runs, i):
    intents, (ref_plans, _), (port_plans, _) = runs
    assert ref_plans[i].origin == "llm", intents[i]
    assert port_plans[i].to_json() == ref_plans[i].to_json(), intents[i]


@pytest.mark.parametrize("mode", ["off", "prompt"])
def test_live_forwards_equal_the_reference_forward_count(runs, mode):
    _, (_, ref_steps), (_, port_steps) = runs
    ref_texts, ref_n = ref_steps[mode]
    texts, n = port_steps[mode]
    assert texts == ref_texts
    assert n["live_forwards"] == ref_n["forwards"], (n, ref_n)
    # The one-forward-late exit dispatches at most one idle forward a
    # segment beyond the live ones.
    assert n["live_forwards"] <= n["decode_forwards"]


def test_drafting_takes_fewer_forwards_and_accepts_tokens(runs):
    _, (_, ref_steps), (_, port_steps) = runs
    off, on = port_steps["off"][1], port_steps["prompt"][1]
    assert on["live_forwards"] < off["live_forwards"], (off, on)
    assert ref_steps["prompt"][1]["forwards"] < ref_steps["off"][1]["forwards"]
    assert on["accepted"] > 0 and on["drafted"] >= on["accepted"]
    assert off["drafted"] == off["accepted"] == 0


# ------------------------------------------------ the reference's engine tests
def make_engine(**engine):
    """The reference engine tests' geometry: the `test` preset with random
    weights, the byte vocab, greedy."""
    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 256},
        "engine": {
            "max_batch_size": 4, "max_decode_len": 96, "kv_page_size": 16,
            "max_pages_per_seq": 16, "temperature": 0.0, **engine,
        },
    })
    return InferenceEngine(cfg, device="cpu")


async def assert_no_leak(eng) -> None:
    await eng.drop_unpinned()
    eng._prefix_cache.check_invariants()
    stats = eng._allocator.stats()
    assert stats.sequences == 0
    eng._allocator.check_invariants()


def test_draft_speculation_matches_ff_only():
    """Drafting is exact under greedy decode: with a trie grammar whose names
    appear verbatim in the prompt, output is identical with drafts on and
    off, and drafts never cost extra live forwards."""
    names = [f"svc-alpha-{i:02d}" for i in range(6)] + ["metric-rank-00"]

    async def go():
        eng_ff = make_engine(speculate_k=8, draft_mode="off")
        eng_dr = make_engine(speculate_k=8, draft_mode="prompt")
        await eng_ff.start()
        await eng_dr.start()
        try:
            g_ff = build_plan_grammar(eng_ff.tokenizer, names)
            g_dr = build_plan_grammar(eng_dr.tokenizer, names)
            prompt = eng_ff.tokenizer.encode("services: " + " ".join(names) + "\nIntent: rank alpha\nJSON:")
            tokens = {"ff": 0, "dr": 0}
            for budget in (24, 64, 96):
                r_ff = await eng_ff.generate(prompt, max_new_tokens=budget, grammar=g_ff)
                r_dr = await eng_dr.generate(prompt, max_new_tokens=budget, grammar=g_dr)
                assert r_dr.text == r_ff.text, (budget, r_dr.text, r_ff.text)
                tokens["ff"] += r_ff.generated_tokens
                tokens["dr"] += r_dr.generated_tokens
            assert tokens["dr"] == tokens["ff"]
            f_ff, f_dr = eng_ff.queue_stats()["live_forwards"], eng_dr.queue_stats()["live_forwards"]
            assert f_dr <= f_ff, f"drafts cost extra forwards: {f_dr} vs {f_ff}"
        finally:
            await eng_ff.aclose()
            await eng_dr.aclose()

    asyncio.run(go())


def test_draft_speculation_accepts_through_branch_points():
    """A two-name trie branches where only the short name can still finish
    within budget, so the budget-masked greedy pick at the branch is forced
    whatever the weights. Fast-forward cannot force that position (two
    legal columns); the draft, proposed from the prompt's example, is
    accepted there. Same output, strictly fewer forwards."""
    names = ["aa", "a" + "b" * 40]

    async def go():
        eng_ff = make_engine(speculate_k=8, draft_mode="off")
        eng_dr = make_engine(speculate_k=8, draft_mode="prompt")
        await eng_ff.start()
        await eng_dr.start()
        try:
            g_ff = build_plan_grammar(eng_ff.tokenizer, names)
            g_dr = build_plan_grammar(eng_dr.tokenizer, names)
            prompt = eng_ff.tokenizer.encode('Example:{"steps":[{"s":"aa","in":["k"],"next":[]}]} JSON:')
            budget = int(g_ff.dist[g_ff.start_state]) + 6  # fewest tokens of a plan, + 6
            for _ in range(2):
                r_ff = await eng_ff.generate(prompt, max_new_tokens=budget, grammar=g_ff)
                r_dr = await eng_dr.generate(prompt, max_new_tokens=budget, grammar=g_dr)
                assert r_dr.text == r_ff.text, (r_dr.text, r_ff.text)
                assert '"s":"aa"' in r_dr.text
            q_ff, q_dr = eng_ff.queue_stats(), eng_dr.queue_stats()
            assert q_dr["live_forwards"] < q_ff["live_forwards"], (q_dr, q_ff)
            assert q_dr["accepted"] > 0
        finally:
            await eng_ff.aclose()
            await eng_dr.aclose()

    asyncio.run(go())


def test_draft_speculation_concurrent_rows_allocator_clean():
    """Drafted decode with several concurrent rows (staggered admissions,
    different emitted offsets, per-row prompt buffers) stays legal and
    leaks no pages."""

    async def go():
        eng = make_engine(speculate_k=8, draft_mode="prompt")
        await eng.start()
        try:
            prompts = [eng.tokenizer.encode(f"intent {i}: compose services. JSON:") for i in range(6)]
            results = await asyncio.gather(*(eng.generate(p, max_new_tokens=32) for p in prompts))
            for r in results:
                assert eng.grammar.walk(r.text) != eng.grammar.dead_state
            await assert_no_leak(eng)
        finally:
            await eng.aclose()

    asyncio.run(go())


def test_pipeline_depths_agree():
    """Staggered greedy generations give identical output at pipeline depths
    1, 2 and 3 (flags read up to three segments late, retirement through
    the generation guard), and no page or prefix leaks at any depth."""

    async def run(depth: int):
        eng = make_engine(pipeline_depth=depth, decode_steps_per_tick=1)
        await eng.start()
        try:
            tok = eng.tokenizer
            prompts = [tok.encode(f"intent number {i}: compose services. JSON:") for i in range(5)]
            tasks = []
            for i, p in enumerate(prompts):
                tasks.append(asyncio.create_task(eng.generate(p, max_new_tokens=24 + 8 * (i % 3))))
                await asyncio.sleep(0.03 * (i % 2))
            results = await asyncio.gather(*tasks)
            await assert_no_leak(eng)
            return [r.text for r in results]
        finally:
            await eng.aclose()

    async def go():
        texts = [await run(depth) for depth in (1, 2, 3)]
        assert texts[0] == texts[1] == texts[2], texts
        assert all(texts[0])

    asyncio.run(go())


# ------------------------------------------------ pipelining, driven by hand
def _request(eng, loop, prompt, budget):
    return GenerateRequest(
        prompt_ids=prompt, max_new_tokens=budget, constrained=True, temperature=0.0,
        future=loop.create_future(), loop=loop, enqueued_at=time.monotonic(),
    )


def test_generation_guard_keeps_a_lagged_flag_off_the_next_request():
    """Row 0's request finishes inside a segment that is still in flight; the
    client cancels it, the row is reaped and re-admitted with a new request
    before that segment is harvested. The old segment's done flag must not
    retire the new request; the new request then completes with the text it
    gives alone."""
    eng = make_engine(pipeline_depth=2, draft_mode="prompt")
    loop = asyncio.new_event_loop()
    tok = eng.tokenizer
    p_a, p_b = tok.encode("first intent. JSON:"), tok.encode("second, other intent. JSON:")
    try:
        with torch.inference_mode():
            eng._setup()
            slab = eng._slab
            solo = _request(eng, loop, p_b, 24)
            eng._admit(slab, deque([solo]))
            while not solo.future.done():
                eng._dispatch_segment(slab)
                eng._harvest(slab, keep_inflight=0)
                loop.run_until_complete(asyncio.sleep(0))
            want = solo.future.result().text

            a = _request(eng, loop, p_a, 12)
            eng._admit(slab, deque([a]))
            assert slab.req[0] is a
            eng._dispatch_segment(slab)  # a finishes in here (16 forwards)
            a.future.cancel()
            eng._reap_cancelled(slab)
            b = _request(eng, loop, p_b, 24)
            eng._admit(slab, deque([b]))
            assert slab.req[0] is b
            eng._harvest(slab, keep_inflight=0)  # the segment of a: done[0] is set
            loop.run_until_complete(asyncio.sleep(0))
            assert slab.req[0] is b and not b.future.done()
            while not b.future.done():
                eng._dispatch_segment(slab)
                eng._harvest(slab, keep_inflight=1)
                loop.run_until_complete(asyncio.sleep(0))
            assert b.future.result().text == want
            loop.run_until_complete(assert_no_leak(eng))
    finally:
        loop.close()


def test_shutdown_resolves_a_request_whose_segment_is_in_flight():
    eng = make_engine(pipeline_depth=2)
    loop = asyncio.new_event_loop()
    tok = eng.tokenizer
    try:
        with torch.inference_mode():
            eng._setup()
            slab = eng._slab
            short = _request(eng, loop, tok.encode("short one. JSON:"), 8)
            long = _request(eng, loop, tok.encode("long one. JSON:"), 96)
            eng._admit(slab, deque([short, long]))
            eng._dispatch_segment(slab)  # 16 forwards: short ends, long does not
            assert eng._inflight and not short.future.done()
            eng._shutdown(slab, deque())
            loop.run_until_complete(asyncio.sleep(0))
            assert short.future.result().generated_tokens > 0
            with pytest.raises(EngineError, match="engine closed"):
                long.future.result()
            assert not eng._inflight and slab.n_active == 0
    finally:
        loop.close()


BLOCKING = ("__bool__", "__int__", "__float__", "item", "tolist", "cpu", "numpy")


def test_no_blocking_tensor_method_inside_a_segment(monkeypatch):
    """With the tensor methods that wait for the device patched to raise on
    the worker thread while it is inside ``_dispatch_segment``, requests
    complete with drafting on and off; the harvest may use them. Inside a
    segment is the window loop: every window runs in it (on CUDA as a
    replay of the captured window, here as the same function eagerly), up
    to ``steps_per_dispatch`` a segment."""
    eng = make_engine(pipeline_depth=2, draft_mode="prompt")
    inside = threading.local()
    calls = {"segments": 0, "windows": 0, "outside": 0}
    real_dispatch = eng._dispatch_segment
    real_run_window = eng._run_window

    def dispatch(slab):
        inside.on = True
        try:
            real_dispatch(slab)
            calls["segments"] += 1
        finally:
            inside.on = False

    def run_window(slab, key, dfa):
        calls["windows" if getattr(inside, "on", False) else "outside"] += 1
        real_run_window(slab, key, dfa)

    monkeypatch.setattr(eng, "_dispatch_segment", dispatch)
    monkeypatch.setattr(eng, "_run_window", run_window)
    for name in BLOCKING:
        real = getattr(torch.Tensor, name)

        def guarded(self, *args, _real=real, _name=name, **kwargs):
            if getattr(inside, "on", False):
                raise AssertionError(f"Tensor.{_name} inside a segment")
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, guarded)

    async def go():
        await eng.start()
        try:
            tok = eng.tokenizer
            for mode in ("prompt", "off"):
                eng.config.engine.draft_mode = mode
                prompts = [tok.encode(f"intent {i} {mode}: compose. JSON:") for i in range(3)]
                results = await asyncio.gather(*(eng.generate(p, max_new_tokens=40) for p in prompts))
                assert all(r.generated_tokens > 0 for r in results)
        finally:
            await eng.aclose()

    asyncio.run(go())
    assert calls["segments"] > 0 and calls["outside"] == 0
    # A segment may run no window: its early exit can read a flag that a
    # window of the segment before it set.
    assert 0 < calls["windows"] <= calls["segments"] * eng.config.engine.steps_per_dispatch
    assert eng.queue_stats()["windows"] == calls["windows"]


@pytest.mark.parametrize(
    "section,key,value",
    [
        ("engine", "hetero_batch", True),
        ("engine", "speculative", {"enabled": True}),
        ("engine", "kv_tier", {"enabled": True}),
        ("engine", "ring_prefill_min_tokens", 512),
        ("model", "quantize", "int8"),
        (None, None, None),
    ],
    ids=["hetero_batch", "speculative", "kv_tier", "ring_prefill", "int8", "defaults"],
)
def test_options_the_port_does_not_serve_are_refused(section, key, value):
    """The options the port does not serve yet are refused by name; the
    heterogeneous slab and speculative decoding are served (speculation on
    the heterogeneous slab, where its drafter has the stacked grammars), and
    so are the tiered KV cache (its spill tier and governor under the tree),
    weight-only int8 (an int8 tree after start-up,
    ``tests/test_torch_quant.py``) and ring prefill (on a virtual mesh the
    data coordinates become the seq view; ``tests/test_torch_ring_routing.py``
    serves it)."""
    cfg = {"model": {"size": "test", "max_seq_len": 256}, "engine": {}}
    if section is None:
        assert InferenceEngine(MCPXConfig.from_dict(cfg), device="cpu").config.engine.draft_mode == "prompt"
        return
    cfg[section][key] = value
    if key in ("hetero_batch", "speculative"):
        cfg["engine"]["hetero_batch"] = True
        eng = InferenceEngine(MCPXConfig.from_dict(cfg), device="cpu")
        assert eng.config.engine.hetero_batch
        assert eng._spec_k() == (eng.config.engine.speculative.k if key == "speculative" else 0)
        return
    if key == "quantize":
        eng = InferenceEngine(MCPXConfig.from_dict(cfg), device="cpu")
        assert eng._quantized and eng.config.model.quantize == "int8"
        return
    if key == "ring_prefill_min_tokens":
        from mcpx_torch.parallel.mesh import make_mesh

        eng = InferenceEngine(MCPXConfig.from_dict(cfg), device="cpu", mesh=make_mesh(data=2, devices=["cpu"] * 2))
        eng._setup()
        assert eng._seq_mesh.shape == {"data": 1, "seq": 2, "model": 1}
        assert eng._ring_ok(512) and not eng._ring_ok(256)
        return
    if key == "kv_tier":
        eng = InferenceEngine(MCPXConfig.from_dict(cfg), device="cpu")
        assert eng._prefix_cache.spill is eng._spill_tier is not None
        assert eng._prefix_cache.governor is eng._governor is not None
        return
    with pytest.raises(EngineError, match=key):
        InferenceEngine(MCPXConfig.from_dict(cfg), device="cpu")
