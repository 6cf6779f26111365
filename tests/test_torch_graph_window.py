"""The decode window as one function over fixed slab state, held against
the reference package on the CPU, where the same function runs eagerly
(on CUDA it is captured once per key and replayed):

  - the slice as a whole: greedy ``/plan`` at the reference's defaults on
    the committed checkpoint, two registries with different shortlists
    served one after the other (a grammar swap in one table bucket), gives
    byte-identical plans in both packages; the port's ``live_forwards``
    equals the reference's forward count step for step; every window of
    the run has one key;
  - the slab state and the grammar tables keep their storage across
    segments, admissions, releases and grammar swaps, and a swap leaves the
    tables equal to the reference's padded tables;
  - grammars of one pad bucket share a window key, another bucket or
    temperature makes a new one;
  - a segment runs at most ``2 * decode_steps_per_tick - 1`` forwards in
    which every row is idle;
  - the sampler's draw is ``torch.multinomial``'s on the same generator
    state, and replays add their captured launches to the kernel counts.
"""

import asyncio
import os
import random
import time
from collections import deque

import numpy as np
import pytest
import torch

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine import sampling
from mcpx_torch.engine.engine import GenerateRequest, InferenceEngine
from mcpx_torch.engine.kernels import paged_attention as tk
from mcpx_torch.planner.grammar import build_plan_grammar
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.utils.synth import synth_registry

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)
N_SERVICES, N_INTENTS, COHORT = 200, 4, 4
# The reference's defaults for the decode loop at the parity set's
# geometry; the reference on one device and its jnp attention.
CONFIG = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": CKPT},
    "engine": {
        "max_batch_size": 16, "max_decode_len": 64, "kv_page_size": 64, "max_pages_per_seq": 4,
        "temperature": 0.0, "speculate_k": 8, "use_pallas": False, "data_axis": 1, "model_axis": 1,
    },
    "planner": {"kind": "llm"},
    "tracing": {"enabled": False},
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


async def _serve(cp, halves, forwards, keys=None):
    """Serve N_INTENTS intents of each registry half, one half after the
    other (the first half's services deleted before the second's are put),
    recording the planner's engine calls; then, at depth 1, COHORT of the
    second half's calls submitted at once and the first of them alone.
    Returns (plans, texts of the stream, forward-counter deltas)."""
    for rec in halves[0]:
        await cp.registry.put(rec)
    await cp.startup()
    eng = cp.planner.engine
    if keys is not None:
        real_run = eng._run_window

        def run(slab, key, dfa):
            keys.add(key)
            real_run(slab, key, dfa)

        eng._run_window = run
    calls = {}
    real_generate = eng.generate

    async def recording(prompt_ids, **kw):
        if kw.get("max_new_tokens", 0) != 1:
            calls[tuple(prompt_ids)] = kw
        return await real_generate(prompt_ids, **kw)

    eng.generate = recording
    try:
        plans = []
        for h, records in enumerate(halves):
            if h:
                for rec in halves[h - 1]:
                    await cp.registry.delete(rec.name)
                for rec in records:
                    await cp.registry.put(rec)
                calls.clear()
            # Seeds whose plans hold no bf16 near-tie between the two
            # frameworks (Random(0) gives two, with margins under 0.05).
            rng = random.Random(10 + h)
            intents = [intent_for(records, rng) for _ in range(N_INTENTS)]
            plans += [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
        eng.generate = real_generate
        stream = sorted(calls.items())[:COHORT]
        gen = lambda call: eng.generate(list(call[0]), **call[1])  # noqa: E731
        eng.config.engine.pipeline_depth = 1
        before = forwards(eng)
        texts = [r.text for r in await asyncio.gather(*(gen(c) for c in stream))]
        texts.append((await gen(stream[0])).text)
        after = forwards(eng)
        return plans, texts, {k: after[k] - before[k] for k in after}
    finally:
        await eng.aclose()


@pytest.fixture(scope="module")
def runs():
    records = jsynth(N_SERVICES, seed=0)
    jhalves = [records[: N_SERVICES // 2], records[N_SERVICES // 2 :]]
    port_records = synth_registry(N_SERVICES, seed=0)
    halves = [port_records[: N_SERVICES // 2], port_records[N_SERVICES // 2 :]]
    ref = asyncio.run(_serve(
        jbuild(JConfig.from_dict(CONFIG)), jhalves,
        lambda e: {"forwards": e.metrics.decode_forwards._value.get()},
    ))
    keys: set = set()
    port = asyncio.run(_serve(
        build_control_plane(MCPXConfig.from_dict(CONFIG), device="cpu"), halves,
        lambda e: {k: e.queue_stats()[k] for k in ("live_forwards", "decode_forwards", "windows", "segments")},
        keys,
    ))
    return ref, port, keys


@pytest.mark.parametrize("i", range(2 * N_INTENTS))
def test_plans_across_two_registries_are_byte_identical(runs, i):
    (ref_plans, _, _), (port_plans, _, _), _ = runs
    assert ref_plans[i].origin == "llm"
    assert port_plans[i].to_json() == ref_plans[i].to_json()


def test_live_forwards_equal_the_reference_forward_count(runs):
    (_, ref_texts, ref_n), (_, texts, n), _ = runs
    assert texts == ref_texts
    assert n["live_forwards"] == ref_n["forwards"], (n, ref_n)
    tick = MCPXConfig().engine.decode_steps_per_tick
    assert n["decode_forwards"] == n["windows"] * tick
    assert n["live_forwards"] <= n["decode_forwards"] <= n["live_forwards"] + (2 * tick - 1) * n["segments"]


def test_every_grammar_of_the_run_shares_one_window_key(runs):
    _, _, keys = runs
    assert len(keys) == 1, keys
    (key,) = keys
    assert key[:4] == ("draft", ("greedy",), 8, 16)


# ------------------------------------------------ the engine driven by hand
def make_engine(**engine):
    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 256},
        "engine": {
            "max_batch_size": 4, "max_decode_len": 64, "kv_page_size": 16,
            "max_pages_per_seq": 16, "temperature": 0.0, **engine,
        },
    })
    return InferenceEngine(cfg, device="cpu")


def _request(loop, prompt, budget, grammar=None):
    return GenerateRequest(
        prompt_ids=prompt, max_new_tokens=budget, constrained=True, temperature=0.0,
        future=loop.create_future(), loop=loop, enqueued_at=time.monotonic(), grammar=grammar,
    )


def _drain(eng, loop, reqs, keep_inflight=0):
    """Dispatch and harvest until every request resolves; returns per
    segment (forwards dispatched, live forwards) when ``keep_inflight`` is 0."""
    slab = eng._slab
    per_segment = []
    while not all(r.future.done() for r in reqs):
        s0 = dict(eng._stats)
        eng._dispatch_segment(slab)
        eng._harvest(slab, keep_inflight=keep_inflight)
        loop.run_until_complete(asyncio.sleep(0))
        per_segment.append(tuple(eng._stats[k] - s0[k] for k in ("decode_forwards", "live_forwards")))
    eng._harvest(slab, keep_inflight=0)
    return per_segment


def _storage(eng) -> dict:
    ptrs = {f"slab.{k}": t.data_ptr() for k, t in eng._slab.dev.items()}
    for bucket, tables in eng._tables.items():
        ptrs.update({f"{bucket}.{i}": t.data_ptr() for i, t in enumerate(tables.dfa)})
    ptrs.update({f"kv.{k}": t.data_ptr() for k, t in eng._paged_kv.items()})
    return ptrs


def test_slab_state_and_grammar_tables_keep_their_storage():
    """Segments, admissions, releases and a grammar swap write the slab's
    buffers and the bucket's tables in place; after each swap the tables
    hold exactly the reference's padded tables of the new grammar (the
    rows a larger grammar wrote before are padding again)."""
    eng = make_engine()
    loop = asyncio.new_event_loop()
    tok = eng.tokenizer
    big = build_plan_grammar(tok, [f"svc-{c}{i:02d}" for c in "abcdefgh" for i in range(6)])
    small = build_plan_grammar(tok, ["aa", "bb"])
    pad = eng._grammar_pad()
    assert big.n_states > small.n_states
    try:
        with torch.inference_mode():
            eng._setup()
            slab = eng._slab
            prompt = tok.encode("services: aa bb\nIntent: rank\nJSON:")
            first, seen = None, 0
            for g in (None, big, small, big):
                reqs = [_request(loop, prompt, 24, g), _request(loop, tok.encode("other. JSON:"), 12, g)]
                eng._admit(slab, deque(reqs))
                first = first or _storage(eng)
                _drain(eng, loop, reqs, keep_inflight=1)
                now = _storage(eng)
                assert {k: now[k] for k in first} == first
                assert len(eng._tables) == 1
                (tables,) = eng._tables.values()
                grammar = g or eng.grammar
                assert tables.grammar is grammar
                # Rows no grammar has written yet are never indexed; every
                # row some grammar wrote is the new grammar's or padding.
                seen = max(seen, grammar.n_states)
                for got, ref in zip(tables.dfa, grammar.device_tables(pad)):
                    got = got.numpy()
                    if got.ndim and got.shape[0] == pad:
                        got, ref = got[:seen], ref[:seen]
                    np.testing.assert_array_equal(got, ref)
                assert all(r.future.result().generated_tokens > 0 for r in reqs)
    finally:
        loop.close()


def test_one_pad_bucket_shares_a_window_key():
    """Two grammars whose padded tables have one shape map to one key; a
    grammar in a larger state bucket, or a sampled slab, makes another."""
    eng = make_engine(grammar_state_budget=64)
    tok = eng.tokenizer
    g1 = build_plan_grammar(tok, ["alpha-01", "beta-02"])
    g2 = build_plan_grammar(tok, ["gamma-03", "delta-04"])
    g3 = build_plan_grammar(tok, [f"svc-{c}{i:02d}" for c in "abcdefgh" for i in range(6)])
    assert -(-g1.n_states // 64) == -(-g2.n_states // 64) < -(-g3.n_states // 64)
    with torch.inference_mode():
        eng._setup()
        slab = eng._slab

        def key(grammar, temperature=0.0):
            slab.grammar, slab.temperature = grammar, temperature
            return eng._window_plan(slab)[0]

        k1, k2, k3 = key(g1), key(g2), key(g3)
        assert k1 == k2
        assert k3 != k1 and k3[4][0] > k1[4][0] and k3[:4] == k1[:4]
        sampled = key(g1, 0.7)
        assert sampled[0] == "fast" and sampled[1] == ("sampled", 0.7, 0) and sampled[4] == k1[4]
        assert key(g2, 0.7) == sampled
        # One set of buffers a bucket: the grammars of the first share it.
        assert len(eng._tables) == 2


@pytest.mark.parametrize("tick", [1, 4])
def test_idle_forwards_a_segment_stay_within_the_bound(tick):
    """Staggered budgets, drafting on: every segment runs at most
    ``2 * tick - 1`` forwards in which every row is idle, the live count
    never exceeds what was dispatched, and with windows wider than one
    forward some segment does run idle forwards (the bound is reached for,
    not vacuous)."""
    eng = make_engine(decode_steps_per_tick=tick, steps_per_dispatch=4)
    loop = asyncio.new_event_loop()
    tok = eng.tokenizer
    try:
        with torch.inference_mode():
            eng._setup()
            idle = []
            for rnd in range(3):
                reqs = [
                    _request(loop, tok.encode(f"intent {rnd} {i}: compose. JSON:"), 9 + 7 * i + rnd)
                    for i in range(3)
                ]
                eng._admit(eng._slab, deque(reqs))
                for fwd, live in _drain(eng, loop, reqs):
                    assert fwd % tick == 0 and fwd <= 4 * tick
                    assert 0 <= fwd - live <= 2 * tick - 1, (fwd, live)
                    idle.append(fwd - live)
            assert eng._stats["decode_forwards"] == eng._stats["windows"] * tick
            if tick > 1:
                assert max(idle) > 0
    finally:
        loop.close()


# ------------------------------------------------ sampling and launch counts
@pytest.mark.parametrize("seed", range(4))
def test_sampled_draw_is_multinomials_on_the_same_generator(seed):
    """The sampler's exponential-noise argmax gives ``torch.multinomial``'s
    draw from the same generator state (its one-sample path, without the
    host-side check that would stop a CUDA graph capture)."""
    npr = np.random.default_rng(seed)
    logits = torch.from_numpy(npr.standard_normal((8, 600)).astype(np.float32))
    mask = torch.from_numpy(npr.random((8, 600)) < 0.6)
    g1 = torch.Generator().manual_seed(seed)
    g2 = torch.Generator().manual_seed(seed)
    got = sampling.sample(logits, g1, temperature=0.8, top_k=50, mask=mask)
    masked = torch.where(mask, logits, torch.full_like(logits, sampling.NEG_INF)) / 0.8
    kth = torch.topk(masked, 50, dim=-1).values[..., -1:]
    masked = torch.where(masked < kth, torch.full_like(masked, sampling.NEG_INF), masked)
    want = torch.multinomial(torch.softmax(masked, dim=-1), 1, generator=g2).squeeze(-1)
    assert torch.equal(got, want)
    assert bool(mask[torch.arange(8), got].all())


def test_replays_add_their_captured_launches():
    """A call made under capture counts in CAPTURED, not LAUNCHES; each
    replay adds what its capture recorded."""
    before, cap = tk.kernel_launches(), tk.captured_launches()
    try:
        tk.count_replay({"ragged_paged_attention": 18})
        tk.count_replay({"ragged_paged_attention": 18})
        assert tk.kernel_launches()["ragged_paged_attention"] == before["ragged_paged_attention"] + 36
        assert tk.captured_launches() == cap
    finally:
        tk.LAUNCHES.update(before)
    assert tk.ticket_count(64, 8, 1, 8) == 64 and tk.ticket_count(16, 128, 1, 4) == 16 * 8
