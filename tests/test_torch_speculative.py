"""Grammar-aware speculative decoding in the port, held against the
reference package on the CPU:

  - the speculative stack companions (``stacked_spec_tables``) equal the
    reference's, and the window admissibility (``stacked_window_admissibility``)
    too, on the same states and budgets;
  - the drafter: ``advance_drafter_state`` within 1e-5 in float32 and
    ``draft_window``'s proposals, states and masks exactly, on the same
    numpy inputs made from a seed, in both draft modes; ``accept_rows``
    exactly;
  - sampled rows draw from the exact masked softmax (``sample_rows``, and
    ``sample_window_rows`` through ``accept_rows``), by a chi-square test at
    a false-failure rate of 1e-6, and never draw a masked column;
  - the engine on the committed checkpoint in float32: the greedy rows of
    the reference bench's five-class mix under speculation equal the
    reference's speculative engine's and the port's with speculation off,
    and drafted and accepted counts equal the reference's request by
    request;
  - ports of the reference's speculative tests (``test_speculative.py``):
    the grammar draft mode's exactness (``:159``), constrained rows never
    emit an inadmissible token (``:191``), one window
    key across the grammar mix (``:236``), slot recycling with mixed
    accepted lengths (``:270``), the live flip-off drain (``:308``), and
    speculation without the heterogeneous slab serving the legacy path
    (``:456``);
  - the port's own risks: no blocking tensor method inside a heterogeneous
    or speculative segment (what a CUDA graph captures), the ``K+1`` page
    slack of a row at its budget ceiling, a cancelled row's slot and
    drafter state released, and the first-maximum tie-break shared by the
    vocabulary-space and compact-space greedy picks.
"""

import asyncio
import dataclasses
import os
import random
import time
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.engine import sampling as jsampling
from mcpx.engine import speculative as jspec
from mcpx.engine.engine import InferenceEngine as JEngine
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.models.tokenizer import ByteTokenizer as JByteTokenizer
from mcpx.planner import grammar as jgrammar
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine import sampling, speculative
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.tokenizer import ByteTokenizer
from mcpx_torch.planner import grammar

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)
ENGINE = {
    "max_batch_size": 8, "max_decode_len": 48, "kv_page_size": 16, "max_pages_per_seq": 16,
    "temperature": 0.0, "hetero_batch": True, "speculative": {"enabled": True, "k": 4},
    "use_pallas": False, "data_axis": 1, "model_axis": 1, "warmup_compile": False,
}
CONFIG = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 256, "checkpoint_path": CKPT},
    "engine": ENGINE,
    "tracing": {"enabled": False},
}
HOT, BUDGET, N_MIX = 0.7, 48, 10
ALT_NAMES = ["spec-rank-svc", "spec-sum-svc", "spec-etl-svc"]
# (constrained, temperature, second grammar): the reference bench's
# speculation mix (bench.py::_spec_phase).
CLASSES = [(True, 0.0, False), (True, 0.0, True), (False, 0.0, False), (True, HOT, False), (False, HOT, False)]
GREEDY = [i for i in range(N_MIX) if CLASSES[i % 5][1] <= 0.0]


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def float32(cls):
    return dataclasses.replace(cls.named("test", vocab_size=3072, max_seq_len=256), dtype="float32")


def _ref_counts(eng) -> tuple[int, int]:
    m = eng.metrics
    return (
        int(sum(m.spec_drafted.labels(cls=c)._value.get() for c in ("constrained", "free"))),
        int(sum(m.spec_accepted.labels(cls=c)._value.get() for c in ("constrained", "free"))),
    )


def _port_counts(eng) -> tuple[int, int]:
    q = eng.queue_stats()
    return q["drafted"], q["accepted"]


async def serve(eng, build_plan_grammar, counts) -> dict:
    """First the greedy classes one request at a time, recording the
    drafted and accepted counts each adds; then the five classes
    round-robin, ``N_MIX`` requests sent at once."""
    await eng.start()
    try:
        tok = eng.tokenizer
        alt = build_plan_grammar(tok, ALT_NAMES)

        def one(i):
            constrained, temp, use_alt = CLASSES[i % 5]
            return eng.generate(
                tok.encode(f"spec intent {i}: compose the services. JSON:"), max_new_tokens=BUDGET,
                constrained=constrained, temperature=temp, grammar=alt if use_alt else None,
            )

        steps = []
        for i in GREEDY[:3]:
            before = counts(eng)
            ids = (await one(100 + i)).token_ids
            steps.append((ids, tuple(b - a for a, b in zip(before, counts(eng)))))
        out = await asyncio.gather(*(one(i) for i in range(N_MIX)))
        return {"steps": steps, "ids": [r.token_ids for r in out], "texts": [r.text for r in out], "alt": alt}
    finally:
        await eng.aclose()


@pytest.fixture(scope="module")
def runs():
    ref = asyncio.run(serve(
        JEngine(JConfig.from_dict(CONFIG), model_cfg=float32(JGemmaConfig)), jgrammar.build_plan_grammar, _ref_counts
    ))
    port = asyncio.run(serve(
        InferenceEngine(MCPXConfig.from_dict(CONFIG), model_cfg=float32(GemmaConfig), device="cpu"),
        grammar.build_plan_grammar, _port_counts,
    ))
    off = MCPXConfig.from_dict(CONFIG)
    off.engine.speculative.enabled = False
    port_off = asyncio.run(serve(
        InferenceEngine(off, model_cfg=float32(GemmaConfig), device="cpu"), grammar.build_plan_grammar, _port_counts
    ))
    return ref, port, port_off


@pytest.mark.parametrize("i", GREEDY)
def test_greedy_rows_under_speculation_equal_the_reference_and_speculation_off(runs, i):
    ref, port, off = runs
    assert port["ids"][i] == ref["ids"][i], (port["texts"][i], ref["texts"][i])
    assert port["ids"][i] == off["ids"][i]
    assert port["ids"][i]


def test_drafted_and_accepted_counts_equal_the_reference_request_by_request(runs):
    ref, port, off = runs
    assert [ids for ids, _ in port["steps"]] == [ids for ids, _ in ref["steps"]]
    assert [n for _, n in port["steps"]] == [n for _, n in ref["steps"]]
    assert all(dr > 0 and 0 < ac <= dr for _, (dr, ac) in port["steps"]), port["steps"]
    assert all(n == (0, 0) for _, n in off["steps"])


def test_constrained_rows_of_the_mix_walk_their_grammar(runs):
    _, port, _ = runs
    generic = grammar.build_plan_grammar(port["alt"].tokenizer)
    for i, text in enumerate(port["texts"]):
        constrained, _temp, use_alt = CLASSES[i % 5]
        if constrained:
            g = port["alt"] if use_alt else generic
            assert g.walk(text) != g.dead_state, (i, text)


# ------------------------------------------------------------ tables and drafter
def _slots(tok_cls, mod):
    tok = tok_cls()
    rng = random.Random(7)
    names1 = sorted({f"svc-{rng.randrange(100):02d}" for _ in range(3)})
    names2 = sorted({f"rank-{rng.choice(['etl', 'ml'])}" for _ in range(2)})
    slots = [mod.build_trivial_grammar(tok), mod.build_plan_grammar(tok, names1), mod.build_plan_grammar(tok, names2)]
    return slots, names1, names2


@pytest.mark.parametrize("pad", [64, 512])
def test_stacked_spec_tables_equal_the_reference(pad):
    ref = jgrammar.stacked_spec_tables(_slots(JByteTokenizer, jgrammar)[0], pad)
    port = grammar.stacked_spec_tables(_slots(ByteTokenizer, grammar)[0], pad)
    for a, b in zip(ref, port):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


K, H = 4, 16


def _draft_inputs():
    """The reference test's rows (``test_speculative.py:350``): two grammars
    at several cuts of a plan, and a free row; a seeded embedding."""
    slots, names1, names2 = _slots(ByteTokenizer, grammar)
    tok = ByteTokenizer()
    rows = []  # (slot, DFA state, emitted, constrained)
    for gi, name in ((1, names1[0]), (2, names2[0])):
        plan = '{"steps":[{"s":"%s","in":[],"next":[]}]}' % name
        for cut in (0, 1, 8, 12, 14, len(plan) - 4):
            st = slots[gi].walk(plan[:cut])
            assert st != slots[gi].dead_state
            rows.append((gi, st, cut, True))
    rows.append((0, slots[0].start_state, 5, False))
    nprng = np.random.default_rng(7)
    B = len(rows)
    inputs = dict(
        dfa_id=np.asarray([r[0] for r in rows], np.int64),
        st=np.asarray([r[1] for r in rows], np.int64),
        emitted=np.asarray([r[2] for r in rows], np.int64),
        cons=np.asarray([r[3] for r in rows], bool),
        embed=nprng.normal(size=(tok.vocab_size, H)).astype(np.float32),
        cur=np.full((B,), tok.encode("{")[0], np.int64),
        hstate=nprng.normal(size=(B, H)).astype(np.float32),
    )
    free = np.ones((tok.vocab_size,), bool)
    free[[tok.eos_id, tok.pad_id]] = False
    inputs["free_mask"] = free
    return slots, inputs, tok


@pytest.mark.parametrize("slack,mode", [(48, "recurrent"), (6, "recurrent"), (48, "grammar")])
def test_draft_window_equals_the_reference(slack, mode):
    slots, x, tok = _draft_inputs()
    jslots = _slots(JByteTokenizer, jgrammar)[0]
    strans, smask, sdist, sactive, seos = jgrammar.stacked_tables(jslots, 512)
    sdist_succ, _ = jgrammar.stacked_spec_tables(jslots, 512)
    budgets = x["emitted"] + slack
    done = np.zeros_like(x["cons"])
    ref = jspec.draft_window(
        jnp.asarray(x["embed"]), tuple(jnp.asarray(t) for t in (strans, smask, sdist_succ, sactive, seos)),
        jnp.asarray(x["dfa_id"], jnp.int32), jnp.asarray(x["st"], jnp.int32), jnp.asarray(x["cur"], jnp.int32),
        jnp.asarray(x["hstate"]), jnp.asarray(x["emitted"], jnp.int32), jnp.asarray(budgets, jnp.int32),
        jnp.asarray(done), jnp.asarray(x["cons"]), jnp.asarray(x["free_mask"]), tok.pad_id, k=K, mode=mode,
    )
    ptrans, pmask, pdist, pactive, peos = grammar.stacked_tables(slots, 512)
    pdist_succ, _ = grammar.stacked_spec_tables(slots, 512)
    t = torch.from_numpy
    port = speculative.draft_window(
        t(x["embed"]), (t(ptrans), t(pmask), t(pdist_succ), t(pactive).long(), t(peos)),
        t(x["dfa_id"]), t(x["st"]), t(x["cur"]), t(x["hstate"]), t(x["emitted"]), t(budgets),
        t(done), t(x["cons"]), t(x["free_mask"]), tok.pad_id, k=K, mode=mode,
    )
    for name, a, b in zip(("p_toks", "p_use", "s_before", "s_fin", "masks"), ref, port):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert np.asarray(ref[1]).sum() > len(budgets)  # chains formed: not a vacuous pass
    # The walk's masks are the window admissibility at every position
    # verification can consume (its unbroken proposal prefix).
    states = torch.cat([port[2], port[3][:, None]], dim=1)
    rem = t(budgets)[:, None] - (t(x["emitted"])[:, None] + torch.arange(K + 1)[None, :]) - 1
    want = grammar.stacked_window_admissibility(
        (t(ptrans), t(pmask), t(pdist), t(pactive), t(peos)), t(x["dfa_id"]), states, rem
    )
    jwant = jgrammar.stacked_window_admissibility(
        tuple(jnp.asarray(a) for a in (strans, smask, sdist, sactive, seos)),
        jnp.asarray(x["dfa_id"], jnp.int32), jnp.asarray(states.numpy(), jnp.int32),
        jnp.asarray(rem.numpy(), jnp.int32),
    )
    np.testing.assert_array_equal(np.asarray(jwant), want.numpy())
    prefix = torch.cumprod(port[1].long(), 1).bool()  # the unbroken proposal prefix
    valid = torch.cat([torch.ones((len(budgets), 1), dtype=torch.bool), prefix], 1)
    assert torch.equal(port[4][valid], want[valid])


def test_advance_drafter_state_equals_the_reference():
    rng = np.random.default_rng(3)
    B, W, V = 9, K + 1, 256
    h = rng.normal(size=(B, H)).astype(np.float32)
    embed = rng.normal(size=(V, H)).astype(np.float32)
    window = rng.integers(0, V, size=(B, W))
    n = rng.integers(1, W + 1, size=(B,))
    ref = jspec.advance_drafter_state(
        jnp.asarray(h), jnp.asarray(embed), jnp.asarray(window, jnp.int32), jnp.asarray(n, jnp.int32)
    )
    t = torch.from_numpy
    port = speculative.advance_drafter_state(t(h), t(embed), t(window), t(n))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_accept_rows_equals_the_reference():
    rng = np.random.default_rng(5)
    samples = rng.integers(0, 3, size=(64, K))
    proposals = rng.integers(0, 3, size=(64, K))
    valid = rng.random((64, K)) < 0.8
    ja, jn = jsampling.accept_rows(jnp.asarray(samples), jnp.asarray(proposals), jnp.asarray(valid))
    pa, pn = sampling.accept_rows(torch.from_numpy(samples), torch.from_numpy(proposals), torch.from_numpy(valid))
    np.testing.assert_array_equal(np.asarray(ja), pa.numpy())
    np.testing.assert_array_equal(np.asarray(jn), pn.numpy())


# ------------------------------------------------------------ sampled rows
N_DRAWS, TEMPERATURE, FALSE_FAILURE = 20000, 0.7, 1e-6
# Fixed logits: the two largest masked (a draw of them would show); at
# T = 0.7 the least likely kept column expects several hundred draws.
LOGITS = np.array([3.0, 2.5, 0.0, 0.4, 0.8, -0.3, 0.6, 1.0, -5.0, 0.2], np.float32)
MASK = np.array([0, 0, 1, 1, 1, 1, 1, 1, 0, 1], bool)


def _softmax() -> np.ndarray:
    z = np.where(MASK, LOGITS.astype(np.float64), -np.inf) / TEMPERATURE
    p = np.exp(z - z.max())
    return p / p.sum()


def _chi2_ok(ids: np.ndarray) -> None:
    p = _softmax()
    counts = np.bincount(ids, minlength=LOGITS.size)
    assert counts[p == 0].sum() == 0, counts  # never a masked column
    support = p > 0
    expected = counts.sum() * p[support]
    assert expected.min() >= 50
    chi2 = float(((counts[support] - expected) ** 2 / expected).sum())
    assert chi2 < stats.chi2.ppf(1.0 - FALSE_FAILURE, df=int(support.sum()) - 1), (chi2, counts, p)


def test_sample_rows_draws_follow_the_masked_softmax():
    logits = torch.from_numpy(np.tile(LOGITS, (N_DRAWS, 1)))
    temps = torch.full((N_DRAWS,), TEMPERATURE)
    ids = sampling.sample_rows(
        logits, torch.Generator().manual_seed(11), temps, mask=torch.from_numpy(MASK)
    )
    _chi2_ok(ids.numpy())
    # Greedy rows of the same call take the masked argmax.
    temps[::2] = 0.0
    mixed = sampling.sample_rows(logits, torch.Generator().manual_seed(11), temps, mask=torch.from_numpy(MASK))
    assert bool((mixed[::2] == int(np.argmax(np.where(MASK, LOGITS, -np.inf)))).all())


def test_window_samples_and_accepted_corrections_follow_the_masked_softmax():
    """A one-draft window [B, 2, V] with the same logits at both positions
    and the draft ``x``: the first emitted token (the draft when accepted,
    else the correction at position 0) and, after an accepted draft, the
    correction at position 1 each follow the masked softmax."""
    gen = torch.Generator().manual_seed(13)
    logits = torch.from_numpy(np.tile(LOGITS, (N_DRAWS, 2, 1)))
    temps = torch.full((N_DRAWS,), TEMPERATURE)
    gumbel = -torch.log(sampling.exponential_noise(logits.shape, gen, "cpu"))
    tok_w = sampling.sample_window_rows(logits, temps, mask=torch.from_numpy(MASK), gumbel=gumbel)
    x = 7  # the most likely kept column: accepted often
    acc, a = sampling.accept_rows(tok_w[:, :1], torch.full((N_DRAWS, 1), x), torch.ones((N_DRAWS, 1), dtype=torch.bool))
    first = torch.where(acc[:, 0], x, tok_w[:, 0])
    _chi2_ok(first.numpy())
    after = tok_w[acc[:, 0], 1]
    assert after.numel() > N_DRAWS // 5
    _chi2_ok(after.numpy())
    greedy = sampling.sample_window_rows(logits[:4], torch.zeros(4), mask=torch.from_numpy(MASK), gumbel=gumbel[:4])
    assert bool((greedy == int(np.argmax(np.where(MASK, LOGITS, -np.inf)))).all())


# ------------------------------------------------------------ engine tests
def make_engine(**engine):
    """The reference speculative tests' geometry: the `test` preset with
    random weights, the byte vocab, greedy."""
    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 256},
        "engine": {
            "max_batch_size": 4, "max_decode_len": 96, "kv_page_size": 16, "max_pages_per_seq": 16,
            "temperature": 0.0, **engine,
        },
    })
    return InferenceEngine(cfg, device="cpu")


def spec_engine(**spec):
    return make_engine(hetero_batch=True, speculative={"enabled": True, "k": 4, **spec})


def window_keys(eng) -> list:
    return [s["signature"] for s in eng.costs.snapshot()["executables"].get("window", {}).get("signatures", [])]


def test_grammar_draft_mode_is_exact():
    """``draft="grammar"`` (forced successors only, no drafter scoring) is
    exact under greedy decode, accepts every draft it makes (a forced draft
    verifies with certainty), and still takes fewer live forwards than it
    emits tokens."""

    async def go():
        off, on = make_engine(hetero_batch=True), spec_engine(draft="grammar")
        await off.start()
        await on.start()
        try:
            p = off.tokenizer.encode("plan: compose. JSON:")
            a = await off.generate(p, max_new_tokens=48)
            b = await on.generate(p, max_new_tokens=48)
            assert a.text == b.text
            q = on.queue_stats()
            assert q["drafted"] > 0 and q["accepted"] == q["drafted"]
            assert q["live_forwards"] < q["decode_tokens"]
            assert "'grammar'" in window_keys(on)[0]
        finally:
            await off.aclose()
            await on.aclose()

    asyncio.run(go())


def test_constrained_rows_never_emit_inadmissible():
    """Over seeded grammars and temperatures, a constrained row under
    speculation emits only a legal prefix of its grammar."""

    async def go():
        eng = spec_engine()
        await eng.start()
        try:
            tok = eng.tokenizer
            for seed in range(4):
                rng = random.Random(seed)
                names = [
                    f"{rng.choice(['data', 'rank', 'sum'])}-{rng.choice(['etl', 'ml', 'api'])}-"
                    f"{rng.randrange(100):02d}"
                    for _ in range(rng.randrange(2, 6))
                ]
                g = grammar.build_plan_grammar(tok, sorted(set(names)))
                results = await asyncio.gather(*(
                    eng.generate(
                        tok.encode(f"seeded plan {seed}-{i}. JSON:"),
                        max_new_tokens=rng.choice([g.min_len, 24, 48]), temperature=t, grammar=g,
                    )
                    for i, t in enumerate([0.0, 0.9, 0.0, 1.3])
                ))
                for r in results:
                    assert g.walk(r.text) != g.dead_state, (seed, r.text)
            assert eng.queue_stats()["drafted"] > 0
            await eng.drop_unpinned()
            assert eng._allocator.stats().sequences == 0
            eng._allocator.check_invariants()
        finally:
            await eng.aclose()

    asyncio.run(go())


def test_one_window_key_across_the_grammar_mix():
    """The fixed [B, K+1] window: one speculative key serves every grammar,
    accept pattern, temperature and constrained/free mix."""

    async def go():
        eng = spec_engine()
        await eng.start()
        try:
            tok = eng.tokenizer
            p = tok.encode("plan: compose. JSON:")
            await eng.generate(p, max_new_tokens=24)
            keys = window_keys(eng)
            assert len(keys) == 1 and "'spec'" in keys[0], keys
            g1 = grammar.build_plan_grammar(tok, ["svc-a", "svc-b"])
            g2 = grammar.build_plan_grammar(tok, ["other-x", "other-y"])
            await asyncio.gather(
                eng.generate(p, max_new_tokens=24, grammar=g1),
                eng.generate(p, max_new_tokens=24, grammar=g2, temperature=0.7),
                eng.generate(tok.encode("free"), max_new_tokens=8, constrained=False),
            )
            assert window_keys(eng) == keys
            assert eng.kernel_paths()["paths"]["spec_verify"]["dispatches"] == eng.queue_stats()["spec_verify"] > 0
        finally:
            await eng.aclose()

    asyncio.run(go())


def test_slot_recycle_with_mixed_accepted_lengths():
    """Rows retiring with different accepted lengths (two grammars through
    two slots, a free row, a hot row) release their slots, drafter state
    and pages, and the overflow grammar defers, then completes."""

    async def go():
        eng = make_engine(hetero_batch=True, hetero_grammar_slots=2, speculative={"enabled": True, "k": 4})
        await eng.start()
        try:
            tok = eng.tokenizer
            p = tok.encode("plan: q. JSON:")
            g1 = grammar.build_plan_grammar(tok, ["aaa-svc"])
            g2 = grammar.build_plan_grammar(tok, ["bbb-svc-with-a-much-longer-name"])
            r1, r2, _r3, r4 = await asyncio.gather(
                eng.generate(p, max_new_tokens=32, grammar=g1),
                eng.generate(p, max_new_tokens=64, grammar=g2),
                eng.generate(tok.encode("free"), max_new_tokens=8, constrained=False),
                eng.generate(p, max_new_tokens=24, temperature=0.9),
            )
            assert '"s":"aaa-svc"' in r1.text
            assert '"s":"bbb-svc-with-a-much-longer-name"' in r2.text
            assert eng.grammar.walk(r4.text) != eng.grammar.dead_state
            assert eng.queue_stats()["resident_grammars"] == 0
            assert all(n == 0 for n in eng._dfa_slot_refs)
            assert not bool(eng._slab.dev["hstate"].any())
            await eng.drop_unpinned()
            assert eng._allocator.stats().sequences == 0
            eng._allocator.check_invariants()
        finally:
            await eng.aclose()

    asyncio.run(go())


def test_live_flip_off_drains_under_the_latched_window():
    """A live ``speculative.enabled`` flip-off while speculative rows are
    resident: they finish under the latched window (no new window key while
    they drain), the request arriving meanwhile waits for the drain and is
    served by the heterogeneous window, and every output is legal."""

    async def go():
        eng = spec_engine()
        await eng.start()
        try:
            tok = eng.tokenizer
            p = tok.encode("plan: compose. JSON:")
            await eng.generate(p, max_new_tokens=24)
            keys = window_keys(eng)

            async def flip_then_request():
                await asyncio.sleep(0.05)  # lands while rows are resident
                eng.config.engine.speculative.enabled = False
                assert eng._slab.spec
                return await eng.generate(p, max_new_tokens=24)

            r1, r2 = await asyncio.gather(eng.generate(p, max_new_tokens=96), flip_then_request())
            r3 = await eng.generate(p, max_new_tokens=24)
            for r in (r1, r2, r3):
                assert eng.grammar.walk(r.text) != eng.grammar.dead_state
            new = window_keys(eng)[len(keys):]
            assert new and all("'hetero'" in k for k in new), new
            assert not eng._slab.spec and eng._slab.n_active == 0
        finally:
            await eng.aclose()

    asyncio.run(go())


def test_speculation_without_hetero_serves_the_legacy_path(caplog):
    async def go():
        eng = make_engine(speculative={"enabled": True, "k": 4})
        await eng.start()
        try:
            res = await eng.generate(eng.tokenizer.encode("plan: compose. JSON:"), max_new_tokens=24)
            assert eng.grammar.walk(res.text) != eng.grammar.dead_state
            q = eng.queue_stats()
            assert q["spec_verify"] == 0 and q["spec_accept_rate"] == 0.0
            assert eng.metrics.spec_drafted.labels(cls="constrained").value == 0
            assert eng.kernel_paths()["paths"]["spec_verify"]["dispatches"] == 0
        finally:
            await eng.aclose()

    with caplog.at_level("WARNING", logger="mcpx_torch.engine"):
        asyncio.run(go())
    assert any("without hetero_batch" in r.getMessage() for r in caplog.records)


BLOCKING = ("__bool__", "__int__", "__float__", "item", "tolist", "cpu", "numpy")


@pytest.mark.parametrize("spec", [False, True], ids=["hetero", "speculative"])
def test_no_blocking_tensor_method_inside_a_segment(monkeypatch, spec):
    """With the tensor methods that wait for the device patched to raise
    inside ``_dispatch_segment``, a heterogeneous mix (a new grammar in a
    slot, a sampled row, a free row) completes in both windows: what a
    CUDA graph captures has no host synchronisation."""
    eng = spec_engine() if spec else make_engine(hetero_batch=True)
    inside = {"on": False}
    real_dispatch = eng._dispatch_segment

    def dispatch(slab):
        inside["on"] = True
        try:
            real_dispatch(slab)
        finally:
            inside["on"] = False

    monkeypatch.setattr(eng, "_dispatch_segment", dispatch)
    for name in BLOCKING:
        real = getattr(torch.Tensor, name)

        def guarded(self, *args, _real=real, _name=name, **kwargs):
            if inside["on"]:
                raise AssertionError(f"Tensor.{_name} inside a segment")
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, guarded)

    async def go():
        await eng.start()
        try:
            tok = eng.tokenizer
            g = grammar.build_plan_grammar(tok, ["svc-a", "svc-b"])
            out = await asyncio.gather(
                eng.generate(tok.encode("plan: a. JSON:"), max_new_tokens=32, grammar=g),
                eng.generate(tok.encode("plan: b. JSON:"), max_new_tokens=32, temperature=0.8),
                eng.generate(tok.encode("free"), max_new_tokens=8, constrained=False),
            )
            assert all(r.generated_tokens > 0 for r in out)
            assert (eng.queue_stats()["spec_verify"] > 0) == spec
        finally:
            await eng.aclose()

    asyncio.run(go())


def _until_done(eng, loop, reqs) -> None:
    """Run segments by hand until every request's future is done."""
    while not all(r.future.done() for r in reqs):
        eng._dispatch_segment(eng._slab)
        eng._harvest(eng._slab, keep_inflight=0)
        loop.run_until_complete(asyncio.sleep(0))


def _req(loop, prompt, budget, grammar=None):
    from mcpx_torch.engine.engine import GenerateRequest

    return GenerateRequest(
        prompt_ids=prompt, max_new_tokens=budget, constrained=True, temperature=0.0,
        future=loop.create_future(), loop=loop, enqueued_at=time.monotonic(), grammar=grammar,
    )


def test_rows_reserve_the_verify_window_slack_at_the_budget_ceiling():
    """A row admitted under speculation (k 4) at its budget ceiling (a
    64-token row capacity, the longest prompt it leaves room for beside a
    48-token budget) holds pages for its prompt, its budget and the K+1
    window: the last verify window's rejected positions land in its own
    pages, never past its table. Its greedy output equals speculation
    off's, which reserves the fast-forward window's slack instead."""
    texts = {}
    for spec in (True, False):
        eng = make_engine(
            hetero_batch=True, speculative={"enabled": spec, "k": 4}, max_decode_len=48,
            max_pages_per_seq=4, prefix_cache=False, speculate_k=5,
        )
        loop = asyncio.new_event_loop()
        try:
            with torch.inference_mode():
                eng._setup()
                prompt = eng.tokenizer.encode("a long prompt that fills the row's pages: compose. JSON:")
                r = _req(loop, prompt, 48)
                eng._admit(eng._slab, deque([r]))
                pages = eng._allocator.pages_of(eng._slab.sid[0])
                kept = 64 - 48 - 5  # capacity - budget - slack (K+1 = 5, or the chunk 5)
                assert len(pages) * 16 == 64 >= kept + 48 + 5
                assert bool((eng._slab.dev["page_table"][0] > 0).all())
                assert int(eng._slab.dev["budgets"][0]) == 48
                _until_done(eng, loop, [r])
                texts[spec] = r.future.result().token_ids
                assert eng.grammar.walk(eng.tokenizer.decode(texts[spec])) != eng.grammar.dead_state
                eng._shutdown(eng._slab, deque())
        finally:
            loop.close()
    assert texts[True] == texts[False] and len(texts[True]) > 8


def test_a_cancelled_speculative_row_frees_its_slot_and_drafter_state():
    """A speculative row cancelled mid-decode is reaped: its slot reference
    drops (the next grammar takes the only slot at once, without waiting
    for ``fairness_timeout_s``), its drafter state is zero, and the next
    request's output equals its output on a fresh engine."""
    loop = asyncio.new_event_loop()
    try:
        with torch.inference_mode():
            outs = []
            for fresh in (False, True):
                eng = make_engine(hetero_batch=True, hetero_grammar_slots=2, speculative={"enabled": True, "k": 4})
                eng._setup()
                tok = eng.tokenizer
                p = tok.encode("plan: q. JSON:")
                g1 = grammar.build_plan_grammar(tok, ["aaa-svc"])
                g2 = grammar.build_plan_grammar(tok, ["bbb-svc"])
                if not fresh:
                    first = _req(loop, p, 96, g1)
                    eng._admit(eng._slab, deque([first]))
                    eng._dispatch_segment(eng._slab)
                    eng._harvest(eng._slab, keep_inflight=0)
                    assert bool(eng._slab.dev["hstate"][0].any()) and eng._dfa_slot_refs == [0, 1]
                    first.future.cancel()
                    eng._reap_cancelled(eng._slab)
                    assert eng._dfa_slot_refs == [0, 0] and not bool(eng._slab.dev["hstate"].any())
                second = _req(loop, p, 32, g2)
                eng._admit(eng._slab, deque([second]))
                _until_done(eng, loop, [second])
                assert eng._dfa_slots[1] is g2 and eng._dfa_slot_refs == [0, 0]
                outs.append(second.future.result().token_ids)
                eng._shutdown(eng._slab, deque())
            assert outs[0] == outs[1]
            assert '"s":"bbb-svc"' in tok.decode(outs[0])
    finally:
        loop.close()


def test_argmax_breaks_ties_at_the_first_maximum_in_both_column_spaces():
    """Vocabulary-space and compact-space greedy picks agree on a tie:
    ``active_ids`` strictly increase, and both argmaxes take the first
    maximum."""
    V = 3072
    logits = torch.zeros((4, V))
    logits[:, [7, 11, 2900]] = 5.0  # a three-way tie
    active = torch.tensor([2, 7, 11, 20, 2900])
    mask = torch.zeros((V,), dtype=torch.bool)
    mask[active] = True
    temps = torch.zeros(4)
    vocab = sampling.sample_rows(logits, None, temps, mask=mask)
    compact = active[sampling.sample_rows(logits[:, active], None, temps)]
    window = sampling.sample_window_rows(logits[:, None, :], temps, mask=mask, gumbel=torch.zeros((4, 1, V)))
    assert vocab.tolist() == compact.tolist() == window[:, 0].tolist() == [7] * 4
