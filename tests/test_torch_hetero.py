"""The heterogeneous slab in the port, held against the reference package on
the CPU:

  - the stacked grammar tables (``build_trivial_grammar``,
    ``stacked_tables``) equal the reference's array for array, and the
    engine's fixed stack holds them after slots change owner;
  - the reference bench's five-class mix (``bench.py::_mixed_phase``:
    constrained greedy, free at 0.7, a second grammar greedy, constrained
    at 0.7, free greedy) on the committed checkpoint in float32: the greedy
    rows are byte-identical to the reference's heterogeneous engine and to
    the port's own homogeneous slab, and every constrained row walks its
    grammar;
  - ports of the reference engine's heterogeneous tests: one window key
    across a grammar and sampling mix (``test_engine.py:806``, on the CPU
    the window's first eager runs stand for captures) and slot recycling
    with a deferred grammar (``:841``).

The reference runs on one device with its jnp attention, one engine for the
module, and without warm-up compiles.
"""

import asyncio
import dataclasses
import os

import numpy as np
import pytest
import torch

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.engine.engine import InferenceEngine as JEngine
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.models.tokenizer import ByteTokenizer as JByteTokenizer
from mcpx.planner import grammar as jgrammar
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.tokenizer import ByteTokenizer
from mcpx_torch.planner import grammar

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)
ENGINE = {
    "max_batch_size": 8, "max_decode_len": 48, "kv_page_size": 16, "max_pages_per_seq": 16,
    "temperature": 0.0, "hetero_batch": True, "use_pallas": False, "data_axis": 1, "model_axis": 1,
    "warmup_compile": False,
}
CONFIG = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 256, "checkpoint_path": CKPT},
    "engine": ENGINE,
    "tracing": {"enabled": False},
}
HOT, BUDGET, N_MIX = 0.7, 24, 10
ALT_NAMES = ["mixed-rank-svc", "mixed-sum-svc", "mixed-etl-svc"]
# (constrained, temperature, second grammar): the reference bench's mix.
CLASSES = [(True, 0.0, False), (False, HOT, False), (True, 0.0, True), (True, HOT, False), (False, 0.0, False)]
GREEDY = [i for i in range(N_MIX) if CLASSES[i % 5][1] <= 0.0]


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def float32(cls):
    return dataclasses.replace(cls.named("test", vocab_size=3072, max_seq_len=256), dtype="float32")


async def serve_mix(eng, build_plan_grammar) -> tuple[list, list, object]:
    """The five classes round-robin, ``N_MIX`` requests sent at once.
    Returns (token ids, texts, the second grammar)."""
    await eng.start()
    try:
        tok = eng.tokenizer
        alt = build_plan_grammar(tok, ALT_NAMES)

        def one(i):
            constrained, temp, use_alt = CLASSES[i % 5]
            return eng.generate(
                tok.encode(f"mixed intent {i}: compose the services. JSON:"), max_new_tokens=BUDGET,
                constrained=constrained, temperature=temp, grammar=alt if use_alt else None,
            )

        out = await asyncio.gather(*(one(i) for i in range(N_MIX)))
        return [r.token_ids for r in out], [r.text for r in out], alt
    finally:
        await eng.aclose()


@pytest.fixture(scope="module")
def mixes():
    ref = asyncio.run(serve_mix(
        JEngine(JConfig.from_dict(CONFIG), model_cfg=float32(JGemmaConfig)), jgrammar.build_plan_grammar
    ))
    cfg = MCPXConfig.from_dict(CONFIG)
    port = asyncio.run(serve_mix(
        InferenceEngine(cfg, model_cfg=float32(GemmaConfig), device="cpu"), grammar.build_plan_grammar
    ))
    homo = MCPXConfig.from_dict(CONFIG)
    homo.engine.hetero_batch = False
    port_homo = asyncio.run(serve_mix(
        InferenceEngine(homo, model_cfg=float32(GemmaConfig), device="cpu"), grammar.build_plan_grammar
    ))
    return ref, port, port_homo


@pytest.mark.parametrize("i", GREEDY)
def test_greedy_rows_of_the_mix_equal_the_reference_and_the_homogeneous_slab(mixes, i):
    (ref_ids, ref_texts, _), (ids, texts, _), (homo_ids, _, _) = mixes
    assert ids[i] == ref_ids[i], (texts[i], ref_texts[i])
    assert ids[i] == homo_ids[i]
    assert ids[i], "an empty greedy row proves nothing"


def test_constrained_rows_of_the_mix_walk_their_grammar(mixes):
    _, (_, texts, alt), _ = mixes
    tok_grammar = grammar.build_plan_grammar(alt.tokenizer)
    for i, text in enumerate(texts):
        constrained, _temp, use_alt = CLASSES[i % 5]
        if constrained:
            g = alt if use_alt else tok_grammar
            assert g.walk(text) != g.dead_state, (i, text)


# ------------------------------------------------------------ stacked tables
def _grammars(tok_cls, mod):
    tok = tok_cls()
    return [
        mod.build_trivial_grammar(tok),
        mod.build_plan_grammar(tok),
        mod.build_plan_grammar(tok, ["svc-a", "svc-b", "rank-c"]),
        mod.build_plan_grammar(tok, ["a" + "b" * 40, "aa"]),
    ]


@pytest.mark.parametrize("pad", [64, 512])
def test_stacked_tables_equal_the_reference(pad):
    ref = jgrammar.stacked_tables(_grammars(JByteTokenizer, jgrammar), pad)
    port = grammar.stacked_tables(_grammars(ByteTokenizer, grammar), pad)
    assert len(ref) == len(port) == 5
    for a, b in zip(ref, port):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_trivial_grammar_equals_the_reference():
    ref, port = jgrammar.build_trivial_grammar(JByteTokenizer()), grammar.build_trivial_grammar(ByteTokenizer())
    for name in ("ctrans", "cmask", "dist", "active_ids", "eos_cols", "byte_transitions"):
        np.testing.assert_array_equal(getattr(ref, name), getattr(port, name))
    assert (ref.cdead, ref.start_state, ref.dead_state, ref.accept_states) == (
        port.cdead, port.start_state, port.dead_state, port.accept_states
    )
    assert port.walk("anything at all") in port.accept_states
    plan = grammar.build_plan_grammar(ByteTokenizer())
    assert plan.min_len == jgrammar.build_plan_grammar(JByteTokenizer()).min_len > 1


# ------------------------------------------------------------ engine tests
def make_engine(**engine):
    """The reference engine tests' geometry: the `test` preset with random
    weights, the byte vocab, greedy, the heterogeneous slab."""
    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 256},
        "engine": {
            "max_batch_size": 4, "max_decode_len": 96, "kv_page_size": 16, "max_pages_per_seq": 16,
            "temperature": 0.0, "hetero_batch": True, **engine,
        },
    })
    return InferenceEngine(cfg, device="cpu")


def window_keys(eng) -> list:
    return [s["signature"] for s in eng.costs.snapshot()["executables"].get("window", {}).get("signatures", [])]


def test_one_window_key_across_the_grammar_and_sampling_mix():
    """After the first heterogeneous window, new grammars, a free row and a
    second temperature add no window key: temperature and the constrained
    flag are per-row data and grammars are stacked table data."""

    async def go():
        eng = make_engine()
        await eng.start()
        try:
            tok = eng.tokenizer
            p = tok.encode("plan: compose. JSON:")
            await eng.generate(p, max_new_tokens=24)
            keys = window_keys(eng)
            assert len(keys) == 1 and "'hetero'" in keys[0], keys
            g1 = grammar.build_plan_grammar(tok, ["svc-a", "svc-b"])
            g2 = grammar.build_plan_grammar(tok, ["other-x", "other-y"])
            out = await asyncio.gather(
                eng.generate(p, max_new_tokens=24, grammar=g1),
                eng.generate(p, max_new_tokens=24, grammar=g2, temperature=0.7),
                eng.generate(tok.encode("free"), max_new_tokens=8, constrained=False),
            )
            assert g1.walk(out[0].text) != g1.dead_state
            assert g2.walk(out[1].text) != g2.dead_state
            assert window_keys(eng) == keys
        finally:
            await eng.aclose()

    asyncio.run(go())


def test_grammar_slots_recycle_and_defer():
    """More distinct grammars than slots (two slots: the trivial one and one
    constrained grammar at a time): the second grammar waits until the
    first drains, then admits and completes; slot references return to
    0, the stack's slot 1 holds the last grammar, and nothing leaks."""

    async def go():
        eng = make_engine(hetero_grammar_slots=2)
        await eng.start()
        try:
            tok = eng.tokenizer
            p = tok.encode("plan: q. JSON:")
            g1 = grammar.build_plan_grammar(tok, ["aaa-svc"])
            g2 = grammar.build_plan_grammar(tok, ["bbb-svc"])
            r1, r2 = await asyncio.gather(
                eng.generate(p, max_new_tokens=32, grammar=g1),
                eng.generate(p, max_new_tokens=32, grammar=g2),
            )
            assert '"s":"aaa-svc"' in r1.text
            assert '"s":"bbb-svc"' in r2.text
            assert eng.queue_stats()["resident_grammars"] == 0
            assert eng._dfa_slot_refs == [0, 0]
            assert eng._dfa_slots[1] is g2
            (stack,) = eng._stacks.values()
            assert stack.grammars == [eng._trivial_grammar, g2]
            want = grammar.stacked_tables([eng._trivial_grammar, g2], eng._grammar_pad())
            for got, ref in zip(stack.dfa, want):
                assert torch.equal(got.cpu(), torch.from_numpy(ref).to(got.dtype))
            await eng.drop_unpinned()
            assert eng._allocator.stats().sequences == 0
            eng._allocator.check_invariants()
        finally:
            await eng.aclose()

    asyncio.run(go())
