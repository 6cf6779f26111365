"""The slice as a whole with the radix prefix cache on, as the reference's
default config runs it: the port's engine and control plane against the
reference package's, both with ``engine.prefix_cache: true`` (the reference
on its jnp attention and one device), on the committed checkpoint.

  - a sequential repeat stream through ``generate``: identical texts,
    identical hits, matched and prefilled tokens, and warm text equal to
    cold text (the reference's own engine test asserts the last);
  - a concurrent repeat-heavy ``/plan`` stream: byte-identical plans;
  - the page layout of a suffix window: pad slots never write a tree page;
  - a failed admission prefill fails its requests, drops the tree and
    leaves the page allocator whole, and the engine serves on.
"""

import asyncio
import os
import random
import time

import pytest
import torch

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.engine.engine import InferenceEngine as JEngine
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.engine.prefix_cache import RadixPrefixCache
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.utils.synth import synth_registry

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)
# Small pages so that short prompts share whole pages; the reference's own
# engine test of the prefix cache uses the same geometry.
ENGINE = {
    "max_batch_size": 4, "max_decode_len": 48, "kv_page_size": 16, "max_pages_per_seq": 16,
    "temperature": 0.0, "speculate_k": 8, "hetero_batch": False, "prefix_cache": True,
    "draft_mode": "off", "use_pallas": False, "data_axis": 1, "model_axis": 1,
}
MODEL = {"size": "test", "vocab": "bpe", "max_seq_len": 256, "checkpoint_path": CKPT}
HEADER = "Compose a DAG.\nServices:\n"


def _config(cls, **engine):
    return cls.from_dict({
        "model": MODEL, "engine": {**ENGINE, **engine}, "planner": {"kind": "llm"},
        "tracing": {"enabled": False},
    })


async def _sequential(eng, prefill_tokens):
    """Three prompts sharing a declared header, cold then warm, then a
    novel tail: (texts, cache stats, prefill tokens after each phase)."""
    await eng.start()
    try:
        tok = eng.tokenizer
        head = tok.encode(HEADER + "svc-0 in:a out:b\nsvc-1 in:b out:c\n")
        prompts = [head + tok.encode(f"svc-{i} in:c out:d\nIntent: thing {i}\nJSON:") for i in range(3)]
        texts, marks = [], []
        for p in prompts + prompts + [head + tok.encode("Intent: other\nJSON:")]:
            res = await eng.generate(p, max_new_tokens=16, shared_prefix_len=len(head))
            texts.append(res.text)
            marks.append(prefill_tokens(eng))
        return texts, eng._prefix_cache.stats(), marks
    finally:
        await eng.aclose()


def test_sequential_repeats_match_reference_and_warm_equals_cold():
    ref_texts, ref_stats, ref_marks = asyncio.run(
        _sequential(JEngine(_config(JConfig)), lambda e: e.metrics.prefill_tokens._value.get())
    )
    texts, stats, marks = asyncio.run(
        _sequential(InferenceEngine(_config(MCPXConfig), device="cpu"), lambda e: e._stats["prefill_tokens"])
    )
    assert texts == ref_texts
    assert texts[3:6] == texts[:3]  # warm == cold
    for key in ("hits", "misses", "matched_tokens", "inserted_tokens", "nodes", "resident_tokens"):
        assert stats[key] == ref_stats[key], key
    assert stats["hits"] >= 3 and stats["matched_tokens"] > 0
    assert [int(m) for m in marks] == [int(m) for m in ref_marks]
    # The repeats prefilled at most their last partial page each.
    assert marks[5] - marks[2] <= 3 * ENGINE["kv_page_size"]


N_SERVICES = 200
PLAN_ENGINE = {"max_batch_size": 16, "kv_page_size": 64, "max_pages_per_seq": 4, "max_decode_len": 64}


async def _plan_waves(cp, records, waves):
    for rec in records:
        await cp.registry.put(rec)
    await cp.startup()
    try:
        out = []
        for wave in waves:
            out += [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in wave))]
        return out, cp.planner.engine.prefix_cache_stats()
    finally:
        await cp.planner.engine.aclose()


@pytest.fixture(scope="module")
def plan_streams():
    records = jsynth(N_SERVICES, seed=0)
    rng = random.Random(0)
    pool = [intent_for(records, rng) for _ in range(4)]
    # Four intents, then each of them again beside two new ones: the second
    # wave matches the first wave's prompts in the tree.
    waves = [pool[:2], pool[:2] + pool[2:4], pool[2:4]]
    ref = asyncio.run(_plan_waves(jbuild(_config(JConfig, **PLAN_ENGINE)), records, waves))
    port = asyncio.run(
        _plan_waves(
            build_control_plane(_config(MCPXConfig, **PLAN_ENGINE), device="cpu"),
            synth_registry(N_SERVICES, seed=0), waves,
        )
    )
    return ref, port


@pytest.mark.parametrize("i", range(8))
def test_concurrent_repeat_plans_are_byte_identical(plan_streams, i):
    (ref, _), (port, _) = plan_streams
    assert ref[i].origin == "llm"
    assert port[i].to_json() == ref[i].to_json()


def test_concurrent_repeat_stream_hits_the_tree_like_the_reference(plan_streams):
    (_, ref_stats), (_, stats) = plan_streams
    assert stats["hits"] > 0
    for key in ("hits", "misses", "matched_tokens", "inserted_tokens"):
        assert stats[key] == ref_stats[key], key


def test_suffix_window_pads_never_write_a_tree_page(monkeypatch):
    """Every suffix prefill of a repeat stream is checked: the pages its
    pad slots (positions P + len .. P + T - 1) map to are never pages of a
    tree node, and the K/V of every node sealed before the prefill is
    unchanged after it."""
    eng = InferenceEngine(_config(MCPXConfig), device="cpu")
    checked = []
    real = eng._suffix_prefill

    def watched(tokens_d, lens_d, pos_d, table_d):
        cache = eng._prefix_cache
        tree, stack = [], [cache.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            tree += [(p, n.pending) for p in n.pages]
        tree_pages = {p for p, _ in tree}
        sealed = sorted(p for p, pending in tree if not pending)
        before = {k: eng._paged_kv[k][:, :, sealed].clone() for k in ("k", "v")}
        psz, T = eng.config.engine.kv_page_size, tokens_d.shape[1]
        for b in range(tokens_d.shape[0]):
            P, n_live = int(pos_d[b]), int(lens_d[b])
            pads = {int(table_d[b, (P + t) // psz]) for t in range(n_live, T) if (P + t) // psz < table_d.shape[1]}
            assert not (pads - {0}) & tree_pages, (b, P, n_live)
        out = real(tokens_d, lens_d, pos_d, table_d)
        for k in ("k", "v"):
            assert torch.equal(eng._paged_kv[k][:, :, sealed], before[k])
        checked.append(int(tokens_d.shape[0]))
        return out

    monkeypatch.setattr(eng, "_suffix_prefill", watched)

    async def go():
        await eng.start()
        try:
            tok = eng.tokenizer
            head = tok.encode(HEADER + "svc-0 in:a out:b\nsvc-1 in:b out:c\nsvc-2 in:c out:d\n")
            tails = ["x", "a longer tail that runs past a page", "y z"]
            for rnd in range(2):
                await asyncio.gather(*(
                    eng.generate(head + tok.encode(f"Intent: {t} {rnd}\nJSON:"), max_new_tokens=8)
                    for t in tails
                ))
        finally:
            await eng.aclose()

    asyncio.run(go())
    assert checked, "no suffix prefill ran"


def test_failed_admission_drops_the_tree_and_keeps_pages_whole(monkeypatch):
    """The failure reaches the caller only once the engine's state is
    whole: ``drop_all`` is slowed by 50 ms, so a worker that resolved the
    futures before dropping the tree would be seen with nodes left."""
    eng = InferenceEngine(_config(MCPXConfig), device="cpu")
    real = eng._suffix_prefill
    calls = {"n": 0}

    def flaky(*args):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected prefill failure")
        return real(*args)

    real_drop_all = RadixPrefixCache.drop_all

    def slow_drop_all(self):
        time.sleep(0.05)
        real_drop_all(self)

    monkeypatch.setattr(eng, "_suffix_prefill", flaky)
    monkeypatch.setattr(RadixPrefixCache, "drop_all", slow_drop_all)

    async def go():
        await eng.start()
        try:
            tok = eng.tokenizer
            prompt = tok.encode(HEADER + "svc-0 in:a out:b\nsvc-1 in:b out:c\nIntent: go\nJSON:")
            cold = await eng.generate(prompt, max_new_tokens=8)
            assert eng._prefix_cache.n_nodes > 0
            with pytest.raises(RuntimeError, match="injected"):
                await eng.generate(prompt, max_new_tokens=8)  # matches: suffix prefill
            assert eng._prefix_cache.n_nodes == 0 and eng._prefix_cache.resident_tokens == 0
            assert eng._allocator.stats().sequences == 0
            eng._allocator.check_invariants()
            again = await eng.generate(prompt, max_new_tokens=8)  # dense again, then cached
            assert again.text == cold.text
            warm = await eng.generate(prompt, max_new_tokens=8)
            assert warm.text == cold.text and calls["n"] == 2
        finally:
            await eng.aclose()

    asyncio.run(go())


def test_prompt_capacity_with_a_shared_prefix_matches_reference():
    port = InferenceEngine(_config(MCPXConfig), device="cpu")
    ref = JEngine(_config(JConfig))
    for budget in (0, 8, 48):
        for shared in (0, 9, 16, 40, 64, 200):
            assert port.prompt_capacity(budget, shared) == ref.prompt_capacity(budget, shared), (budget, shared)



def test_pin_api_holds_a_run_under_eviction_and_stats_report_reuse():
    """``pin_prefix`` keeps a resident run through full eviction pressure
    until ``unpin_prefix``; ``queue_stats`` reports the reuse and the pins
    held; an unpin after ``aclose`` is a no-op."""
    eng = InferenceEngine(_config(MCPXConfig), device="cpu")

    async def go():
        await eng.start()
        try:
            tok = eng.tokenizer
            prompt = tok.encode(HEADER + "svc-0 in:a out:b\nsvc-1 in:b out:c\nIntent: pin\nJSON:")
            await eng.generate(prompt, max_new_tokens=8)
            await eng.generate(prompt, max_new_tokens=8)
            qs = eng.queue_stats()
            assert qs["prefix_token_hit_rate"] > 0 and qs["suffix_prefills"] == 1
            assert qs["prefill_tokens"] < 2 * len(prompt)
            pin = await eng.pin_prefix(prompt)
            assert pin is not None and pin.refs == 1
            assert eng.queue_stats()["prefix_pins"] == 1
            assert await eng.drop_unpinned() > 0  # the pinned run stays
            assert eng._prefix_cache.probe(prompt) > 0
            eng.unpin_prefix(pin)
            for _ in range(100):
                await asyncio.sleep(0.02)
                if pin.refs == 0:
                    break
            assert pin.refs == 0 and eng.queue_stats()["prefix_pins"] == 0
            assert await eng.drop_unpinned() == 0
            assert eng._prefix_cache.n_nodes == 0 and eng._allocator.stats().sequences == 0
            eng._allocator.check_invariants()
            late = await eng.pin_prefix(prompt)  # nothing resident: no pin
            assert late is None and eng.queue_stats()["prefix_pins"] == 0
        finally:
            await eng.aclose()
        # An unpin after shutdown is a no-op: nothing is queued or changed.
        eng.unpin_prefix(pin)
        assert eng._queue.qsize() == 0 and pin.refs == 0

    asyncio.run(go())
