"""The port's tiered KV cache (``engine.kv_tier``) against the reference
package's, on the CPU:

  - the radix tree, host spill tier and cache governor of both packages,
    driven by the same seeded operation streams (serve = match and insert,
    probe, lookup, pin and unpin, evict, ``evict_tenant``, ``evict_host``,
    poll, landing of copies in flight, partial matches that split device
    and spilled edges, ``restore_spilled``, copy budgets) over numpy stub
    copies: after every step the tree's shape, every host run's bytes and
    all three ``stats()`` are equal;
  - the governor's shares, fold, snapshot and restore, number for number;
  - the tiered engines of both packages on the reference bench's tier
    geometry (``bench.py::_tier_phase``: batch 4, 16-token pages, 16 pages
    a row, greedy, two new tokens) over 16 prompts x 3 rounds, on the
    committed checkpoint in float32: byte-identical outputs and equal
    spills, readmits, destructive evictions, denied readmits and prefill
    tokens; the port's tier off against on: the same outputs; the seeded
    chaos profile and the thrash/victim tenant stream: the reference's
    counts and per-tenant hit rates;
  - the warm-restart snapshot in the port (the reference's engine tests,
    ported): save, restore and a first request served from readmitted KV,
    a corrupt or stale manifest skipped, a changed fingerprint falling back
    to ids that rebuild lazily, ``aclose`` with spills in flight leaving no
    host bytes; and snapshots across the packages in both directions.

Host bookkeeping and greedy outputs: every comparison is exact.
"""

import asyncio
import dataclasses
import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.engine.cache_governor import CacheGovernor as JGovernor
from mcpx.engine.engine import InferenceEngine as JEngine
from mcpx.engine.kv_cache import PageAllocator as JAllocator
from mcpx.engine.prefix_cache import RadixPrefixCache as JCache
from mcpx.engine.spill import HostSpillTier as JTier
from mcpx.engine.spill import SpillChaos as JChaos
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine.cache_governor import CacheGovernor
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.engine.kv_cache import PageAllocator
from mcpx_torch.engine.prefix_cache import RadixPrefixCache
from mcpx_torch.engine.spill import HostSpillTier, SpillChaos
from mcpx_torch.models.gemma.config import GemmaConfig

PAGE = 4
TENANTS = ("a", "b", "c")
CKPT = os.path.join(os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz")
N_PROMPTS, ROUNDS = 16, 3
CHAOS = {"seed": 7, "host_alloc_fail_p": 0.3, "copy_delay_p": 0.3, "copy_delay_s": 0.02}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blocks(*ids):
    out = []
    for k in ids:
        out.extend([k * 100, k * 100 + 1, k * 100 + 2, k * 100 + 3])
    return out


# ------------------------------------------------------------ tree + tier
class StubDevice:
    """The device copies of both packages as numpy stubs: a run's "KV" for
    page p is the constant plane p (v is -k). A gather is in flight until
    ``land()``; the reference's handle answers ``is_ready``, the port's
    event answers ``query``, both from the same ticket."""

    def __init__(self):
        self.tickets = 0
        self.landed = 0
        self.readmitted: list[list[int]] = []

    def _arrays(self, pages):
        k = np.broadcast_to(np.asarray(pages, np.float32)[:, None, None], (len(pages), PAGE, 1))
        k = np.ascontiguousarray(k[None, None])
        return k, -k

    def ref_gather(self, pages):
        self.tickets += 1
        t, stub = self.tickets, self
        k, v = self._arrays(pages)

        class Handle:
            def __init__(self, a):
                self.a = a

            def is_ready(self):
                return t <= stub.landed

            def __array__(self, dtype=None, copy=None):
                return self.a

        return Handle(k), Handle(v)

    def port_gather(self, pages):
        t, stub = self.tickets, self  # the reference's gather of the same step took the ticket
        k, v = self._arrays(pages)

        class Event:
            def query(self):
                return t <= stub.landed

            def synchronize(self):
                pass

        return k, v, (Event(),), None

    def readmit(self, k, v, pages):
        self.readmitted.append(list(pages))

    def land(self):
        self.landed = self.tickets


class Twin:
    """A reference tree, tier and governor and the port's, driven by the
    same calls over one stub device (the reference side calls it first)."""

    def __init__(self, rng, governed=True):
        self.dev = StubDevice()
        self.clock = [0.0]
        clock = lambda: self.clock[0]  # noqa: E731
        host_bytes = rng.choice((0, 160, 400, 1 << 20))
        n_pages, max_nodes, max_tokens = 96, rng.choice((8, 24, 96)), rng.choice((16, 32, 48))
        profile = {"seed": rng.randrange(100), "host_alloc_fail_p": rng.choice((0.0, 0.2)),
                   "copy_delay_p": rng.choice((0.0, 0.3)), "copy_delay_s": 2.0}
        self.sides = []
        for Alloc, Cache, Tier, Chaos, Gov, gather in (
            (JAllocator, JCache, JTier, JChaos, JGovernor, self.dev.ref_gather),
            (PageAllocator, RadixPrefixCache, HostSpillTier, SpillChaos, CacheGovernor, self.dev.port_gather),
        ):
            alloc = Alloc(n_pages=n_pages, page_size=PAGE, max_pages_per_seq=32)
            tier = Tier(host_bytes=host_bytes, chaos=Chaos(profile, clock=clock), clock=clock)
            tier.bind(gather, self.dev.readmit, bytes_per_token=4)
            gov = Gov({"a": 2.0}, max_tenants=2) if governed else None
            cache = Cache(alloc, PAGE, max_nodes=max_nodes, max_tokens=max_tokens, spill=tier, governor=gov)
            self.sides.append((alloc, cache, tier, gov))
        self.pins: list[tuple] = []

    def both(self, fn):
        """``fn(side)`` on the reference, then on the port; the answers must
        agree (nodes are compared by shape)."""
        ra, pa = fn(self.sides[0]), fn(self.sides[1])
        assert shape(ra) == shape(pa), (ra, pa)
        return ra, pa

    def check(self):
        (ja, jc, jt, jg), (ta, tc, tt, tg) = self.sides
        assert shape(jc.root) == shape(tc.root)
        assert jc.stats() == tc.stats()
        assert jt.stats() == tt.stats()
        if jg is not None:
            assert jg.stats(jc.max_tokens) == tg.stats(tc.max_tokens)
            assert jg.resident_by_tenant() == tg.resident_by_tenant()
        assert vars(ja.stats()) == vars(ta.stats())
        for _a, c, _t, _g in self.sides:
            c.check_invariants()
        ja.check_invariants()
        ta.check_invariants()


def shape(x):
    """A node (and its subtree), or any other answer, as plain data: a host
    run by its accounting and, once landed, its bytes."""
    if isinstance(x, tuple):
        return tuple(shape(v) for v in x)
    if isinstance(x, list):
        return [shape(v) for v in x]
    if not hasattr(x, "children"):
        return x
    run = x.host
    host = None
    if run is not None:
        host = (run.n_tokens, run.nbytes, run.tenant, run.ready, run.ready_at,
                np.asarray(run.k).tobytes() if run.ready else None,
                np.asarray(run.v).tobytes() if run.ready else None)
    kids = tuple((k, shape(c)) for k, c in x.children.items())
    return (x.tokens, tuple(x.pages), x.refs, x.pending, x.tenant, x.sid, x.stamp, host, kids)


def _sequence(rng):
    return blocks(*(rng.randrange(10) for _ in range(rng.randrange(1, 6)))) + [7]


def _serve(twin, rng):
    """Match a prompt (pinning what matched), insert its aligned rest for a
    tenant, seal; keep the pins for a while, as a resident row would."""
    ids = _sequence(rng)
    tenant = rng.choice(TENANTS)
    cap = rng.choice((None, None, 8, 12))
    record = rng.random() < 0.8

    def go(side):
        _a, cache, _t, _g = side
        n, pages, node = cache.match(ids, cap, record=record)
        if node is not None:
            node.refs += 1
        want = (len(ids) // PAGE) * PAGE - n
        inode = cache.insert(ids, n, want, tenant=tenant) if want > 0 else None
        cache.seal()
        return n, pages, node, inode

    (_jn, _jp, jnode, jinode), (_tn, _tp, tnode, tinode) = twin.both(go)
    twin.pins.append(((jnode, jinode), (tnode, tinode)))


def _unpin(twin, rng):
    if not twin.pins:
        return
    pins = twin.pins.pop(rng.randrange(len(twin.pins)))
    for side in pins:
        for node in side:
            if node is not None and node.refs > 0:
                node.refs -= 1


def _restore(twin, rng):
    path = _sequence(rng)[:-1]
    edge = PAGE * rng.randrange(1, len(path) // PAGE + 1)
    tenant = rng.choice(TENANTS)
    n_pages = edge // PAGE
    k = np.full((1, 1, n_pages, PAGE, 1), float(rng.randrange(50)), np.float32)
    twin.both(lambda side: side[1].restore_spilled(path, edge, k.copy(), -k, tenant))


def _on_tree(method, *draw):
    """An op calling the tree's ``method`` on both sides with the same
    arguments, drawn once by ``draw(rng)`` each."""

    def op(twin, rng):
        args = [d(rng) for d in draw]
        twin.both(lambda side: getattr(side[1], method)(*args))

    return op


def _evict(twin, rng):
    n = rng.choice((0, 8, 40))
    twin.both(lambda side: side[1].evict(n, need_resident=n // 2))


def _cycle(twin, rng):
    budget = rng.choice((0, 4, 16))
    for _a, _c, tier, _g in twin.sides:
        tier.copy_tokens_per_cycle = budget
        tier.begin_cycle()


def _tick(twin, rng):
    twin.clock[0] += 1.5


# name: (weight, op)
OPS = {
    "serve": (6, _serve),
    "unpin": (3, _unpin),
    "probe": (1, _on_tree("probe", _sequence)),
    "lookup": (1, _on_tree("lookup", _sequence)),
    "evict": (1, _evict),
    "evict_tenant": (1, _on_tree("evict_tenant", lambda rng: rng.choice(TENANTS), lambda rng: rng.randrange(24))),
    "evict_host": (1, _on_tree("evict_host", lambda rng: rng.choice((0, 64, 400)))),
    "poll": (3, lambda twin, rng: twin.both(lambda side: side[2].poll())),
    "land": (2, lambda twin, rng: twin.dev.land()),
    "tick": (1, _tick),
    "cycle": (1, _cycle),
    "restore": (1, _restore),
}


@pytest.mark.parametrize("seed", range(6))
def test_tree_tier_and_governor_agree_with_reference_step_for_step(seed):
    rng = random.Random(seed)
    twin = Twin(rng, governed=seed % 3 != 2)
    names = list(OPS)
    weights = [OPS[n][0] for n in names]
    seen = set()
    for _step in range(400):
        name = rng.choices(names, weights)[0]
        OPS[name][1](twin, rng)
        seen.add(name)
        twin.check()
    (_ja, jc, jt, _jg), (_ta, tc, tt, _tg) = twin.sides
    assert seen == set(OPS)
    assert tt.spills == jt.spills and tt.readmits == jt.readmits
    # The stream reached the tier at all, and split a spilled edge.
    assert tt.spills + tt.destructive_evictions > 0


def test_spilled_partial_match_splits_the_host_run_like_the_reference():
    """The reference's ``test_spilled_partial_match_splits_host_run`` on
    both packages at once: a spilled 12-token run, matched by a prompt
    sharing only its first page, splits at that page (each half its own
    copy) and readmits just the head: the same pages and halves."""
    twin = Twin(random.Random(3), governed=False)
    for _a, cache, tier, _g in twin.sides:
        cache.max_tokens = 12
        tier.host_bytes, tier.chaos = 1 << 20, None
    for ids in (blocks(1, 2, 3) + [9], blocks(5, 6, 7) + [9]):
        def insert_all(side, ids=ids):
            cache = side[1]
            n = cache.match(ids)[0]
            node = cache.insert(ids, n, 12 - n)
            node.refs -= 1
            cache.seal()
            return n
        twin.both(insert_all)
        twin.check()
    twin.dev.land()
    twin.both(lambda s: s[2].poll())
    assert twin.sides[1][1].n_spilled == 1
    (rn, rp), (pn, pp) = twin.both(lambda s: s[1].match(blocks(1, 8) + [9])[:2])
    assert pn == rn == 4 and pp == rp and len(pp) == 1
    head = twin.sides[1][1].root.children[tuple(blocks(1))]
    assert head.pages and head.children[tuple(blocks(2))].host.k.shape[2] == 2
    twin.check()


# ------------------------------------------------------------- governor
def _gov_ops(rng, gov, n_ops):
    for _ in range(n_ops):
        t = rng.choice(TENANTS + ("d", "e"))
        op = rng.randrange(8)
        k = rng.randrange(0, 40)
        if op == 0:
            gov.on_insert(t, k)
        elif op == 1:
            gov.on_drop(t, min(k, gov.device_tokens(t)))
        elif op == 2:
            gov.on_spill(t, min(k, gov.device_tokens(t)))
        elif op == 3:
            gov.on_readmit(t, min(k, gov.host_tokens(t)))
        elif op == 4:
            gov.on_host_drop(t, min(k, gov.host_tokens(t)))
        elif op == 5:
            gov.on_adopt(t, k)
        elif op == 6:
            gov.on_lookup(t, k if rng.random() < 0.6 else 0, rng.randrange(0, 40))
        else:
            gov.reset_residency()


@pytest.mark.parametrize("seed", range(3))
def test_governor_shares_fold_snapshot_and_restore_match_reference(seed):
    weights = {"a": 3.0, "b": 0.5}
    govs = [JGovernor(weights, max_tenants=4), CacheGovernor(weights, max_tenants=4)]
    for step in range(60):
        for g in govs:
            _gov_ops(random.Random(seed * 1000 + step), g, 5)
        for budget in (0, 37, 512):
            j, p = govs
            assert j.stats(budget) == p.stats(budget)
            for t in TENANTS + ("d", "e", "other"):
                assert j.fold(t) == p.fold(t) and j.weight(t) == p.weight(t)
                assert j.fair_share_tokens(t, budget) == p.fair_share_tokens(t, budget)
                assert j.host_fair_share_tokens(t, budget) == p.host_fair_share_tokens(t, budget)
                assert j.over_share(t, budget, extra=7) == p.over_share(t, budget, extra=7)
                assert j.over_host_share(t, budget) == p.over_host_share(t, budget)
                assert j.token_hit_rate(t) == p.token_hit_rate(t)
    assert govs[0].snapshot() == govs[1].snapshot()
    state = {"weights": {"gold": 2.5, "bad": "x", "neg": -1, "ok": 4}}
    restored = [JGovernor(), CacheGovernor()]
    for g in restored:
        g.restore(govs[1].snapshot())
        g.restore(state)
    assert restored[0].snapshot() == restored[1].snapshot()
    assert restored[1].weight("gold") == 2.5 and restored[1].weight("neg") == 1.0


# ---------------------------------------------------------------- engines
def _config(cls, enabled=True, *, chaos="", snapshot="", checkpoint=CKPT, vocab="bpe", **engine):
    eng = {
        "data_axis": 1, "model_axis": 1, "warmup_compile": False, "hetero_batch": False,
        "max_batch_size": 4, "max_pages_per_seq": 16, "kv_page_size": 16, "max_decode_len": 8,
        "prefix_cache": True, "prefix_cache_entries": 4096, "use_pallas": False,
        "speculative": {"enabled": False},
        "kv_tier": {"enabled": enabled, "host_mb": 256.0, "copy_tokens_per_cycle": 4096,
                    "snapshot_path": snapshot, "chaos_profile": chaos},
    }
    eng.update(engine)
    return cls.from_dict({"model": {"size": "test", "vocab": vocab, "checkpoint_path": checkpoint}, "engine": eng})


REF = dict(Engine=JEngine, Config=JConfig, Gemma=JGemmaConfig, kw={})
PORT = dict(Engine=InferenceEngine, Config=MCPXConfig, Gemma=GemmaConfig, kw={"device": "cpu"})


def _engine(ns, cfg):
    mc = dataclasses.replace(
        ns["Gemma"].named("test", vocab_size=3072, max_seq_len=cfg.model.max_seq_len), dtype="float32"
    )
    return ns["Engine"](cfg, model_cfg=mc, **ns["kw"])


def prefill_total(eng) -> float:
    for line in eng.metrics.render().decode().splitlines():
        if line.startswith("mcpx_engine_prefill_tokens_total "):
            return float(line.split()[-1])
    return 0.0


def tier_prompts(tok, n=N_PROMPTS):
    return [tok.encode(f"tier workload {i}: " + "compose rank fetch join " * 12)[:128] for i in range(n)]


async def _drive(eng, stream, tenants=None):
    outs = []
    for j, p in enumerate(stream):
        r = await eng.generate(
            p, max_new_tokens=2, constrained=False, temperature=0.0,
            tenant=tenants[j] if tenants else "default",
        )
        outs.append(r.token_ids)
    return outs


def _counts(eng, pf0: float) -> dict:
    st = eng.prefix_cache_stats()
    out = {k: st[k] for k in ("hits", "misses", "matched_tokens", "inserted_tokens", "evictions", "nodes")}
    out["prefill_tokens"] = prefill_total(eng) - pf0
    if st["tier"] is not None:
        out.update({k: st["tier"][k] for k in (
            "spills", "readmits", "destructive_evictions", "denied_readmits", "host_evictions",
            "host_tokens", "host_bytes", "chaos_alloc_failures",
        )})
    return out


async def _tier_stream(ns, enabled=True, chaos=""):
    eng = _engine(ns, _config(ns["Config"], enabled, chaos=chaos))
    if chaos:
        # A frozen clock: a copy-latency spike never ends, whatever the
        # host's speed, so both packages see the same spikes.
        eng._spill_tier._clock = eng._spill_tier.chaos._clock = lambda: 0.0
    await eng.start()
    try:
        pf0 = prefill_total(eng)
        prompts = tier_prompts(eng.tokenizer)
        outs = [await _drive(eng, prompts) for _ in range(ROUNDS)]
        costs = eng.costs.snapshot()["executables"] if ns is PORT else None
        return outs, _counts(eng, pf0), eng.queue_stats(), eng.prefix_cache_stats(), costs
    finally:
        await eng.aclose()


@pytest.fixture(scope="module")
def tier_streams():
    return {
        "ref": asyncio.run(_tier_stream(REF)),
        "port": asyncio.run(_tier_stream(PORT)),
        "port_off": asyncio.run(_tier_stream(PORT, enabled=False)),
    }


def test_tiered_engine_outputs_and_counts_match_reference(tier_streams):
    ref, port = tier_streams["ref"], tier_streams["port"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[1]["spills"] > 0 and port[1]["readmits"] > 0 and port[1]["destructive_evictions"] == 0
    q = port[2]
    assert (q["prefix_spills"], q["prefix_readmits"]) == (port[1]["spills"], port[1]["readmits"])
    assert q["prefix_host_pages"] == port[3]["host_pages"] > 0


def test_tier_off_serves_the_same_outputs_as_tier_on(tier_streams):
    on, off = tier_streams["port"], tier_streams["port_off"]
    assert off[0] == on[0]
    assert off[3]["tier"] is None and off[3]["governor"] is None and off[2]["prefix_spills"] == 0
    # Single tier: round 2 on re-prefills what eviction destroyed.
    assert on[1]["prefill_tokens"] < off[1]["prefill_tokens"]
    assert on[3]["governor"]["default"]["token_hit_rate"] > 0


def test_tier_copies_are_counted_in_costs_by_the_bytes_they_move(tier_streams):
    """``spill_gather`` and ``spill_readmit`` in the cost registry: one
    signature a page count, one call a copy, each charged the run's K and V
    read once and written once (float32 pools here)."""
    _outs, counts, _q, _st, costs = tier_streams["port"]
    mc = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072), dtype="float32")
    for name, n_copies in (("spill_gather", counts["spills"]), ("spill_readmit", counts["readmits"])):
        sigs = costs[name]["signatures"]
        assert sum(e["calls"] for e in sigs) == n_copies > 0
        for e in sigs:
            pages = int(e["signature"].strip("(),"))
            assert e["flops"] == 0.0
            assert e["bytes_accessed"] == 2 * 2 * mc.n_kv_heads * mc.n_layers * pages * 16 * mc.head_dim * 4
    assert "spill_gather" not in tier_streams["port_off"][4]


@pytest.fixture(scope="module")
def chaos_streams():
    chaos = json.dumps(CHAOS)
    return asyncio.run(_tier_stream(REF, chaos=chaos)), asyncio.run(_tier_stream(PORT, chaos=chaos))


def test_seeded_chaos_profile_gives_the_reference_counts(chaos_streams, tier_streams):
    ref, port = chaos_streams
    assert port[0] == ref[0] == tier_streams["port"][0]
    assert port[1] == ref[1]
    assert port[1]["chaos_alloc_failures"] > 0 and port[1]["destructive_evictions"] > 0


async def _thrash(ns):
    eng = _engine(ns, _config(ns["Config"]))
    await eng.start()
    try:
        tok = eng.tokenizer
        victim = tier_prompts(tok, 4)
        thrash = [tok.encode(f"thrash {i}: " + "spam flood churn " * 14)[:128] for i in range(2 * N_PROMPTS)]
        stream, tenants = [], []
        for burst in range(ROUNDS * 4):
            for j in range(4):
                stream.append(thrash[(burst * 4 + j) % len(thrash)])
                tenants.append("thrash")
            stream += victim
            tenants += ["victim"] * 4
        outs = await _drive(eng, stream, tenants)
        return outs, eng.prefix_cache_stats()
    finally:
        await eng.aclose()


def test_thrash_and_victim_tenants_get_the_reference_hit_rates():
    ref = asyncio.run(_thrash(REF))
    port = asyncio.run(_thrash(PORT))
    assert port[0] == ref[0]
    assert port[1]["governor"] == ref[1]["governor"]
    assert {k: port[1]["tier"][k] for k in ref[1]["tier"]} == ref[1]["tier"]
    gov = port[1]["governor"]
    assert gov["victim"]["token_hit_rate"] > gov["thrash"]["token_hit_rate"]


# --------------------------------------------------------------- snapshot
def _small_config(snap="", enabled=True):
    """The reference's own snapshot-test engine (``tests/test_kv_tier.py``):
    test preset, byte vocab, random weights."""
    return MCPXConfig.from_dict({
        "model": {"size": "test"},
        "engine": {
            "max_batch_size": 4, "max_pages_per_seq": 16, "kv_page_size": 16, "max_decode_len": 16,
            "prefix_cache_entries": 64,
            "kv_tier": {"enabled": enabled, "host_mb": 64.0, "snapshot_path": snap},
        },
    })


def _probe_prompts(tok, tag, n, body):
    return [tok.encode(f"{tag} probe {i}: " + body * 28)[:128] for i in range(n)]


def test_snapshot_round_trip_and_corrupt_or_stale_skip(tmp_path):
    snap = str(tmp_path / "kv.snap")

    async def go():
        eng = InferenceEngine(_small_config(snap), device="cpu")
        await eng.start()
        prompts = _probe_prompts(eng.tokenizer, "warm", 3, "qrst ")
        outs = [(await eng.generate(p, max_new_tokens=8, constrained=False, temperature=0.0)).token_ids
                for p in prompts]
        await eng.aclose()
        assert os.path.exists(snap) and os.path.exists(snap + ".npz")
        manifest = json.load(open(snap))
        assert manifest["version"] == 1 and manifest["nodes"] and manifest["dtype"] == "bfloat16"

        eng2 = InferenceEngine(_small_config(snap), device="cpu")
        await eng2.start()
        st = eng2.prefix_cache_stats()
        assert st["spilled_nodes"] >= 3 and st["host_tokens"] >= 3 * 112
        pf0 = prefill_total(eng2)
        r = await eng2.generate(prompts[0], max_new_tokens=8, constrained=False, temperature=0.0)
        warm = prefill_total(eng2) - pf0
        assert r.token_ids == outs[0]
        assert warm <= 64, warm  # the 112-token head readmitted, the last page prefilled
        assert eng2.prefix_cache_stats()["tier"]["readmits"] >= 1
        await eng2.aclose()

        with open(snap, "w") as f:
            f.write('{"version": 1, "garbage')
        eng3 = InferenceEngine(_small_config(snap), device="cpu")
        await eng3.start()
        assert eng3.state == "ready" and eng3.prefix_cache_stats()["spilled_nodes"] == 0
        r3 = await eng3.generate(prompts[0], max_new_tokens=8, constrained=False, temperature=0.0)
        assert r3.token_ids == outs[0]
        await eng3.aclose()

        manifest["page_size"] = 999
        with open(snap, "w") as f:
            json.dump(manifest, f)
        eng4 = InferenceEngine(_small_config(snap), device="cpu")
        await eng4.start()
        assert eng4.prefix_cache_stats()["spilled_nodes"] == 0
        await eng4.aclose()

    asyncio.run(go())


def test_snapshot_with_changed_fingerprint_rebuilds_heads_lazily(tmp_path):
    snap = str(tmp_path / "kv.snap")

    async def go():
        eng = InferenceEngine(_small_config(snap), device="cpu")
        await eng.start()
        p = _probe_prompts(eng.tokenizer, "lazy", 1, "dfgh ")[0]
        r0 = await eng.generate(p, max_new_tokens=8, constrained=False, temperature=0.0, shared_prefix_len=80)
        await eng.aclose()
        manifest = json.load(open(snap))
        assert manifest["declared_heads"], "declared head not recorded"
        manifest["fingerprint"] = 1e9  # another model's KV
        with open(snap, "w") as f:
            json.dump(manifest, f)

        eng2 = InferenceEngine(_small_config(snap), device="cpu")
        await eng2.start()
        assert eng2.prefix_cache_stats()["spilled_nodes"] == 0  # stale KV refused
        assert eng2._warm_heads, "ids-only heads not queued"
        r1 = await eng2.generate(p, max_new_tokens=8, constrained=False, temperature=0.0, shared_prefix_len=80)
        assert r1.token_ids == r0.token_ids
        assert not eng2._warm_heads  # consumed by its lazy rebuild
        assert eng2.prefix_cache_stats()["resident_tokens"] > 0
        await eng2.aclose()

    asyncio.run(go())


def test_aclose_with_spills_in_flight_leaves_no_host_bytes(tmp_path):
    snap = str(tmp_path / "kv.snap")

    async def go():
        eng = InferenceEngine(_small_config(snap), device="cpu")
        await eng.start()
        for p in _probe_prompts(eng.tokenizer, "close", 6, "lmno "):
            await eng.generate(p, max_new_tokens=2, constrained=False, temperature=0.0)
        tier = eng._spill_tier
        assert tier.spills > 0
        await eng.aclose()
        assert eng.state == "closed"
        assert tier.pending_copies() == 0
        assert tier.host_tokens == 0 and tier.host_bytes_used == 0
        assert os.path.exists(snap)
        assert eng.prefix_cache_stats()["spilled_nodes"] == 0

    asyncio.run(go())


def test_chaos_profile_reaches_the_tier_and_bad_profiles_are_ignored():
    cfg = _small_config()
    cfg.engine.kv_tier.chaos_profile = '{"seed": 5, "host_alloc_fail_p": 0.25}'
    eng = InferenceEngine(cfg, device="cpu")
    assert eng._spill_tier.chaos.host_alloc_fail_p == 0.25
    cfg.engine.kv_tier.chaos_profile = '{"host_alloc_fail_p": 1.5}'
    assert InferenceEngine(cfg, device="cpu")._spill_tier.chaos is None


async def _write_snapshot(ns, snap):
    eng = _engine(ns, _config(ns["Config"], snapshot=snap))
    await eng.start()
    prompts = tier_prompts(eng.tokenizer, 3)
    outs = await _drive(eng, prompts)
    await eng.aclose()
    return prompts, outs


async def _restore_snapshot(ns, snap, prompt):
    eng = _engine(ns, _config(ns["Config"], snapshot=snap))
    await eng.start()
    try:
        restored = eng.prefix_cache_stats()["spilled_nodes"]
        pf0 = prefill_total(eng)
        out = (await _drive(eng, [prompt]))[0]
        return restored, out, prefill_total(eng) - pf0
    finally:
        await eng.aclose()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshots_restore_across_the_packages(tmp_path, writer):
    """A snapshot written by either package (same weights: the committed
    checkpoint, float32 on both sides) restores in both: the same run
    count, and the warm first output equal to the writer's round 1."""
    src = str(tmp_path / "written.snap")
    prompts, outs = asyncio.run(_write_snapshot(REF if writer == "reference" else PORT, src))
    got = {}
    for name, ns in (("reference", REF), ("port", PORT)):
        snap = str(tmp_path / f"{name}.snap")
        shutil.copy(src, snap)
        shutil.copy(src + ".npz", snap + ".npz")
        got[name] = asyncio.run(_restore_snapshot(ns, snap, prompts[0]))
    (r_n, r_out, r_pf), (p_n, p_out, p_pf) = got["reference"], got["port"]
    assert p_n == r_n >= 3
    assert p_out == r_out == outs[0]
    assert p_pf == r_pf < len(prompts[0])
