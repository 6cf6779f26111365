"""The tiered KV cache (``engine.kv_tier``) on meshes of distinct devices, on
the CPU: host devices ``cpu:0..3`` copy between each other as cards do, so
the tier's per-device copies (``parallel.transfer.gather_run`` and
``readmit_run``), its spills, readmits, governor, chaos draws and
warm-restart snapshots run here as they run on a mesh of cards. At the tier
geometry of ``tests/test_torch_kv_tier.py`` (batch 4, 16-token pages, 16 a
row, greedy, two new tokens; the committed checkpoint in float32):

  - the tiered stream on ``data=2``, ``model=2`` and 2 x 2 gives the
    unmeshed engine's tokens and tier counters exactly, with one tier copy
    counted on each device a copy touches; a GQA config (two KV heads, each
    model shard's own) on 2 x 2 the same, its gather joining the heads;
  - on ``data=2`` the reference engine's tokens and counters at
    ``data_axis=2, model_axis=1`` (no head sums there: exact);
  - the GQA round trip, spill, page reuse, readmit into other pages, bit
    for bit on every device, its host run the unmeshed gather's;
  - snapshots across layouts and packages, and the weights' fingerprint on
    every layout equal to the unmeshed one;
  - a seeded chaos profile's counts on 2 x 2, and ``aclose`` with spills in
    flight leaving no host bytes.

Each engine run is bounded by ``asyncio.wait_for``: a fault fails, it does
not hang."""

import asyncio
import dataclasses
import json
import os
import shutil

import pytest
import torch

from mcpx.core.config import MCPXConfig as JConfig
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.engine.kv_cache import init_paged_kv
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.params import load_or_init
from mcpx_torch.parallel import transfer
from mcpx_torch.parallel.mesh import make_mesh, serve_layout
from tests.test_torch_kv_tier import (
    CHAOS,
    CKPT,
    PORT,
    REF,
    ROUNDS,
    _config,
    _counts,
    _drive,
    _engine,
    prefill_total,
    tier_prompts,
)

HOST4 = [torch.device("cpu", i) for i in range(4)]
SHAPES = {"data2": dict(data=2), "model2": dict(model=2), "2x2": dict(data=2, model=2)}
LIMIT_S = 120.0  # one engine run; a healthy one takes a few seconds
PSZ = 16


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _model_cfg(cfg, gqa: bool = False):
    mc = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072, max_seq_len=cfg.model.max_seq_len),
                             dtype="float32")
    return dataclasses.replace(mc, n_kv_heads=2) if gqa else mc


def _mesh(shape):
    return None if shape is None else make_mesh(**SHAPES[shape], devices=HOST4)


def _tier_engine(shape=None, *, gqa=False, chaos="", snapshot=""):
    cfg = _config(MCPXConfig, chaos=chaos, snapshot=snapshot, checkpoint="" if gqa else CKPT)
    eng = InferenceEngine(cfg, model_cfg=_model_cfg(cfg, gqa), device="cpu", mesh=_mesh(shape))
    if chaos:
        eng._spill_tier._clock = eng._spill_tier.chaos._clock = lambda: 0.0  # spikes never end
    return eng


async def _stream(eng, n_prompts=16):
    await eng.start()
    try:
        pf0 = prefill_total(eng)
        transfer.reset_counts()
        prompts = tier_prompts(eng.tokenizer, n_prompts)
        outs = [await _drive(eng, prompts) for _ in range(ROUNDS)]
        return outs, _counts(eng, pf0), transfer.counts(), eng._layout
    finally:
        await eng.aclose()


def _copies_per_run(layout):
    """(devices a gather reads, devices a readmit writes)."""
    if layout is None or not layout.cross:
        return 1, 1
    spans = {layout.kv_range(layout.card(0, m)) for m in range(layout.model)}
    return len(spans - {None}), len(layout.devices)


@pytest.fixture(scope="module")
def unmeshed():
    return {gqa: _run(_stream(_tier_engine(gqa=gqa))) for gqa in (False, True)}


@pytest.fixture(scope="module")
def meshed():
    return {}


@pytest.mark.parametrize("shape,gqa", [("data2", False), ("model2", False), ("2x2", False), ("2x2", True)],
                         ids=["data2", "model2", "2x2", "2x2_gqa"])
def test_the_tiered_stream_on_host_devices_gives_the_unmeshed_tokens_and_counts(unmeshed, meshed, shape, gqa):
    """16 prompts x 3 rounds through a resident cap of 512 tokens: every
    token and tier counter (spills, readmits, destructive evictions, host
    tokens and bytes, prefill tokens, the tree's) equal to the unmeshed
    engine's; the tier's copies counted on each device they read or wrote
    (a GQA gather reads both model shards' heads)."""
    outs, counts, moved, layout = meshed[(shape, gqa)] = _run(_stream(_tier_engine(shape, gqa=gqa)))
    want_outs, want_counts, _, _ = unmeshed[gqa]
    assert layout.cross and len(layout.devices) == len(HOST4[: 4 if shape == "2x2" else 2])
    assert outs == want_outs
    assert counts == want_counts
    assert counts["spills"] > 0 and counts["readmits"] > 0 and counts["destructive_evictions"] == 0
    reads, writes = _copies_per_run(layout)
    assert reads == (2 if gqa else 1) and writes == len(layout.devices)
    assert moved["tier_copies"] == counts["spills"] * reads + counts["readmits"] * writes


def test_the_data2_stream_gives_the_reference_tokens_and_counts(meshed):
    """The port on ``data=2`` host devices against the reference engine at
    ``data_axis=2, model_axis=1`` on two of its CPU devices."""
    if ("data2", False) not in meshed:
        meshed[("data2", False)] = _run(_stream(_tier_engine("data2")))
    outs, counts, _, _ = meshed[("data2", False)]

    async def reference():
        eng = _engine(REF, _config(JConfig, data_axis=2, model_axis=1))
        await eng.start()
        try:
            pf0 = prefill_total(eng)
            prompts = tier_prompts(eng.tokenizer)
            return [await _drive(eng, prompts) for _ in range(ROUNDS)], _counts(eng, pf0)
        finally:
            await eng.aclose()

    ref_outs, ref_counts = _run(reference())
    assert outs == ref_outs
    assert counts == ref_counts


class Node:
    def __init__(self, n_tokens):
        self.tokens, self.tenant, self.host = tuple(range(n_tokens)), "default", None


def _bound(shape, seed=0):
    """An engine that is not started (GQA widths), its layout and pools made
    as ``_setup`` makes them and filled from a seed, each device with its
    heads of one whole pool pair; its tier bound to its own copies."""
    cfg = _config(MCPXConfig, checkpoint="")
    mc = _model_cfg(cfg, gqa=True)
    eng = InferenceEngine(cfg, model_cfg=mc, device="cpu", mesh=_mesh(shape))
    eng._layout = serve_layout(eng._mesh, mc)
    n_pages = eng._allocator.n_pages
    gen = torch.Generator().manual_seed(seed)
    whole = {k: torch.randn((mc.n_kv_heads, mc.n_layers, n_pages, PSZ, mc.head_dim), generator=gen) for k in "kv"}
    eng._paged_kv = init_paged_kv(mc, n_pages, PSZ, "cpu", layout=eng._layout)
    for _dev, (k0, k1), pool in transfer.pools_on(eng._paged_kv, eng._layout):
        for k in "kv":
            pool[k].copy_(whole[k][k0:k1])
    per_token = 2 * mc.n_kv_heads * mc.n_layers * mc.head_dim * 4
    eng._spill_tier.bind(eng._spill_gather, eng._spill_readmit, per_token)
    return eng, whole, gen


@pytest.mark.parametrize("n_pages", [4, 7])
@pytest.mark.parametrize("shape", ["model2", "2x2"])
def test_the_gqa_round_trip_is_bit_exact_on_every_device(shape, n_pages):
    """Spill a run of two KV heads split over the model shards, overwrite
    its pages on every device at once (as the next prefill writes freed
    pages), land it, readmit it into other pages: the host run equals the
    unmeshed gather of the same contents, every device's readmitted pages
    equal its heads of the clone, the pools are the same tensors, and the
    host tier is empty. A run naming page 0 is refused."""
    eng, whole, gen = _bound(shape)
    layout, tier = eng._layout, eng._spill_tier
    assert layout.cross and layout.kv_split
    src, dst = list(range(3, 3 + n_pages)), list(range(30, 30 + n_pages))
    truth_k, truth_v, events, _ = transfer.gather_run(whole, None, src)
    assert events == ()
    ptrs = {(dev, k): pool[k].data_ptr() for dev, _, pool in transfer.pools_on(eng._paged_kv, layout) for k in "kv"}
    transfer.reset_counts()
    node = Node(n_pages * PSZ)
    assert tier.spill(node, src)
    for _dev, _span, pool in transfer.pools_on(eng._paged_kv, layout):
        for k in "kv":
            idx = torch.tensor(src)
            pool[k].index_copy_(2, idx, torch.randn(pool[k].index_select(2, idx).shape, generator=gen))
    tier.poll()
    assert tier.readmit_usable(node)
    assert torch.equal(node.host.k, truth_k) and torch.equal(node.host.v, truth_v)
    assert tuple(node.host.k.shape) == (2, 2, n_pages, PSZ, 32)
    assert tier.readmit(node, dst)
    for dev, (k0, k1), pool in transfer.pools_on(eng._paged_kv, layout):
        assert torch.equal(pool["k"].index_select(2, torch.tensor(dst)), truth_k[k0:k1]), dev
        assert torch.equal(pool["v"].index_select(2, torch.tensor(dst)), truth_v[k0:k1]), dev
    assert {(dev, k): pool[k].data_ptr() for dev, _, pool in transfer.pools_on(eng._paged_kv, layout)
            for k in "kv"} == ptrs
    assert tier.host_bytes_used == 0 and tier.host_tokens == 0
    moved = transfer.counts()
    assert moved["tier_copies"] == 2 + len(layout.devices)
    run_bytes = 2 * truth_k.numel() * truth_k.element_size()
    assert moved["tier_bytes"] == run_bytes * (1 + len(layout.devices) // 2)
    with pytest.raises(ValueError, match="page 0"):
        transfer.gather_run(eng._paged_kv, layout, [0, 5])


def _first_restored(eng_factory, snap, prompt):
    async def go():
        eng = eng_factory(snap)
        await eng.start()
        try:
            restored = eng.prefix_cache_stats()["spilled_nodes"]
            pf0 = prefill_total(eng)
            out = (await _drive(eng, [prompt]))[0]
            return restored, out, prefill_total(eng) - pf0, eng.prefix_cache_stats()["tier"]["readmits"]
        finally:
            await eng.aclose()

    return _run(go())


WRITERS = {
    "2x2": lambda snap: _tier_engine("2x2", snapshot=snap),
    "port": lambda snap: _tier_engine(snapshot=snap),
    "reference": lambda snap: _engine(REF, _config(JConfig, snapshot=snap)),
}


@pytest.mark.parametrize("writer,readers", [("2x2", ("port", "reference", "2x2")), ("port", ("2x2",)),
                                            ("reference", ("2x2",))], ids=["from_2x2", "from_port", "from_reference"])
def test_snapshots_restore_across_layouts_and_packages(tmp_path, writer, readers):
    """A snapshot written by an engine on 2 x 2 host devices restores in the
    unmeshed port engine, in the reference and on 2 x 2 again; one written
    unmeshed by either package restores on 2 x 2. Every reader restores the
    same runs, readmits, serves the writer's first output and prefills the
    same tokens for it (the warm-restart prefill ratio), fewer than cold."""
    src = str(tmp_path / "written.snap")

    async def write():
        eng = WRITERS[writer](src)
        await eng.start()
        prompts = tier_prompts(eng.tokenizer, 3)
        outs = await _drive(eng, prompts)
        await eng.aclose()
        return prompts, outs

    prompts, outs = _run(write())
    got = {}
    for reader in readers:
        snap = str(tmp_path / f"{reader}.snap")
        shutil.copy(src, snap)
        shutil.copy(src + ".npz", snap + ".npz")
        got[reader] = _first_restored(WRITERS[reader], snap, prompts[0])
    want = got.get("port") or _first_restored(WRITERS["port"], src, prompts[0])
    for reader, (restored, out, warm, readmits) in got.items():
        assert (restored, out, warm) == want[:3], reader
        assert restored >= 3 and readmits >= 1 and out == outs[0], reader
        assert warm < len(prompts[0]), reader


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_the_fingerprint_is_the_unmeshed_one_on_every_layout(quantize):
    """The weights' fingerprint (the snapshot's identity check) on host
    devices (``model=2``, 2 x 2), on a virtual 2 x 2 mesh (a shard-major
    tree) and unmeshed, float32 and int8: equal within 1e-6 relative, far
    inside the restore's 1e-3 (each leaf read once), where a per-device
    tree once gave none."""
    cfg = _config(MCPXConfig)
    mc = _model_cfg(cfg)
    meshes = {"unmeshed": None, "model2": _mesh("model2"), "2x2": _mesh("2x2"),
              "virtual_2x2": make_mesh(data=2, model=2, devices=["cpu"] * 4)}
    fps = {}
    for name, mesh in meshes.items():
        eng = InferenceEngine(cfg, model_cfg=mc, device="cpu", mesh=mesh)
        eng._layout = serve_layout(mesh, mc)
        eng._params, _ = load_or_init(mc, CKPT, device="cpu", quantize=quantize, mesh=mesh)
        assert isinstance(eng._params, transfer.OnCards) == (name in ("model2", "2x2"))
        fps[name] = eng._params_fingerprint()
    base = fps.pop("unmeshed")
    assert base is not None and base > 0
    for name, fp in fps.items():
        assert fp is not None and abs(fp - base) <= 1e-6 * base, (name, fp, base)


def test_a_seeded_chaos_profile_gives_the_unmeshed_counts_on_2x2():
    """The seeded chaos profile (host allocation failures, copy-latency
    spikes that never end under a frozen clock) on 2 x 2 host devices, 8
    prompts x 3 rounds: the unmeshed engine's tokens and counters, faults
    counted."""
    chaos = json.dumps(CHAOS)
    want = _run(_stream(_tier_engine(chaos=chaos), n_prompts=8))
    got = _run(_stream(_tier_engine("2x2", chaos=chaos), n_prompts=8))
    assert got[0] == want[0] and got[1] == want[1]
    assert got[1]["chaos_alloc_failures"] > 0 and got[1]["destructive_evictions"] > 0


def test_aclose_with_spills_in_flight_on_2x2_leaves_no_host_bytes(tmp_path):
    """A 2 x 2 engine closed right after its spills: the snapshot is written,
    every copy in flight completed or dropped, no host byte or token left."""
    snap = str(tmp_path / "kv.snap")

    async def go():
        eng = _tier_engine("2x2", snapshot=snap)
        await eng.start()
        await _drive(eng, tier_prompts(eng.tokenizer, 8))
        tier = eng._spill_tier
        assert tier.spills > 0
        await eng.aclose()
        return eng, tier

    eng, tier = _run(go())
    assert eng.state == "closed" and tier.pending_copies() == 0
    assert tier.host_tokens == 0 and tier.host_bytes_used == 0
    assert os.path.exists(snap) and json.load(open(snap))["fingerprint"] is not None
