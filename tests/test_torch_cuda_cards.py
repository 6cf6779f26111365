"""The cross-card half of the parallel package on two or more cards of one
host: the ragged kernel launched on another card than the calling
thread's, the capture question (what a CUDA graph captured on one card
makes of work on a second), a ``data=2, model=2`` forward on four cards bit
for bit against the same mesh shape virtual on card 0, a radix-shared page
read from the other data replica, engines on two cards (ring prefill over
them, int8 weights, a mesh built from explicit axes), retrieval row shards,
the ring and data-parallel training on cards. They import neither JAX nor the reference
package:

    python -m pytest tests/test_torch_cuda_cards.py -q --noconftest

With fewer than two cards every test skips (four for the 2 x 2 forward)."""

import asyncio
import dataclasses
import os
import random
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from mcpx_torch.engine.kernels import paged_attention as tk

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "mcpx", "models", "checkpoints",
                    "planner_test_bpe.npz")


def _need(n: int) -> list[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} NVIDIA cards of one host, {have} visible")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.fixture
def cards():
    return _need(2)


def _case(seed, dev, B=8, S=5, K=2, G=4, hd=64, psz=16, p_max=4, dtype=torch.float32):
    rng = random.Random(seed)
    gen = torch.Generator().manual_seed(seed)
    n_pages = B * p_max + 1
    q = torch.randn((B, S, K, G, hd), generator=gen).to(dtype)
    kp = torch.randn((K, 2, n_pages, psz, hd), generator=gen).to(dtype)
    vp = torch.randn((K, 2, n_pages, psz, hd), generator=gen).to(dtype)
    pages = list(range(1, n_pages))
    rng.shuffle(pages)
    table = torch.tensor(pages[: B * p_max], dtype=torch.int32).reshape(B, p_max)
    q_lens = torch.tensor([S, 1, 3, 0, 2, S, 1, 4][:B], dtype=torch.int32)
    starts = torch.tensor([rng.randint(0, p_max * psz - S - 1) for _ in range(B)], dtype=torch.int32)
    return [t.to(dev) for t in (q, kp, vp, table, starts, q_lens)]


@pytest.mark.cuda
def test_the_kernel_launches_on_card_1_from_a_thread_on_card_0(cards):
    """A worker thread whose current device is card 0 launches the kernel
    over card 1's tensors: the launch lands on card 1 (its count there),
    agrees with the plain version on card 1 within 2e-5 in float32, gives
    exact zeros past each row's length, and leaves the thread on card 0 and
    every ticket buffer at 0."""
    args = _case(0, cards[1])
    seen = {}

    def worker():
        torch.cuda.set_device(0)
        n0 = tk.launches_by_card().get(1, 0)
        out = tk.ragged_paged_attention(*args, 1)
        torch.cuda.synchronize(cards[1])
        seen.update(out=out, launched=tk.launches_by_card().get(1, 0) - n0, device=torch.cuda.current_device())

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    out = seen["out"]
    assert out.device == cards[1] and seen["launched"] == 1 and seen["device"] == 0
    ref = tk.ragged_paged_attention_reference(*args, 1)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=2e-5, atol=2e-5)
    for b, ql in enumerate(args[5].tolist()):
        assert bool((out[b, ql:] == 0).all())
    assert all(int(t.abs().sum()) == 0 for t in tk.ticket_counters())


_CAPTURE_PROBE = r"""
import sys
import torch

how = sys.argv[1]
c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
x = torch.randn(1024, device=c0)


def work():
    if how == "fork":
        # The capturing stream forks onto a stream of card 1 through an
        # event, and joins it back the same way.
        side = streams[1]
        side.wait_stream(torch.cuda.current_stream(c0))
        with torch.cuda.stream(side):
            y = (x * 2).to(c1, non_blocking=True)
            blocks.append(y.data_ptr())
            z = (y * 3).to(c0, non_blocking=True)
        torch.cuda.current_stream(c0).wait_stream(side)
        return z + 1
    # A peer copy as the forward issues it: card 1's current stream.
    y = (x * 2).to(c1, non_blocking=True)
    return (y * 3).to(c0, non_blocking=True) + 1


streams, blocks = {1: torch.cuda.Stream(c1)}, []
want = work()
blocks.clear()
torch.cuda.synchronize(c0)
torch.cuda.synchronize(c1)
graph, s0 = torch.cuda.CUDAGraph(), torch.cuda.Stream(c0)
s0.wait_stream(torch.cuda.current_stream(c0))
try:
    with torch.cuda.stream(s0):
        graph.capture_begin()
        try:
            out = work()
        finally:
            graph.capture_end()
except Exception as e:
    print("capture=" + type(e).__name__ + ": " + str(e).splitlines()[0][:160])
    sys.exit(0)
# Card 1's blocks that the capture used: the graph's memory pool is card
# 0's, so card 1's allocator hands them to the next allocation there.
later = torch.empty(1024, device=c1)
reused = later.data_ptr() in blocks
x.copy_(torch.randn(1024, device=c0))
want = (x * 2 * 3) + 1
graph.replay()
torch.cuda.synchronize(c0)
torch.cuda.synchronize(c1)
print("capture=ok|card1_block_reused=" + str(reused) + "|replay_equal=" + str(bool(torch.equal(out, want))))
"""


@pytest.mark.cuda
def test_what_a_capture_on_card_0_makes_of_work_on_card_1(cards):
    """The capture question, each probe in a process of its own: a capture
    on card 0 whose stream forks onto a stream of card 1 through events and
    joins back (``fork``), and one that issues the peer copies as the
    sharded forward issues them, on card 1's current stream (``peer_copy``).
    Where a probe captures, its replay equals the eager result, and the
    probe prints whether card 1's allocator hands a block the capture used
    to the next allocation there (the graph's memory pool is the capturing
    card's alone). The engine runs the windows of a mesh of cards eagerly:
    its forward's copies are of the second kind, and a window that forked
    would leave its blocks on the other cards to later work while its
    replays still write them."""
    seen = {}
    for how in ("fork", "peer_copy"):
        proc = subprocess.run([sys.executable, "-c", _CAPTURE_PROBE, how], capture_output=True, text=True,
                              timeout=120)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("capture=")]
        seen[how] = lines[0] if lines else f"died rc={proc.returncode}: {proc.stderr[-300:]}"
    print(f"capture question: {seen}")
    for how, line in seen.items():
        assert not line.startswith("died"), (how, line)
        if line.startswith("capture=ok"):
            assert line.endswith("replay_equal=True") and "card1_block_reused=" in line, (how, line)


@pytest.mark.cuda
def test_a_2x2_forward_on_four_cards_is_bit_equal_to_the_virtual_mesh():
    """The test preset in float32 (random weights from seed 3), GQA with
    two KV heads so that each model shard writes its own: one ragged decode
    forward on a ``data=2, model=2`` mesh of cards 0-3 against the same
    mesh shape virtual on card 0: logits and every card's pools (each data
    replica of its KV heads) bit for bit, ``n_layers`` launches on each
    card, and the same transfers on both meshes."""
    cards4 = _need(4)
    from mcpx_torch.engine.kv_cache import init_paged_kv
    from mcpx_torch.engine.paged_decode import decode_chunk_paged
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.models.gemma.params import load_or_init
    from mcpx_torch.parallel import transfer
    from mcpx_torch.parallel.mesh import ServeLayout, make_mesh

    cfg = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072), n_kv_heads=2, dtype="float32")
    B, S, psz, p_max = 8, 5, 16, 4
    q, kp, vp, table, starts, q_lens = _case(3, cards4[0], B=B, S=S, K=2, G=2, hd=32, psz=psz, p_max=p_max)
    kp = torch.randn((2, cfg.n_layers) + tuple(kp.shape[2:]), generator=torch.Generator().manual_seed(4)).to(cards4[0])
    vp = kp.flip(0).clone()
    tokens = torch.randint(0, 3072, (B, S), generator=torch.Generator().manual_seed(5)).to(cards4[0])
    res = {}
    for arm, devices in (("virtual", [cards4[0]] * 4), ("cards", cards4)):
        layout = ServeLayout(make_mesh(data=2, model=2, devices=devices), cfg)
        assert layout.kv_split and layout.cross == (arm == "cards")
        params, _ = load_or_init(cfg, seed=3, device=cards4[0], mesh=layout.mesh)
        paged = init_paged_kv(cfg, kp.shape[2], psz, cards4[0], layout=layout)
        for dev, t in transfer.trees(paged, layout).items():
            k0, k1 = layout.kv_range(dev)
            t["k"].copy_(kp[k0:k1])
            t["v"].copy_(vp[k0:k1])
        transfer.reset_counts()
        before = tk.launches_by_card()
        logits, paged = decode_chunk_paged(params, cfg, tokens, starts, table, paged,
                                           logits_at=(q_lens.long() - 1).clamp(min=0), q_lens=q_lens, layout=layout)
        for d in cards4:
            torch.cuda.synchronize(d)
        after = tk.launches_by_card()
        res[arm] = (layout, logits, paged, transfer.counts(), {i: after.get(i, 0) - before.get(i, 0) for i in after})
    (_, v_logits, v_paged, v_counts, _), (layout, c_logits, c_paged, c_counts, c_by) = res["virtual"], res["cards"]
    assert torch.equal(c_logits, v_logits)
    for dev, t in transfer.trees(c_paged, layout).items():
        k0, k1 = layout.kv_range(dev)
        for k in ("k", "v"):
            assert torch.equal(t[k].to(cards4[0]), v_paged[k][k0:k1]), (dev, k)
    assert {i: n for i, n in c_by.items() if n} == {i: cfg.n_layers for i in range(4)}
    assert c_counts == v_counts and c_counts["forwards"] == 1 and c_counts["transfers"] > 0


def _engine_cfg(prefix_cache=True, quantize="none", **engine):
    from mcpx_torch.core.config import MCPXConfig

    return MCPXConfig.from_dict({
        "model": {"size": "test", "vocab": "bpe", "max_seq_len": 512, "checkpoint_path": CKPT, "quantize": quantize},
        "engine": {"max_batch_size": 4, "kv_page_size": 16, "max_pages_per_seq": 8, "max_decode_len": 24,
                   "temperature": 0.0, "prefix_cache": prefix_cache, **engine},
        "planner": {"kind": "llm"},
    })


@pytest.mark.cuda
def test_a_radix_shared_page_is_read_from_the_other_data_replica(cards):
    """A ``data=2`` engine over cards 0-1 (float32, the committed
    checkpoint, prefix cache on): a prompt served alone (row 0, data
    coordinate 0) builds tree pages; three prompts that share its head then
    take rows 0-2, so row 2 (data coordinate 1) reads those pages from card
    1's pools. Every token equals the unmeshed engine's, the tree was hit,
    the two replicas' pools are byte for byte equal on every page a row can
    read (every write mirrored; page 0, the null page, takes the writes of
    idle rows and pad slots, several in one scatter, whichever lands last,
    and nothing reads it), and the windows ran eagerly with nothing
    captured."""
    from mcpx_torch.engine.engine import InferenceEngine
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.parallel import transfer
    from mcpx_torch.parallel.mesh import make_mesh

    model_cfg = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072, max_seq_len=512), dtype="float32")
    rng = random.Random(0)
    head = [rng.randrange(3, 3000) for _ in range(40)]
    tails = [[rng.randrange(3, 3000) for _ in range(5 + i)] for i in range(3)]

    async def serve(mesh):
        eng = InferenceEngine(_engine_cfg(), model_cfg=model_cfg, device=cards[0], mesh=mesh)
        await eng.start()
        try:
            first = await eng.generate(head + [7, 8], constrained=False)
            rest = await asyncio.gather(*(eng.generate(head + t, constrained=False) for t in tails))
            stats, pools = eng.queue_stats(), eng._paged_kv
            copies = None
            if mesh is not None:
                for d in cards:
                    torch.cuda.synchronize(d)
                copies = {str(d): {k: t[k].to(cards[0]) for k in ("k", "v")}
                          for d, t in transfer.trees(pools, eng._layout).items()}
            return [first.token_ids] + [r.token_ids for r in rest], stats, eng.prefix_cache_stats(), copies
        finally:
            await eng.aclose()

    want, _, _, _ = asyncio.run(serve(None))
    got, stats, prefix, copies = asyncio.run(serve(make_mesh(data=2, devices=cards[:2])))
    assert got == want
    assert prefix["hits"] > 0
    assert stats["captures"] == stats["warmup_captures"] == stats["replays"] == 0 and stats["eager_windows"] > 0
    a, b = copies.values()
    differing = {k: sorted({int(p) for p in (a[k] != b[k]).nonzero()[:, 2].tolist()}) for k in ("k", "v")}
    print(f"pages differing between the replicas: {differing}")
    assert all(torch.equal(a[k][:, :, 1:], b[k][:, :, 1:]) for k in ("k", "v")), differing


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["ring", "int8", "axes"])
def test_an_engine_on_two_cards_serves_the_unmeshed_tokens(cards, arm):
    """An engine over cards 0-1 (float32, the committed checkpoint, prefix
    cache on) against the unmeshed engine on card 0, a prompt alone and
    then three sharing its head: every token equal, the windows eager.
    ``ring``: ``data=2`` with ``ring_prefill_min_tokens=32``, so its full
    prefills ring over the two cards viewed as a seq axis
    (``ring_prefill`` with the layout's model shards around it, the dense
    caches and pools on both cards); ``int8``: ``model=2`` with int8
    weights (each card its shard's codes and scales) against the unmeshed
    int8 engine; ``axes``: no mesh given and ``engine.data_axis=2``,
    ``model_axis=1``, so the engine builds its mesh over cards 0-1."""
    from mcpx_torch.engine.engine import InferenceEngine
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.parallel.mesh import make_mesh

    model_cfg = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072, max_seq_len=512), dtype="float32")
    rng = random.Random(1)
    head = [rng.randrange(3, 3000) for _ in range(40)]
    tails = [[rng.randrange(3, 3000) for _ in range(5 + i)] for i in range(3)]
    kw = {"ring": dict(ring_prefill_min_tokens=32), "int8": dict(quantize="int8"),
          "axes": dict(data_axis=2, model_axis=1)}[arm]
    mesh = {"ring": make_mesh(data=2, devices=cards[:2]), "int8": make_mesh(model=2, devices=cards[:2]),
            "axes": None}[arm]

    async def serve(meshed):
        cfg = _engine_cfg(**(kw if meshed else {k: v for k, v in kw.items() if k == "quantize"}))
        eng = InferenceEngine(cfg, model_cfg=model_cfg, device=cards[0], mesh=mesh if meshed else None)
        await eng.start()
        try:
            first = await eng.generate(head + [7, 8], constrained=False)
            rest = await asyncio.gather(*(eng.generate(head + t, constrained=False) for t in tails))
            return ([first.token_ids] + [r.token_ids for r in rest], eng.queue_stats(),
                    eng.metrics.ring_prefills._only().value, eng._mesh.distinct_devices(), eng._layout)
        finally:
            await eng.aclose()

    want, _, _, _, _ = asyncio.run(serve(False))
    got, stats, rings, devices, layout = asyncio.run(serve(True))
    print(f"{arm}: devices {devices}, ring prefills {rings}, eager windows {stats['eager_windows']}")
    assert got == want
    assert devices == cards[:2] and layout.cross
    assert stats["captures"] == stats["replays"] == 0 and stats["eager_windows"] > 0
    assert (rings > 0) == (arm == "ring")


@pytest.mark.cuda
def test_the_kv_tier_is_refused_on_a_mesh_of_cards(cards):
    """The KV tier's copies and snapshots run on one card's pools: an engine
    on a mesh of cards with the tier on fails its start by name."""
    from mcpx_torch.core.errors import EngineError
    from mcpx_torch.engine.engine import InferenceEngine
    from mcpx_torch.parallel.mesh import make_mesh

    cfg = _engine_cfg(kv_tier={"enabled": True})
    eng = InferenceEngine(cfg, device=cards[0], mesh=make_mesh(data=2, devices=cards[:2]))
    with pytest.raises(EngineError, match="kv_tier"):
        asyncio.run(eng.start())


@pytest.mark.cuda
def test_retrieval_row_shards_rank_on_their_cards(cards):
    """A device table of 3,000 rows on a ``model=2`` mesh of cards 0-1: one
    row shard on each card, and every shortlist equal to the unmeshed
    index's."""
    from mcpx_torch.core.config import RetrievalConfig
    from mcpx_torch.parallel.mesh import make_mesh
    from mcpx_torch.registry.memory import InMemoryRegistry
    from mcpx_torch.retrieval.index import RetrievalIndex, RowShards
    from mcpx_torch.utils.synth import intent_for, synth_registry

    async def go():
        registry, records = InMemoryRegistry(), synth_registry(3000, seed=1)
        for rec in records:
            await registry.put(rec)
        plain = RetrievalIndex(RetrievalConfig(compute="device"), device=cards[0])
        meshed = RetrievalIndex(RetrievalConfig(compute="device"), device=cards[0],
                                mesh=make_mesh(model=2, devices=cards[:2]))
        for index in (plain, meshed):
            await index.refresh(registry)
        rng = random.Random(1)
        intents = [intent_for(records, rng) for _ in range(16)]
        assert isinstance(meshed._table, RowShards)
        assert [p.device for p in meshed._table.parts] == cards[:2]
        for intent in intents:
            assert await meshed.shortlist(intent, 24) == await plain.shortlist(intent, 24)

    asyncio.run(go())


@pytest.mark.cuda
def test_the_ring_over_cards_matches_dense(cards):
    """Ring attention on a ``seq`` mesh of two cards (one hop a peer copy)
    against the dense ``_attend`` on card 0, float32 within 2e-5."""
    from mcpx_torch.models.gemma.model import _attend
    from mcpx_torch.parallel.mesh import make_mesh
    from mcpx_torch.parallel.ring_attention import ring_attention

    gen = torch.Generator().manual_seed(0)
    B, T, K, G, hd = 2, 256, 1, 4, 64
    q = torch.randn((B, T, K, G, hd), generator=gen).to(cards[0])
    k = torch.randn((B, T, K, hd), generator=gen).to(cards[0])
    v = torch.randn((B, T, K, hd), generator=gen).to(cards[0])
    lens = torch.tensor([T, 37], device=cards[0])
    pos = torch.arange(T, device=cards[0])
    mask = (pos[None, None, :] <= pos[None, :, None]) & (pos[None, None, :] < lens[:, None, None])
    want = _attend(q, k, v, mask)
    got = ring_attention(q, k, v, lens, make_mesh(seq=2, devices=cards[:2]))
    valid = pos[None, :] < lens[:, None]
    np.testing.assert_allclose(got[valid].cpu().numpy(), want[valid].cpu().numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_data_parallel_training_on_two_cards_matches_one(cards):
    """The test preset in float32 from the committed checkpoint, 4 steps at
    batch 8 on a ``data=2`` mesh of cards 0-1 (a replica on card 1, its
    gradients summed on card 0) against no mesh: every loss within 1e-5
    relative, the parameters within the card training test's 1e-4 (the
    embedding's backward adds with atomics, so no two runs are bit for
    bit)."""
    from mcpx_torch.models.bpe import BPETokenizer
    from mcpx_torch.models.corpus import CorpusConfig, build_corpus_sync
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.models.gemma.params import load_npz
    from mcpx_torch.models.train import TrainConfig, flatten_params, train
    from mcpx_torch.parallel.mesh import make_mesh

    corpus = build_corpus_sync(BPETokenizer(), CorpusConfig(n_examples=48, registry_size=60, seed=0),
                               device=cards[0])
    tcfg = TrainConfig(steps=4, batch_size=8, lr=3e-3, warmup_steps=1, log_every=1)
    runs = []
    for mesh in (None, make_mesh(data=2, devices=cards[:2])):
        params, report = train(GemmaConfig.named("test", vocab_size=BPETokenizer().vocab_size), corpus, tcfg,
                               device=cards[0], init=load_npz(CKPT, "cpu", torch.float32), mesh=mesh)
        runs.append((flatten_params(params), [x for _, x in report["loss_log"]]))
    (p0, l0), (p1, l1) = runs
    assert len(l0) == len(l1) == 4
    assert max(abs(a - b) / abs(b) for a, b in zip(l1, l0)) <= 1e-5
    assert max(float((p1[k] - p0[k]).abs().max()) for k in p0) <= 1e-4
