"""Item 5c's cross-device half of the parallel package on the CPU
(``mcpx_torch/parallel/transfer.py``): what crosses between the coordinates
of a serving mesh, counted on virtual meshes (every copy there is the
tensor itself, and each move between two coordinates counts as the same
mesh of cards copies it), against the count worked out from the layout; the
placement of a parameter tree on a mesh of ``cpu`` and ``meta`` coordinates
against the reference's ``NamedSharding.devices_indices_map`` on its
8-device CPU mesh, block by block; the KV homes of a write; and the
refusals that stay. The cross-card runs themselves need two or more cards
(``tests/test_torch_cuda_cards.py``)."""

import asyncio
import dataclasses
import math
import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.models.gemma.model import init_params as jinit_params
from mcpx.parallel import mesh as jmesh
from mcpx_torch.core.errors import EngineError
from mcpx_torch.engine.paged_decode import decode_chunk_paged
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import forward, init_kv_cache, param_shapes
from mcpx_torch.models.gemma.params import load_or_init, params_from_numpy
from mcpx_torch.parallel import mesh as tmesh
from mcpx_torch.parallel import transfer
from mcpx_torch.parallel.mesh import ServeLayout, make_mesh

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(cfg, B, S, p_max, psz, seed=0):
    rng = np.random.default_rng(seed)
    n_pages = B * p_max + 1
    shape = (cfg.n_kv_heads, cfg.n_layers, n_pages, psz, cfg.head_dim)
    pools = {"k": torch.from_numpy(rng.standard_normal(shape, np.float32)),
             "v": torch.from_numpy(rng.standard_normal(shape, np.float32))}
    table = torch.from_numpy((rng.permutation(n_pages - 1)[: B * p_max] + 1).astype(np.int32).reshape(B, p_max))
    positions = torch.from_numpy(rng.integers(0, p_max * psz - S, B).astype(np.int32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))
    q_lens = torch.from_numpy(np.asarray([S, 1, 2, 0][:B], np.int32))
    return tokens, positions, table, q_lens, pools


def _expected_decode(layout, cfg, B, S, p_max):
    """Transfers and bytes of one ragged decode forward with ``logits_at``,
    worked out from the layout: per row block ``d`` (reducing coordinate
    ``(d, 0)``, control ``(0, 0)``) the packed inputs once to every other
    coordinate that reads them; per layer the normed activations out to the
    other attention shards and their partial outputs back, the KV writes to
    every data replica of their heads, the MLP's the same way; the
    embedding's rows in from the other vocabulary shards, the final
    activations out to them and every shard's logits to the control card."""
    elt = 4  # float32
    D, hd, V, L = cfg.d_model, cfg.head_dim, cfg.vocab_size, cfg.n_layers
    n_attn, n_ff, n_vocab = len(layout.attn), layout.n_ff, layout.n_vocab
    n, nbytes = 0, 0
    for d, (r0, r1) in enumerate(layout.rows(B)):
        b = r1 - r0
        readers = {(d, 0)} | {(d, m) for m in range(max(n_vocab, n_attn))}
        readers |= {(e, a) for e in range(layout.data) for a in range(n_attn)}
        readers.discard((0, 0))
        packed = 4 * (2 * b * S + 3 * b + b * p_max)  # tokens, positions, start, q_lens, logits_at, table
        n, nbytes = n + len(readers), nbytes + len(readers) * packed
        act = b * S * D * elt
        n, nbytes = n + (n_vocab - 1), nbytes + (n_vocab - 1) * act  # embedding rows in
        for _ in range(L):
            n, nbytes = n + 2 * (n_attn - 1), nbytes + 2 * (n_attn - 1) * act  # h out, parts back
            n, nbytes = n + 2 * (n_ff - 1), nbytes + 2 * (n_ff - 1) * act
            if layout.kv_split:
                moves = [(a.kv[1] - a.kv[0]) for a in layout.attn for e in range(layout.data) if e != d]
            else:
                moves = [(a.kv[1] - a.kv[0]) for i, a in enumerate(layout.attn) for e in range(layout.data)
                         if (e, i) != (d, 0)]
            n, nbytes = n + 2 * len(moves), nbytes + sum(2 * b * S * k * hd * elt for k in moves)
        n, nbytes = n + (n_vocab - 1), nbytes + (n_vocab - 1) * b * D * elt  # final activations out
        logits = [(d, m) for m in range(n_vocab) if (d, m) != (0, 0)]
        n, nbytes = n + len(logits), nbytes + len(logits) * b * (V // n_vocab) * 4
    return n, nbytes


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_decode_forward_transfers_equal_the_layouts_count(shape):
    """At the test preset in float32, one ragged decode forward (decode,
    drafted and idle rows, one logit row each) on a virtual mesh moves the
    transfers and bytes worked out from its layout, counts one forward,
    and gives the unmeshed forward's logits and pools."""
    cfg = dataclasses.replace(GemmaConfig.named("test", vocab_size=384), dtype="float32")
    B, S, p_max, psz = 4, 3, 3, 8
    mesh = make_mesh(data=shape[0], model=shape[1], devices=CPU8)
    layout = ServeLayout(mesh, cfg)
    assert len(layout.attn) == shape[1] and len(layout.rows(B)) == shape[0] and not layout.cross
    plain, _ = load_or_init(cfg, seed=4, device="cpu")
    meshed, _ = load_or_init(cfg, seed=4, mesh=mesh, device="cpu")
    tokens, positions, table, q_lens, pools = _case(cfg, B, S, p_max, psz)
    at = (q_lens.long() - 1).clamp(min=0)
    outs = []
    for params, lay in ((plain, None), (meshed, layout)):
        pk = {k: v.clone() for k, v in pools.items()}
        transfer.reset_counts()
        logits, pk = decode_chunk_paged(params, cfg, tokens, positions, table, pk, logits_at=at, q_lens=q_lens,
                                        layout=lay)
        outs.append((transfer.counts(), logits, pk))
    (none, *_), (got, *_) = outs
    assert none == {"forwards": 0, "transfers": 0, "bytes": 0, "tier_copies": 0, "tier_bytes": 0}
    want = _expected_decode(layout, cfg, B, S, p_max)
    assert (got["forwards"], got["transfers"], got["bytes"]) == (1, *want)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        a, b = (a, b) if isinstance(a, torch.Tensor) else (torch.cat([a["k"], a["v"]]), torch.cat([b["k"], b["v"]]))
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


def test_dense_forward_counts_one_forward_and_mirrors_every_row():
    """A dense prefill on a virtual 2 x 2 mesh: one sharded forward whose
    rows of both data blocks land in the one cache, equal to the unmeshed
    prefill's cache."""
    cfg = GemmaConfig(vocab_size=384, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                      dtype="float32")
    mesh = make_mesh(data=2, model=2, devices=CPU8)
    layout = ServeLayout(mesh, cfg)
    assert layout.kv_split and [h for _, h, _ in transfer.homes(layout, 1)] == [(1, 2)] * 2
    B, T = 4, 5
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 384, (B, T)))
    positions = torch.arange(T).expand(B, T)
    mask = (torch.arange(T)[None, None, :] <= positions[:, :, None])
    plain, _ = load_or_init(cfg, seed=5, device="cpu")
    meshed, _ = load_or_init(cfg, seed=5, mesh=mesh, device="cpu")
    caches = []
    for params, lay in ((plain, None), (meshed, layout)):
        transfer.reset_counts()
        cache0 = init_kv_cache(cfg, B, T, device="cpu")
        logits, cache = forward(params, cfg, tokens, positions, cache0, mask, layout=lay)
        caches.append((transfer.counts()["forwards"], logits, cache))
    assert caches[0][0] == 0 and caches[1][0] == 1
    np.testing.assert_allclose(caches[1][1].numpy(), caches[0][1].numpy(), rtol=1e-5, atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(caches[1][2][k].numpy(), caches[0][2][k].numpy(), rtol=1e-5, atol=1e-5)


def test_homes_write_each_device_once_and_send_to_every_replica():
    """MQA on a virtual 2 x 2 mesh: the one KV head is projected once and
    sent to all four coordinates' pools, written once (one device)."""
    cfg = GemmaConfig.named("test")
    layout = ServeLayout(make_mesh(data=2, model=2, devices=CPU8), cfg)
    assert not layout.kv_split
    homes = transfer.homes(layout, None)
    assert [c for c, _, _ in homes] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert [fresh for _, _, fresh in homes] == [True, False, False, False]
    assert all(h == (0, 1) for _, h, _ in homes)
    assert layout.kv_range(torch.device("cpu")) == (0, 1) and layout.control == torch.device("cpu")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("preset", ["test", "7b"])
def test_params_placed_on_cpu_and_meta_match_the_reference_blocks(preset, shape):
    """Each model coordinate on a device of its own (``cpu`` for model 0,
    ``meta`` for model 1): every leaf's block on a device is the slice the
    reference's ``NamedSharding`` gives the device at that coordinate, and
    the ``cpu`` blocks hold the reference's values."""
    data, model = shape
    devices = [["cpu", "meta"][m] for _ in range(data) for m in range(model)]
    tm_ = make_mesh(data=data, model=model, devices=devices)
    jm = jmesh.make_mesh(data=data, model=model)
    small = dict(n_layers=1, vocab_size=64) if preset == "7b" else {}
    jcfg = dataclasses.replace(JGemmaConfig.named(preset), **small, dtype="float32")
    cfg = dataclasses.replace(GemmaConfig.named(preset), **small, dtype="float32")
    jp = jinit_params(jcfg, jax.random.PRNGKey(0)) if preset == "test" else None
    if jp is not None:
        params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    else:  # 7b's widths: every leaf a broadcast view, no memory behind it
        shapes = param_shapes(cfg)
        params = {k: torch.zeros(()).expand(shapes[k]) for k in ("embed", "final_norm")}
        params["layers"] = {k: torch.zeros(()).expand(v) for k, v in shapes.items() if k not in params}
    placed = tmesh.shard_pytree(params, tmesh.param_pspecs(cfg, tm_), tm_)
    jspecs = jmesh.param_pspecs(jcfg, jm)

    def leaves(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    flat, jflat, src = leaves(placed), leaves(jspecs), leaves(params)
    checked = 0
    for path, got in flat.items():
        shape_ = tuple(src[path].shape)
        want = NamedSharding(jm, jflat[path]).devices_indices_map(shape_)
        assert isinstance(got, tmesh.Sharded) and set(got.blocks) == {torch.device("cpu"), torch.device("meta")}
        for coord in np.ndindex(*jm.devices.shape):
            box, part = got.blocks[tm_.devices[coord]]
            jbox = want[jm.devices[coord]]
            assert [s.indices(n) for s, n in zip(box, shape_)] == [s.indices(n) for s, n in zip(jbox, shape_)]
            assert tuple(part.shape) == tuple(len(range(*s.indices(n))) for s, n in zip(jbox, shape_))
            if part.device.type == "cpu" and jp is not None:
                np.testing.assert_array_equal(part.numpy(), np.asarray(_at(jp, path))[tuple(jbox)])
            checked += 1
    assert checked == len(flat) * math.prod(shape)


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_entry_points_refuse_a_mesh_whose_first_coordinate_is_elsewhere():
    """The control card is the mesh's first coordinate: weights made on
    another device are refused by name."""
    cfg = GemmaConfig(vocab_size=384, d_model=64, n_layers=1, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                      dtype="float32")
    with pytest.raises(EngineError, match="is not the device the weights are made on"):
        load_or_init(cfg, seed=0, device="meta", mesh=make_mesh(model=2, devices=CPU8))


def test_phase_27_claims_nothing_without_two_cards(capsys):
    """``chip_smoke.py``'s phase 27 on a machine with fewer than two cards
    (none here) prints that it did not run and passes nothing; asked for
    more cards than are visible (``--cards``), it fails."""
    import json
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    assert chip_smoke.cross_card_phase("cpu") == {"ran": False, "launches": 0}
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "cross_card" and line["ran"] is False and line["cards_visible"] == 0
    with pytest.raises(SystemExit, match="--cards asks for 2"):
        chip_smoke.cross_card_phase("cpu", need=2)


# Distinct host devices: every copy between them is a real one, as between
# cards, so the cross-device code (``transfer.OnCards`` trees, per-device
# pools and caches, mirrored KV writes, the per-device commit, the joined
# embedding, ring hops and training replicas) runs here.
HOST4 = [torch.device("cpu", i) for i in range(4)]


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)], ids=["2x2", "1x2", "2x1"])
def test_a_forward_on_host_devices_is_bit_equal_to_the_virtual_mesh(shape, quantize):
    """The test preset in float32 (GQA with two KV heads on 2 x 2, so each
    model shard writes its own), random weights from seed 6: one ragged
    decode forward, one dense prefill committed to the pools, and the
    drafter's joined embedding on a mesh of distinct host devices against
    the same mesh shape virtual on the CPU: logits, every device's pools
    and dense cache (each data replica of its KV heads) and the embedding
    bit for bit, each device holding only its shard, and the decode
    forward's transfers equal."""
    from mcpx_torch.engine.kv_cache import commit_prefill_to_pages, init_paged_kv
    from mcpx_torch.models.gemma.model import prefill, whole_embed

    data, model = shape
    cfg = dataclasses.replace(GemmaConfig.named("test", vocab_size=384), n_kv_heads=2 if shape == (2, 2) else 1,
                              dtype="float32")
    B, S, p_max, psz, T = 4, 3, 3, 8, 16
    tokens, positions, table, q_lens, pools = _case(cfg, B, S, p_max, psz, seed=6)
    prompt = torch.from_numpy(np.random.default_rng(7).integers(0, 384, (B, T)))
    lens = torch.tensor([T, T - 3, 5, T - 1])
    res = {}
    for arm, devices in (("virtual", CPU8), ("host", HOST4)):
        layout = ServeLayout(make_mesh(data=data, model=model, devices=devices), cfg)
        assert layout.cross == (arm == "host")
        params, _ = load_or_init(cfg, seed=6, quantize=quantize, mesh=layout.mesh, device="cpu")
        paged = init_paged_kv(cfg, pools["k"].shape[2], psz, "cpu", layout=layout)
        for dev, t in transfer.trees(paged, layout).items():
            k0, k1 = layout.kv_range(dev)
            for k in ("k", "v"):
                t[k].copy_(pools[k][k0:k1])
        transfer.reset_counts()
        logits, paged = decode_chunk_paged(params, cfg, tokens, positions, table, paged,
                                           logits_at=(q_lens.long() - 1).clamp(min=0), q_lens=q_lens, layout=layout)
        counts = transfer.counts()
        dense_logits, dense = prefill(params, cfg, prompt, lens, init_kv_cache(cfg, B, T, layout=layout, device="cpu"),
                                      last_only=True, layout=layout)
        commit_prefill_to_pages(paged, dense, table, lens, psz, layout=layout)
        res[arm] = dict(layout=layout, params=params, logits=logits, dense_logits=dense_logits, paged=paged,
                        dense=dense, counts=counts, embed=whole_embed(params, layout))
    v, h = res["virtual"], res["host"]
    layout = h["layout"]
    assert isinstance(h["params"], transfer.OnCards) and len(h["params"].trees) == data * model
    with pytest.raises(TypeError):
        h["params"]["embed"]  # noqa: B018 - a reader that does not know of devices fails
    assert torch.equal(h["logits"], v["logits"]) and torch.equal(h["dense_logits"], v["dense_logits"])
    for dev in layout.devices:
        k0, k1 = layout.kv_range(dev)
        for k in ("k", "v"):
            assert torch.equal(transfer.trees(h["paged"], layout)[dev][k], v["paged"][k][k0:k1]), (dev, k)
            assert torch.equal(transfer.trees(h["dense"], layout)[dev][k], v["dense"][k][..., k0:k1, :]), (dev, k)
    ve, he = v["embed"], h["embed"]
    assert all(torch.equal(he[k], ve[k]) for k in ve) if quantize == "int8" else torch.equal(he, ve)
    assert h["counts"] == v["counts"] and h["counts"]["forwards"] == 1


async def _host_serve(mesh, model_cfg, quantize: str = "none", **engine):
    from mcpx_torch.core.config import MCPXConfig
    from mcpx_torch.engine.engine import InferenceEngine

    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 512, "quantize": quantize},
        "engine": {"use_pallas": False, "max_batch_size": 4, "max_decode_len": 24, "kv_page_size": 16,
                   "max_pages_per_seq": 16, "temperature": 0.0, **engine},
    })
    eng = InferenceEngine(cfg, model_cfg=model_cfg, device="cpu", mesh=mesh)
    await eng.start()
    try:
        tok = eng.tokenizer
        head = tok.encode("intent 0: fetch the user record, then enrich it and store the result. " * 2)
        first = await eng.generate(head + tok.encode(" JSON:"), max_new_tokens=16, shared_prefix_len=32)
        rest = await asyncio.gather(*(eng.generate(head + tok.encode(f" step {i}. JSON:"), max_new_tokens=16,
                                                   shared_prefix_len=32) for i in range(3)))
        return ([first.token_ids] + [r.token_ids for r in rest], eng.queue_stats(), eng.prefix_cache_stats(),
                eng.metrics.ring_prefills._only().value, eng._layout)
    finally:
        await eng.aclose()


@pytest.mark.parametrize("arm", ["data2", "data2_model2", "data2_ring", "model2_int8"])
def test_an_engine_on_host_devices_serves_the_unmeshed_tokens(arm):
    """The engine on a mesh of distinct host devices (prefix cache on, the
    reference's defaults otherwise): a prompt whose head the tree keeps,
    then three sharing it as one cohort, so rows on data coordinate 1 read
    pages written on coordinate 0. Every token equals the unmeshed
    engine's (int8 against int8), the tree was hit, the windows ran eagerly
    and nothing was captured; ``data2_ring`` routes its full prefills
    through ring attention over the two devices as a seq axis."""
    model_cfg = dataclasses.replace(GemmaConfig.named("test"), n_kv_heads=2 if arm == "data2_model2" else 1,
                                    dtype="float32")
    kw = dict(quantize="int8") if arm.endswith("int8") else {}
    kw.update(ring_prefill_min_tokens=32) if arm.endswith("ring") else None
    shape = {"data2": dict(data=2), "data2_model2": dict(data=2, model=2), "data2_ring": dict(data=2),
             "model2_int8": dict(model=2)}[arm]
    want, _, _, _, _ = asyncio.run(_host_serve(None, model_cfg, **kw))
    got, stats, prefix, rings, layout = asyncio.run(_host_serve(make_mesh(**shape, devices=HOST4), model_cfg, **kw))
    assert layout.cross and got == want
    assert prefix["hits"] > 0
    assert stats["captures"] == stats["replays"] == 0 and stats["eager_windows"] > 0
    assert (rings > 0) == arm.endswith("ring")


def test_training_on_host_devices_is_bit_equal_to_the_virtual_mesh():
    """Data-parallel training of the test preset, 3 steps at batch 8 from
    one seed, on a ``data=2`` mesh of two host devices (a replica on the
    second, its gradients added on the first after its own, copies
    counted) against the same mesh virtual on the CPU: every logged loss
    and every parameter bit for bit."""
    from mcpx_torch.models.bpe import BPETokenizer
    from mcpx_torch.models.corpus import CorpusConfig, build_corpus_sync
    from mcpx_torch.models.train import TrainConfig, flatten_params, train

    corpus = build_corpus_sync(BPETokenizer(), CorpusConfig(n_examples=32, registry_size=40, seed=2), device="cpu")
    tcfg = TrainConfig(steps=3, batch_size=8, lr=3e-3, warmup_steps=1, log_every=1)
    cfg = GemmaConfig.named("test", vocab_size=BPETokenizer().vocab_size)
    runs = []
    for devices in (CPU8[:2], HOST4[:2]):
        transfer.reset_counts()
        params, report = train(cfg, corpus, tcfg, device="cpu", mesh=make_mesh(data=2, devices=devices))
        runs.append((flatten_params(params), report["loss_log"], transfer.counts()["transfers"]))
    (p0, l0, n0), (p1, l1, n1) = runs
    assert l1 == l0 and all(torch.equal(p1[k], p0[k]) for k in p0)
    assert n0 == 0 and n1 > 0


def test_retrieval_row_shards_on_host_devices_rank_as_the_unmeshed_index():
    """A device table of 300 rows on a ``model=2`` mesh of two host
    devices: one row shard on each, every shortlist the unmeshed index's."""
    from mcpx_torch.core.config import RetrievalConfig
    from mcpx_torch.registry.memory import InMemoryRegistry
    from mcpx_torch.retrieval.index import RetrievalIndex, RowShards
    from mcpx_torch.utils.synth import intent_for, synth_registry

    async def go():
        records = synth_registry(300, seed=1)
        indexes = [RetrievalIndex(RetrievalConfig(compute="device"), device="cpu", mesh=mesh)
                   for mesh in (None, make_mesh(model=2, devices=HOST4[:2]))]
        for index in indexes:
            registry = InMemoryRegistry()
            for rec in records:
                await registry.put(rec)
            await index.refresh(registry)
        plain, meshed = indexes
        assert isinstance(meshed._table, RowShards) and len(meshed._table.parts) == 2
        rng = random.Random(1)
        for intent in [intent_for(records, rng) for _ in range(8)]:
            assert await meshed.shortlist(intent, 12) == await plain.shortlist(intent, 12)

    asyncio.run(go())
