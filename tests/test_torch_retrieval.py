"""The retrieval index of the port against the reference's, on the CPU.

``RetrievalConfig.compute`` places the table: ``"device"``, or ``"auto"`` at
or above ``device_threshold`` rows, scores a float32 tensor on the index's
device (here the CPU) with ``torch.mv`` and ``torch.topk``, as the reference
scores its device table with ``einsum`` and ``lax.top_k``; ``"host"`` and
``"auto"`` below the threshold score the numpy mirror in both packages.
Held here: the score vectors within 1e-6 of the reference's, the shortlists
equal in both modes, exact ties lowest index first, snapshots that cross
between the packages, and the factory's snapshot load and rebuild; under a
mesh (a virtual CPU mesh against the reference's on the conftest's 8
devices) the table's rows split over ``model`` where they divide, with the
same shortlists.
"""

import asyncio
import logging
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpx.core.config import MCPXConfig as JConfig, RetrievalConfig as JRetrievalConfig
from mcpx.registry.memory import InMemoryRegistry as JRegistry
from mcpx.retrieval.index import RetrievalIndex as JIndex, _topk_scores
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.core.config import MCPXConfig, RetrievalConfig
from mcpx_torch.core.errors import EngineError
from mcpx_torch.registry.memory import InMemoryRegistry
from mcpx_torch.retrieval.index import RetrievalIndex
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.utils.synth import synth_registry

N_SERVICES, N_INTENTS, K = 300, 16, 8
# compute mode -> (RetrievalConfig overrides, whether the table is on the device)
COMPUTE = {
    "host": ({"compute": "host"}, False),
    "device": ({"compute": "device"}, True),
    "auto_above": ({"compute": "auto", "device_threshold": 64}, True),
    "auto_below": ({"compute": "auto", "device_threshold": N_SERVICES + 1}, False),
}


async def _built(index, registry, records):
    for rec in records:
        await registry.put(rec)
    await index.refresh(registry)
    return index


def _pair(compute: str, mode: str = "residual"):
    kw = {**COMPUTE[compute][0], "shortlist_mode": mode}
    ref = asyncio.run(_built(JIndex(JRetrievalConfig(**kw)), JRegistry(), jsynth(N_SERVICES, seed=0)))
    port = asyncio.run(_built(
        RetrievalIndex(RetrievalConfig(**kw), device="cpu"), InMemoryRegistry(), synth_registry(N_SERVICES, seed=0)
    ))
    return ref, port


def _intents() -> list:
    rng = random.Random(0)
    records = jsynth(N_SERVICES, seed=0)
    return [intent_for(records, rng) for _ in range(N_INTENTS)]


@pytest.mark.parametrize("compute", list(COMPUTE))
def test_scores_and_placement_match_reference(compute):
    ref, port = _pair(compute)
    on_device = COMPUTE[compute][1]
    assert (port._table is not None) == on_device == (ref._table is not None)
    np.testing.assert_array_equal(port._table_np, ref._table_np)
    if on_device:
        assert port._table.dtype == torch.float32 and port._table.device.type == "cpu"
    for intent in _intents():
        q = port.embedder.embed(intent)
        vals, idx = _topk_scores(jnp.asarray(ref._table_np), jnp.asarray(q), k=N_SERVICES)
        ref_scores = np.empty(N_SERVICES, np.float32)
        ref_scores[np.asarray(idx)] = np.asarray(vals)
        if on_device:
            pv, pi = port._device_topk(q, N_SERVICES)
            port_scores = np.empty(N_SERVICES, np.float32)
            port_scores[pi] = pv
        else:
            port_scores = port._table_np @ q
        np.testing.assert_allclose(port_scores, ref_scores, rtol=0, atol=1e-6)
        assert port._base_order(q, K) == ref._base_order(q, K), intent


@pytest.mark.parametrize("mode", ["residual", "topk"])
@pytest.mark.parametrize("compute", list(COMPUTE))
def test_shortlists_match_reference(compute, mode):
    ref, port = _pair(compute, mode)
    for intent in _intents():
        ours = asyncio.run(port.shortlist(intent, K))
        assert ours == asyncio.run(ref.shortlist(intent, K)), intent
        assert len(ours) == K


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_exact_ties_come_out_lowest_index_first(tmp_path, k):
    """Rows 2, 4, 6 and 9 are one vector, the best; row 7 is the next.
    The device order is ``lax.top_k``'s for every k, including a tie across
    the k-th place (k 1-3)."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(12, 16)).astype(np.float32) * 0.1
    best = np.ones(16, np.float32)
    table[[2, 4, 6, 9]] = best
    table[7] = best * 0.9
    q = best / np.linalg.norm(best)
    path = str(tmp_path / "ties.npz")
    np.savez(open(path, "wb"), table=table, names=np.asarray([f"s{i}" for i in range(12)], dtype=object))
    port = RetrievalIndex(RetrievalConfig(compute="device", embed_dim=16), device="cpu")
    port.load(path)
    _, ref_idx = _topk_scores(jnp.asarray(table), jnp.asarray(q), k=k)
    vals, idx = port._device_topk(q, k)
    assert idx == [int(i) for i in np.asarray(ref_idx)] == [2, 4, 6, 9, 7][:k]
    assert vals == sorted(vals, reverse=True)


@pytest.mark.parametrize("model", [2, 4, 8], ids=["model2", "model4", "model8_replicates"])
def test_meshed_index_ranks_as_the_reference_and_the_unmeshed_index(tmp_path, model):
    """``RetrievalIndex(mesh=)``: 300 rows split over ``model`` 2 and 4 (one
    row shard per coordinate, ranked there, merged by (-score, row)), and
    kept whole where 8 does not divide them; shortlists in both modes equal
    the reference's meshed index's and the unmeshed port's, a snapshot
    reloads onto the mesh, and ties come out lowest row first."""
    from mcpx.parallel.mesh import make_mesh as jmake_mesh
    from mcpx_torch.parallel.mesh import make_mesh
    from mcpx_torch.retrieval.index import RowShards

    for mode in ("residual", "topk"):
        kw = {"compute": "device", "shortlist_mode": mode}
        ref = asyncio.run(_built(JIndex(JRetrievalConfig(**kw), mesh=jmake_mesh(data=1, model=model)),
                                 JRegistry(), jsynth(N_SERVICES, seed=0)))
        mesh = make_mesh(model=model, devices=["cpu"] * model)
        port = asyncio.run(_built(RetrievalIndex(RetrievalConfig(**kw), device="cpu", mesh=mesh),
                                  InMemoryRegistry(), synth_registry(N_SERVICES, seed=0)))
        plain = asyncio.run(_built(RetrievalIndex(RetrievalConfig(**kw), device="cpu"),
                                   InMemoryRegistry(), synth_registry(N_SERVICES, seed=0)))
        if N_SERVICES % model == 0:
            assert isinstance(port._table, RowShards) and len(port._table.parts) == model
            assert port._table.offsets == list(range(0, N_SERVICES, N_SERVICES // model))
        else:
            assert isinstance(port._table, torch.Tensor) and port._table.shape[0] == N_SERVICES
        for intent in _intents():
            got = asyncio.run(port.shortlist(intent, K))
            assert got == asyncio.run(ref.shortlist(intent, K)) == asyncio.run(plain.shortlist(intent, K)), intent
            q = port.embedder.embed(intent)
            (vals, idx), (pvals, pidx) = port._device_topk(q, K), plain._device_topk(q, K)
            assert idx == pidx  # a part's product may round its last bit apart from the whole table's
            np.testing.assert_allclose(vals, pvals, rtol=0, atol=1e-6)
    path = str(tmp_path / "meshed.snap")
    port.save(path)
    loaded = RetrievalIndex(RetrievalConfig(compute="device", shortlist_mode="topk"), device="cpu", mesh=mesh)
    loaded.load(path)
    assert type(loaded._table) is type(port._table)
    for intent in _intents():
        assert asyncio.run(loaded.shortlist(intent, K)) == asyncio.run(plain.shortlist(intent, K))
    rng = np.random.default_rng(3)
    table = rng.normal(size=(16, 16)).astype(np.float32) * 0.1
    table[[2, 9, 13]] = np.ones(16, np.float32)  # one best vector in several row shards
    ties = RetrievalIndex(RetrievalConfig(compute="device", embed_dim=16), device="cpu",
                          mesh=make_mesh(model=4, devices=["cpu"] * 4))
    ties._table = ties._place(table)
    for k in (1, 2, 3, 4):
        assert ties._device_topk(np.ones(16, np.float32) / 4, k)[1][:3] == [2, 9, 13][:k]


@pytest.mark.parametrize("sharded", [False, True], ids=["index", "sharded_index"])
def test_a_mesh_of_another_device_is_refused(sharded):
    """Row shards live on the index's own device: a mesh naming another
    device raises at construction, for the sharded index too."""
    from mcpx_torch.cluster.sharding import ShardedRetrievalIndex
    from mcpx_torch.parallel.mesh import make_mesh

    cls = ShardedRetrievalIndex if sharded else RetrievalIndex
    with pytest.raises(EngineError, match="device meta holds no data"):
        cls(RetrievalConfig(compute="device"), device="cpu", mesh=make_mesh(model=2, devices=["cpu", "meta"]))


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("compute", ["host", "device"])
def test_snapshot_crosses_between_packages(tmp_path, writer, compute):
    ref, port = _pair(compute)
    path = str(tmp_path / "index.snap")  # an exact path: no .npz appended
    (ref if writer == "reference" else port).save(path)
    kw = COMPUTE[compute][0]
    ref_loaded = JIndex(JRetrievalConfig(**kw))
    port_loaded = RetrievalIndex(RetrievalConfig(**kw), device="cpu")
    ref_loaded.load(path)
    port_loaded.load(path)
    assert ref_loaded.version == port_loaded.version == -1
    assert (port_loaded._table is not None) == COMPUTE[compute][1]
    assert port_loaded._names == ref._names and port_loaded._word_sets == ref._word_sets
    for intent in _intents():
        expect = asyncio.run(ref.shortlist(intent, K))
        assert asyncio.run(port_loaded.shortlist(intent, K)) == expect == asyncio.run(ref_loaded.shortlist(intent, K))


def test_device_table_needs_the_card_and_strict_fp32(monkeypatch):
    """No silent host scoring: ``compute="device"`` on an index resolved to
    CUDA raises without a card, and scoring with TF32 on raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = RetrievalIndex(RetrievalConfig(compute="device"))
    registry = InMemoryRegistry()
    with pytest.raises(EngineError, match="CUDA is not available"):
        asyncio.run(_built(index, registry, synth_registry(4, seed=0)))
    _, port = _pair("device")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        asyncio.run(port.shortlist("fetch auth data", K))


@pytest.mark.parametrize("snapshot", ["good", "corrupt", "missing"])
def test_factory_loads_snapshot_or_rebuilds_as_reference(tmp_path, caplog, snapshot):
    """``retrieval.snapshot_path``: a good snapshot is loaded at build time
    (version -1, revalidated by the first refresh); an unusable one is
    logged and the index rebuilt from the registry, in both packages."""
    ref, _ = _pair("host")
    path = tmp_path / "index.snap"
    if snapshot == "good":
        ref.save(str(path))
    elif snapshot == "corrupt":
        path.write_bytes(b"not a snapshot")
    cfg = {"planner": {"kind": "heuristic"}, "retrieval": {"snapshot_path": str(path)}}

    async def serve(cp, records):
        loaded = (cp.retriever.size, cp.retriever.version)
        for rec in records:
            await cp.registry.put(rec)
        ctx = await cp._context(_intents()[0])
        return loaded, ctx.shortlist, cp.retriever.version

    with caplog.at_level(logging.WARNING):
        port = asyncio.run(serve(build_control_plane(MCPXConfig.from_dict(cfg), device="cpu"),
                                 synth_registry(N_SERVICES, seed=0)))
    warned = [r for r in caplog.records if "unusable" in r.getMessage()]
    expect = asyncio.run(serve(jbuild(JConfig.from_dict(cfg)), jsynth(N_SERVICES, seed=0)))
    assert port == expect
    assert port[0] == ((N_SERVICES, -1) if snapshot == "good" else (0, -1))
    assert port[2] == N_SERVICES  # the first refresh revalidated against the live registry
    assert bool(warned) == (snapshot != "good")
