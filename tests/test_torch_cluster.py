"""The cluster layer of the port against the reference's, on the CPU.

  - the scenarios of the reference's ``tests/test_cluster.py`` run through
    both packages' ``EnginePool`` over a duck-typed fake engine (the
    reference's ``FakeClusterEngine``, and its copy here publishing the port
    engine's ``queue_depth`` and ``active_rows``): the same routed
    replicas, decision rings (timestamps aside), journals, scoreboards and
    attributions, step for step; ``affinity_key`` and ``rendezvous_choice``
    give equal bytes and picks, and the policies equal scores;
  - ``ShardedRetrievalIndex`` ranks as the reference's, in host mode and
    with the table on ``device="cpu"``, and a snapshot crosses the two
    packages both ways;
  - a pool of two CPU ``InferenceEngine``s (the test preset in float32 on
    the committed checkpoint) gives ``Plan.to_json()`` byte-identical to
    the reference's single engine on 8 intents;
  - kill under load, drain and rejoin with a warm snapshot on CPU engines:
    the resteered plans are valid, the rejoined replica restores its runs
    and prefills less than a cold one, pins and ledger totals survive;
  - the repairs the pool needed in the engine: the kernel wrapper's ticket
    registry and counts under concurrent threads, and a closed engine that
    holds no tensor.
"""

import asyncio
import dataclasses
import os
import random
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcpx.cluster import EnginePool as JPool
from mcpx.cluster import (
    CostBurnPolicy as JCostBurnPolicy,
    PrefixAffinityPolicy as JPrefixAffinityPolicy,
    QueueDepthPolicy as JQueueDepthPolicy,
    RoundRobinPolicy as JRoundRobinPolicy,
    RouteRequest as JRouteRequest,
    RoutingPipeline as JRoutingPipeline,
    affinity_key as jaffinity_key,
    rendezvous_choice as jrendezvous_choice,
)
from mcpx.cluster.replica import ReplicaHandle as JReplicaHandle
from mcpx.cluster.sharding import ShardedRetrievalIndex as JSharded
from mcpx.core.config import MCPXConfig as JConfig, RetrievalConfig as JRetrievalConfig
from mcpx.core.errors import EngineError as JEngineError
from mcpx.engine.engine import InferenceEngine as JEngine
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.planner.llm import LLMPlanner as JPlanner
from mcpx.registry.memory import InMemoryRegistry as JRegistry
from mcpx.resilience.chaos import ClusterFaults as JClusterFaults
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.cluster import (
    CostBurnPolicy,
    EnginePool,
    PrefixAffinityPolicy,
    QueueDepthPolicy,
    RoundRobinPolicy,
    RouteRequest,
    RoutingPipeline,
    affinity_key,
    rendezvous_choice,
)
from mcpx_torch.cluster.replica import ReplicaHandle
from mcpx_torch.cluster.sharding import ShardedRetrievalIndex
from mcpx_torch.core.config import MCPXConfig, RetrievalConfig
from mcpx_torch.core.errors import EngineError
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.engine.kernels import paged_attention as tk
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.planner.llm import LLMPlanner
from mcpx_torch.registry.memory import InMemoryRegistry
from mcpx_torch.resilience.chaos import ClusterFaults
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.utils.synth import synth_registry
from tests.test_cluster import FakeClusterEngine as JFakeEngine

CKPT = os.path.join(os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz")


class FakeClusterEngine(JFakeEngine):
    """The reference's fake for the port's pool: the same behaviour, its
    queue under the port engine's names and ``kernel_paths`` for
    ``pallas_paths``."""

    def __init__(self, index=0, fail_start=False, service_s=0.01):
        super().__init__(index, fail_start, service_s)
        self.state = "cold"

    async def start(self):
        if self.fail_start:
            self.state = "failed"
            raise EngineError(f"replica {self.index} boom")
        self.state = "ready"

    async def generate(self, prompt_ids, **kw):
        if self.state != "ready":
            raise EngineError(f"engine not ready (state={self.state})")
        self.calls.append((tuple(prompt_ids), kw.get("tenant", "default")))
        if self.hold is not None:
            await self.hold.wait()
            if self.state != "ready":
                raise EngineError("engine closed mid-request")
        return {"replica": self.index, "n": len(self.calls)}

    def queue_stats(self):
        qs = super().queue_stats()
        qs["queue_depth"], qs["active_rows"] = qs.pop("depth"), qs.pop("active")
        for k in ("depth_constrained", "depth_free", "hol_wait_ms", "prefix_nodes",
                  "prefix_resident_pages", "prefix_hit_rate", "pallas"):
            qs.pop(k)
        return qs

    def kernel_paths(self):
        return {"decode": {"engaged": False}}


PKGS = {
    "reference": SimpleNamespace(
        pool=JPool, config=JConfig, fake=JFakeEngine, error=JEngineError, handle=JReplicaHandle,
        faults=JClusterFaults, queue=JQueueDepthPolicy, affinity=JPrefixAffinityPolicy,
        burn=JCostBurnPolicy, rr=JRoundRobinPolicy, request=JRouteRequest, pipeline=JRoutingPipeline,
        key=jaffinity_key, choice=jrendezvous_choice, paths="pallas_paths",
    ),
    "port": SimpleNamespace(
        pool=EnginePool, config=MCPXConfig, fake=FakeClusterEngine, error=EngineError, handle=ReplicaHandle,
        faults=ClusterFaults, queue=QueueDepthPolicy, affinity=PrefixAffinityPolicy,
        burn=CostBurnPolicy, rr=RoundRobinPolicy, request=RouteRequest, pipeline=RoutingPipeline,
        key=affinity_key, choice=rendezvous_choice, paths="kernel_paths",
    ),
}


def _pool(p, n=3, cfg=None, fail=(), **kw):
    cfg = cfg or p.config()
    cfg.cluster.replicas = n
    cfg.cluster.scoreboard_interval_s = 0.05
    engines = {}

    def factory(i, _cfg):
        e = p.fake(i, fail_start=i in fail)
        engines.setdefault(i, []).append(e)
        return e

    return p.pool(cfg, engine_factory=factory, **kw), engines


def _handles(p, n=3, depths=None):
    hs = []
    for i in range(n):
        h = p.handle(i, p.fake(i))
        h.engine.state = "ready"
        h.state = "ready"
        h.stats = {"depth": (depths or [0] * n)[i], "service_ewma_s": 0.1, "eta_s": 0.0}
        hs.append(h)
    return hs


def _strip(obj):
    """A pool read less its wall-clock fields (``ts``)."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, (list, tuple)):
        return [_strip(v) for v in obj]
    return obj


def _reads(pool) -> dict:
    return _strip({
        "snapshot": pool.scoreboard_snapshot(), "attribution": pool.attribution(),
        "counts": pool.journal_counts(), "states": [r.state for r in pool.replicas],
        "generations": [r.generation for r in pool.replicas],
    })


def _both(story):
    ref, port = (asyncio.run(story(PKGS[name])) for name in ("reference", "port"))
    assert port == ref
    return port


# ------------------------------------------------------------- routing units
def test_affinity_keys_and_rendezvous_picks_match_reference():
    rng = random.Random(0)
    for _ in range(200):
        ids = [rng.randrange(3072) for _ in range(rng.randrange(1, 300))]
        kw = dict(prefix_tokens=rng.choice((1, 16, 64, 128)), page_size=rng.choice((1, 4, 16, 64)))
        key = affinity_key(ids, **kw)
        assert key == jaffinity_key(ids, **kw)
        n = rng.randrange(1, 6)
        alive = sorted(rng.sample(range(6), n))
        picks = [
            p.choice(key, [h for h in _handles(p, 6) if h.index in alive]).index
            for p in (PKGS["reference"], PKGS["port"])
        ]
        assert picks[0] == picks[1] and picks[0] in alive


async def _policy_story(p):
    out = []
    hs = _handles(p, 3, depths=[5, 0, 5])
    hs[0].stats["eta_s"] = hs[2].stats["eta_s"] = 1.0
    out.append(p.pipeline([p.queue()]).route(p.request(prompt_ids=(1, 2)), hs).index)
    aff = p.affinity(prefix_tokens=16, page_size=4, weight=1.0)
    pipe = p.pipeline([p.queue(), aff])
    req = p.request(prompt_ids=tuple(range(32)))
    out.append([pipe.route(req, hs).index for _ in range(6)])
    hs = _handles(p, 2)
    aff = p.affinity(prefix_tokens=8, page_size=1, weight=1.0, imbalance_ratio=2.0)
    req = p.request(prompt_ids=(9, 9, 9, 9))
    out.append((aff.score(req, hs), aff.last_preferred))
    hs[aff.last_preferred].stats["depth"] = 50
    out.append((aff.score(req, hs), aff.last_preferred))

    class SloStub:
        fast_burn_threshold = 14.4

        def fast_burn(self, tenant=None):
            return 20.0 if tenant == "hog" else 0.0

    pol = p.burn(slo=SloStub(), ledger=None)
    for tenant, depths in (("hog", [0, 0, 6]), ("good", [0, 0, 6]), ("hog", None)):
        out.append(pol.score(p.request(prompt_ids=(1,), tenant=tenant), _handles(p, 3, depths)))
    pipe = p.pipeline([p.queue(), p.rr()], ring_size=4)
    hs = _handles(p, 3)
    out.append([pipe.route(p.request(prompt_ids=(i,)), hs).index for i in range(10)])
    out.append((len(pipe.decisions), _strip(pipe.recent_decisions()), _strip(pipe.last_decision)))
    out.append(p.pipeline([p.queue()]).last_decision)
    return out


def test_policies_score_and_route_as_reference():
    out = _both(_policy_story)
    assert out[0] == 1 and len(set(out[1])) == 1  # queue baseline; affinity sticks
    assert out[3][1] is None  # the imbalance hatch drops the bonus
    assert out[-3] == [0, 1, 2, 0, 1, 2, 0, 1, 2, 0] and out[-2][0] == 4


# ---------------------------------------------------------------- pool stories
async def _start_story(p):
    pool, engines = _pool(p, 3)
    await pool.start()
    out = [pool.state]
    for i in range(8):
        res = await pool.generate([1, 2, 3, i % 3], tenant=f"t{i % 2}")
        out.append(res["replica"])
    qs = pool.queue_stats()
    out.append((qs["cluster"], qs["eta_s"], qs["resident_grammars"], pool.prompt_capacity()))
    out.append(getattr(pool, p.paths)())
    out.append(sorted(pool.prefix_cache_stats()))
    out.append(_reads(pool))
    await pool.aclose()
    out.append((pool.state, [e[0].state for e in engines.values()]))
    return out


def test_start_generate_and_stats_match_reference():
    out = _both(_start_story)
    assert out[0] == "ready" and out[-1] == ("closed", ["closed"] * 3)


async def _partial_story(p):
    cfg = p.config()
    pool, _ = _pool(p, 2, cfg, fail=(1,))
    await pool.start()
    out = [pool.state, [r.state for r in pool.replicas], type(pool._startup_error).__name__]
    out.append((await pool.generate([4, 5]))["replica"])
    pool2, _ = _pool(p, 2, p.config(), fail=(0, 1))
    try:
        await pool2.start()
    except p.error as e:
        out.append(str(e))
    return out


def test_partial_start_survives_and_total_failure_raises_as_reference():
    out = _both(_partial_story)
    assert out[:2] == ["ready", ["ready", "dead"]] and "boom" in out[-1]


async def _kill_story(p):
    pool, engines = _pool(p, 2)
    await pool.start()
    victim = pool.replicas[0].engine
    victim.hold = asyncio.Event()
    pool.replicas[1].stats = dict(pool.replicas[1].stats, eta_s=9.0)
    task = asyncio.create_task(pool.generate([5, 6, 7], tenant="a"))
    await asyncio.sleep(0.05)
    out = [bool(victim.calls)]
    await pool.kill(0)
    out.append(await asyncio.wait_for(task, 2))
    out.append((pool.resteers, [r.state for r in pool.replicas]))
    out += [(await pool.generate([9, 9], tenant="a"))["replica"] for _ in range(4)]
    await pool.rejoin(0)
    out.append((pool.replicas[0].generation, len(engines[0]), pool.replicas[0].routable))
    try:
        await pool.rejoin(1)
    except p.error as e:
        out.append(str(e))
    out.append(_reads(pool))
    await pool.aclose()
    return out


def test_kill_resteers_inflight_and_rejoin_match_reference():
    out = _both(_kill_story)
    assert out[0] and out[1]["replica"] == 1 and out[2] == (1, ["dead", "ready"])
    assert out[3:7] == [1, 1, 1, 1] and out[7] == (1, 2, True)


async def _drain_story(p):
    pool, _ = _pool(p, 2)
    pool.config.cluster.drain_timeout_s = 2.0
    await pool.start()
    eng = pool.replicas[0].engine
    eng.hold = asyncio.Event()
    pool.replicas[1].stats["eta_s"] = 9.0
    task = asyncio.create_task(pool.generate([1, 2], tenant="a"))
    await asyncio.sleep(0.05)
    out = [bool(eng.calls)]
    drain = asyncio.create_task(pool.drain(0))
    await asyncio.sleep(0.05)
    out.append((drain.done(), pool.replicas[0].state))
    eng.hold.set()
    out.append(await task)
    await asyncio.wait_for(drain, 2)
    out.append((pool.replicas[0].state, eng.state))
    out.append(_reads(pool))
    return out


def test_drain_waits_for_inflight_then_closes_as_reference():
    out = _both(_drain_story)
    assert out[0] and out[1] == (False, "draining") and out[3] == ("dead", "closed")


async def _pin_story(p):
    pool, engines = _pool(p, 3)
    await pool.start()
    ids = list(range(40))
    pin = await pool.pin_prefix(ids)
    out = [pin.replica, pool._affinity_replica(ids).index, engines[pin.replica][0].pinned]
    pool.unpin_prefix(None)
    return out


def test_pin_lands_on_the_affinity_replica_as_reference():
    out = _both(_pin_story)
    assert out[0] == out[1] and out[2] == [tuple(range(40))]


def test_unpin_on_a_dead_replica_is_a_no_op():
    """The port's pin remembers its engine: once its replica is killed (or
    killed and rejoined), unpin touches neither the closed engine nor the
    slot's new one."""

    async def go():
        pool, engines = _pool(PKGS["port"], 2)
        await pool.start()
        pin = await pool.pin_prefix(list(range(40)))
        await pool.kill(pin.replica)
        pool.unpin_prefix(pin)
        await pool.rejoin(pin.replica)
        pool.unpin_prefix(pin)
        assert engines[pin.replica][0].pinned == [tuple(range(40))]
        assert engines[pin.replica][1].pinned == []

    asyncio.run(go())


async def _skew_story(p):
    pool, _ = _pool(p, 3)
    await pool.start()
    out = [pool.replica_skew()]
    for r, depth in zip(pool.replicas, (8, 1, 0)):
        r.stats = {"depth": depth, "active": 0}
    out.append(pool.replica_skew())
    pool.update_gauges()
    return out


def test_replica_skew_matches_reference():
    out = _both(_skew_story)
    assert out[1] == pytest.approx(8 / 3, rel=1e-6)


async def _chaos_story(p):
    pool, _ = _pool(p, 2, chaos=p.faults(replica=1, at_s=0.05, down_s=0.1, rejoin=True))
    await pool.start()
    await asyncio.sleep(0.1)
    out = [pool.replicas[1].state]
    await asyncio.sleep(0.25)
    out.append((pool.replicas[1].state, pool.replicas[1].generation))
    out.append([e["kind"] for e in pool.journal.tail()])
    await pool.aclose()
    return out


def test_chaos_schedule_kills_then_rejoins_as_reference():
    out = _both(_chaos_story)
    assert out[:2] == ["dead", ("ready", 1)] and out[2] == ["kill", "rejoin"]


async def _journal_story(p):
    cfg = p.config()
    cfg.telemetry.provenance.route_ring = 6
    pool, _ = _pool(p, 2, cfg)
    await pool.start()
    rng = random.Random(3)
    out = []
    for _ in range(10):
        ids = [rng.randrange(50) for _ in range(rng.randrange(1, 80))]
        out.append((await pool.generate(ids, tenant=rng.choice("ab")))["replica"])
        if rng.random() < 0.4:
            pool.refresh_scoreboard()
    await pool.kill(1)
    out.append((await pool.generate([1, 2, 3]))["replica"])
    await pool.rejoin(1)
    out.append(_reads(pool))
    await pool.aclose()
    return out


def test_journal_counts_attribution_and_snapshot_match_reference():
    out = _both(_journal_story)
    reads = out[-1]
    assert reads["counts"]["routed"] == 11 and reads["counts"]["kill"] == reads["counts"]["rejoin"] == 1
    assert len(reads["snapshot"]["decisions"]) == 6
    kinds = [e["kind"] for e in reads["snapshot"]["journal"]]
    assert kinds.index("kill") < kinds.index("rejoin")


def test_pool_is_engine_shaped_for_the_port():
    """The reference's surface (``pallas_paths`` as ``kernel_paths``) and
    the port engine's."""

    async def go():
        pool, _ = _pool(PKGS["port"], 2)
        await pool.start()
        for attr in (
            "generate", "queue_stats", "state", "start", "aclose", "tokenizer", "pin_prefix",
            "unpin_prefix", "prefix_cache_stats", "prompt_capacity", "kernel_paths", "metrics",
            "costs", "device", "kernel_launches", "capture_counts", "ledger_totals", "drop_unpinned",
        ):
            assert hasattr(pool, attr), attr
        qs = pool.queue_stats()
        assert "hol_wait_ms" not in qs and qs["queue_depth"] == sum(
            r.engine.queue_stats()["queue_depth"] for r in pool.replicas
        )
        assert pool.kernel_paths()["decode"]["engaged"] is False

    asyncio.run(go())


# ------------------------------------------------------------------ sharding
def _records(n):
    from mcpx_torch.registry.base import ServiceRecord

    return [
        ServiceRecord(
            name=f"svc-{i}", endpoint=f"local://svc-{i}",
            description=f"service number {i} does task-{i % 7} on stream-{i % 3}",
        )
        for i in range(n)
    ]


@pytest.mark.parametrize("compute", ["host", "device"])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_sharded_shortlists_match_reference(compute, n_shards):
    async def build(index, registry, records):
        for rec in records:
            await registry.put(rec)
        await index.refresh(registry)
        return index

    kw = dict(compute=compute, shortlist_mode="topk")
    ref = asyncio.run(build(JSharded(JRetrievalConfig(**kw), n_shards=n_shards), JRegistry(), jsynth(300, seed=0)))
    port = asyncio.run(build(
        ShardedRetrievalIndex(RetrievalConfig(**kw), n_shards=n_shards, device="cpu"),
        InMemoryRegistry(), synth_registry(300, seed=0),
    ))
    assert port.shard_sizes == ref.shard_sizes and sum(port.shard_sizes) == 300
    assert bool(port._shards) == (compute == "device")
    rng = random.Random(1)
    for _ in range(12):
        intent = intent_for(jsynth(300, seed=0), rng)
        for k in (1, 5, 12):
            assert asyncio.run(port.shortlist(intent, k)) == asyncio.run(ref.shortlist(intent, k)), (intent, k)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_index_on_a_mesh_ranks_as_the_reference(n_shards):
    """``ShardedRetrievalIndex(mesh=)``: each registry shard's rows split
    again over ``model`` where they divide (150 rows over 2; 100 over 2),
    shortlists equal to the reference's meshed sharded index and to the
    port's unmeshed one."""
    from mcpx.parallel.mesh import make_mesh as jmake_mesh
    from mcpx_torch.parallel.mesh import make_mesh
    from mcpx_torch.retrieval.index import RowShards

    async def build(index, registry, records):
        for rec in records:
            await registry.put(rec)
        await index.refresh(registry)
        return index

    kw = dict(compute="device", shortlist_mode="topk")
    ref = asyncio.run(build(JSharded(JRetrievalConfig(**kw), n_shards=n_shards, mesh=jmake_mesh(data=4, model=2)),
                            JRegistry(), jsynth(300, seed=0)))
    port = asyncio.run(build(
        ShardedRetrievalIndex(RetrievalConfig(**kw), n_shards=n_shards, device="cpu",
                              mesh=make_mesh(data=4, model=2, devices=["cpu"] * 8)),
        InMemoryRegistry(), synth_registry(300, seed=0),
    ))
    plain = asyncio.run(build(ShardedRetrievalIndex(RetrievalConfig(**kw), n_shards=n_shards, device="cpu"),
                              InMemoryRegistry(), synth_registry(300, seed=0)))
    assert port.shard_sizes == ref.shard_sizes == plain.shard_sizes
    assert all(isinstance(s, RowShards) and len(s.parts) == 2 for s in port._shards)
    rng = random.Random(1)
    for _ in range(12):
        intent = intent_for(jsynth(300, seed=0), rng)
        for k in (1, 5, 12):
            got = asyncio.run(port.shortlist(intent, k))
            assert got == asyncio.run(ref.shortlist(intent, k)) == asyncio.run(plain.shortlist(intent, k)), (intent, k)


@pytest.mark.parametrize("compute", ["host", "device"])
def test_sharded_merge_is_exact_on_random_tables(compute):
    """Seeded random tables, ties included: the shard merge equals the
    unsharded ranking (score descending, row ascending) and the
    reference's."""
    rng = np.random.default_rng(0)
    for seed in range(4):
        table = rng.standard_normal((50, 16)).astype(np.float32)
        table[10] = table[40]  # an exact tie across shards
        q = rng.standard_normal(16).astype(np.float32)
        ref = JSharded(JRetrievalConfig(compute="host"), n_shards=3)
        ref._table_np, ref._names = table, [f"s{i}" for i in range(50)]
        port = ShardedRetrievalIndex(RetrievalConfig(compute=compute), n_shards=3, device="cpu")
        port._table_np, port._names = table, list(ref._names)
        if compute == "device":
            port._place(table)
        scores = table @ q
        want = sorted(range(50), key=lambda i: (-float(scores[i]), i))[:10]
        assert port._base_order(q, 10) == ref._base_order(q, 10) == want, seed


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sharded_snapshot_crosses_between_packages(tmp_path, writer):
    async def build(index, registry, records):
        for rec in records:
            await registry.put(rec)
        await index.refresh(registry)
        return index

    path = str(tmp_path / "index.snap")
    if writer == "reference":
        asyncio.run(build(JSharded(JRetrievalConfig(), n_shards=2), JRegistry(), jsynth(120, seed=2))).save(path)
    else:
        asyncio.run(build(
            ShardedRetrievalIndex(RetrievalConfig(), n_shards=2, device="cpu"), InMemoryRegistry(),
            synth_registry(120, seed=2),
        )).save(path)
    ref = JSharded(JRetrievalConfig(compute="device"), n_shards=3)
    ref.load(path)
    port = ShardedRetrievalIndex(RetrievalConfig(compute="device"), n_shards=3, device="cpu")
    port.load(path)
    assert port.size == ref.size == 120 and port.shard_sizes == [40, 40, 40]
    rng = random.Random(4)
    for _ in range(8):
        intent = intent_for(jsynth(120, seed=2), rng)
        assert asyncio.run(port.shortlist(intent, 8)) == asyncio.run(ref.shortlist(intent, 8))


# ------------------------------------------------------- CPU engines in a pool
ENGINE_CONFIG = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": CKPT},
    "engine": {
        "max_batch_size": 16, "max_decode_len": 64, "kv_page_size": 64, "max_pages_per_seq": 4,
        "temperature": 0.0, "speculate_k": 8, "hetero_batch": False, "prefix_cache": False,
        "draft_mode": "off", "use_pallas": False, "data_axis": 1, "model_axis": 1,
    },
    "planner": {"kind": "llm"},
    "tracing": {"enabled": False},
}
N_SERVICES, N_INTENTS = 200, 8


def _f32(gemma):
    return dataclasses.replace(gemma.named("test", vocab_size=3072, max_seq_len=2048), dtype="float32")


async def _serve(cp, records, intents):
    for rec in records:
        await cp.registry.put(rec)
    await cp.startup()
    try:
        return [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
    finally:
        await cp.planner.engine.aclose()


def test_two_replica_pool_plans_are_byte_identical_to_the_reference_engine():
    """The port's pool of two float32 CPU engines, every request routed by
    the default pipeline, against the reference's one engine."""
    records = jsynth(N_SERVICES, seed=0)
    rng = random.Random(0)
    intents = [intent_for(records, rng) for _ in range(N_INTENTS)]
    jcfg = JConfig.from_dict(ENGINE_CONFIG)
    ref = asyncio.run(_serve(
        jbuild(jcfg, planner=JPlanner(JEngine(jcfg, model_cfg=_f32(JGemmaConfig)), jcfg.planner)), records, intents
    ))
    tcfg = MCPXConfig.from_dict({**ENGINE_CONFIG, "cluster": {"enabled": True, "replicas": 2}})
    pool = EnginePool(tcfg, engine_factory=lambda i, cfg: InferenceEngine(cfg, model_cfg=_f32(GemmaConfig), device="cpu"))
    cp = build_control_plane(tcfg, planner=LLMPlanner(pool, tcfg.planner), device="cpu")
    assert cp.cluster is pool and cp.metrics.render()
    port = asyncio.run(_serve(cp, synth_registry(N_SERVICES, seed=0), intents))
    assert sum(p.origin == "llm" for p in ref) >= N_INTENTS - 1
    assert [p.to_json() for p in port] == [p.to_json() for p in ref]
    assert sum(r.routed for r in pool.replicas) == N_INTENTS + 1  # and the warm request


LIFECYCLE_CONFIG = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": CKPT},
    "engine": {
        "max_batch_size": 8, "max_decode_len": 48, "kv_page_size": 16, "max_pages_per_seq": 16,
        "temperature": 0.0, "kv_tier": {"enabled": True},
    },
    "planner": {"kind": "llm"},
    "cluster": {"enabled": True, "replicas": 2, "shard_registry": True, "burn_aware": True,
                "drain_timeout_s": 30.0},
    "slo": {"enabled": True},
    "telemetry": {"ledger": {"enabled": True}, "provenance": {"enabled": True}},
}


def test_kill_drain_and_warm_rejoin_on_cpu_engines(tmp_path):
    """The factory's pool of two CPU engines with the tiered cache and a
    warm-snapshot directory: a burst; a burst during which the replica
    with rows in flight is killed (its requests resteer and every plan is
    valid); a rejoin that restores the slot's snapshot before its first
    request, which then prefills less than its prompt; a drain under a
    burst and its rejoin. No pin is left, the ledger totals keep the
    killed engine's bills, and the launch counts of CPU engines stay 0."""
    cfg = MCPXConfig.from_dict(LIFECYCLE_CONFIG)
    cfg.cluster.warm_snapshot_dir = str(tmp_path)
    cp = build_control_plane(cfg, device="cpu")
    pool = cp.cluster
    assert isinstance(cp.retriever, ShardedRetrievalIndex) and cp.retriever.n_shards == 2
    records = synth_registry(60, seed=0)
    rng = random.Random(0)
    intents = [intent_for(records, rng) for _ in range(6)]

    async def burst(during=None):
        tasks = [asyncio.create_task(cp.plan(i, use_cache=False)) for i in intents]
        if during is not None:
            await during()
        plans = [p for p, _ in await asyncio.gather(*tasks)]
        for p in plans:
            p.validate()
            assert p.origin == "llm" and {n.service for n in p.nodes} <= {r.name for r in records}
        return plans

    async def go():
        for rec in records:
            await cp.registry.put(rec)
        await cp.startup()
        try:
            await burst()

            async def kill_busy():
                while not any(r.inflight for r in pool.replicas):
                    await asyncio.sleep(0.005)
                victim = max(pool.replicas, key=lambda r: r.inflight).index
                await pool.kill(victim)
                holder["victim"] = victim

            holder = {}
            await burst(kill_busy)
            victim = holder["victim"]
            assert os.path.exists(os.path.join(str(tmp_path), f"replica-{victim}.json"))
            old = pool.replicas[victim].engine
            assert old._params is None and old._paged_kv is None
            await pool.rejoin(victim)
            r = pool.replicas[victim]
            assert r.generation == 1 and r.routable
            assert r.engine.queue_stats()["prefix_host_pages"] > 0  # restored runs, in the host tier
            other = pool.replicas[1 - victim]
            other.state = "draining"  # steer the warm request to the rejoined slot
            plan, _ = await cp.plan(intents[0], use_cache=False)
            other.state = "ready"
            warm = r.engine.queue_stats()["prefill_tokens"]
            assert 0 < warm < len(plan.prompt_ids)
            drain = [None]

            async def drain_other():
                await asyncio.sleep(0.01)
                drain[0] = asyncio.create_task(pool.drain(1 - victim))

            await burst(drain_other)
            await drain[0]
            assert pool.replicas[1 - victim].state == "dead"
            await pool.rejoin(1 - victim)
            kinds = [e["kind"] for e in pool.scoreboard_snapshot()["journal"]]
            for kind in ("kill", "rejoin", "drain"):
                assert kind in kinds, kind
            counts = pool.journal_counts()
            assert counts["resteer"] >= 1 and counts["routed"] >= 3 * len(intents) + 1
            for r in pool.replicas:
                assert r.engine.queue_stats()["prefix_pins"] == 0
            totals = pool.ledger_totals()
            assert totals["flops"] > sum(r.engine.ledger_totals()["flops"] for r in pool.replicas)
            assert all(sum(c.values()) == 0 for c in pool.replica_launches().values())
            text = cp.metrics.render().decode()
            assert "mcpx_cluster_replicas_ready 2" in text and "mcpx_cluster_routed_requests_total" in text
        finally:
            await cp.aclose()

    torch.set_num_threads(1)
    asyncio.run(go())


# ------------------------------------------------------------------- repairs
@pytest.fixture
def busy_threads():
    """Python switches threads every microsecond while the test runs."""
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(before)


def test_ticket_registry_and_counts_hold_under_threads(busy_threads, monkeypatch):
    """Engines on several worker threads share the wrapper's ticket
    registry and launch counts: every hold is kept, every release undone,
    a growing buffer is never lost, and each thread's own count plus the
    others' make the process's. The buffers are made on the CPU here (no
    stream captures there)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    dev = torch.device("cpu")
    stream, n_threads, rounds = 7_777_001, 8, 2000
    key = (dev, stream)
    own = [dict() for _ in range(n_threads)]
    n0 = tk.kernel_launches()["ragged_paged_attention"]
    start = threading.Barrier(n_threads)

    def run(fn):
        threads = [threading.Thread(target=fn, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)

    def grow(t):
        # Launches on one shared stream, at growing widths.
        start.wait()
        for i in range(rounds):
            tk._tickets(dev, stream, 1 + (i * n_threads + t) % 997)

    def hold(t):
        tk.count_into(own[t])
        start.wait()
        for _ in range(rounds):
            tk.hold_tickets(dev, stream, 64)
            tk.count_replay({"ragged_paged_attention": 1})
        tk.count_into(None)

    def release(t):
        start.wait()
        for _ in range(rounds):
            tk.release_tickets(dev, stream)

    try:
        run(grow)
        assert tk._TICKETS[key].numel() >= 997
        run(hold)
        assert tk._HELD[key] == n_threads * rounds
        assert [c["ragged_paged_attention"] for c in own] == [rounds] * n_threads
        assert tk.kernel_launches()["ragged_paged_attention"] - n0 == n_threads * rounds
        run(release)
        assert key not in tk._HELD and key not in tk._TICKETS
    finally:
        tk.LAUNCHES["ragged_paged_attention"] = n0
        tk._HELD.pop(key, None)
        tk._TICKETS.pop(key, None)


def _tensors(obj, seen, depth=0):
    """Tensors reachable from ``obj`` through dicts, sequences and object
    attributes (a few levels; the tokenizer and config are skipped)."""
    if id(obj) in seen or depth > 5:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple, set, frozenset)):
        items = list(obj)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        items = list(vars(obj).values())
    else:
        return []
    return [t for it in items for t in _tensors(it, seen, depth + 1)]


def test_a_closed_engine_holds_no_tensor():
    """After ``aclose`` nothing of the engine is left for a reference that
    outlives it (a pool's killed slot) to keep alive: weights, KV pools,
    slab, grammar tables (the heterogeneous stacks too), masks, generator,
    flag ring."""
    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 256},
        "engine": {"max_batch_size": 4, "max_decode_len": 16, "kv_page_size": 16, "max_pages_per_seq": 8,
                   "hetero_batch": True, "kv_tier": {"enabled": True}},
    })
    engine = InferenceEngine(cfg, device="cpu")

    async def go():
        await engine.start()
        tok = engine.tokenizer
        await asyncio.gather(*(
            engine.generate(tok.encode(f"intent {i}: compose. JSON:"), max_new_tokens=8, constrained=i % 2 == 0)
            for i in range(3)
        ))
        assert _tensors(engine, {id(engine.tokenizer), id(engine.config)})
        await engine.aclose()

    asyncio.run(go())
    left = _tensors(engine, {id(engine.tokenizer), id(engine.config)})
    assert left == [], [tuple(t.shape) for t in left]


def test_engines_in_one_process_take_turns_on_the_device(busy_threads):
    """Two CPU engines serving at once from their worker threads: no two
    workers are ever inside their device work (admission, a segment's
    dispatch, a harvest) at the same time; each holds the process's device
    lock for it."""
    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 256},
        "engine": {"max_batch_size": 4, "max_decode_len": 24, "kv_page_size": 16, "max_pages_per_seq": 8},
    })
    engines = [InferenceEngine(cfg, device="cpu") for _ in range(2)]
    inside = {"now": 0, "most": 0}
    count = threading.Lock()

    def watched(fn):
        def run(*a, **kw):
            with count:
                inside["now"] += 1
                inside["most"] = max(inside["most"], inside["now"])
            try:
                return fn(*a, **kw)
            finally:
                with count:
                    inside["now"] -= 1
        return run

    for e in engines:
        e._admit, e._dispatch_segment, e._harvest = (
            watched(e._admit), watched(e._dispatch_segment), watched(e._harvest))

    async def go():
        await asyncio.gather(*(e.start() for e in engines))
        try:
            for _ in range(3):
                await asyncio.gather(*(
                    e.generate(e.tokenizer.encode(f"intent {i}: compose. JSON:"), max_new_tokens=12)
                    for e in engines for i in range(3)
                ))
        finally:
            await asyncio.gather(*(e.aclose() for e in engines))

    torch.set_num_threads(1)
    asyncio.run(go())
    assert inside["most"] == 1 and inside["now"] == 0
