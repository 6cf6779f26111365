"""Three faults of the port found against the reference, held closed on the
CPU:

  - the factory serves no option it ignores: each option the reference
    factory reads is served and wired as the reference wires it: the
    cluster's engine pool and sharded registry, the retrieval snapshot,
    the mock planner, the file and Redis registries, SentencePiece
    vocabularies, the default-on telemetry, the Redis plan-cache tier, the
    admission scheduler, the resilience facade, the chaos transport and
    telemetry's default-off parts (the Redis telemetry mirror, the flight
    recorder, the cost ledger, decision provenance, the SLO tracker) are
    served and wired;
  - sampled decoding (the configs' default ``temperature=0.2``) draws from
    the exact softmax of the masked, scaled and top-k-cut logits, in both
    packages: many draws from fixed logits, their counts held to the exact
    probabilities by a chi-square test at a false-failure rate of 1e-6 per
    test, and no masked or cut column ever drawn (the two RNGs never agree
    draw for draw, so the draws themselves are not compared);
  - the plan divergence on the half registry with intents from
    ``Random(0)``: in float32 on both sides the plans are byte-identical.
"""

import asyncio
import dataclasses
import json
import os
import random
import re

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.engine import sampling as jsampling
from mcpx.engine.engine import InferenceEngine as JEngine
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.planner.llm import LLMPlanner as JPlanner
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.errors import ConfigError
from mcpx_torch.engine import sampling
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.planner.llm import LLMPlanner
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.server.plan_cache import RedisPlanCache
from mcpx_torch.utils.synth import synth_registry

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ refusals
# The five options the port served once telemetry's default-off parts were
# ported; the retrieval snapshot, the mock planner, the file and Redis
# registries and SentencePiece vocabs it served with the rest of the config
# surface; the cluster's two, served with the cluster layer. An option the
# port refused would raise ConfigError naming it.
TELEMETRY_PARTS = {
    ("telemetry", "redis_url"), ("telemetry", "flight.enabled"), ("telemetry", "ledger.enabled"),
    ("telemetry", "provenance.enabled"), ("slo", "enabled"),
}
MAKERS = {
    ("retrieval", "snapshot_path"), ("planner", "kind"), ("registry", "backend"), ("model", "vocab"),
    ("cluster", "enabled"), ("cluster", "shard_registry"),
}
SERVED = TELEMETRY_PARTS | MAKERS


@pytest.mark.parametrize(
    "section,key,value",
    [
        ("cluster", "enabled", True),
        ("cluster", "shard_registry", True),
        ("retrieval", "snapshot_path", "index.npz"),
        ("telemetry", "redis_url", "redis://localhost:6379/0"),
        # The reference's control plane builds these default-off parts.
        ("telemetry", "flight.enabled", True),
        ("telemetry", "ledger.enabled", True),
        ("telemetry", "provenance.enabled", True),
        ("slo", "enabled", True),
        ("planner", "kind", "mock"),
        ("registry", "backend", "file"),
        ("registry", "backend", "redis"),
        ("model", "vocab", "sp"),
        (None, None, None),
    ],
)
def test_factory_refuses_options_the_port_does_not_serve(section, key, value, tmp_path):
    cfg = {"planner": {"kind": "heuristic"}}
    if section is None:
        # The defaults (telemetry on) and the Redis plan-cache tier are served.
        cfg["planner"]["plan_cache_redis_url"] = "redis://localhost:6379/1"
        cp = build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
        assert cp.config.telemetry.enabled
        assert isinstance(cp.redis_plan_cache, RedisPlanCache)
        # Default-on observability: one metrics registry, a tracer from
        # the config; the worker-loop profiler is served too.
        assert cp.orchestrator._metrics is cp.metrics and cp.tracer.enabled
        # The default-off parts are off: none is built.
        assert (cp.ledger, cp.slo, cp.flight, cp.provenance, cp.telemetry_mirror) == (None,) * 5
        cfg["telemetry"] = {"flight": {"profile_worker": True}}
        build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
        # The mirror is the reference's only while telemetry is on.
        cfg["telemetry"] = {"enabled": False, "redis_url": "redis://localhost:6379/0"}
        assert build_control_plane(MCPXConfig.from_dict(cfg), device="cpu").telemetry_mirror is None
        return
    node = cfg.setdefault(section, {})
    *parents, leaf = key.split(".")
    for name in parents:
        node = node.setdefault(name, {})
    node[leaf] = value
    if (section, key) not in SERVED:
        with pytest.raises(ConfigError, match=re.escape(f"{section}.{key}")):
            build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
        return
    if (section, key) in MAKERS:
        _check_served_maker(cfg, section, value, tmp_path)
        return
    # A served option builds its part and wires it as the reference does.
    from mcpx_torch.scheduler import Scheduler
    from mcpx_torch.telemetry.flight import FlightRecorder
    from mcpx_torch.telemetry.ledger import UsageLedger
    from mcpx_torch.telemetry.mirror import FakeAsyncRedis, RedisTelemetryMirror
    from mcpx_torch.telemetry.provenance import ProvenanceRecorder
    from mcpx_torch.telemetry.slo import SLOTracker

    if key == "flight.enabled":
        node["bundle_dir"] = str(tmp_path)
    if section == "slo":
        cfg["scheduler"] = {"enabled": True, "burn_aware": True}
    cp = build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
    built = {
        "redis_url": cp.telemetry_mirror, "flight.enabled": cp.flight, "ledger.enabled": cp.ledger,
        "provenance.enabled": cp.provenance, "enabled": cp.slo,
    }
    for name, part in built.items():
        assert (part is not None) == (name == key), name
    if key == "redis_url":
        assert isinstance(cp.telemetry_mirror, RedisTelemetryMirror)
        assert cp.telemetry_mirror.store is cp.telemetry
        # The client is injectable: one sync over the in-memory Redis.
        cp.telemetry.record("svc", latency_ms=5.0, ok=True)
        cp.telemetry_mirror._client = FakeAsyncRedis()
        assert asyncio.run(cp.telemetry_mirror.sync()) == 0
    elif key == "flight.enabled":
        assert isinstance(cp.flight, FlightRecorder) and cp.flight.config.bundle_dir == str(tmp_path)
        assert "slo_burn" in {d.name for d in cp.flight.detectors}
    elif key == "ledger.enabled":
        assert isinstance(cp.ledger, UsageLedger) and cp.ledger._metrics is cp.metrics
    elif key == "provenance.enabled":
        assert isinstance(cp.provenance, ProvenanceRecorder) and cp.provenance.metrics is cp.metrics
    else:
        # slo.enabled: the tracker's burning() feeds a burn_aware scheduler.
        assert isinstance(cp.slo, SLOTracker) and isinstance(cp.scheduler, Scheduler)
        assert cp.scheduler._slo_burning == cp.slo.burning


def _check_served_maker(cfg: dict, section: str, value, tmp_path) -> None:
    """A served maker builds the part the reference's factory builds."""
    from mcpx_torch.models.sp_model import tiny_model
    from mcpx_torch.models.tokenizer import SentencePieceTokenizer
    from mcpx_torch.planner.mock import MockPlanner
    from mcpx_torch.registry import FileRegistry
    from mcpx_torch.registry.redis_backend import RedisRegistry
    from mcpx_torch.retrieval.index import RetrievalIndex
    from mcpx_torch.telemetry.mirror import FakeAsyncRedis

    records = synth_registry(12, seed=0)
    if section == "cluster":
        # The pool of cluster.replicas engines behind the LLM planner, on
        # the control plane's device; shard_registry (with the pool) makes
        # the retrieval index row-sharded, one shard per replica.
        from mcpx_torch.cluster import EnginePool
        from mcpx_torch.cluster.sharding import ShardedRetrievalIndex

        cfg["planner"]["kind"] = "llm"
        cfg["cluster"]["enabled"] = True
        cfg["cluster"]["replicas"] = 3
        cp = build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
        assert isinstance(cp.planner.engine, EnginePool) and cp.cluster is cp.planner.engine
        assert [r.engine.device.type for r in cp.cluster.replicas] == ["cpu"] * 3
        sharded = isinstance(cp.retriever, ShardedRetrievalIndex)
        assert sharded == bool(cfg["cluster"].get("shard_registry"))
        assert not sharded or cp.retriever.n_shards == 3
    elif section == "retrieval":
        # A snapshot written by the index is loaded at build time.
        index = RetrievalIndex(device="cpu")
        asyncio.run(_refreshed(index, records))
        cfg["retrieval"]["snapshot_path"] = path = str(tmp_path / value)
        index.save(path)
        cp = build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
        assert cp.retriever.size == 12 and cp.retriever.version == -1
    elif section == "planner":
        cp = build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
        assert isinstance(cp.planner, MockPlanner)
    elif value == "file":
        path = tmp_path / "reg.json"
        path.write_text(json.dumps([r.to_dict() for r in records]))
        cfg["registry"]["file_path"] = str(path)
        cp = build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
        assert isinstance(cp.registry, FileRegistry)
        assert len(asyncio.run(cp.registry.list_services())) == 12
    elif value == "redis":
        cfg["registry"]["redis_url"] = "redis://localhost:6379/2"
        cp = build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
        assert isinstance(cp.registry, RedisRegistry)
        cp.registry._client = FakeAsyncRedis()
        asyncio.run(cp.registry.put(records[0]))
        assert asyncio.run(cp.registry.version()) == 1
    else:  # an sp: vocab, read by the LLM planner's engine
        tiny_model().save(str(tmp_path / "tiny.model"))
        cfg["planner"]["kind"] = "llm"
        cfg["model"]["vocab"] = f"sp:{tmp_path / 'tiny.model'}"
        cp = build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
        assert isinstance(cp.planner.engine.tokenizer, SentencePieceTokenizer)
        assert cp.planner.engine.model_cfg.vocab_size == cp.planner.engine.tokenizer.vocab_size == 384


async def _refreshed(index, records):
    from mcpx_torch.registry.memory import InMemoryRegistry

    registry = InMemoryRegistry()
    for rec in records:
        await registry.put(rec)
    await index.refresh(registry)


@pytest.mark.parametrize("option", ["scheduler.enabled", "resilience.enabled", "resilience.chaos_profile"])
def test_factory_serves_and_wires_scheduler_resilience_and_chaos(tmp_path, option):
    """The three options the factory refused until the scheduler and the
    resilience layer were ported are served and wired as the reference's
    factory wires them: the scheduler over the engine's queue stats, the
    resilience facade into the orchestrator with its breakers feeding the
    replan policy, the chaos transport around the transport (also with
    resilience off)."""
    from mcpx_torch.resilience import Resilience
    from mcpx_torch.resilience.chaos import ChaosTransport
    from mcpx_torch.scheduler import Scheduler

    cfg = {"planner": {"kind": "heuristic"}}
    if option == "scheduler.enabled":
        cfg["scheduler"] = {"enabled": True}
    elif option == "resilience.enabled":
        cfg["resilience"] = {"enabled": True}
    else:
        profile = tmp_path / "chaos.json"
        profile.write_text('{"seed": 3, "endpoints": {"local://x": {"error_rate": 0.5}}, '
                           '"cluster": {"replica": 1, "at_s": 1.0, "down_s": 1.0}}')
        cfg["resilience"] = {"chaos_profile": str(profile)}
    cp = build_control_plane(MCPXConfig.from_dict(cfg), device="cpu")
    res = cp.orchestrator.resilience
    if option == "scheduler.enabled":
        assert isinstance(cp.scheduler, Scheduler) and cp.scheduler._engine_stats is None
        assert res is None
    elif option == "resilience.enabled":
        assert isinstance(res, Resilience) and cp.scheduler is None
        assert cp.replan_policy._breakers is res.breakers
        assert not isinstance(cp.orchestrator._transport, ChaosTransport)
    else:
        assert isinstance(cp.orchestrator._transport, ChaosTransport) and res is None
        assert cp.orchestrator._transport._profile.seed == 3
        assert cp.replan_policy._breakers is None
    # The option's off state is the pass-through.
    plain = build_control_plane(MCPXConfig.from_dict({"planner": {"kind": "heuristic"}}), device="cpu")
    assert plain.scheduler is None and plain.orchestrator.resilience is None
    assert not isinstance(plain.orchestrator._transport, ChaosTransport)


# ------------------------------------------------------------ sampling
N_DRAWS, TEMPERATURE, FALSE_FAILURE = 20000, 0.2, 1e-6
# Fixed logits: the two largest are masked (a draw of them would show),
# the rest span 0.8 so that at T = 0.2 the least likely kept column still
# expects about 100 of the draws.
LOGITS = np.array([3.0, 2.5, 0.0, 0.1, 0.2, 0.3, 0.35, 0.45, 0.55, 0.6, 0.7, 0.8, -5.0, 0.05],
                  np.float32)
MASK = np.array([0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1], bool)


def _exact(top_k: int) -> np.ndarray:
    z = np.where(MASK, LOGITS.astype(np.float64), -np.inf) / TEMPERATURE
    if top_k:
        kth = np.sort(z)[-top_k]
        z = np.where(z < kth, -np.inf, z)
    p = np.exp(z - z.max())
    return p / p.sum()


def _draw(package: str, top_k: int, seed: int) -> np.ndarray:
    tiled = np.tile(LOGITS, (N_DRAWS, 1))
    if package == "reference":
        ids = jsampling.sample(
            jax.numpy.asarray(tiled), jax.random.PRNGKey(seed),
            temperature=TEMPERATURE, top_k=top_k, mask=jax.numpy.asarray(MASK),
        )
    else:
        ids = sampling.sample(
            torch.from_numpy(tiled), torch.Generator().manual_seed(seed),
            temperature=TEMPERATURE, top_k=top_k, mask=torch.from_numpy(MASK),
        )
    return np.bincount(np.asarray(ids), minlength=LOGITS.size)


@pytest.mark.parametrize("top_k", [0, 4], ids=["top_k_off", "top_k_4"])
@pytest.mark.parametrize("package", ["reference", "port"])
def test_sampled_draws_follow_the_masked_softmax(package, top_k):
    p = _exact(top_k)
    counts = _draw(package, top_k, seed=3)
    assert counts.sum() == N_DRAWS
    # Masked and cut columns: never drawn.
    assert counts[p == 0].sum() == 0, counts
    support = p > 0
    expected = N_DRAWS * p[support]
    assert expected.min() >= 50
    chi2 = float(((counts[support] - expected) ** 2 / expected).sum())
    limit = stats.chi2.ppf(1.0 - FALSE_FAILURE, df=int(support.sum()) - 1)
    assert chi2 < limit, (chi2, limit, counts, p)


# ------------------------------------------------------------ Random(0)
N_SERVICES, N_INTENTS = 200, 4
CONFIG = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": CKPT},
    "engine": {
        "max_batch_size": 16, "max_decode_len": 64, "kv_page_size": 64, "max_pages_per_seq": 4,
        "temperature": 0.0, "speculate_k": 8, "use_pallas": False, "data_axis": 1, "model_axis": 1,
    },
    "planner": {"kind": "llm"},
    "tracing": {"enabled": False},
}


async def _serve_halves(cp, halves) -> list:
    """Serve N_INTENTS intents of each registry half (from ``Random(h)``,
    the first half's from ``Random(0)``), one half after the other."""
    for rec in halves[0]:
        await cp.registry.put(rec)
    await cp.startup()
    try:
        plans = []
        for h, records in enumerate(halves):
            if h:
                for rec in halves[h - 1]:
                    await cp.registry.delete(rec.name)
                for rec in records:
                    await cp.registry.put(rec)
            rng = random.Random(h)
            intents = [intent_for(records, rng) for _ in range(N_INTENTS)]
            plans += [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
        return plans
    finally:
        await cp.planner.engine.aclose()


def test_random0_half_registry_plans_match_reference_in_float32():
    """The ``Random(0)`` set whose bf16 plans differ in 2 of 8 (near-ties
    under bf16 rounding) gives byte-identical plans with float32 forwards
    on both sides. ``model.dtype`` is read by neither package's engine, so
    both get a float32 model config; the checkpoint's bf16 weights are
    exact in float32 on both."""
    jcfg, cfg = JConfig.from_dict(CONFIG), MCPXConfig.from_dict(CONFIG)
    jmodel = dataclasses.replace(JGemmaConfig.named("test", vocab_size=3072, max_seq_len=2048), dtype="float32")
    model = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072, max_seq_len=2048), dtype="float32")
    records = jsynth(N_SERVICES, seed=0)
    port_records = synth_registry(N_SERVICES, seed=0)
    half = N_SERVICES // 2
    ref = asyncio.run(_serve_halves(
        jbuild(jcfg, planner=JPlanner(JEngine(jcfg, model_cfg=jmodel), jcfg.planner)),
        [records[:half], records[half:]],
    ))
    engine = InferenceEngine(cfg, model_cfg=model, device="cpu")
    port = asyncio.run(_serve_halves(
        build_control_plane(cfg, planner=LLMPlanner(engine, cfg.planner), device="cpu"),
        [port_records[:half], port_records[half:]],
    ))
    assert engine.model_cfg.dtype == "float32"
    assert sum(p.origin == "llm" for p in port) >= len(port) - 1
    differ = [i for i, (a, b) in enumerate(zip(ref, port)) if a.to_json() != b.to_json()]
    assert not differ, [(ref[i].to_json(), port[i].to_json()) for i in differ]
