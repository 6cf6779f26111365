"""``plan_and_execute`` and the warm replan held against the reference
package on the CPU:

  - the replan prompt: ``render_prompt`` and ``build_prompt_ids`` with an
    ``avoid`` list and seeded telemetry give byte-identical text and ids;
  - the control plane on the heuristic planner: ``plan_and_execute``'s
    output equal to the reference's (trace timings masked) when a replan
    routes around a failure and when the budget runs out; the prompt prefix
    pinned once and released exactly once, also when ``execute`` raises;
  - the Redis plan-cache tier over an injected dict-backed client: misses,
    writes, a shared hit on a second control plane, and the repaired plan
    written to every tier after a replan, with the reference's counters;
  - on the committed checkpoint (greedy, one device on the reference side,
    float32 forwards on both sides, and again in bf16 where noted):
    the warm replan of ``tests/test_prefix_cache.py``
    (``test_llm_planner_warm_replan_reuses_prefix``): both plans equal the
    reference's, the replan prompt byte-extends the original through the
    services block and the engine serves that head from the radix tree,
    prefilling only the suffix; and ``plan_and_execute`` over intents whose
    first service always fails: output dicts equal (timings masked), every
    pin released, including when ``execute`` raises. In bf16 the warm
    replan is equal too; the plan_and_execute set parts from the reference
    at one engine call, whose first differing token is shown to be a
    near-tie (both top-2 margins below the frameworks' bf16 logit gap).

Service latencies are recorded as 0 ms in both packages' telemetry stores
(the EWMA latency comes from the wall clock, and prompts render it as
``p50=``, heuristic explanations as ``p50~``), so prompts and plans after
executions depend only on outcomes.
"""

import asyncio
import dataclasses
import os
import random

import pytest
import torch

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.engine.engine import InferenceEngine as JEngine
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.orchestrator.transport import LocalTransport as JLocal
from mcpx.orchestrator.transport import RouterTransport as JRouter
from mcpx.orchestrator.transport import TransportError as JTransportError
from mcpx.planner import llm as jllm
from mcpx.planner.base import PlanContext as JPlanContext
from mcpx.planner.llm import LLMPlanner as JPlanner
from mcpx.registry import InMemoryRegistry as JRegistry
from mcpx.registry import ServiceRecord as JRecord
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.telemetry.stats import TelemetryStore as JTelemetryStore
from mcpx.models.tokenizer import make_tokenizer as jmake_tokenizer
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.tokenizer import make_tokenizer
from mcpx_torch.orchestrator.transport import LocalTransport, RouterTransport, TransportError
from mcpx_torch.planner import llm
from mcpx_torch.planner.base import PlanContext
from mcpx_torch.planner.llm import LLMPlanner
from mcpx_torch.registry import InMemoryRegistry, ServiceRecord
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.telemetry.stats import TelemetryStore
from mcpx_torch.utils.synth import synth_registry

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)



def _model_cfg(gemma_config_cls, dtype: str):
    """The test preset's model config in ``dtype``: ``model.dtype`` is read
    by neither package's engine, so the engines get it directly."""
    return dataclasses.replace(gemma_config_cls.named("test", vocab_size=3072, max_seq_len=2048), dtype=dtype)


REF = dict(
    build=lambda cfg, **kw: jbuild(cfg, **kw), Config=JConfig, Local=JLocal, Router=JRouter,
    TransportError=JTransportError, Record=JRecord, Registry=JRegistry,
    planner=lambda cfg, dtype: JPlanner(JEngine(cfg, model_cfg=_model_cfg(JGemmaConfig, dtype)), cfg.planner),
)
PORT = dict(
    build=lambda cfg, **kw: build_control_plane(cfg, device="cpu", **kw), Config=MCPXConfig,
    Local=LocalTransport, Router=RouterTransport, TransportError=TransportError,
    Record=ServiceRecord, Registry=InMemoryRegistry,
    planner=lambda cfg, dtype: LLMPlanner(
        InferenceEngine(cfg, model_cfg=_model_cfg(GemmaConfig, dtype), device="cpu"), cfg.planner
    ),
)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def masked(obj):
    """``obj`` with wall-clock fields and trace ids replaced by None."""
    if isinstance(obj, dict):
        return {
            k: None if k in ("latency_ms", "total_ms", "trace_id") else masked(v)
            for k, v in obj.items()
        }
    if isinstance(obj, list):
        return [masked(v) for v in obj]
    return obj


def zero_latency(store) -> None:
    """Record every call of ``store`` at 0 ms: outcomes stay, the wall
    clock leaves the prompts."""
    record = store.record

    def at_zero(service, *, latency_ms, ok, cost=0.0):
        record(service, latency_ms=0.0, ok=ok, cost=cost)

    store.record = at_zero


def failing_transport(ns, records, failing: set):
    """A zero-latency handler for every endpoint and fallback of
    ``records``; every endpoint of a ``failing`` service raises."""
    local = ns["Local"]()
    calls = []

    def handler(name, endpoint, fail):
        async def call(payload):
            calls.append(endpoint)
            if fail:
                raise ns["TransportError"](f"{name} is down")
            return {"service": name, "out": sorted(payload)}

        return call

    for r in records:
        for ep in [r.endpoint, *r.fallbacks]:
            local.register(ep.removeprefix("local://"), handler(r.name, ep, r.name in failing))
    return ns["Router"](local=local), calls


# ------------------------------------------------------------ the prompt
@pytest.mark.parametrize("budget", [400, 90])
@pytest.mark.parametrize("avoid", [None, ["svc-b", "svc-a"]], ids=["no_avoid", "avoid"])
def test_replan_prompt_is_byte_identical(avoid, budget):
    services, jservices = synth_registry(12, seed=4), jsynth(12, seed=4)
    store, jstore = TelemetryStore(), JTelemetryStore()
    for i, rec in enumerate(services[:7]):
        for k in range(3):
            ms, ok = 3.0 * i + 7.5 * k, (i + k) % 3 != 0
            store.record(rec.name, latency_ms=ms, ok=ok, cost=0.1 * k)
            jstore.record(rec.name, latency_ms=ms, ok=ok, cost=0.1 * k)
    ctx = PlanContext(registry=None, telemetry=store.snapshot())
    jctx = JPlanContext(registry=None, telemetry=jstore.snapshot())
    text, head = llm.render_prompt("fetch then score", services, ctx, avoid=avoid)
    jtext, jhead = jllm.render_prompt("fetch then score", jservices, jctx, avoid=avoid)
    assert (text, head) == (jtext, jhead)
    assert ("\nAvoid: svc-b,svc-a\n" in text) == bool(avoid)
    assert " err=" in text and " p50=" in text
    got = llm.build_prompt_ids(make_tokenizer("bpe"), "fetch then score", services, ctx, budget, avoid=avoid)
    want = jllm.build_prompt_ids(jmake_tokenizer("bpe"), "fetch then score", jservices, jctx, budget, avoid=avoid)
    assert got == want
    assert len(got[0]) + len(got[1]) <= budget


# ------------------------------------------------------- heuristic planner
def _rank_records(ns):
    mk = lambda name: ns["Record"](  # noqa: E731
        name=name, endpoint=f"local://{name}", description="rank items by score quality",
        input_schema={"query": "str"}, output_schema={"score": "str"},
    )
    return [mk("rank-broken"), mk("rank-healthy")]


class PinRecorder:
    def __init__(self):
        self.pins, self.unpins = [], []

    async def pin_prefix(self, ids):
        self.pins.append(list(ids))
        return ("pin", len(self.pins))

    def unpin_prefix(self, handle):
        self.unpins.append(handle)


async def _heuristic_run(ns, records, failing, max_replans, raise_in_execute=False):
    cfg = ns["Config"].from_dict({
        "planner": {"kind": "heuristic", "shortlist_top_k": 1},
        "orchestrator": {"retry_backoff_s": 0.0, "default_retries": 0},
        "telemetry": {"max_replans": max_replans},
    })
    transport, calls = failing_transport(ns, records, failing)
    cp = ns["build"](cfg, transport=transport)
    zero_latency(cp.telemetry)  # the heuristic planner explains with p50
    for r in records:
        await cp.registry.put(r)
    rec = PinRecorder()
    cp.planner.engine = rec  # heuristic planner: the engine slot is free
    seen_prior = []
    real_plan = cp.planner.plan

    async def spy_plan(intent, context):
        seen_prior.append(context.replan_prior)
        plan = await real_plan(intent, context)
        # LLM provenance, so the pin path engages.
        plan.prompt_ids = [1, 2, 3, 4]
        plan.prompt_services = [n.service for n in plan.nodes]
        return plan

    cp.planner.plan = spy_plan
    if raise_in_execute:
        async def broken_execute(plan, payload, trace=None):
            raise RuntimeError("executor crashed")

        cp.execute = broken_execute
        with pytest.raises(RuntimeError, match="executor crashed"):
            await cp.plan_and_execute("rank items by score quality", {"query": "q"})
        return None, rec, seen_prior, calls, None
    out = await cp.plan_and_execute("rank items by score quality", {"query": "q"})
    return out, rec, seen_prior, calls, cp.cache_stats()


@pytest.mark.parametrize(
    "failing,max_replans",
    [({"rank-broken"}, 2), ({"rank-broken", "rank-healthy"}, 2), ({"rank-broken"}, 0), (set(), 2)],
    ids=["replan_recovers", "budget_runs_out", "no_replan_budget", "healthy"],
)
def test_heuristic_plan_and_execute_matches_reference(failing, max_replans):
    ref = asyncio.run(_heuristic_run(REF, _rank_records(REF), failing, max_replans))
    port = asyncio.run(_heuristic_run(PORT, _rank_records(PORT), failing, max_replans))
    out, rec, prior, calls, cache = port
    assert masked(out) == masked(ref[0])
    assert (prior, calls, cache) == (ref[2], ref[3], ref[4])
    # Pinned once (the original plan), released exactly once.
    assert rec.pins == ref[1].pins == [[1, 2, 3, 4]]
    assert rec.unpins == ref[1].unpins == [("pin", 1)]
    if failing == {"rank-broken"} and max_replans:
        assert out["status"] == "ok" and out["replans"] == 1
        assert [n["name"] for n in out["graph"]["nodes"]] == ["rank-healthy"]
        assert prior == [None, ("rank-broken",)]


def test_pin_released_when_execute_raises():
    for ns in (REF, PORT):
        _, rec, _, _, _ = asyncio.run(
            _heuristic_run(ns, _rank_records(ns), {"rank-broken"}, 2, raise_in_execute=True)
        )
        assert rec.pins == [[1, 2, 3, 4]] and rec.unpins == [("pin", 1)]


# ------------------------------------------------------------ redis tier
class DictRedis:
    """The async get/set surface of a redis client over a dict."""

    def __init__(self):
        self.data, self.ttls = {}, {}

    async def get(self, key):
        return self.data.get(key)

    async def set(self, key, value, ex=None):
        self.data[key] = value
        self.ttls[key] = ex


async def _redis_run(ns, cache_cls):
    client = DictRedis()
    cfg = {
        "planner": {"kind": "heuristic", "shortlist_top_k": 1, "plan_cache_redis_ttl_s": 0.4},
        "orchestrator": {"retry_backoff_s": 0.0, "default_retries": 0},
    }
    out = []
    for _ in range(2):  # two replicas over one shared tier
        transport, _ = failing_transport(ns, _rank_records(ns), {"rank-broken"})
        cp = ns["build"](ns["Config"].from_dict(cfg), transport=transport)
        zero_latency(cp.telemetry)
        cp.redis_plan_cache = cache_cls(client=client, ttl_s=0.4)
        for r in _rank_records(ns):
            await cp.registry.put(r)
        p1, _ = await cp.plan("rank items by score quality")
        res = await cp.plan_and_execute("rank items by score quality", {"query": "q"})
        await asyncio.gather(*cp._cache_writes)
        p2, _ = await cp.plan("rank items by score quality")
        out.append((p1.to_json(), masked(res), p2.to_json(), cp.cache_stats()))
    return out, sorted(client.data.items()), sorted(client.ttls.values())


def test_redis_tier_matches_reference():
    from mcpx.server.plan_cache import RedisPlanCache as JCache
    from mcpx_torch.server.plan_cache import RedisPlanCache

    ref = asyncio.run(_redis_run(REF, JCache))
    port = asyncio.run(_redis_run(PORT, RedisPlanCache))
    assert port == ref
    (first, second), data, ttls = port
    # Replica 1 missed both tiers and wrote; the replan's repaired plan went
    # to every tier; replica 2 hit the shared tier first.
    assert first[3]["plan_cache"]["misses"] == 1 and second[3]["plan_cache"]["redis_hits"] == 1
    assert "rank-healthy" in first[2] and len(data) == 1 and ttls == [1]


# ----------------------------------------------------- committed checkpoint
N_SERVICES, N_INTENTS = 40, 4
CONFIG = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": CKPT},
    "engine": {
        # 16-token pages (the reference's prefix-cache tests' geometry): the
        # shared services block spans several pages of these short prompts.
        "max_batch_size": 16, "max_decode_len": 64, "kv_page_size": 16, "max_pages_per_seq": 16,
        "temperature": 0.0, "speculate_k": 8, "use_pallas": False, "data_axis": 1, "model_axis": 1,
    },
    "planner": {"kind": "llm"},
    "orchestrator": {"retry_backoff_s": 0.0},
    "tracing": {"enabled": False},
}


async def _llm_run(ns, records, port: bool, dtype: str = "float32"):
    """On one control plane: the failing set from /plan, the planner-level
    warm replan, then plan_and_execute over every intent (one at a time),
    and one more whose execute raises. Every engine call is kept as
    (prompt ids, grammar, decode budget, generated ids)."""
    cfg = ns["Config"].from_dict(CONFIG)
    rng = random.Random(5)
    intents = [intent_for(records, rng) for _ in range(N_INTENTS)]
    cp0 = ns["build"](cfg, planner=ns["planner"](cfg, dtype))
    for r in records:
        await cp0.registry.put(r)
    await cp0.startup()
    eng = cp0.planner.engine
    out = {"generate": []}
    real_generate = eng.generate

    async def recording(prompt_ids, **kw):
        res = await real_generate(prompt_ids, **kw)
        if kw.get("max_new_tokens", 0) != 1:  # not the planner's warm-up
            budget = kw.get("max_new_tokens") or cfg.engine.max_decode_len
            out["generate"].append((list(prompt_ids), kw.get("grammar"), budget, list(res.token_ids)))
        return res

    eng.generate = recording
    try:
        # The failing set: the first service of every other intent's plan.
        plans = [p for p, _ in [await cp0.plan(i, use_cache=False) for i in intents]]
        failing = {p.nodes[0].service for p in plans[::2]}
        out["plans"] = [p.to_json() for p in plans]
        transport, calls = failing_transport(ns, records, failing)
        cp = ns["build"](cfg, transport=transport, planner=cp0.planner, registry=cp0.registry,
                         retriever=cp0.retriever)
        zero_latency(cp.telemetry)

        # Warm replan, planner level: exclude plan 0's first service.
        ctx = await cp._context(intents[0])
        plan1 = await cp.planner.plan(intents[0], ctx)
        m0 = eng._prefix_cache.matched_tokens
        q0 = eng.queue_stats() if port else None
        ctx2 = await cp._context(
            intents[0], {plan1.nodes[0].service}, replan_prior=tuple(plan1.prompt_services)
        )
        plan2 = await cp.planner.plan(intents[0], ctx2)
        out["warm"] = dict(
            plans=[plan1.to_json(), plan2.to_json()], origins=[plan1.origin, plan2.origin],
            ids=[plan1.prompt_ids, plan2.prompt_ids], matched=eng._prefix_cache.matched_tokens - m0,
            excluded=plan1.nodes[0].service,
        )
        if port:
            q1 = eng.queue_stats()
            out["warm"]["suffix"] = {
                k: q1[k] - q0[k] for k in ("suffix_prefills", "suffix_prefill_launches", "prefill_tokens")
            }

        results, pins_after, handles = [], [], []
        if port:
            real_pin = eng.pin_prefix

            async def pin_spy(ids):
                handles.append(await real_pin(ids))
                return handles[-1]

            eng.pin_prefix = pin_spy
        for intent in intents:
            results.append(masked(await cp.plan_and_execute(intent, {"text": "t", "query": "q"})))
            if port:
                pins_after.append(await _pins_released(eng))
        out["results"], out["failing"], out["calls"] = results, sorted(failing), calls
        out["telemetry"] = {k: s.to_dict() for k, s in sorted(cp.telemetry.snapshot().items())}

        async def broken_execute(plan, payload, trace=None):
            raise RuntimeError("executor crashed")

        cp.execute = broken_execute
        with pytest.raises(RuntimeError, match="executor crashed"):
            await cp.plan_and_execute(intents[1], {})
        if port:
            out["pins_after"] = pins_after + [await _pins_released(eng)]
            out["pins_taken"] = sum(h is not None for h in handles)
            out["pinned_nodes"] = _pinned_nodes(eng._prefix_cache)
    finally:
        await eng.aclose()
    return out


async def _pins_released(eng) -> int:
    """Pins the engine still holds once the queued unpin has been applied
    (it rides the worker's queue)."""
    for _ in range(200):
        if eng.queue_stats()["prefix_pins"] == 0:
            break
        await asyncio.sleep(0.01)
    return eng.queue_stats()["prefix_pins"]


def _pinned_nodes(tree) -> int:
    """Nodes with a live pinner (the engine is idle: no row pins either)."""
    n, stack = 0, list(tree.root.children.values())
    while stack:
        node = stack.pop()
        n += node.refs > 0
        stack.extend(node.children.values())
    return n


@pytest.fixture(scope="module")
def llm_runs():
    ref = asyncio.run(_llm_run(REF, jsynth(N_SERVICES, seed=0), port=False))
    port = asyncio.run(_llm_run(PORT, synth_registry(N_SERVICES, seed=0), port=True))
    return ref, port


@pytest.fixture(scope="module")
def llm_runs_bf16():
    ref = asyncio.run(_llm_run(REF, jsynth(N_SERVICES, seed=0), port=False, dtype="bfloat16"))
    port = asyncio.run(_llm_run(PORT, synth_registry(N_SERVICES, seed=0), port=True, dtype="bfloat16"))
    return ref, port


def test_llm_planner_warm_replan_reuses_prefix(llm_runs):
    _check_warm_replan(*llm_runs)


def test_llm_planner_warm_replan_reuses_prefix_in_bf16(llm_runs_bf16):
    """The warm replan in bf16, as the card serves it: the same plans and
    prompts as the reference, exactly."""
    _check_warm_replan(*llm_runs_bf16)


def _check_warm_replan(ref, port):
    warm = port["warm"]
    assert warm["origins"] == ["llm", "llm"]
    assert warm["plans"] == ref["warm"]["plans"] and warm["ids"] == ref["warm"]["ids"]
    assert warm["excluded"] not in warm["plans"][1]
    tok = make_tokenizer("bpe")
    text1 = tok.decode(warm["ids"][0])
    shared = tok.encode(text1[: text1.rindex("\nIntent:")])
    assert warm["ids"][1][: len(shared)] == shared
    assert "Avoid:" in tok.decode(warm["ids"][1])
    # The engine served the shared head from the tree and prefilled only
    # the suffix (on the CPU the plain version of the kernel: no launches).
    page = CONFIG["engine"]["kv_page_size"]
    assert warm["matched"] >= (len(shared) // page) * page - page > 0
    assert warm["matched"] == ref["warm"]["matched"]
    assert warm["suffix"]["suffix_prefills"] >= 1
    assert warm["suffix"]["prefill_tokens"] <= len(warm["ids"][1]) - warm["matched"]


def test_llm_plan_and_execute_matches_reference(llm_runs):
    ref, port = llm_runs
    assert port["plans"] == ref["plans"]
    assert port["failing"] == ref["failing"] and port["failing"]
    assert port["results"] == ref["results"]
    assert port["calls"] == ref["calls"]
    assert port["telemetry"] == ref["telemetry"]
    replanned = [r for r in port["results"] if r["replans"]]
    assert replanned, port["results"]
    for r in port["results"]:
        names = {n["service"] for n in r["graph"]["nodes"]}
        if r["replans"]:
            assert not names & set(port["failing"]), r
    # Every pin released: after each plan_and_execute, and after the one
    # whose execute raised.
    assert port["pins_taken"] == N_INTENTS + 1
    assert port["pins_after"] == [0] * (N_INTENTS + 1) and port["pinned_nodes"] == 0


def _allowed(grammar, toks: list, budget: int):
    """(active token ids, the columns greedy decoding may pick) after
    ``toks``: grammar-legal and able to finish within the decode budget,
    as the engines mask them."""
    trans, mask, dist, active, eos, inv = grammar.device_tables(64)
    s = 0
    for t in toks:
        s = int(trans[s, inv[t]])
    legal = mask[s]
    finish = legal & (eos | (dist[trans[s]] <= budget - len(toks) - 1))
    return active, finish if finish.any() else legal


def test_llm_plan_and_execute_bf16_difference_is_a_near_tie(llm_runs_bf16):
    """In bf16 the /plan plans and the warm replan equal the reference's;
    the first engine call of plan_and_execute whose output differs (its
    prompt byte-identical in both packages) parts at a token where both
    frameworks' masked top-2 margins are below the largest gap between the
    two frameworks' bf16 logits over the allowed columns (dense prefill of
    the prompt and the common generated prefix, the committed checkpoint):
    a near-tie that bf16 rounding decides, not a port fault. In float32
    the same runs are equal (``test_llm_plan_and_execute_matches_reference``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcpx.models.gemma import model as jm
    from mcpx.models.train import load_npz as jload_npz
    from mcpx_torch.models.gemma import model as tm
    from mcpx_torch.models.gemma.params import params_from_numpy

    ref, port = llm_runs_bf16
    assert port["plans"] == ref["plans"] and port["failing"] == ref["failing"]
    pairs = list(zip(port["generate"], ref["generate"]))
    k_call = next(i for i, (a, b) in enumerate(pairs) if a[3] != b[3])
    (ids, grammar, budget, toks), (ref_ids, _, _, ref_toks) = pairs[k_call]
    assert ids == ref_ids and all(a[3] == b[3] for a, b in pairs[:k_call])
    k = next(i for i, (x, y) in enumerate(zip(toks, ref_toks)) if x != y)
    prefix = ids + toks[:k]
    jcfg, tcfg = _model_cfg(JGemmaConfig, "bfloat16"), _model_cfg(GemmaConfig, "bfloat16")
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jload_npz(CKPT))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    n = len(prefix)
    jl, _ = jm.prefill(
        jparams, jcfg, jnp.asarray([prefix], jnp.int32), jnp.asarray([n], jnp.int32),
        jm.init_kv_cache(jcfg, 1, n), last_only=True,
    )
    tl, _ = tm.prefill(
        tparams, tcfg, torch.tensor([prefix]), torch.tensor([n]), tm.init_kv_cache(tcfg, 1, n, device="cpu"),
        last_only=True,
    )
    active, allowed = _allowed(grammar, toks[:k], budget)
    cols = active[allowed]
    jv, tv = np.asarray(jl[0], np.float32)[cols], tl[0].float().numpy()[cols]
    margins = [float(np.diff(np.sort(v)[-2:])[0]) for v in (tv, jv)]
    gap = float(np.abs(tv - jv).max())
    print(f"call {k_call} token {k}: top-2 margins port {margins[0]:.4f} ref {margins[1]:.4f}, bf16 gap {gap:.4f}")
    assert toks[k] in cols and ref_toks[k] in cols
    assert max(margins) < gap

