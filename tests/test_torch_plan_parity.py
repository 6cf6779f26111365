"""The slice as a whole: greedy /plan through the LLM planner in the
reference package and in the port, on the committed checkpoint, must give
byte-identical plans.

Both sides use the BPE vocab, temperature 0, speculate_k=8, the homogeneous
slab, no drafting and no prefix cache, over the same 200-service synthetic
registry and the same 8 intents. The reference runs its jnp attention
(``use_pallas=False``; its own tests hold kernel and reference to identical
greedy output); the port runs on the CPU, where attention takes the plain
version. Plans are compared as ``Plan.to_json()`` strings: no tolerance.
"""

import asyncio
import dataclasses
import os
import random

import pytest

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.engine.engine import InferenceEngine as JEngine
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.models.tokenizer import make_tokenizer as jmake_tokenizer
from mcpx.planner.base import PlanContext as JPlanContext
from mcpx.planner.llm import LLMPlanner as JPlanner, build_prompt_ids as jbuild_prompt_ids
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.tokenizer import make_tokenizer
from mcpx_torch.planner.base import PlanContext
from mcpx_torch.planner.llm import LLMPlanner, build_prompt_ids
from mcpx_torch.registry.base import ServiceRecord
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.utils.synth import synth_registry

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)
N_SERVICES, N_INTENTS = 200, 8
CONFIG = {
    "model": {"size": "test", "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": CKPT},
    "engine": {
        "max_batch_size": 16, "max_decode_len": 64, "kv_page_size": 64, "max_pages_per_seq": 4,
        "temperature": 0.0, "speculate_k": 8, "hetero_batch": False, "prefix_cache": False,
        "draft_mode": "off", "use_pallas": False,
        # One device: the test suite's 8-device virtual CPU mesh would
        # otherwise shard the reference's heads, and the tensor-parallel
        # fp32 sums can flip a near-tied greedy pick.
        "data_axis": 1, "model_axis": 1,
    },
    "planner": {"kind": "llm"},
    "tracing": {"enabled": False},
}


async def _serve(cp, records, intents, direct: bool = False):
    for rec in records:
        await cp.registry.put(rec)
    await cp.startup()
    try:
        via_cp = [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
        if not direct:
            return via_cp, None
        contexts = [await cp._context(i) for i in intents]
        via_planner = await asyncio.gather(
            *(cp.planner.plan(i, c) for i, c in zip(intents, contexts))
        )
        return via_cp, list(via_planner)
    finally:
        await cp.planner.engine.aclose()


@pytest.fixture(scope="module")
def plans():
    records = jsynth(N_SERVICES, seed=0)
    rng = random.Random(0)
    intents = [intent_for(records, rng) for _ in range(N_INTENTS)]
    ref, _ = asyncio.run(_serve(jbuild(JConfig.from_dict(CONFIG)), records, intents))
    port_cp, port_direct = asyncio.run(
        _serve(
            build_control_plane(MCPXConfig.from_dict(CONFIG), device="cpu"),
            synth_registry(N_SERVICES, seed=0), intents, direct=True,
        )
    )
    return intents, ref, port_cp, port_direct


@pytest.mark.parametrize("i", range(N_INTENTS))
def test_port_plan_is_byte_identical_to_reference(plans, i):
    intents, ref, port_cp, _ = plans
    assert ref[i].origin == "llm", intents[i]
    assert port_cp[i].to_json() == ref[i].to_json(), intents[i]


@pytest.mark.parametrize("budget", [40, 180])
def test_prompt_ids_match_reference(budget):
    """``build_prompt_ids`` renders, encodes and clamps the prompt to the
    same token ids in both packages, including the proportional shrink of
    the service list when the budget is tight."""
    records = jsynth(N_SERVICES, seed=0)
    rng = random.Random(1)
    jtok, ttok = jmake_tokenizer("bpe"), make_tokenizer("bpe")
    for _ in range(4):
        intent = intent_for(records, rng)
        services = rng.sample(records, 12)
        ref = jbuild_prompt_ids(jtok, intent, services, JPlanContext(registry=None), budget)
        out = build_prompt_ids(
            ttok, intent, [ServiceRecord.from_dict(r.to_dict()) for r in services],
            PlanContext(registry=None), budget,
        )
        assert out == ref, intent


def test_planner_direct_matches_control_plane(plans):
    """``LLMPlanner.plan`` called with the control plane's retrieval context
    gives the same plans as ``ControlPlane.plan``."""
    _, _, port_cp, port_direct = plans
    assert [p.to_json() for p in port_direct] == [p.to_json() for p in port_cp]
    for p in port_cp:
        p.validate()


def test_shortlist_constrained_plans_match_reference_in_float32():
    """``planner.constrain_names="shortlist"``: the grammar admits only the
    retrieval shortlist's names (a trie per shortlist, not one over the
    registry). Greedy plans on the committed checkpoint, float32 forwards
    on both sides, are byte-identical."""
    cfg = {**CONFIG, "planner": {"kind": "llm", "constrain_names": "shortlist"}}
    records = jsynth(N_SERVICES, seed=0)
    rng = random.Random(5)
    intents = [intent_for(records, rng) for _ in range(N_INTENTS)]
    jcfg, tcfg = JConfig.from_dict(cfg), MCPXConfig.from_dict(cfg)
    jmodel = dataclasses.replace(JGemmaConfig.named("test", vocab_size=3072, max_seq_len=2048), dtype="float32")
    model = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072, max_seq_len=2048), dtype="float32")
    ref, _ = asyncio.run(_serve(
        jbuild(jcfg, planner=JPlanner(JEngine(jcfg, model_cfg=jmodel), jcfg.planner)), records, intents
    ))
    engine = InferenceEngine(tcfg, model_cfg=model, device="cpu")
    port, _ = asyncio.run(_serve(
        build_control_plane(tcfg, planner=LLMPlanner(engine, tcfg.planner), device="cpu"),
        synth_registry(N_SERVICES, seed=0), intents,
    ))
    assert engine.model_cfg.dtype == "float32"
    assert sum(p.origin == "llm" for p in ref) >= N_INTENTS - 1
    assert [p.to_json() for p in port] == [p.to_json() for p in ref]
