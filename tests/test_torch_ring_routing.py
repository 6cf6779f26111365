"""Long-prompt routing through ring prefill on the port's engine: the
reference's ``tests/test_ring_routing.py`` on ``mcpx_torch`` (the same float32
``MODEL_F32`` and meshes, as virtual CPU meshes), and the port's greedy tokens
against the reference engine's (on the conftest's 8 devices) from one
float32 checkpoint, for the long prompt (ring-routed) and the short one."""

import asyncio
import dataclasses

import jax
import pytest
import torch

from mcpx.core.config import MCPXConfig as JMCPXConfig
from mcpx.engine.engine import InferenceEngine as JInferenceEngine
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.models.gemma.model import init_params as jinit
from mcpx.models.train import save_npz as jsave_npz
from mcpx.parallel.mesh import make_mesh as jmake_mesh
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.errors import EngineError
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.parallel.mesh import make_mesh

CPU8 = [torch.device("cpu")] * 8
# float32 end to end so dense-vs-ring softmax accumulation cannot wobble the
# greedy argmax (the reference test's rationale).
SHAPE = dict(vocab_size=384, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
             dtype="float32", max_seq_len=512)
MODEL_F32 = GemmaConfig(**SHAPE)
LONG_PROMPT = (
    "Compose a service DAG over the following services. "
    + " ".join(f"svc-{i:03d} in:query out:result" for i in range(18))
    + " Intent: fetch then summarize. JSON:"
)
SHORT_PROMPT = "plan. JSON:"


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(ring_min: int, checkpoint: str = "") -> dict:
    return {
        "model": {"size": "test", "max_seq_len": 512, "checkpoint_path": checkpoint},
        "engine": {
            "use_pallas": False, "max_batch_size": 2, "max_decode_len": 48, "kv_page_size": 16,
            "max_pages_per_seq": 32, "temperature": 0.0, "ring_prefill_min_tokens": ring_min,
        },
    }


async def _serve(eng):
    await eng.start()
    try:
        out_long = await eng.generate(eng.tokenizer.encode(LONG_PROMPT), max_new_tokens=40)
        out_short = await eng.generate(eng.tokenizer.encode(SHORT_PROMPT), max_new_tokens=24)
        return out_long.token_ids, out_short.token_ids, eng._seq_mesh
    finally:
        await eng.aclose()


def _port(ring_min: int, checkpoint: str = "", mesh_kw=None):
    eng = InferenceEngine(MCPXConfig.from_dict(_cfg_dict(ring_min, checkpoint)), model_cfg=MODEL_F32,
                          mesh=make_mesh(**(mesh_kw or dict(data=4, model=2)), devices=CPU8), device="cpu")
    long_ids, short_ids, seq_mesh = asyncio.run(_serve(eng))
    return long_ids, short_ids, seq_mesh, eng.metrics.ring_prefills._only().value, eng


def test_long_prompt_routes_through_ring_and_matches_dense():
    """The ~600-byte prompt takes a bucket over the 256 threshold and rings
    over the 4 data coordinates viewed as a seq axis; the short prompt stays
    dense; the tokens equal the dense route's."""
    ring_long, ring_short, seq_mesh, n_ring, eng = _port(256)
    assert seq_mesh is not None and seq_mesh.shape == {"data": 1, "seq": 4, "model": 2}
    dense_long, dense_short, no_mesh, n_dense, _ = _port(0)
    assert no_mesh is None
    assert n_ring == 1 and n_dense == 0
    assert ring_long == dense_long and ring_short == dense_short
    assert eng.queue_stats()["captures"] == 0  # eager on the CPU, as dense prefill


def test_injected_seq_mesh_is_reused():
    """An engine on a mesh that already carries a seq axis rings over THAT
    mesh."""

    async def go():
        mesh = make_mesh(data=1, seq=4, model=2, devices=CPU8)
        eng = InferenceEngine(MCPXConfig.from_dict(_cfg_dict(256)), model_cfg=MODEL_F32, mesh=mesh, device="cpu")
        await eng.start()
        try:
            assert eng._seq_mesh is mesh
            assert eng._ring_ok(256) and not eng._ring_ok(64) and not eng._ring_ok(258)
        finally:
            await eng.aclose()

    asyncio.run(go())


def test_a_default_engine_builds_a_one_by_one_mesh_and_never_rings():
    """No injected mesh: ``_mesh_axes`` over the engine's one device gives
    1 x 1 whatever the axes ask, so there is no seq view and no ring."""

    async def go():
        cfg = MCPXConfig.from_dict(_cfg_dict(256))
        cfg.engine.data_axis = 4
        eng = InferenceEngine(cfg, model_cfg=MODEL_F32, device="cpu")
        await eng.start()
        try:
            assert eng._mesh.shape == {"data": 1, "model": 1} and eng._seq_mesh is None
            assert not eng._ring_ok(512)
        finally:
            await eng.aclose()

    asyncio.run(go())


@pytest.mark.parametrize("devices", [["cpu", "meta"], [torch.device("cuda", 1)] * 2], ids=["meta", "cuda1"])
def test_a_mesh_of_another_device_is_refused(devices):
    named = "device meta holds no data" if "meta" in devices else "device cuda:1 is not visible"
    with pytest.raises(EngineError, match=named):
        InferenceEngine(MCPXConfig.from_dict(_cfg_dict(256)), model_cfg=MODEL_F32,
                        mesh=make_mesh(data=2, devices=devices), device="cpu")


def test_greedy_tokens_equal_the_reference_engine(tmp_path):
    """One float32 checkpoint (the reference's init of ``MODEL_F32``) served
    by both engines on the ``data=4, model=2`` mesh with ring routing armed:
    the long prompt's ring-prefilled tokens and the short prompt's dense
    ones are the reference engine's."""
    jcfg = JGemmaConfig(**SHAPE)
    ckpt = str(tmp_path / "f32.npz")
    jsave_npz(ckpt, jinit(jcfg, jax.random.PRNGKey(0)), dtype="float32")
    jeng = JInferenceEngine(JMCPXConfig.from_dict(_cfg_dict(256, ckpt)), model_cfg=jcfg,
                            mesh=jmake_mesh(data=4, model=2))
    want_long, want_short, _ = asyncio.run(_serve(jeng))
    assert want_long and want_short
    assert jeng.metrics.ring_prefills._value.get() == 1
    got_long, got_short, _, n_ring, _ = _port(256, ckpt)
    assert n_ring == 1
    assert got_long == want_long and got_short == want_short
    assert dataclasses.asdict(MODEL_F32) == dataclasses.asdict(jcfg)


def test_mesh_axes_follow_the_reference_rule():
    """``_mesh_axes`` over any device count, auto and explicit axes, equals
    the reference engine's (unstarted engines of both packages)."""
    for data_axis, model_axis in ((0, 0), (2, 0), (0, 2), (4, 2), (3, 1), (1, 8)):
        d = _cfg_dict(0)
        d["engine"].update(data_axis=data_axis, model_axis=model_axis)
        port = InferenceEngine(MCPXConfig.from_dict(d), model_cfg=MODEL_F32, device="cpu")
        ref = JInferenceEngine(JMCPXConfig.from_dict(d), model_cfg=JGemmaConfig(**SHAPE))
        for n in range(1, 10):
            assert port._mesh_axes(n) == ref._mesh_axes(n), (data_axis, model_axis, n)
