"""TP/DP serving on the port's engine over virtual CPU meshes: the port's
counterparts of the reference's ``tests/test_engine_scaling.py``
(``test_dp_rows_spread_one_per_device``: the row blocks the engine's
forwards run, ``_layout.rows``, are one row a data coordinate; ``test_cohort_accounting_is_
mesh_invariant`` on 1x1, 2x4 and 8x1 with GQA ``n_kv_heads=4``, so that KV
heads shard, in float32, so that the three meshes' greedy streams and
forwards agree exactly), and a 2x2 engine's greedy tokens against the
reference engine's on ``jmake_mesh(data=2, model=2)`` and the unmeshed
port's, from one float32 checkpoint (the pattern of
``tests/test_torch_ring_routing.py``)."""

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
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.parallel.mesh import make_mesh

CPU8 = [torch.device("cpu")] * 8
# The reference test's model (GQA K=4 so that KV heads really shard over
# `model`), in float32.
SHAPE = dict(vocab_size=384, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
             max_seq_len=256, dtype="float32")
MODEL = GemmaConfig(**SHAPE)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(checkpoint: str = "") -> dict:
    return {
        "model": {"size": "test", "max_seq_len": 256, "checkpoint_path": checkpoint},
        "engine": {
            "use_pallas": False, "max_batch_size": 8, "max_decode_len": 32, "kv_page_size": 16,
            "max_pages_per_seq": 8, "temperature": 0.0,
        },
    }


def _mesh(data: int, model: int):
    return make_mesh(data=data, model=model, devices=CPU8)


def test_dp_rows_spread_one_per_device():
    """The row blocks every forward of an 8x1 engine runs (``_layout.rows``,
    the counterpart of the reference's ``_row_spec``) are one row a data
    coordinate for a batch of 8, in data order, and the whole batch when it
    does not divide over ``data``."""

    async def go():
        eng = InferenceEngine(MCPXConfig.from_dict(_cfg_dict()), model_cfg=MODEL, device="cpu", mesh=_mesh(8, 1))
        await eng.start()
        try:
            assert eng._layout.rows(8) == tuple((i, i + 1) for i in range(8))
            assert eng._layout.rows(6) == ((0, 6),)
            assert eng._layout.rows(eng.config.engine.max_batch_size) == eng._layout.rows(8)
        finally:
            await eng.aclose()

    asyncio.run(go())


async def _cohort(mesh):
    eng = InferenceEngine(MCPXConfig.from_dict(_cfg_dict()), model_cfg=MODEL, device="cpu", mesh=mesh)
    await eng.start()
    try:
        prompt = eng.tokenizer.encode("compose a plan. JSON:")
        results = await asyncio.gather(*(eng.generate(prompt, max_new_tokens=24) for _ in range(8)))
        q = eng.queue_stats()
        return [r.token_ids for r in results], q["decode_forwards"], q["decode_tokens"], eng._layout
    finally:
        await eng.aclose()


@pytest.fixture(scope="module")
def unmeshed_cohort():
    return asyncio.run(_cohort(None))


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 4), (8, 1)], ids=["1x1", "2x4", "8x1"])
def test_cohort_accounting_is_mesh_invariant(mesh_shape, unmeshed_cohort):
    """8 concurrent requests coalesce into one fused decode loop on every
    mesh: forwards well under 2 a generated token of one request, and the
    streams, forwards and tokens those of the unmeshed engine."""
    streams, forwards, tokens, layout = asyncio.run(_cohort(_mesh(*mesh_shape)))
    assert all(streams) and forwards < 2 * (tokens / 8), (forwards, tokens)
    assert (streams, forwards, tokens) == unmeshed_cohort[:3]
    if mesh_shape == (1, 1):
        assert layout is None
    else:
        data, model = mesh_shape
        assert len(layout.rows(8)) == data and len(layout.attn) == model and layout.kv_split == (model > 1)


PROMPTS = ("intent 0: fetch the user record, then enrich it. JSON:", "plan. JSON:",
           "Compose a service DAG over svc-001 in:query out:result and svc-002. JSON:")


async def _serve(eng):
    await eng.start()
    try:
        out = await asyncio.gather(*(eng.generate(eng.tokenizer.encode(p), max_new_tokens=32) for p in PROMPTS))
        params = getattr(eng, "_layout", None) and eng._params
        return [r.token_ids for r in out], params
    finally:
        await eng.aclose()


def test_greedy_tokens_of_a_2x2_engine_equal_the_reference_engine(tmp_path):
    """One float32 checkpoint (the reference's init of ``MODEL``) served by
    the reference engine on ``jmake_mesh(data=2, model=2)`` and by the
    port's engine on a 2x2 virtual mesh (both row blocks and both model
    shards, each with its two query and two KV heads, shard-major weights)
    and unmeshed: the same greedy tokens."""
    jcfg = JGemmaConfig(**SHAPE)
    ckpt = str(tmp_path / "f32.npz")
    jsave_npz(ckpt, jinit(jcfg, jax.random.PRNGKey(0)), dtype="float32")
    want, _ = asyncio.run(_serve(JInferenceEngine(JMCPXConfig.from_dict(_cfg_dict(ckpt)), model_cfg=jcfg,
                                                  mesh=jmake_mesh(data=2, model=2))))
    assert all(want)
    got, params = asyncio.run(_serve(InferenceEngine(MCPXConfig.from_dict(_cfg_dict(ckpt)), model_cfg=MODEL,
                                                     device="cpu", mesh=_mesh(2, 2))))
    plain, _ = asyncio.run(_serve(InferenceEngine(MCPXConfig.from_dict(_cfg_dict(ckpt)), model_cfg=MODEL,
                                                  device="cpu")))
    assert got == want == plain
    assert params["layers"]["wk"].shape == (2, 2, 128, 2, 32) and params["layers"]["wq"].shape == (2, 2, 128, 2, 32)
    assert dataclasses.asdict(MODEL) == dataclasses.asdict(jcfg)
