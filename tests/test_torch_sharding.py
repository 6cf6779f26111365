"""TP/DP on virtual CPU meshes: the port's counterparts of the reference's
``tests/test_sharding.py`` (``test_tp_dp_logits_match_single_device`` on
2x4, ``test_pure_tp_8`` on 1x8, with a decode step on both), against the
reference's sharded jit on the conftest's 8 devices and against the
unmeshed port, at rtol = atol = 1e-5 in float32. Then the layout
(``parallel.mesh.ServeLayout``) against the reference's shardings, the
shard-major weights (``params.shard_major``) as contiguous views by
``data_ptr``, ``decode_chunk_paged`` per shard against unmeshed in float32
and int8, and ``/plan`` on a 1x8 engine against the reference's control
plane on the same mesh shape, from the committed checkpoint in float32."""

import asyncio
import dataclasses
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from mcpx.core.config import MCPXConfig as JMCPXConfig
from mcpx.engine.engine import InferenceEngine as JInferenceEngine
from mcpx.models.gemma import GemmaConfig as JGemmaConfig
from mcpx.models.gemma import decode_step as jdecode_step
from mcpx.models.gemma import init_kv_cache as jinit_kv_cache
from mcpx.models.gemma import init_params as jinit_params
from mcpx.models.gemma import prefill as jprefill
from mcpx.parallel import data_pspec as jdata_pspec
from mcpx.parallel import kv_cache_pspecs as jkv_cache_pspecs
from mcpx.parallel import make_mesh as jmake_mesh
from mcpx.parallel import param_pspecs as jparam_pspecs
from mcpx.parallel import shard_pytree as jshard_pytree
from mcpx.planner.llm import LLMPlanner as JLLMPlanner
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.engine.paged_decode import decode_chunk_paged
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import decode_step, init_kv_cache, prefill
from mcpx_torch.models.gemma.params import load_or_init, params_from_numpy, shard_major
from mcpx_torch.models.gemma.quant import _CONTRACT_AXES, _is_qleaf, quantize_params
from mcpx_torch.parallel.mesh import ServeLayout, data_pspec, make_mesh, param_pspecs
from mcpx_torch.planner.llm import LLMPlanner
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.utils.synth import synth_registry

CPU8 = [torch.device("cpu")] * 8
CKPT = os.path.join(os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfgs():
    # The reference test's model: d_ff 256 and 4 heads shard over model=4,
    # batch 4 over data=2; MQA keeps the one KV head whole.
    return JGemmaConfig(dtype="float32", max_seq_len=32), GemmaConfig(dtype="float32", max_seq_len=32)


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jinit_params(cfgs[0], jax.random.PRNGKey(0))


def _port(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), dtype=torch.float32, device="cpu")


@pytest.mark.parametrize(
    "data,model,B,T,key", [(2, 4, 4, 6, 1), (1, 8, 2, 5, 2)], ids=["2x4", "1x8"]
)
def test_tp_dp_logits_match_single_device(cfgs, jparams, data, model, B, T, key):
    """Prefill and one decode step: the port's sharded forward (every row
    block and model shard in turn) against the reference's sharded jit and
    against the port's unmeshed forward."""
    jcfg, cfg = cfgs
    S = 8
    tokens = jax.random.randint(jax.random.PRNGKey(key), (B, T), 0, 256)
    seq_lens = jnp.full((B,), T)
    jm = jmake_mesh(data=data, model=model)
    sp = jshard_pytree(jparams, jparam_pspecs(jcfg, jm), jm)
    jcache = jshard_pytree(jinit_kv_cache(jcfg, B, S), jkv_cache_pspecs(jcfg, jm, B), jm)
    dspec = jdata_pspec(jm, B)
    st = jax.device_put(tokens, NamedSharding(jm, P(*dspec, None)))
    sl = jax.device_put(seq_lens, NamedSharding(jm, dspec))
    want, jcache = jax.jit(jprefill, static_argnums=1)(sp, jcfg, st, sl, jcache)
    nxt = jnp.argmax(want[:, -1, :], axis=-1).astype(jnp.int32)
    want_step, _ = jax.jit(jdecode_step, static_argnums=1)(sp, jcfg, nxt, jnp.full((B,), T), jcache)

    layout = ServeLayout(make_mesh(data=data, model=model, devices=CPU8), cfg)
    assert layout.sharded and (data == 1 or len(layout.rows(B)) == data)
    toks, lens = torch.tensor(np.asarray(tokens)), torch.tensor(np.asarray(seq_lens))
    got = {}
    for name, lay in (("unmeshed", None), ("sharded", layout)):
        params = _port(jparams) if lay is None else shard_major(_port(jparams), lay)
        logits, cache = prefill(params, cfg, toks, lens, init_kv_cache(cfg, B, S, device="cpu"), layout=lay)
        step, _ = decode_step(params, cfg, torch.tensor(np.asarray(nxt)), torch.full((B,), T), cache, layout=lay)
        got[name] = (logits.numpy(), step.numpy())
    for name, (logits, step) in got.items():
        np.testing.assert_allclose(logits, np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(step, np.asarray(want_step), rtol=1e-5, atol=1e-5, err_msg=name)
    for a, b in zip(got["sharded"], got["unmeshed"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (1, 8)], ids=["2x2", "2x4", "1x8"])
@pytest.mark.parametrize("preset", ["test", "2b", "7b"])
def test_layout_ranges_are_the_reference_shardings(preset, shape):
    """Each model coordinate's query-head, KV-head, ``d_ff`` and vocabulary
    range, and the row blocks of a batch, are the blocks the reference's
    ``NamedSharding`` gives the device at that coordinate."""
    data, model = shape
    jm = jmake_mesh(data=data, model=model)
    jcfg, cfg = JGemmaConfig.named(preset), GemmaConfig.named(preset)
    layout = ServeLayout(make_mesh(data=data, model=model, devices=CPU8), cfg)
    specs = jparam_pspecs(jcfg, jm)
    L, D = cfg.n_layers, cfg.d_model
    cases = (
        (layout.heads, (L, D, cfg.n_heads, cfg.head_dim), specs["layers"]["wq"], 2),
        (layout.kv_heads, (L, D, cfg.n_kv_heads, cfg.head_dim), specs["layers"]["wk"], 2),
        (layout.ff, (L, D, cfg.d_ff), specs["layers"]["w_gate"], 2),
        (layout.vocab, (cfg.vocab_size, D), specs["embed"], 0),
    )
    for ranges, full, spec, dim in cases:
        blocks = NamedSharding(jm, spec).devices_indices_map(full)
        for m in range(model):
            sl = blocks[jm.devices[0, m]][dim]
            assert ranges[m] == sl.indices(full[dim])[:2], (spec, m)
    for batch in (1, 4, 6, 8, 64):
        blocks = NamedSharding(jm, P(*jdata_pspec(jm, batch))).devices_indices_map((batch,))
        want = sorted({blocks[d][0].indices(batch)[:2] for d in jm.devices.flat})
        assert list(layout.rows(batch)) == want and data_pspec(layout.mesh, batch) == tuple(jdata_pspec(jm, batch))
    assert set(layout.sharded) == {
        k for k, s in {"embed": specs["embed"], **specs["layers"]}.items() if "model" in tuple(s)
    }


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_shard_major_blocks_are_contiguous_views(quantize):
    """``load_or_init`` on a 2x2 virtual mesh: every leaf split over
    ``model`` is one tensor in which the block of layer ``i`` and shard
    ``m`` is the contiguous view ``leaf[i, m]`` at ``(i * M + m)`` blocks
    from its start (the vocabulary shards of ``embed`` likewise), holding
    the whole leaf's slice at that shard's range; int8 scales beside their
    codes; a leaf kept whole is the unmeshed one."""
    cfg = GemmaConfig(vocab_size=384, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                      dtype="float32")
    mesh = make_mesh(data=2, model=2, devices=CPU8)
    layout = ServeLayout(mesh, cfg)
    assert set(layout.sharded) == {"embed", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    plain, _ = load_or_init(cfg, seed=5, quantize=quantize, device="cpu")
    meshed, _ = load_or_init(cfg, seed=5, quantize=quantize, mesh=mesh, device="cpu")
    ranges = {"embed": layout.vocab, "wq": layout.heads, "wo": layout.heads, "wk": layout.kv_heads,
              "wv": layout.kv_heads, "w_gate": layout.ff, "w_up": layout.ff, "w_down": layout.ff}
    for name, whole in {"embed": plain["embed"], **plain["layers"]}.items():
        got = meshed["embed"] if name == "embed" else meshed["layers"][name]
        parts = ({"int8": got["int8"], "scale": got["scale"]}, whole) if _is_qleaf(whole) else ({"": got}, {"": whole})
        dim = layout.sharded.get(name)
        for part, t in parts[0].items():
            w = parts[1][part]
            split = dim is not None and (part != "scale" or dim not in _CONTRACT_AXES[name])
            if not split:
                assert torch.equal(t, w), (name, part)
                continue
            stacked = name != "embed"
            layers = range(t.shape[0]) if stacked else [None]
            n = 0
            for i in layers:
                for m, (lo, hi) in enumerate(ranges[name]):
                    view = t[i, m] if stacked else t[m]
                    assert view.is_contiguous()
                    assert view.data_ptr() == t.data_ptr() + n * view.numel() * view.element_size(), (name, i, m)
                    ref = (w[i] if stacked else w).narrow(dim - 1 if stacked else dim, lo, hi - lo)
                    assert torch.equal(view, ref), (name, part, i, m)
                    n += 1
            assert n * view.numel() == t.numel() == w.numel()


def _paged_case(seed, cfg, B=8, S=5, psz=16, p_max=4):
    rng = np.random.default_rng(seed)
    n_pages = B * p_max + 1
    shape = (cfg.n_kv_heads, cfg.n_layers, n_pages, psz, cfg.head_dim)
    pools = {"k": rng.standard_normal(shape, np.float32), "v": rng.standard_normal(shape, np.float32)}
    table = (rng.permutation(n_pages - 1)[: B * p_max] + 1).astype(np.int32).reshape(B, p_max)
    q_lens = np.asarray([5, 1, 3, 0, 2, 5, 1, 4], np.int32)[:B]
    positions = rng.integers(0, p_max * psz - S, B).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)
    return [torch.from_numpy(a) for a in (tokens, positions, table, q_lens)], pools


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("kv_heads,shape", [(1, (2, 2)), (4, (2, 2)), (4, (2, 4)), (1, (1, 8))],
                         ids=["mqa-2x2", "gqa-2x2", "gqa-2x4", "mqa-1x8"])
def test_decode_chunk_paged_per_shard_matches_unmeshed(quantize, kv_heads, shape):
    """One ragged forward (decode, drafted and idle rows) of every row block
    and model shard against the unmeshed forward on the same pools: the
    last-slot, every-slot and compact (``active_cols``) logits and the
    pools after it (each shard wrote its KV heads) within 1e-5."""
    cfg = GemmaConfig(vocab_size=384, d_model=128, n_layers=2, n_heads=4, n_kv_heads=kv_heads, head_dim=32,
                      d_ff=256, dtype="float32")
    mesh = make_mesh(data=shape[0], model=shape[1], devices=CPU8)
    layout = ServeLayout(mesh, cfg)
    plain, _ = load_or_init(cfg, seed=2, quantize=quantize, device="cpu")
    meshed, _ = load_or_init(cfg, seed=2, quantize=quantize, mesh=mesh, device="cpu")
    (tokens, positions, table, q_lens), pools = _paged_case(3, cfg)
    cols = torch.tensor([0, 7, 100, 191, 192, 200, 383])
    for kw in ({"logits_at": (q_lens.long() - 1).clamp(min=0)}, {}, {"active_cols": cols}):
        outs = []
        for params, lay in ((plain, None), (meshed, layout)):
            pk = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
            logits, pk = decode_chunk_paged(params, cfg, tokens, positions, table, pk, q_lens=q_lens, layout=lay, **kw)
            outs.append((logits, pk["k"], pk["v"]))
        for a, b in zip(*outs):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ /plan on 1x8
ENGINE = {
    "max_batch_size": 8, "kv_page_size": 16, "max_pages_per_seq": 16, "max_decode_len": 48,
    "temperature": 0.0, "use_pallas": False, "data_axis": 1, "model_axis": 8,
}


def _config(cls):
    return cls.from_dict({
        "model": {"size": "test", "vocab": "bpe", "max_seq_len": 256, "checkpoint_path": CKPT},
        "engine": ENGINE, "planner": {"kind": "llm"}, "tracing": {"enabled": False},
    })


async def _plans(cp, engine, records, intents):
    calls = {}
    real = engine.generate

    async def recording(prompt_ids, **kw):
        res = await real(prompt_ids, **kw)
        calls[tuple(prompt_ids)] = res.token_ids
        return res

    engine.generate = recording
    for rec in records:
        await cp.registry.put(rec)
    await cp.startup()
    try:
        plans = [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
        return [p.to_json() for p in plans], calls, getattr(engine, "_layout", None), engine._params
    finally:
        await engine.aclose()


@pytest.fixture(scope="module")
def plans_1x8():
    """``/plan`` of four intents through the reference's control plane on a
    1x8 mesh (one start), the port's on a 1x8 virtual mesh and the
    unmeshed port's, from the committed checkpoint in float32."""
    records = jsynth(60, seed=0)
    rng = random.Random(0)
    intents = [intent_for(records, rng) for _ in range(4)]
    jcfg = dataclasses.replace(JGemmaConfig.named("test", vocab_size=3072, max_seq_len=256), dtype="float32")
    cfg = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072, max_seq_len=256), dtype="float32")
    jconf = _config(JMCPXConfig)
    jeng = JInferenceEngine(jconf, model_cfg=jcfg, mesh=jmake_mesh(data=1, model=8))
    ref = asyncio.run(_plans(jbuild(jconf, planner=JLLMPlanner(jeng, jconf.planner)), jeng, records, intents))
    out = {"reference": ref}
    for name, mesh in (("1x8", make_mesh(data=1, model=8, devices=CPU8)), ("unmeshed", None)):
        conf = _config(MCPXConfig)
        eng = InferenceEngine(conf, model_cfg=cfg, device="cpu", mesh=mesh)
        out[name] = asyncio.run(_plans(build_control_plane(conf, planner=LLMPlanner(eng, conf.planner), device="cpu"),
                                       eng, synth_registry(60, seed=0), intents))
    return out


def test_plan_on_a_1x8_engine_equals_the_reference_engines(plans_1x8):
    """The 1x8 engine serves ``/plan`` with its MLP and vocabulary split 8
    ways (4 heads do not divide 8) and shard-major weights: plans and
    greedy token streams byte-identical to the reference's on its 1x8 mesh
    and to the unmeshed port's."""
    ref_plans, ref_calls, _, _ = plans_1x8["reference"]
    plans, calls, layout, params = plans_1x8["1x8"]
    assert layout is not None and layout.n_ff == 8 and layout.n_vocab == 8 and len(layout.attn) == 1
    assert params["layers"]["w_gate"].shape[:2] == (2, 8) and params["embed"].shape[0] == 8
    assert plans == ref_plans == plans_1x8["unmeshed"][0]
    assert calls == ref_calls == plans_1x8["unmeshed"][1]
    assert all('"nodes"' in p for p in plans)
