"""Weight-only int8 serving in the port (``mcpx_torch/models/gemma/quant.py``
and its call sites), held against the reference package on the CPU:

  - ``quantize_params``: int8 codes and f32 scales bit-equal to the
    reference's on the same numpy weights, at the test width and at a
    2-layer cut of the 2b widths;
  - ``dequant_layer``, ``embed_lookup`` and ``unembed(subset=)`` with atol 0
    in float32; ``quantized_param_bytes`` equal for test, 2b and 7b;
  - the int8 ``forward``, ``prefill`` and ``decode_chunk_paged`` against the
    reference's within 1e-4 (float32: summation order only);
  - ``params_from_numpy`` carries a quantized tree across without casting
    its int8 and scale leaves;
  - the reference's own int8 cases (``tests/test_quant.py``): the round-trip
    error bound, streaming init against a post-hoc quantize, prefill logits
    close to the full-precision model, bytes at rest near half, the engine
    serving a constrained plan, an unknown mode rejected; its v5e capacity
    case is a claim about a TPU and is replaced here by the bytes equality;
  - ``/plan`` byte parity with the reference's int8 control plane on the
    committed checkpoint in float32, homogeneous and with speculation
    (drafted and accepted counts equal request by request);
  - the weight fingerprint over the quantized tree in the reference's leaf
    order, so a snapshot from a quantized engine restores across the
    packages both ways.
"""

import asyncio
import dataclasses
import os
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.engine.engine import InferenceEngine as JEngine
from mcpx.engine.paged_decode import decode_chunk_paged as jdecode
from mcpx.models.gemma import model as jm
from mcpx.models.gemma import quant as jq
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.planner.llm import LLMPlanner as JPlanner
from mcpx.server.factory import build_control_plane as jbuild
from mcpx.utils.synth import intent_for, synth_registry as jsynth
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.errors import ConfigError, EngineError
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.engine.paged_decode import decode_chunk_paged
from mcpx_torch.models.gemma import model as tm
from mcpx_torch.models.gemma import quant
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.params import load_or_init, n_bytes, params_from_numpy
from mcpx_torch.planner.grammar import build_plan_grammar
from mcpx_torch.planner.llm import LLMPlanner
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.telemetry.costs import forward_cost
from mcpx_torch.utils.synth import synth_registry

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)
F32_TOL = 1e-4  # float32 forwards: summation order only


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_params(cfg, seed: int, dtype=np.float32) -> dict:
    """A nested numpy weight tree of ``cfg``'s shapes, drawn from ``seed``;
    norms small and nonzero so the 1 + w scale is exercised."""
    rng = np.random.default_rng(seed)
    shapes = tm.param_shapes(GemmaConfig(**dataclasses.asdict(cfg)))
    norms = ("pre_attn_norm", "pre_mlp_norm", "final_norm")

    def draw(name):
        shape = shapes[name]
        if name in norms:
            return (rng.standard_normal(shape, np.float32) * 0.1).astype(dtype)
        fan_in = np.prod([shape[a] for a in quant._CONTRACT_AXES[name]])
        return (rng.standard_normal(shape, np.float32) / np.sqrt(fan_in)).astype(dtype)

    return {
        "embed": draw("embed"),
        "layers": {k: draw(k) for k in shapes if k not in ("embed", "final_norm")},
        "final_norm": draw("final_norm"),
    }


def _port_tree(jtree) -> dict:
    return params_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


SMALL = JGemmaConfig(vocab_size=384, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                     d_ff=96, dtype="float32", max_seq_len=64)


# ------------------------------------------------------------- quantize
@pytest.mark.parametrize("width", ["test", "2b_cut"])
def test_quantize_params_is_bit_equal_to_reference(width):
    if width == "test":
        jcfg = dataclasses.replace(JGemmaConfig.named("test", vocab_size=3072), dtype="float32")
        dtype = np.float32
    else:
        # The 2b widths (d_model 2048, head_dim 256, d_ff 16384) cut to two
        # layers, in bf16 as the 2b cell serves.
        jcfg = dataclasses.replace(JGemmaConfig.named("2b", vocab_size=3072), n_layers=2)
        dtype = jnp.bfloat16
    tree = _numpy_params(jcfg, 3, dtype)
    ref = _flat(jax.tree.map(np.asarray, jq.quantize_params(jax.tree.map(jnp.asarray, tree))))
    got = _flat(quant.quantize_params(params_from_numpy(tree, device="cpu")))
    assert sorted(ref) == sorted(got)
    for name, r in ref.items():
        g = got[name]
        if name.endswith("/int8"):
            assert g.dtype == torch.int8 and r.dtype == np.int8, name
            assert np.array_equal(g.numpy(), r), name
        elif name.endswith("/scale"):
            assert g.dtype == torch.float32, name
            assert np.array_equal(g.numpy().view(np.uint32), r.view(np.uint32)), name
        else:
            assert np.array_equal(g.float().numpy(), np.asarray(r, np.float32)), name
    del tree, ref, got


def test_dequant_lookup_and_unembed_match_reference_exactly():
    jcfg = SMALL
    jtree = jq.quantize_params(jax.tree.map(jnp.asarray, _numpy_params(jcfg, 5)))
    tree = _port_tree(jtree)
    for i in range(jcfg.n_layers):
        ref = jq.dequant_layer({k: jax.tree.map(lambda a: a[i], v) for k, v in jtree["layers"].items()},
                               jnp.float32)
        got = quant.dequant_layer(tree["layers"], i, torch.float32)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=0)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (3, 7)).astype(np.int32)
    ref = jq.embed_lookup(jtree["embed"], jnp.asarray(tokens), jnp.float32)
    got = quant.embed_lookup(tree["embed"], torch.from_numpy(tokens), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=0)
    # Small integers: every product and partial sum is exact in float32,
    # so the two matmuls agree whatever their summation order.
    x = rng.integers(-4, 5, (2, 5, jcfg.d_model)).astype(np.float32)
    subset = np.array([0, 7, 100, 383, 12], np.int32)
    for sub in (None, subset):
        ref = jq.unembed(jnp.asarray(x), jtree["embed"], None if sub is None else jnp.asarray(sub))
        got = quant.unembed(torch.from_numpy(x), tree["embed"], None if sub is None else torch.from_numpy(sub))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=0)
    full = quant.dequant_params(tree)
    ref_full = jax.tree.map(np.asarray, jq.dequant_params(jtree, jnp.float32))
    for name, r in _flat(ref_full).items():
        np.testing.assert_allclose(_flat(full)[name].numpy(), r, rtol=0, atol=0)


@pytest.mark.parametrize("size", ["test", "2b", "7b"])
def test_quantized_param_bytes_equal_reference(size):
    """The bytes-at-rest equality that stands in for the reference's v5e
    capacity case (a TPU claim): both packages count the same bytes for the
    int8 tree, from shapes alone."""
    kw = {"vocab_size": 256128} if size == "7b" else {}
    ref = jq.quantized_param_bytes(JGemmaConfig.named(size, **kw))
    assert quant.quantized_param_bytes(GemmaConfig.named(size, **kw)) == ref


def test_params_from_numpy_keeps_int8_and_scale_leaves():
    jtree = jq.quantize_params(jax.tree.map(jnp.asarray, _numpy_params(SMALL, 7)))
    tree = params_from_numpy(jax.tree.map(np.asarray, jtree), dtype="bfloat16", device="cpu")
    assert quant.is_quantized(tree)
    assert tree["embed"]["int8"].dtype == torch.int8 and tree["embed"]["scale"].dtype == torch.float32
    assert tree["layers"]["wq"]["int8"].dtype == torch.int8
    assert tree["layers"]["pre_attn_norm"].dtype == torch.bfloat16
    assert tree["final_norm"].dtype == torch.bfloat16


# -------------------------------------------------------------- forwards
@pytest.fixture(scope="module")
def small_q():
    jtree = jq.quantize_params(jax.tree.map(jnp.asarray, _numpy_params(SMALL, 11)))
    return jtree, _port_tree(jtree), GemmaConfig(**dataclasses.asdict(SMALL))


def test_int8_forward_and_prefill_match_reference(small_q):
    jtree, tree, cfg = small_q
    rng = np.random.default_rng(12)
    B, T, S = 2, 9, 16
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    lens = np.array([9, 5], np.int32)
    ref, ref_kv = jm.prefill(jtree, SMALL, jnp.asarray(tokens), jnp.asarray(lens), jm.init_kv_cache(SMALL, B, S))
    got, got_kv = tm.prefill(tree, cfg, torch.from_numpy(tokens), torch.from_numpy(lens),
                             tm.init_kv_cache(cfg, B, S, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_kv["k"].numpy(), np.asarray(ref_kv["k"]), rtol=F32_TOL, atol=F32_TOL)
    last, _ = tm.prefill(tree, cfg, torch.from_numpy(tokens), torch.from_numpy(lens),
                         tm.init_kv_cache(cfg, B, S, device="cpu"), last_only=True)
    np.testing.assert_allclose(last.numpy(), got.numpy()[np.arange(B), lens - 1], rtol=F32_TOL, atol=F32_TOL)
    # forward at absolute positions past a filled cache.
    pos = np.array([[9, 10, 11], [5, 6, 7]], np.int32)
    chunk = rng.integers(0, cfg.vocab_size, (B, 3)).astype(np.int32)
    mask = np.arange(S)[None, None, :] <= pos[:, :, None]
    ref, _ = jm.forward(jtree, SMALL, jnp.asarray(chunk), jnp.asarray(pos), ref_kv, jnp.asarray(mask))
    got, _ = tm.forward(tree, cfg, torch.from_numpy(chunk), torch.from_numpy(pos), got_kv, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("compact", [False, True])
def test_int8_decode_chunk_paged_matches_reference(small_q, compact):
    jtree, tree, cfg = small_q
    rng = np.random.default_rng(13)
    B, S, psz, pmax = 3, 4, 8, 4
    n_pages = B * pmax + 1
    K, L, hd = cfg.n_kv_heads, cfg.n_layers, cfg.head_dim
    pools = {k: rng.standard_normal((K, L, n_pages, psz, hd), np.float32) for k in ("k", "v")}
    table = np.arange(1, n_pages, dtype=np.int32).reshape(B, pmax)
    pos = np.array([5, 12, 0], np.int32)
    q_lens = np.array([4, 1, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    cols = np.array([1, 5, 9, 200, 383], np.int32) if compact else None
    ref, ref_kv = jdecode(
        jtree, SMALL, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(table),
        {k: jnp.asarray(v) for k, v in pools.items()}, q_lens=jnp.asarray(q_lens), use_pallas=False,
        **({"active_cols": jnp.asarray(cols)} if compact else {"logits_at": jnp.asarray(np.maximum(q_lens - 1, 0))}),
    )
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    got, got_kv = decode_chunk_paged(
        tree, cfg, torch.from_numpy(tokens), torch.from_numpy(pos), torch.from_numpy(table), tpools,
        q_lens=torch.from_numpy(q_lens),
        **({"active_cols": torch.from_numpy(cols)} if compact else
           {"logits_at": torch.from_numpy(np.maximum(q_lens - 1, 0))}),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=F32_TOL, atol=F32_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(got_kv[k].numpy(), np.asarray(ref_kv[k]), rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------- the reference's own int8 cases
@pytest.fixture(scope="module")
def f32_params():
    cfg = GemmaConfig(dtype="float32", max_seq_len=64)
    params, _ = load_or_init(cfg, seed=0, device="cpu")
    return cfg, params


def test_roundtrip_error_bounded(f32_params):
    cfg, params = f32_params
    q = quant.quantize_params(params)
    assert quant.is_quantized(q) and not quant.is_quantized(params)
    deq = quant.dequant_params(q, torch.float32)
    for name in ("wq", "w_down", "w_gate"):
        a, b = params["layers"][name], deq["layers"][name]
        assert float((a - b).abs().max() / a.abs().max()) < 0.01, name  # <1% of absmax


def test_streaming_init_matches_posthoc_quantize(f32_params):
    """``load_or_init(quantize="int8")`` quantizes each leaf as it is
    created; the tree equals ``quantize_params`` of the full-precision init
    from the same seed exactly (the same eager arithmetic on both paths)."""
    cfg, params = f32_params
    stream, source = load_or_init(cfg, seed=0, quantize="int8", device="cpu")
    assert source == "random"
    posthoc = _flat(quant.quantize_params(params))
    stream = _flat(stream)
    assert sorted(stream) == sorted(posthoc)
    for name, a in stream.items():
        assert a.dtype == posthoc[name].dtype and torch.equal(a, posthoc[name]), name


def test_prefill_logits_close_to_full_precision(f32_params):
    cfg, params = f32_params
    B, T, S = 2, 12, 16
    tokens = torch.randint(0, 255, (B, T), generator=torch.Generator().manual_seed(1))
    lens = torch.full((B,), T)
    ref, _ = tm.prefill(params, cfg, tokens, lens, tm.init_kv_cache(cfg, B, S, device="cpu"))
    got, _ = tm.prefill(quant.quantize_params(params), cfg, tokens, lens, tm.init_kv_cache(cfg, B, S, device="cpu"))
    # int8 weights: logits agree to a few percent of the logit scale, and
    # greedy next-token choices rarely differ on random weights.
    assert float((ref - got).abs().max() / ref.abs().max()) < 0.05
    agree = float((ref.argmax(-1) == got.argmax(-1)).float().mean())
    assert agree > 0.9, agree


def test_bytes_at_rest_halved():
    cfg = GemmaConfig()
    bf16 = 2 * sum(int(np.prod(s)) for s in tm.param_shapes(cfg).values())
    q = quant.quantized_param_bytes(cfg)
    assert q < 0.62 * bf16, (q, bf16)  # int8 + f32 scales + norms
    # The counted bytes are what a quantized tree holds.
    params, _ = load_or_init(dataclasses.replace(cfg, dtype="bfloat16"), seed=0, quantize="int8", device="cpu")
    assert n_bytes(params) == q


def test_forward_cost_bills_one_byte_a_weight():
    cfg = GemmaConfig.named("2b", vocab_size=3072)
    kw = dict(batch=64, width=1, context=256, unembed_rows=64, unembed_cols=3072)
    flops, full = forward_cost(cfg, **kw)
    qflops, q = forward_cost(cfg, **kw, quantized=True)
    assert qflops == flops
    # The weight share roughly halves; the cache and logit bytes stay.
    assert 0.45 < q / full < 0.6, q / full


def test_engine_serves_constrained_plan_quantized():
    """The serving stack (admission, paged decode, grammar) runs with int8
    weights: the same code path, the quantized tree at the choke points."""
    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "vocab": "bpe", "quantize": "int8"},
        "engine": {"max_batch_size": 2, "max_decode_len": 48, "max_pages_per_seq": 8, "temperature": 0.0},
    })

    async def go():
        eng = InferenceEngine(cfg, device="cpu")
        try:
            await eng.start()
            assert quant.is_quantized(eng._params)
            g = build_plan_grammar(eng.tokenizer, ["fetch", "rank"])
            res = await eng.generate(
                eng.tokenizer.encode("Intent: fetch then rank\nJSON:"), constrained=True, grammar=g
            )
            assert g.is_accept(g.walk(res.text)), res.text
        finally:
            await eng.aclose()

    asyncio.run(go())


def test_validate_rejects_unknown_quantize():
    with pytest.raises(ConfigError, match="quantize"):
        MCPXConfig.from_dict({"model": {"quantize": "int4"}})
    with pytest.raises(EngineError, match="quantize"):
        load_or_init(GemmaConfig(), quantize="int4", device="cpu")


# ------------------------------------------------------------ /plan parity
N_SERVICES, N_INTENTS = 200, 8
ENGINE = {
    "max_batch_size": 16, "max_decode_len": 64, "kv_page_size": 16, "max_pages_per_seq": 16,
    "temperature": 0.0, "speculate_k": 8, "use_pallas": False, "data_axis": 1, "model_axis": 1,
    "warmup_compile": False,
}


def _plan_config(cls, spec: bool):
    eng = dict(ENGINE)
    if spec:
        eng.update(hetero_batch=True, speculative={"enabled": True, "k": 4})
    return cls.from_dict({
        "model": {"size": "test", "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": CKPT,
                  "quantize": "int8"},
        "engine": eng, "planner": {"kind": "llm"}, "tracing": {"enabled": False},
    })


def _f32(cls):
    return dataclasses.replace(cls.named("test", vocab_size=3072, max_seq_len=2048), dtype="float32")


def _spec_counts(engine, ref: bool) -> tuple:
    if ref:
        m = engine.metrics
        return tuple(
            int(sum(fam.labels(cls=c)._value.get() for c in ("constrained", "free")))
            for fam in (m.spec_drafted, m.spec_accepted)
        )
    q = engine.queue_stats()
    return q["drafted"], q["accepted"]


async def _serve_plans(cp, records, intents, ref: bool) -> tuple:
    """Each intent's plan, one request at a time (the drafted and accepted
    counts each adds recorded), then all at once."""
    for rec in records:
        await cp.registry.put(rec)
    await cp.startup()
    engine = cp.planner.engine
    try:
        one, counts = [], []
        for i in intents:
            before = _spec_counts(engine, ref)
            one.append((await cp.plan(i, use_cache=False))[0])
            counts.append(tuple(b - a for a, b in zip(before, _spec_counts(engine, ref))))
        burst = [p for p, _ in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
        int8 = all(
            v["int8"].dtype in (torch.int8, np.int8) for v in (engine._params["embed"], engine._params["layers"]["wq"])
        )
        return one, counts, burst, (int8, engine.model_cfg.dtype)
    finally:
        await engine.aclose()


@pytest.fixture(scope="module", params=[False, True], ids=["homogeneous", "speculative"])
def int8_plans(request):
    spec = request.param
    records = jsynth(N_SERVICES, seed=0)
    rng = random.Random(0)
    intents = [intent_for(records, rng) for _ in range(N_INTENTS)]
    jcfg = _plan_config(JConfig, spec)
    ref = asyncio.run(_serve_plans(
        jbuild(jcfg, planner=JPlanner(JEngine(jcfg, model_cfg=_f32(JGemmaConfig)), jcfg.planner)),
        records, intents, ref=True,
    ))
    cfg = _plan_config(MCPXConfig, spec)
    engine = InferenceEngine(cfg, model_cfg=_f32(GemmaConfig), device="cpu")
    port = asyncio.run(_serve_plans(
        build_control_plane(cfg, planner=LLMPlanner(engine, cfg.planner), device="cpu"),
        synth_registry(N_SERVICES, seed=0), intents, ref=False,
    ))
    return spec, intents, ref, port


def test_int8_plans_are_byte_identical_to_reference(int8_plans):
    spec, intents, ref, port = int8_plans
    (r_one, r_counts, r_burst, r_kind), (p_one, p_counts, p_burst, p_kind) = ref, port
    assert r_kind == p_kind == (True, "float32")
    for i, intent in enumerate(intents):
        assert r_one[i].origin == "llm", intent
        assert p_one[i].to_json() == r_one[i].to_json(), intent
        assert p_burst[i].to_json() == r_burst[i].to_json(), intent
    if spec:
        assert p_counts == r_counts
        assert sum(d for d, _ in p_counts) > 0 and sum(a for _, a in p_counts) > 0


# -------------------------------------------------------------- snapshot
def _tier_config(cls, snap: str):
    return cls.from_dict({
        "model": {"size": "test", "vocab": "bpe", "checkpoint_path": CKPT, "quantize": "int8"},
        "engine": {
            "data_axis": 1, "model_axis": 1, "warmup_compile": False, "hetero_batch": False,
            "max_batch_size": 4, "max_pages_per_seq": 16, "kv_page_size": 16, "max_decode_len": 8,
            "use_pallas": False, "speculative": {"enabled": False},
            "kv_tier": {"enabled": True, "host_mb": 64.0, "snapshot_path": snap},
        },
    })


REF = (JEngine, JConfig, JGemmaConfig, {})
PORT = (InferenceEngine, MCPXConfig, GemmaConfig, {"device": "cpu"})


def _tier_engine(ns, snap):
    Engine, Config, Gemma, kw = ns
    return Engine(_tier_config(Config, snap), model_cfg=dataclasses.replace(
        Gemma.named("test", vocab_size=3072, max_seq_len=2048), dtype="float32"), **kw)


def _prompts(tok, n=3):
    return [tok.encode(f"tier workload {i}: " + "compose rank fetch join " * 12)[:128] for i in range(n)]


async def _gen(eng, prompt):
    r = await eng.generate(prompt, max_new_tokens=2, constrained=False, temperature=0.0)
    return r.token_ids


async def _write(ns, snap):
    eng = _tier_engine(ns, snap)
    await eng.start()
    prompts = _prompts(eng.tokenizer)
    outs = [await _gen(eng, p) for p in prompts]
    fp = eng._params_fingerprint()
    await eng.aclose()
    return prompts, outs, fp


async def _restore(ns, snap, prompt):
    eng = _tier_engine(ns, snap)
    await eng.start()
    try:
        return eng.prefix_cache_stats()["spilled_nodes"], await _gen(eng, prompt), eng._params_fingerprint()
    finally:
        await eng.aclose()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_quantized_snapshot_restores_across_the_packages(tmp_path, writer):
    """A snapshot written by a quantized engine of either package restores
    in both: the fingerprints over the int8 trees agree within the restore's
    1e-3 relative tolerance, the runs come back, and the warm first output
    equals the writer's."""
    src = str(tmp_path / "written.snap")
    prompts, outs, fp = asyncio.run(_write(REF if writer == "reference" else PORT, src))
    got = {}
    for name, ns in (("reference", REF), ("port", PORT)):
        snap = str(tmp_path / f"{name}.snap")
        shutil.copy(src, snap)
        shutil.copy(src + ".npz", snap + ".npz")
        got[name] = asyncio.run(_restore(ns, snap, prompts[0]))
    (r_n, r_out, r_fp), (p_n, p_out, p_fp) = got["reference"], got["port"]
    assert abs(p_fp - r_fp) <= 1e-3 * abs(r_fp) and abs(fp - r_fp) <= 1e-3 * abs(r_fp)
    assert p_n == r_n >= 3
    assert p_out == r_out == outs[0]
