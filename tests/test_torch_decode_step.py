"""One-token decode in the port against the reference package, on the same
numpy-made weights, pools and page tables: ``write_decode_kv`` bit for bit
in float32 (a page past the pool dropped, a position past the table's width
reading its last column), ``decode_step_paged`` against the reference's
``use_pallas=False`` path within 2e-5, the chunk forward equal to S
sequential steps within 2e-5 (the reference's
``test_decode_chunk_matches_sequential_steps``), ``decode_step`` on the
dense cache against the reference's within 2e-5 and against a full prefill
within 2e-4 (the reference's ``test_decode_matches_prefill``), the step on a
virtual mesh against the unmeshed step, and ``load_or_init``'s CUDA
default."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpx.engine.kv_cache import write_decode_kv as jwrite
from mcpx.engine.paged_decode import decode_step_paged as jstep_paged
from mcpx.models.gemma import GemmaConfig as JConfig
from mcpx.models.gemma import decode_step as jdecode_step
from mcpx.models.gemma import init_kv_cache as jinit_kv_cache
from mcpx.models.gemma import prefill as jprefill
from mcpx_torch.core.errors import EngineError
from mcpx_torch.engine.kv_cache import write_decode_kv
from mcpx_torch.engine.paged_decode import decode_chunk_paged, decode_step_paged
from mcpx_torch.models.gemma import GemmaConfig, decode_step, init_kv_cache, prefill
from mcpx_torch.models.gemma.model import param_shapes
from mcpx_torch.models.gemma.params import load_or_init, params_from_numpy, shard_major
from mcpx_torch.models.gemma.quant import _CONTRACT_AXES
from mcpx_torch.parallel.mesh import ServeLayout, make_mesh

# The reference test's model: GQA (4 query heads over 2 KV heads), float32.
SMALL = dict(dtype="float32", d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64)


def numpy_params(cfg, seed: int) -> dict:
    """A nested numpy tree of ``cfg``'s shapes at the reference init's
    scale (normal over sqrt(fan-in), ``init_params``), with small nonzero
    norms so every term of the forward shows."""
    rng = np.random.default_rng(seed)
    tree = {"layers": {}}
    for name, shape in param_shapes(cfg).items():
        if "norm" in name:
            arr = rng.standard_normal(shape) * 0.1
        else:
            arr = rng.standard_normal(shape) / np.sqrt(np.prod([shape[a] for a in _CONTRACT_AXES[name]]))
        (tree if name in ("embed", "final_norm") else tree["layers"])[name] = arr.astype(np.float32)
    return tree


def both(tree: dict):
    return params_from_numpy(tree, device="cpu"), {
        "embed": jnp.asarray(tree["embed"]), "final_norm": jnp.asarray(tree["final_norm"]),
        "layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()},
    }


def pools_of(cfg, seed: int, n_pages: int, psz: int) -> dict:
    rng = np.random.default_rng(seed)
    shape = (cfg.n_kv_heads, cfg.n_layers, n_pages, psz, cfg.head_dim)
    return {k: rng.standard_normal(shape).astype(np.float32) for k in ("k", "v")}


# ------------------------------------------------------------ write_decode_kv
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_decode_kv_matches_the_reference_bit_for_bit(seed):
    """Rows write mid-page, at a page boundary, through a table entry that
    names a page past the pool (the reference's ``mode="drop"`` scatter
    drops it) and at a position past the table's width (the reference's
    gather reads the last column); the port writes in place."""
    rng = np.random.default_rng(seed)
    L, K, hd, psz, p_max, B = 3, 2, 8, 4, 3, 6
    n_pages = B * p_max + 1
    pools = {k: rng.standard_normal((K, L, n_pages, psz, hd)).astype(np.float32) for k in ("k", "v")}
    table = (rng.permutation(n_pages - 1) + 1).astype(np.int32).reshape(B, p_max)
    table[2, 1] = n_pages + 3  # past the pool: dropped
    table[4, 2] = 2 * n_pages  # the last column, reached from past the table's width: dropped
    positions = np.array([1, psz, psz + 2, 2 * psz - 1, p_max * psz + 5, p_max * psz + 1], np.int32)
    k_new = rng.standard_normal((L, B, K, hd)).astype(np.float32)
    v_new = rng.standard_normal((L, B, K, hd)).astype(np.float32)

    ref = jwrite({k: jnp.asarray(v) for k, v in pools.items()}, jnp.asarray(k_new), jnp.asarray(v_new),
                 jnp.asarray(table), jnp.asarray(positions))
    got = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    ptrs = {k: v.data_ptr() for k, v in got.items()}
    out = write_decode_kv(got, torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(table),
                          torch.from_numpy(positions))
    assert out is got and {k: v.data_ptr() for k, v in out.items()} == ptrs
    for k in ("k", "v"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    # Row 5 wrote through its last column, slot 1; rows 2 and 4 wrote
    # nothing anywhere.
    np.testing.assert_array_equal(out["k"][:, :, table[5, -1], 1].numpy(), k_new[:, 5].transpose(1, 0, 2))
    changed = (out["k"].numpy() != pools["k"]).any(axis=(0, 1, 4))
    assert changed.sum() == 4


# ----------------------------------------------------------- decode_step_paged
def paged_case(seed: int, B: int = 2, S: int = 5, psz: int = 4, p_max: int = 4):
    cfg = GemmaConfig(**SMALL)
    tparams, jparams = both(numpy_params(cfg, seed))
    pools = pools_of(cfg, seed + 1, B * p_max + 1, psz)
    table = (np.arange(B * p_max, dtype=np.int32).reshape(B, p_max) + 1)
    pos0 = np.array([3, 6], np.int32)[:B]  # mid-page, ragged starts
    tokens = np.random.default_rng(seed + 2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, tparams, jparams, pools, table, pos0, tokens


@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_equals_sequential_steps(seed):
    """The port's counterpart of the reference's
    ``test_decode_chunk_matches_sequential_steps``: S 5 chunk logits and
    pools equal to 5 sequential ``decode_step_paged`` calls."""
    cfg, params, _, pools, table, pos0, tokens = paged_case(seed)
    S = tokens.shape[1]
    seq_pool = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    steps = []
    for i in range(S):
        lg, seq_pool = decode_step_paged(params, cfg, torch.from_numpy(tokens[:, i]), torch.from_numpy(pos0 + i),
                                         torch.from_numpy(table), seq_pool)
        steps.append(lg)
    chunk, chunk_pool = decode_chunk_paged(params, cfg, torch.from_numpy(tokens), torch.from_numpy(pos0),
                                           torch.from_numpy(table), {k: torch.from_numpy(v.copy()) for k, v in pools.items()})
    np.testing.assert_allclose(chunk.numpy(), torch.stack(steps, 1).numpy(), rtol=2e-5, atol=2e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(chunk_pool[k].numpy(), seq_pool[k].numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_step_paged_matches_the_reference(seed):
    """Five steps from the same pools through both packages: the [B, V]
    logits of every step and the pools after each within 2e-5; the port's
    pools are updated in place."""
    cfg, tparams, jparams, pools, table, pos0, tokens = paged_case(seed)
    jcfg = JConfig(**SMALL)
    jpool = {k: jnp.asarray(v) for k, v in pools.items()}
    tpool = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    ptrs = {k: v.data_ptr() for k, v in tpool.items()}
    for i in range(tokens.shape[1]):
        want, jpool = jstep_paged(jparams, jcfg, jnp.asarray(tokens[:, i]), jnp.asarray(pos0 + i),
                                  jnp.asarray(table), jpool, use_pallas=False)
        got, out = decode_step_paged(tparams, cfg, torch.from_numpy(tokens[:, i]), torch.from_numpy(pos0 + i),
                                     torch.from_numpy(table), tpool)
        assert out is tpool and {k: v.data_ptr() for k, v in out.items()} == ptrs
        assert tuple(got.shape) == (tokens.shape[0], cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
        for k in ("k", "v"):
            np.testing.assert_allclose(tpool[k].numpy(), np.asarray(jpool[k]), rtol=2e-5, atol=2e-5)


def test_decode_step_paged_on_a_virtual_mesh_matches_unmeshed():
    """``layout=`` passes through to ``decode_chunk_paged``: the step on a
    ``data=2, model=2`` virtual mesh of the CPU (shard-major weights, every
    row block and model shard in turn) equals the unmeshed step within
    1e-5, logits and pools."""
    cfg = GemmaConfig(**{**SMALL, "n_kv_heads": 4})
    layout = ServeLayout(make_mesh(data=2, model=2, devices=[torch.device("cpu")] * 4), cfg)
    tree = numpy_params(cfg, 4)
    B, psz, p_max = 4, 4, 4
    pools = pools_of(cfg, 5, B * p_max + 1, psz)
    table = torch.arange(B * p_max, dtype=torch.int32).reshape(B, p_max) + 1
    pos = torch.tensor([3, 6, 0, 9], dtype=torch.int32)
    tok = torch.tensor([5, 17, 200, 383])
    outs = []
    # shard_major lays the leaves out in place: each arm gets its own tree.
    whole = params_from_numpy(tree, device="cpu")
    for params, lay in ((whole, None), (shard_major(params_from_numpy(tree, device="cpu"), layout), layout)):
        pk = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
        logits, pk = decode_step_paged(params, cfg, tok, pos, table, pk, layout=lay)
        outs.append((logits, pk["k"], pk["v"]))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- decode_step
@pytest.fixture(scope="module")
def dense():
    cfg = GemmaConfig(dtype="float32", max_seq_len=64)
    tparams, jparams = both(numpy_params(cfg, 7))
    return cfg, JConfig(dtype="float32", max_seq_len=64), tparams, jparams


def test_decode_step_matches_prefill(dense):
    """The port's counterpart of the reference's
    ``test_decode_matches_prefill``: prefill one token, step the rest one at
    a time, and reproduce the full prefill's logits within 2e-4."""
    cfg, _, params, _ = dense
    B, T, S = 2, 10, 16
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (B, T)))
    full, _ = prefill(params, cfg, tokens, torch.tensor([T, T]), init_kv_cache(cfg, B, S, device="cpu"))
    step, cache = prefill(params, cfg, tokens[:, :1], torch.tensor([1, 1]), init_kv_cache(cfg, B, S, device="cpu"))
    got = [step[:, 0]]
    for t in range(1, T):
        lg, cache = decode_step(params, cfg, tokens[:, t], torch.tensor([t, t]), cache)
        got.append(lg)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(), rtol=2e-4, atol=2e-4)


def test_decode_step_matches_the_reference(dense):
    """Ragged rows (each at its own cache index) stepped through both
    packages from the same prefilled cache: logits within 2e-5 at every
    step, the dense caches after it too."""
    cfg, jcfg, tparams, jparams = dense
    B, T, S = 3, 6, 16
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (B, T)).astype(np.int32)
    lens = np.array([6, 2, 4], np.int32)
    _, jcache = jprefill(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens), jinit_kv_cache(jcfg, B, S))
    _, tcache = prefill(
        tparams, cfg, torch.from_numpy(tokens), torch.from_numpy(lens), init_kv_cache(cfg, B, S, device="cpu")
    )
    for t in range(4):
        tok = rng.integers(0, 256, (B,)).astype(np.int32)
        idx = lens + t
        want, jcache = jdecode_step(jparams, jcfg, jnp.asarray(tok), jnp.asarray(idx), jcache)
        got, tcache = decode_step(tparams, cfg, torch.from_numpy(tok), torch.from_numpy(idx), tcache)
        assert tuple(got.shape) == (B, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
        for k in ("k", "v"):
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------- load_or_init
def test_load_or_init_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GemmaConfig(**SMALL)
    with pytest.raises(EngineError, match="CUDA is not available"):
        load_or_init(cfg)
    with pytest.raises(EngineError, match="CUDA is not available"):
        load_or_init(cfg, seed=1, device=None)
    params, source = load_or_init(cfg, device="cpu")
    assert source == "random" and params["embed"].device.type == "cpu"
