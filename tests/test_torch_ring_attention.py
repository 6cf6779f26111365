"""The port's ring attention (``mcpx_torch/parallel/ring_attention.py``)
against the reference's (``mcpx/parallel/ring_attention.py``): the reference
under ``shard_map`` on the conftest's 8 virtual CPU devices, the port on a
virtual CPU mesh, the same seeded numpy inputs through both. The reference
test's three mesh parametrizations against each other and against the dense
``_attend`` (rtol = atol = 2e-5, the reference test's own), ``ring_prefill``
against the reference's and against the port's dense ``prefill``, and the
``ConfigError`` cases."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.models.gemma.model import init_params as jinit
from mcpx.parallel.mesh import make_mesh as jmake_mesh
from mcpx.parallel.ring_attention import ring_attention as jring_attention
from mcpx.parallel.ring_attention import ring_prefill as jring_prefill
from mcpx.utils.backend import mesh_context
from mcpx_torch.core.errors import ConfigError
from mcpx_torch.models.gemma import model as tm
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.params import load_or_init, params_from_numpy
from mcpx_torch.parallel.mesh import make_mesh
from mcpx_torch.parallel.ring_attention import ring_attention, ring_prefill

CPU8 = [torch.device("cpu")] * 8
TOL = dict(rtol=2e-5, atol=2e-5)


def dense_reference(q, k, v, seq_lens):
    """The port's ``_attend`` under the causal and right-padding mask the
    ring derives (the reference test's ``dense_reference``)."""
    B, T = q.shape[:2]
    pos = torch.arange(T)
    mask = (pos[None, None, :] <= pos[None, :, None]) & (pos[None, None, :] < seq_lens.long()[:, None, None])
    return tm._attend(q, k, v, mask.expand(B, T, T))


def _inputs(B, T, K, G, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, K, G, hd), np.float32)
    k = rng.standard_normal((B, T, K, hd), np.float32)
    v = rng.standard_normal((B, T, K, hd), np.float32)
    seq_lens = np.concatenate([[T, 3], rng.integers(1, T + 1, max(B - 2, 0))])[:B].astype(np.int32)
    return q, k, v, seq_lens


@pytest.mark.parametrize(
    "mesh_kw,B,T,K,G",
    [
        ({"seq": 8}, 2, 64, 2, 2),  # pure SP
        ({"seq": 4, "model": 2}, 2, 32, 2, 1),  # SP x TP(heads), MQA-ish
        ({"data": 2, "seq": 4}, 4, 32, 1, 3),  # DP x SP, GQA
    ],
    ids=["sp8", "sp4xtp2", "dp2xsp4"],
)
def test_ring_matches_the_reference_and_dense(mesh_kw, B, T, K, G):
    q, k, v, seq_lens = _inputs(B, T, K, G)
    jm = jmake_mesh(**mesh_kw)
    with mesh_context(jm):
        want = np.asarray(jax.jit(lambda *a: jring_attention(*a, jm))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seq_lens)))
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, seq_lens))
    got = ring_attention(tq, tk, tv, tl, make_mesh(**mesh_kw, devices=CPU8))
    assert got.shape == tq.shape and got.dtype == tv.dtype
    dense = dense_reference(tq, tk, tv, tl).numpy()
    valid = np.arange(T)[None, :] < seq_lens[:, None]
    np.testing.assert_allclose(got.numpy()[valid], want[valid], **TOL)
    np.testing.assert_allclose(got.numpy()[valid], dense[valid], **TOL)
    # Padded queries too: both rings give the same (well-defined) values.
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ring_output_follows_v_dtype():
    q, k, v, seq_lens = _inputs(2, 32, 2, 2)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, seq_lens))
    got = ring_attention(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), tl, make_mesh(seq=4, devices=CPU8))
    dense = dense_reference(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), tl)
    assert got.dtype == torch.bfloat16
    valid = torch.arange(32)[None, :] < tl[:, None]
    torch.testing.assert_close(got[valid].float(), dense[valid].float(), rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def f32_params():
    cfg = dataclasses.replace(JGemmaConfig.named("test"), dtype="float32")
    return cfg, jax.tree.map(np.asarray, jinit(cfg, jax.random.PRNGKey(0)))


def test_ring_prefill_matches_both_references(f32_params):
    """The test preset in float32 from the reference's init: the port's
    ``ring_prefill`` on a seq-8 virtual mesh against the reference's on 8
    devices and against the port's dense ``prefill``, logits and cache on
    valid positions, and ``last_only``."""
    jcfg, tree = f32_params
    cfg = dataclasses.replace(GemmaConfig.named("test"), dtype="float32")
    params = params_from_numpy(tree, device="cpu")
    B, T = 2, 64
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 255, (B, T)).astype(np.int32)
    seq_lens = np.asarray([T, 37], np.int32)
    jm = jmake_mesh(seq=8)
    with mesh_context(jm):
        jlogits, jcache = jax.jit(lambda p, t, sl: jring_prefill(p, jcfg, t, sl, jm))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), jnp.asarray(seq_lens))
    mesh = make_mesh(seq=8, devices=CPU8)
    tt, tl = torch.from_numpy(tokens).long(), torch.from_numpy(seq_lens)
    logits, cache = ring_prefill(params, cfg, tt, tl, mesh)
    dlogits, dcache = tm.prefill(params, cfg, tt, tl, tm.init_kv_cache(cfg, B, T, device="cpu"))
    valid = np.arange(T)[None, :] < seq_lens[:, None]
    assert logits.shape == (B, T, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy()[valid], np.asarray(jlogits)[valid], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy()[valid], dlogits.numpy()[valid], rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        got = cache[name].numpy()[:, valid]
        np.testing.assert_allclose(got, np.asarray(jcache[name])[:, valid], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, dcache[name].numpy()[:, valid], rtol=1e-5, atol=1e-5)
    last, _ = ring_prefill(params, cfg, tt, tl, mesh, tm.init_kv_cache(cfg, B, T, device="cpu"), last_only=True)
    torch.testing.assert_close(last, logits[torch.arange(B), tl.long() - 1], rtol=0, atol=1e-5)


def test_ring_requires_seq_axis_and_divisibility():
    q = torch.zeros((1, 8, 1, 1, 4))
    k = torch.zeros((1, 8, 1, 4))
    sl = torch.tensor([8])
    with pytest.raises(ConfigError, match="'seq' axis"):
        ring_attention(q, k, k, sl, make_mesh(data=2, model=4, devices=CPU8))
    mesh = make_mesh(seq=8, devices=CPU8)
    with pytest.raises(ConfigError, match="must divide"):
        ring_attention(q[:, :6], k[:, :6], k[:, :6], sl, mesh)
    cfg = GemmaConfig(vocab_size=64, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1, head_dim=8, d_ff=16,
                      dtype="float32")
    params, _ = load_or_init(cfg, seed=0, device="cpu")
    with pytest.raises(ConfigError, match="cache length == T"):
        ring_prefill(params, cfg, torch.zeros((1, 8), dtype=torch.long), torch.tensor([8]), mesh,
                     tm.init_kv_cache(cfg, 1, 16, device="cpu"))
