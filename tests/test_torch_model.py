"""The port's Gemma pieces (mcpx_torch.models.gemma) against the reference
package's, on the same numpy inputs and the committed trained checkpoint
carried across with ``params_from_numpy``. fp32 tolerances absorb summation
order only; bf16 ones absorb the two frameworks rounding at different places,
and greedy argmax must agree."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpx.models.gemma import model as jm
from mcpx.models.gemma.config import GemmaConfig as JConfig
from mcpx.models.train import load_npz as jload_npz
from mcpx_torch.models.gemma import model as tm
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.params import load_or_init, params_from_numpy

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64), np.float32) * 3
    w = rng.standard_normal((64,), np.float32) * 0.1
    ref = jm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    out = tm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ref16 = jm.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-6)
    out16 = tm.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 1e-6)
    # One bf16 ulp of the output at |x| ~ 10.
    np.testing.assert_allclose(out16.float().numpy(), np.asarray(ref16, np.float32), rtol=8e-3, atol=8e-3)


def test_apply_rope_matches_reference_half_split():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32), np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    ref = jm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    out = tm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    # cos/sin of angles up to ~500 rad: the two libms differ by a few ulps.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_params_from_numpy_carries_both_tree_forms():
    with np.load(CKPT) as z:
        flat = {k: z[k] for k in z.files}
    from_npz = params_from_numpy(flat, device="cpu")
    nested = jax.tree.map(np.asarray, jload_npz(CKPT))
    from_jax = params_from_numpy(nested, device="cpu")
    assert from_npz["layers"]["wq"].dtype == torch.bfloat16
    assert tuple(from_npz["layers"]["wq"].shape) == (2, 128, 4, 32)
    for key in ("embed", "final_norm"):
        assert torch.equal(from_npz[key], from_jax[key])
    for key, v in from_npz["layers"].items():
        assert torch.equal(v, from_jax["layers"][key]), key
    f32 = params_from_numpy(flat, "cpu", torch.float32)
    assert f32["embed"].dtype == torch.float32


def test_init_params_layout_matches_reference():
    jcfg = JConfig(vocab_size=384, d_model=64, n_layers=3, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96)
    tcfg = GemmaConfig(**dataclasses.asdict(jcfg))
    ref = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))
    params, source = load_or_init(tcfg, seed=3, device="cpu")
    assert source == "random"
    assert tuple(params["embed"].shape) == ref["embed"].shape
    for k, v in ref["layers"].items():
        assert tuple(params["layers"][k].shape) == v.shape, k
    again, _ = load_or_init(tcfg, seed=3, device="cpu")
    assert torch.equal(params["layers"]["wq"], again["layers"]["wq"])  # seeded


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.25)])
def test_prefill_logits_match_reference_on_checkpoint(dtype, tol):
    """Prefill (last position per row) of the trained checkpoint on ragged
    prompts. bf16 tolerance: a few bf16 ulps of logits up to ~20 (measured worst 0.2) after two layers of
    bf16 activations rounded at different places."""
    jcfg = dataclasses.replace(JConfig.named("test", vocab_size=3072), dtype=dtype)
    tcfg = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072), dtype=dtype)
    jparams = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), jload_npz(CKPT))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(2)
    B, T = 3, 64
    tokens = rng.integers(0, 3000, (B, T)).astype(np.int32)
    lens = np.asarray([64, 23, 9], np.int32)
    ref, _ = jm.prefill(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lens),
        jm.init_kv_cache(jcfg, B, T), last_only=True,
    )
    out, _ = tm.prefill(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(lens),
        tm.init_kv_cache(tcfg, B, T, device="cpu"), last_only=True,
    )
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=tol, atol=tol)
    assert out.argmax(-1).tolist() == ref.argmax(-1).tolist()
    full, cache = tm.prefill(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(lens), tm.init_kv_cache(tcfg, B, T, device="cpu")
    )
    assert tuple(full.shape) == (B, T, 3072) and full.dtype == torch.float32
    np.testing.assert_allclose(full[torch.arange(B), torch.from_numpy(lens).long() - 1].numpy(), out.numpy(), rtol=1e-5, atol=1e-5)
    assert tuple(cache["k"].shape) == (2, B, T, 1, 32)
