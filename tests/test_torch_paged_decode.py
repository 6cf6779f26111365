"""The port's decode_chunk_paged against the reference package's, with the
reference's Pallas kernel in interpret mode, on the committed checkpoint in
float32, a seeded page table and seeded pools: the last-slot, all-slot and
compact (``active_cols``) unembeds. The tolerance (1e-4) absorbs summation
order over two layers."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpx.engine.paged_decode import decode_chunk_paged as jdecode
from mcpx.models.gemma.config import GemmaConfig as JConfig
from mcpx.models.train import load_npz as jload_npz
from mcpx_torch.engine.paged_decode import decode_chunk_paged as tdecode
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.params import params_from_numpy
from mcpx_torch.models.tokenizer import make_tokenizer
from mcpx_torch.planner.grammar import build_plan_grammar

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "mcpx", "models", "checkpoints", "planner_test_bpe.npz"
)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JConfig.named("test", vocab_size=3072), dtype="float32")
    tcfg = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072), dtype="float32")
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jload_npz(CKPT))
    return jcfg, tcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def case(seed, B=5, S=8, psz=16, p_max=4):
    rng = np.random.default_rng(seed)
    n_pages = B * p_max + 1
    shape = (1, 2, n_pages, psz, 32)
    pools = {"k": rng.standard_normal(shape, np.float32), "v": rng.standard_normal(shape, np.float32)}
    table = (rng.permutation(n_pages - 1)[: B * p_max] + 1).astype(np.int32).reshape(B, p_max)
    q_lens = np.asarray([8, 1, 3, 0, 5], np.int32)[:B]
    positions = np.asarray([rng.integers(0, p_max * psz - S) for _ in range(B)], np.int32)
    tokens = rng.integers(0, 3000, (B, S)).astype(np.int32)
    return tokens, positions, table, pools, q_lens


@pytest.mark.parametrize("seed", [0, 1])
def test_ragged_decode_matches_reference_kernel_interpret(setup, seed):
    jcfg, tcfg, jparams, tparams = setup
    tokens, positions, table, pools, q_lens = case(seed)
    logits_at = np.maximum(q_lens - 1, 0)
    ref, ref_pools = jdecode(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(table),
        {k: jnp.asarray(v) for k, v in pools.items()},
        use_pallas=True, interpret=True,
        logits_at=jnp.asarray(logits_at), q_lens=jnp.asarray(q_lens),
    )
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    out, out_pools = tdecode(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(table), tpools,
        logits_at=torch.from_numpy(logits_at), q_lens=torch.from_numpy(q_lens),
    )
    assert tuple(out.shape) == (5, 3072)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(out_pools[k].numpy(), np.asarray(ref_pools[k]), rtol=1e-5, atol=1e-5)


def test_dense_chunk_decode_matches_reference(setup):
    """q_lens=None: every window slot live, logits at every slot."""
    jcfg, tcfg, jparams, tparams = setup
    tokens, positions, table, pools, _ = case(2, B=3, S=4)
    ref, _ = jdecode(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(table),
        {k: jnp.asarray(v) for k, v in pools.items()}, use_pallas=False,
    )
    out, _ = tdecode(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(table), {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
    )
    assert tuple(out.shape) == (3, 4, 3072)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_unembed_matches_reference(setup, seed):
    """``active_cols``: logits over the plan grammar's active columns at
    every window slot ([B, S, C], the draft verifier's input), against the
    reference with its kernel in interpret mode; a ragged mix with an idle
    row. The greedy column at every live slot must be the same."""
    jcfg, tcfg, jparams, tparams = setup
    tokens, positions, table, pools, q_lens = case(seed)
    cols = build_plan_grammar(make_tokenizer("bpe")).device_tables(64)[3]
    ref, _ = jdecode(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(table),
        {k: jnp.asarray(v) for k, v in pools.items()},
        use_pallas=True, interpret=True, active_cols=jnp.asarray(cols), q_lens=jnp.asarray(q_lens),
    )
    out, _ = tdecode(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
        torch.from_numpy(table), {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
        active_cols=torch.from_numpy(cols), q_lens=torch.from_numpy(q_lens),
    )
    assert tuple(out.shape) == (5, 8, len(cols)) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    live = np.arange(8)[None, :] < q_lens[:, None]
    assert np.array_equal(out.numpy().argmax(-1)[live], np.asarray(ref).argmax(-1)[live])
