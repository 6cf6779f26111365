"""The port's paged KV cache: the copied page allocator's behaviour, and
commit_prefill_to_pages against the reference package's, with chunks past
a row's pages routed to the null page 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpx.engine.kv_cache import commit_prefill_to_pages as jcommit
from mcpx.engine.kv_cache import init_paged_kv as jinit
from mcpx.models.gemma.config import GemmaConfig as JConfig
from mcpx_torch.core.errors import EngineError
from mcpx_torch.engine.kv_cache import PageAllocator, commit_prefill_to_pages, init_paged_kv
from mcpx_torch.models.gemma.config import GemmaConfig


def test_allocator_invariants():
    a = PageAllocator(n_pages=32, page_size=8, max_pages_per_seq=8)
    assert len(a.allocate(1, 20)) == 3
    assert len(a.allocate(2, 1)) == 1
    a.check_invariants()
    assert len(a.extend(1, 40)) == 5
    a.check_invariants()
    a.free(1)
    a.free(1)  # double free is a no-op
    a.check_invariants()
    stats = a.stats()
    assert (stats.sequences, stats.free_pages) == (1, 30)
    with pytest.raises(EngineError, match="already has pages"):
        a.allocate(2, 4)


def test_allocator_exhaustion_and_caps():
    a = PageAllocator(n_pages=4, page_size=8, max_pages_per_seq=8)
    a.allocate(1, 24)
    assert not a.can_allocate(1)
    with pytest.raises(EngineError, match="out of KV pages"):
        a.allocate(2, 1)
    a.free(1)
    assert a.can_allocate(24)
    b = PageAllocator(n_pages=64, page_size=8, max_pages_per_seq=2)
    with pytest.raises(EngineError, match="max_pages_per_seq"):
        b.allocate(1, 100)
    with pytest.raises(EngineError, match="page 0 is reserved"):
        PageAllocator(n_pages=1, page_size=8, max_pages_per_seq=2)


def test_allocator_never_hands_out_the_null_page():
    a = PageAllocator(n_pages=9, page_size=4, max_pages_per_seq=8)
    pages = a.allocate(1, 32)
    assert sorted(pages) == list(range(1, 9))


def test_init_paged_kv_layout_matches_reference():
    jcfg = JConfig(n_layers=3, n_kv_heads=2, head_dim=16, n_heads=4)
    tcfg = GemmaConfig(n_layers=3, n_kv_heads=2, head_dim=16, n_heads=4)
    ref = jinit(jcfg, 7, 4)
    out = init_paged_kv(tcfg, 7, 4, device="cpu")
    assert tuple(out["k"].shape) == ref["k"].shape == (2, 3, 7, 4, 16)
    assert out["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1])
def test_commit_prefill_matches_reference_with_null_page_routing(seed):
    rng = np.random.default_rng(seed)
    L, B, T, K, hd, psz, p_max, n_pages = 2, 3, 16, 2, 8, 4, 4, 16
    dense = {k: rng.standard_normal((L, B, T, K, hd), np.float32) for k in ("k", "v")}
    pools = {k: rng.standard_normal((K, L, n_pages, psz, hd), np.float32) for k in ("k", "v")}
    # Row 0 owns 4 pages, row 1 two (chunks 2-3 -> null page), row 2 none.
    table = np.asarray([[3, 7, 1, 9], [4, 12, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.asarray([16, 6, 1], np.int32)
    ref = jcommit({k: jnp.asarray(v) for k, v in pools.items()},
                  {k: jnp.asarray(v) for k, v in dense.items()},
                  jnp.asarray(table), jnp.asarray(lens), psz)
    out = commit_prefill_to_pages({k: torch.from_numpy(v.copy()) for k, v in pools.items()},
                                  {k: torch.from_numpy(v) for k, v in dense.items()},
                                  torch.from_numpy(table), torch.from_numpy(lens), psz)
    for k in ("k", "v"):
        # Page 0 takes every routed-away chunk (duplicate writes, order
        # unspecified); it is never read, so only the real pages compare.
        np.testing.assert_array_equal(out[k][:, :, 1:].numpy(), np.asarray(ref[k])[:, :, 1:])
    np.testing.assert_array_equal(
        out["k"][:, 1, 12].numpy(), dense["k"][1, 1, psz:2 * psz].transpose(1, 0, 2)
    )
    with pytest.raises(EngineError, match="multiple of page_size"):
        commit_prefill_to_pages(out, {k: torch.zeros((L, B, 6, K, hd)) for k in ("k", "v")},
                                torch.from_numpy(table), torch.from_numpy(lens), psz)
