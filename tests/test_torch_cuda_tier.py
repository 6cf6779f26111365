"""The tiered KV cache's device copies on the card. These tests import
neither JAX nor the reference package, so they run where only PyTorch and
the CUDA toolkit are:

    python -m pytest tests/test_torch_cuda_tier.py -q --noconftest

Elsewhere they skip: the copies are CUDA stream work (pinned host memory,
events, a device sleep to hold a copy in flight). They hold:

  - the spill -> page reuse -> readmit round trip bit for bit: a run's
    pages are cloned, spilled, overwritten at once on the same stream (as
    the next prefill writes freed pages), and readmitted into other pages,
    which then equal the clone, as does the ragged kernel's output over
    them;
  - ``poll()`` returns at once while the copy is in flight behind a long
    device sleep, and the run lands later;
  - a readmit writes the pools in place (their ``data_ptr()`` unchanged),
    and a tiered engine serving on the card keeps its pools at the same
    addresses through spills and readmits, replays its captured windows,
    and answers round 1 as the same engine with the tier off."""

import asyncio
import time

import pytest
import torch

from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.engine.kernels import paged_attention as tk

PSZ, PMAX = 16, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tier's copies are CUDA stream work")
    return torch.device("cuda")


def _config(enabled=True, **engine):
    eng = {
        "max_batch_size": 4, "max_pages_per_seq": PMAX, "kv_page_size": PSZ, "max_decode_len": 8,
        "prefix_cache_entries": 4096, "warmup_compile": False,
        "kv_tier": {"enabled": enabled, "host_mb": 64.0, "copy_tokens_per_cycle": 4096},
    }
    eng.update(engine)
    return MCPXConfig.from_dict({"model": {"size": "test", "max_seq_len": 256}, "engine": eng})


class Node:
    def __init__(self, n_tokens):
        self.tokens, self.tenant, self.host = tuple(range(n_tokens)), "default", None


def _bound_engine(dtype, seed=0):
    """An engine that is not started, its pools filled from a seed and its
    tier bound to its own copy functions (as ``_setup`` binds them)."""
    eng = InferenceEngine(_config(), device="cuda")
    mc = eng.model_cfg
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (mc.n_kv_heads, mc.n_layers, eng._allocator.n_pages, PSZ, mc.head_dim)
    eng._paged_kv = {k: torch.randn(shape, generator=gen, device="cuda").to(dtype) for k in ("k", "v")}
    per_token = 2 * mc.n_kv_heads * mc.n_layers * mc.head_dim * eng._paged_kv["k"].element_size()
    eng._spill_tier.bind(eng._spill_gather, eng._spill_readmit, per_token)
    return eng, gen


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_pages", [1, 4, 7])
def test_spill_page_reuse_readmit_round_trip_is_bit_exact(cuda, dtype, n_pages):
    eng, gen = _bound_engine(dtype)
    pools, tier = eng._paged_kv, eng._spill_tier
    ptrs = {k: t.data_ptr() for k, t in pools.items()}
    src, dst = list(range(3, 3 + n_pages)), list(range(30, 30 + n_pages))
    src_i, dst_i = torch.tensor(src, device=cuda), torch.tensor(dst, device=cuda)
    truth = [pools[k].index_select(2, src_i).clone() for k in ("k", "v")]
    node = Node(n_pages * PSZ)
    assert tier.spill(node, src)
    for k in ("k", "v"):  # the next prefill writes the freed pages at once
        pools[k].index_copy_(2, src_i, torch.randn(truth[0].shape, generator=gen, device=cuda).to(dtype))
    while not tier.readmit_usable(node):
        tier.poll()
        time.sleep(0.001)
    assert node.host.k.is_pinned() and torch.equal(node.host.k, truth[0].cpu())
    assert tier.readmit(node, dst)
    back = [pools[k].index_select(2, dst_i) for k in ("k", "v")]
    assert all(torch.equal(a, b) for a, b in zip(back, truth))
    assert {k: t.data_ptr() for k, t in pools.items()} == ptrs
    assert tier.host_bytes_used == 0 and tier.host_tokens == 0
    if dtype == torch.bfloat16:
        # The kernel over the readmitted pages against the clone in a pool
        # of its own: exactly the same output.
        mc = eng.model_cfg
        K, L, hd, G = mc.n_kv_heads, mc.n_layers, mc.head_dim, mc.n_heads // mc.n_kv_heads
        clone = {k: torch.zeros((K, L, n_pages + 1, PSZ, hd), dtype=dtype, device=cuda) for k in ("k", "v")}
        for k, t in zip(("k", "v"), truth):
            clone[k][:, :, 1:] = t
        live_t = torch.zeros((2, PMAX), dtype=torch.int32, device=cuda)
        clone_t = torch.zeros_like(live_t)
        live_t[:, :n_pages] = dst_i.to(torch.int32)
        clone_t[:, :n_pages] = torch.arange(1, n_pages + 1, dtype=torch.int32, device=cuda)
        end = n_pages * PSZ
        q = torch.randn((2, 8, K, G, hd), generator=gen, device=cuda).to(dtype)
        starts = torch.tensor([end - 8, end - 1], dtype=torch.int32, device=cuda)
        q_lens = torch.tensor([8, 1], dtype=torch.int32, device=cuda)
        for layer in range(L):
            a = tk.ragged_paged_attention(q, pools["k"], pools["v"], live_t, starts, q_lens, layer)
            b = tk.ragged_paged_attention(q, clone["k"], clone["v"], clone_t, starts, q_lens, layer)
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_poll_never_blocks_while_the_copy_is_in_flight(cuda):
    eng, _ = _bound_engine(torch.bfloat16)
    tier = eng._spill_tier
    # A kernel's first launch (lazy module loading) and a new pinned block
    # (cudaHostAlloc) wait for the device: run the copies once first.
    warm = Node(4 * PSZ)
    assert tier.spill(warm, [1, 2, 3, 4])
    tier.drain()
    assert tier.readmit(warm, [1, 2, 3, 4])
    torch.cuda.synchronize()
    eng._prune_readmit_holds()  # the warm run's pinned blocks back in the allocator's cache
    node = Node(4 * PSZ)
    torch.cuda._sleep(400_000_000)  # a few hundred ms of device time ahead of the gather
    t0 = time.perf_counter()
    assert tier.spill(node, [5, 6, 7, 8])
    spill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tier.poll()
    poll_ms = (time.perf_counter() - t0) * 1e3
    assert tier.pending_copies() == 1 and not tier.readmit_usable(node)
    assert spill_ms < 50 and poll_ms < 50, (spill_ms, poll_ms)
    polls = 0
    while not tier.readmit_usable(node):
        tier.poll()
        polls += 1
        time.sleep(0.001)
    assert polls > 1 and tier.pending_copies() == 0
    tier.reset()
    assert tier.host_bytes_used == 0


@pytest.mark.cuda
def test_tiered_engine_keeps_its_pools_and_graphs_through_spills(cuda):
    """A tiered engine on the card: a stream four times its resident cap,
    twice; its pools keep their addresses, its windows replay (nothing is
    captured in round 2), spills and readmits happen, and round 1 answers
    as the tier-off engine's."""

    async def serve(enabled):
        eng = InferenceEngine(_config(enabled), device="cuda")
        await eng.start()
        try:
            tok = eng.tokenizer
            prompts = [tok.encode(f"tier probe {i}: " + "wxyz " * 28)[:128] for i in range(20)]
            ptrs = {k: t.data_ptr() for k, t in eng._paged_kv.items()}
            outs, caps = [], []
            for _ in range(2):
                c0 = eng.queue_stats()["captures"]
                outs.append([
                    (await eng.generate(p, max_new_tokens=2, constrained=False, temperature=0.0)).token_ids
                    for p in prompts
                ])
                caps.append(eng.queue_stats()["captures"] - c0)
            kept = {k: t.data_ptr() for k, t in eng._paged_kv.items()} == ptrs
            return outs, caps, kept, eng.queue_stats(), eng.prefix_cache_stats()
        finally:
            await eng.aclose()

    on = asyncio.run(serve(True))
    off = asyncio.run(serve(False))
    outs, caps, kept, q, st = on
    assert kept and caps[1] == 0 and q["replays"] > 0
    assert st["tier"]["spills"] > 0 and st["tier"]["readmits"] > 0
    assert outs[0] == off[0][0]
