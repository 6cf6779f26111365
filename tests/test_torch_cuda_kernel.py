"""The CUDA ragged paged-attention kernel against its plain PyTorch
version, on the card. These tests import neither JAX nor the reference
package, so they run where only PyTorch and the CUDA toolkit are:

    python -m pytest tests/test_torch_cuda_kernel.py -q --noconftest

Elsewhere they skip: the kernel has no CPU mode. The seeded mixed-batch
and prefill-cohort generators here are shared with the CPU parity tests."""

import random

import numpy as np
import pytest
import torch

from mcpx_torch.engine.kernels import paged_attention as tk


def mixed_case(seed, B=6, S=5, K=2, G=2, hd=16, psz=4, p_max=12):
    """Rows with q_len = S, 1, 1 < q_len < S and 0, then random; distinct
    random pages and start offsets (the reference's mixed-batch generator,
    with numpy draws so both packages see the same numbers)."""
    rng = random.Random(seed)
    npr = np.random.default_rng(seed)
    n_pages = B * p_max + 2
    q = npr.standard_normal((B, S, K, G, hd), np.float32)
    kp = npr.standard_normal((K, 2, n_pages, psz, hd), np.float32)
    vp = npr.standard_normal((K, 2, n_pages, psz, hd), np.float32)
    pages = list(range(1, n_pages))
    rng.shuffle(pages)
    table = np.asarray(pages[: B * p_max], np.int32).reshape(B, p_max)
    mid = rng.randint(2, S - 1) if S > 2 else S
    q_lens = [S, 1, mid, 0, rng.randint(0, S), 1, rng.randint(0, S), S][:B]
    starts = [rng.randint(0, p_max * psz - max(1, q_lens[b]) - 1) for b in range(B)]
    return q, kp, vp, table, np.asarray(starts, np.int32), np.asarray(q_lens, np.int32)


def prefill_case(seed, B=16, S=128, K=1, G=4, hd=32, psz=64, p_max=4, starts=(0, 64, 128), idle=2):
    """A suffix-prefill cohort: q_len uniform in 1..S, each row's start
    drawn from `starts` (those that leave room for S queries in the table),
    and `idle` idle rows among them; numpy draws, as in `mixed_case`."""
    rng = random.Random(seed)
    npr = np.random.default_rng(seed)
    n_pages = B * p_max + 2
    q = npr.standard_normal((B, S, K, G, hd), np.float32)
    kp = npr.standard_normal((K, 2, n_pages, psz, hd), np.float32)
    vp = npr.standard_normal((K, 2, n_pages, psz, hd), np.float32)
    pages = list(range(1, n_pages))
    rng.shuffle(pages)
    table = np.asarray(pages[: B * p_max], np.int32).reshape(B, p_max)
    fits = [s for s in starts if s + S <= p_max * psz]
    idle_rows = set(rng.sample(range(B), idle))
    q_lens = [0 if b in idle_rows else rng.randint(1, S) for b in range(B)]
    st = [rng.choice(fits) for _ in range(B)]
    return q, kp, vp, table, np.asarray(st, np.int32), np.asarray(q_lens, np.int32)


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


DTYPES = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]


def _on_card(case, cuda, dtype):
    q, kp, vp, table, starts, q_lens = [t.to(cuda) for t in as_torch(*case)]
    return q.to(dtype), kp.to(dtype), vp.to(dtype), table, starts, q_lens


def _check_case(case, cuda, dtype, atol, layers=(0, 1)):
    """Kernel against plain on one case: within `atol`, one launch a call,
    pads and idle rows exactly 0, and the ticket counters left at 0."""
    args = _on_card(case, cuda, dtype)
    for layer in layers:
        n0 = tk.kernel_launches()["ragged_paged_attention"]
        out = tk.ragged_paged_attention(*args, layer)
        torch.cuda.synchronize()
        assert tk.kernel_launches()["ragged_paged_attention"] == n0 + 1
        ref = tk.ragged_paged_attention_reference(*args, layer)
        np.testing.assert_allclose(
            out.float().cpu().numpy(), ref.float().cpu().numpy(), rtol=atol, atol=atol
        )
        for b, ql in enumerate(case[5]):
            assert bool((out[b, ql:] == 0).all())
        assert all(int(t.abs().sum()) == 0 for t in tk.ticket_counters())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape", [(4, 32), (8, 256)])
def test_cuda_kernel_matches_plain(cuda, dtype, atol, shape):
    """The CUDA kernel against its plain version on the card: fp32 to
    summation order, bf16 to bf16 rounding of inputs and output."""
    G, hd = shape
    for seed in range(3):
        _check_case(mixed_case(seed, B=8, S=8, K=1, G=G, hd=hd, psz=64, p_max=4), cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("geometry", [{}, dict(S=8, G=8, hd=128, psz=4, p_max=40)])
def test_cuda_kernel_many_pages_per_split(cuda, dtype, atol, geometry):
    """Many pages in one block, more than one kv-head: the default mixed
    geometry (K 2, G 2, hd 16, Psz 4, Pmax 12), whose rows fit one split,
    and a wide one whose rows of two or more queries split into chunks of
    16 pages and merge."""
    for seed in range(3):
        _check_case(mixed_case(seed, **geometry), cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("hd", [24, 40])
def test_cuda_kernel_padded_head_dim(cuda, dtype, atol, hd):
    """hd % 16 == 8: the bf16 path zero-pads the last k-step in shared memory."""
    for seed in range(2):
        case = mixed_case(seed, B=6, S=8, K=1, G=4, hd=hd, psz=16, p_max=6)
        _check_case(case, cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_cuda_kernel_all_idle_batch_is_zero(cuda, dtype, atol):
    case = list(mixed_case(0, B=8, S=8, K=1, G=8, hd=256, psz=64, p_max=4))
    case[5] = np.zeros_like(case[5])
    args = _on_card(case, cuda, dtype)
    out = tk.ragged_paged_attention(*args, 1)
    torch.cuda.synchronize()
    assert bool((out == 0).all())
    assert all(int(t.abs().sum()) == 0 for t in tk.ticket_counters())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_cuda_kernel_repeats_bit_identical(cuda, dtype, atol):
    """Three launches back to back give the same bits: the counters reset
    and the merge visits splits in a fixed order."""
    args = _on_card(mixed_case(1, B=8, S=8, K=2, G=4, hd=64, psz=16, p_max=8), cuda, dtype)
    outs = [tk.ragged_paged_attention(*args, 1) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    ref = tk.ragged_paged_attention_reference(*args, 1)
    np.testing.assert_allclose(
        outs[0].float().cpu().numpy(), ref.float().cpu().numpy(), rtol=atol, atol=atol
    )


@pytest.mark.cuda
def test_cuda_kernel_two_streams_keep_their_own_counters(cuda):
    """Launches on two streams of one device may overlap; each stream has
    its own ticket counters, so every output equals that of a launch alone
    and every counter is back at 0."""
    cases = [
        _on_card(mixed_case(seed, B=8, S=8, K=1, G=8, hd=256, psz=64, p_max=4), cuda, torch.bfloat16)
        for seed in (0, 1)
    ]
    alone = [tk.ragged_paged_attention(*args, 1) for args in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, (s, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                outs[i].append(tk.ragged_paged_attention(*args, 1))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, alone[i]) for o in outs[i])
    assert all(int(t.abs().sum()) == 0 for t in tk.ticket_counters())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape", [(4, 32), (8, 256)])
@pytest.mark.parametrize("S", [64, 128])
def test_cuda_kernel_prefill_width(cuda, dtype, atol, shape, S):
    """Suffix-prefill windows (S*G of 256 to 1,024 rows, cut into query
    tiles) at both head-dim builds: starts at page offsets, idle rows
    beside prefill rows."""
    G, hd = shape
    for seed in range(2):
        _check_case(prefill_case(seed, S=S, G=G, hd=hd), cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape", [(4, 32), (8, 256)])
def test_cuda_kernel_prefill_off_page_starts(cuda, dtype, atol, shape):
    """Starts inside a page: a tile's visible end and the split boundaries
    fall mid-page."""
    G, hd = shape
    for seed in range(2):
        case = prefill_case(seed, S=128, G=G, hd=hd, starts=(5, 37, 70, 127))
        _check_case(case, cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("B", [2, 64])
def test_cuda_kernel_widest_window(cuda, dtype, atol, B):
    """S*G = 2,048 (S 256, G 8, hd 256) in one launch: a small batch keeps
    several splits a tile, a full one falls to one split."""
    _check_case(prefill_case(0, B=B, S=256, G=8, hd=256, starts=(0,), idle=1), cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_cuda_kernel_prefill_repeats_bit_identical(cuda, dtype, atol):
    args = _on_card(prefill_case(3, S=128, G=8, hd=256), cuda, dtype)
    outs = [tk.ragged_paged_attention(*args, 0) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    assert all(int(t.abs().sum()) == 0 for t in tk.ticket_counters())
