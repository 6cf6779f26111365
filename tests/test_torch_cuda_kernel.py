"""The CUDA ragged paged-attention kernel against its plain PyTorch
version, on the card. These tests import neither JAX nor the reference
package, so they run where only PyTorch and the CUDA toolkit are:

    python -m pytest tests/test_torch_cuda_kernel.py -q --noconftest

Elsewhere they skip: the kernel has no CPU mode. The seeded mixed-batch
generator here is shared with the CPU parity tests."""

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


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(4, 32), (8, 256)])
def test_cuda_kernel_matches_plain(cuda, dtype, atol, shape):
    """The CUDA kernel against its plain version on the card: fp32 to
    summation order, bf16 to bf16 rounding of inputs and output."""
    G, hd = shape
    for seed in range(3):
        case = mixed_case(seed, B=8, S=8, K=1, G=G, hd=hd, psz=64, p_max=4)
        q, kp, vp, table, starts, q_lens = [t.to(cuda) for t in as_torch(*case)]
        q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
        for layer in (0, 1):
            n0 = tk.kernel_launches()["ragged_paged_attention"]
            out = tk.ragged_paged_attention(q, kp, vp, table, starts, q_lens, layer)
            torch.cuda.synchronize()
            assert tk.kernel_launches()["ragged_paged_attention"] == n0 + 1
            ref = tk.ragged_paged_attention_reference(q, kp, vp, table, starts, q_lens, layer)
            np.testing.assert_allclose(
                out.float().cpu().numpy(), ref.float().cpu().numpy(), rtol=atol, atol=atol
            )
            for b, ql in enumerate(case[5]):
                assert bool((out[b, ql:] == 0).all())
