"""The port's ragged paged attention (mcpx_torch) against the reference
package's Pallas kernel, run in interpret mode on the CPU as the reference
tests run it. Same numpy-seeded inputs through both. fp32 throughout, so
the tolerance (2e-5) only absorbs summation order."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpx.engine.kernels import paged_attention as jref
from mcpx_torch.core.errors import EngineError
from mcpx_torch.engine.kernels import build
from mcpx_torch.engine.kernels import paged_attention as tk
from tests.test_torch_cuda_kernel import as_torch, mixed_case

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layer", [0, 1])
def test_ragged_plain_matches_reference_kernel_interpret(seed, layer):
    q, kp, vp, table, starts, q_lens = mixed_case(seed)
    ref = jref.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(starts), jnp.asarray(q_lens), layer, interpret=True,
    )
    out = tk.ragged_paged_attention(*as_torch(q, kp, vp, table, starts, q_lens), layer)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    for b, ql in enumerate(q_lens):
        assert np.all(out[b, ql:].numpy() == 0.0), (seed, layer, b)  # exact zeros


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_plain_matches_reference_jnp(seed):
    q, kp, vp, table, starts, q_lens = mixed_case(seed, B=5, S=8, K=1, G=4, hd=32, psz=8, p_max=6)
    ref = jref.ragged_paged_attention_reference(
        *(jnp.asarray(a) for a in (q, kp, vp, table, starts, q_lens)), 1
    )
    out = tk.ragged_paged_attention_reference(*as_torch(q, kp, vp, table, starts, q_lens), 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_ragged_n_pages_matches_reference():
    start = np.asarray([512, 5, 5, 19, 0, 63, 64, 250], np.int32)
    qn = np.asarray([0, 1, 4, 8, 0, 1, 1, 8], np.int32)
    for psz, p_max in ((4, 12), (64, 4), (16, 3)):
        ref = jref._ragged_n_pages(jnp.asarray(start), jnp.asarray(qn), psz, p_max)
        out = tk.ragged_n_pages(torch.from_numpy(start), torch.from_numpy(qn), psz, p_max)
        assert out.tolist() == np.asarray(ref).tolist()
    assert tk.ragged_n_pages(torch.tensor([512]), torch.tensor([0]), 64, 4).tolist() == [0]


@pytest.mark.parametrize("layer", [0, 1])
def test_chunk_wrapper_matches_reference(layer):
    q, kp, vp, table, starts, _ = mixed_case(3, B=3, S=4)
    ref = jref.paged_attention_chunk(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(starts), layer, interpret=True,
    )
    out = tk.paged_attention_chunk(*as_torch(q, kp, vp, table, starts), layer)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("layer", [0, 1])
def test_single_query_wrapper_matches_reference(layer):
    q, kp, vp, table, starts, _ = mixed_case(4, B=4, S=1)
    q1 = np.ascontiguousarray(q[:, 0])  # [B, K, G, hd]
    seq_lens = starts + 1
    ref = jref.paged_attention(
        jnp.asarray(q1), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(seq_lens), layer, interpret=True,
    )
    out = tk.paged_attention(*as_torch(q1, kp, vp, table, seq_lens), layer)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    plain = tk.paged_attention_reference(*as_torch(q1, kp, vp, table, seq_lens), layer)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)


def test_kernel_route_never_falls_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: a tensor on any other
    device gets the kernel or an error, never the plain path, and a call
    takes no launch count unless the kernel launched."""
    q, kp, vp, table, starts, q_lens = as_torch(*mixed_case(0))
    tk.reset_kernel_launches()
    tk.ragged_paged_attention(q, kp, vp, table, starts, q_lens, 0)
    assert tk.kernel_launches() == {"ragged_paged_attention": 0}
    meta = [t.to("meta") for t in (q, kp, vp, table, starts, q_lens)]
    with pytest.raises(EngineError, match="no route"):
        tk.ragged_paged_attention(*meta, 0)
    assert tk.kernel_launches() == {"ragged_paged_attention": 0}


def test_kernel_build_raises_without_the_toolkit(tmp_path, monkeypatch):
    """Where there is no nvcc, loading the kernel raises (it never stands
    in the plain version)."""
    monkeypatch.setenv("MCPX_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(EngineError, match="nvcc not found"):
        build.load("ragged_paged_attention")


def test_kernel_rejects_shapes_it_does_not_take():
    q, kp, vp, table, starts, q_lens = as_torch(*mixed_case(0))
    with pytest.raises(EngineError, match="int32"):
        tk._check(q, kp, vp, table.long(), starts, q_lens, 0)
    with pytest.raises(EngineError, match="float32 or bfloat16"):
        tk._check(q.double(), kp, vp, table, starts, q_lens, 0)
    with pytest.raises(EngineError, match="layer"):
        tk._check(q, kp, vp, table, starts, q_lens, 2)
    wide = torch.zeros((6, 9, 2, 8, 16))  # S*G = 72 rows > 64
    with pytest.raises(EngineError, match="unsupported shape"):
        tk._check(wide, kp, vp, table, starts, q_lens, 0)
    tk._check(q, kp, vp, table, starts, q_lens, 1)
