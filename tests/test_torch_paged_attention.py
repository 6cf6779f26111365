"""The port's ragged paged attention (mcpx_torch) against the reference
package's Pallas kernel, run in interpret mode on the CPU as the reference
tests run it. Same numpy-seeded inputs through both. fp32 throughout, so
the tolerance (2e-5) only absorbs summation order."""

import functools
import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcpx.engine.kernels import paged_attention as jref
from mcpx_torch.core.errors import EngineError
from mcpx_torch.engine.kernels import build
from mcpx_torch.engine.kernels import paged_attention as tk
from tests.test_torch_cuda_kernel import as_torch, mixed_case, prefill_case

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


def _split_and_merge(q, kp, vp, table, starts, q_lens, layer, chunk):
    """The kernel's split arithmetic in plain PyTorch (fp32): each chunk of
    `chunk` positions that starts before the row's last visible position
    gives every query row a partial (m, l, unnormalised acc); the merge
    skips partials with l == 0, rescales the rest to the largest m, and
    writes acc / l where l > 0 and exact zeros elsewhere."""
    B, S, K, G, hd = q.shape
    rows = S * G
    k = tk._gather_pages(kp, table, layer).float()  # [B, K, P, hd]
    v = tk._gather_pages(vp, table, layer).float()
    P = k.shape[2]
    qf = q.float().permute(0, 2, 1, 3, 4).reshape(B, K, rows, hd)  # row r: query r // G
    s = torch.einsum("bkrh,bkph->bkrp", qf, k) * (1.0 / math.sqrt(hd))
    qn = q_lens.long().clamp(0, S)
    row_q = torch.arange(rows) // G
    vis = torch.clamp(starts.long()[:, None] + row_q[None, :] + 1, max=P)  # [B, rows]
    live = row_q[None, :] < qn[:, None]
    mask = (torch.arange(P)[None, None, :] < vis[:, :, None]) & live[:, :, None]
    s = torch.where(mask[:, None], s, torch.full_like(s, tk.NEG_INF))
    lim = torch.where(qn > 0, torch.clamp(starts.long() + qn, max=P), torch.zeros_like(qn))
    ms, ls, accs = [], [], []
    for c0 in range(0, P, chunk):
        sc = s[..., c0:c0 + chunk]
        m = sc.max(-1).values
        p = torch.where(sc <= tk.NEG_INF / 2, torch.zeros_like(sc), torch.exp(sc - m[..., None]))
        work = (c0 < lim)[:, None, None]  # blocks past the last visible position compute nothing
        ms.append(m)
        ls.append(torch.where(work, p.sum(-1), torch.zeros_like(m)))
        accs.append(torch.einsum("bkrp,bkph->bkrh", p, v[:, :, c0:c0 + chunk]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    m_star = torch.where(l > 0, m, torch.full_like(m, tk.NEG_INF)).max(0).values
    w = torch.where(l > 0, torch.exp(m - m_star), torch.zeros_like(m))
    total = (l * w).sum(0)
    merged = (w[..., None] * acc).sum(0)
    out = torch.where(
        total[..., None] > 0, merged / torch.clamp(total, min=1e-30)[..., None], torch.zeros_like(merged)
    )
    return out.reshape(B, K, S, G, hd).permute(0, 2, 1, 3, 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("chunk", ["half_page", "page", "table"])
def test_split_merge_matches_reference_kernel_interpret(seed, chunk):
    """Splitting a row's positions into chunks and merging the partials as
    the CUDA kernel does gives the reference kernel's output (interpret
    mode) and the plain version's, fp32 to 2e-5; pads and idle rows stay
    exact zeros, and chunks that see nothing bring no NaN."""
    q, kp, vp, table, starts, q_lens = mixed_case(seed)
    psz, p_max = kp.shape[3], table.shape[1]
    size = {"half_page": psz // 2, "page": psz, "table": p_max * psz}[chunk]
    args = as_torch(q, kp, vp, table, starts, q_lens)
    out = _split_and_merge(*args, 1, size)
    assert bool(torch.isfinite(out).all())
    ref = jref.ragged_paged_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, table, starts, q_lens)), 1, interpret=True
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    plain = tk.ragged_paged_attention_reference(*args, 1)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **TOL)
    for b, ql in enumerate(q_lens):
        assert np.all(out[b, ql:].numpy() == 0.0), (seed, chunk, b)


def _grid(B, S, K, G, p_max, psz, sms=132, design="mma_sync"):
    """The kernel's query tiles and splits (``grid_of`` in the CUDA source)
    on a card with ``sms`` SMs: (tile rows, positions a split attends).
    mma_sync: 64-row tiles, splits of 64 positions until the blocks make
    about two an SM; warpgroup: split only while the blocks fill less than
    half the SMs, into spans of at least 256 positions; 64-row tiles in
    both."""
    rows = tk.TILE_ROWS
    tiles, total = -(-S * G // rows), p_max * psz
    work = max(1, B * K * tiles)
    if design == "warpgroup":
        want = max(1, min(-(-total // 256), sms // (2 * work)))
    else:
        want = max(1, min(-(-total // 64), -(-2 * sms // work)))
    return rows, -(-(-(-total // want)) // 64) * 64


def _tile_split_and_merge(q, kp, vp, table, starts, q_lens, layer, tile_rows, span):
    """The kernel's query-tile and split arithmetic in plain PyTorch (fp32):
    window rows (query r // G) are cut into tiles of `tile_rows`; a tile
    sees positions below start + its last live query + 1 (`lim`), and split
    c of `span` positions works only when it starts below that. Each
    working split gives every row of the tile a partial (m, l, unnormalised
    acc); the merge skips l == 0, rescales to the largest m, and writes
    acc / l where l > 0 and exact zeros elsewhere."""
    B, S, K, G, hd = q.shape
    rows = S * G
    k = tk._gather_pages(kp, table, layer).float()
    v = tk._gather_pages(vp, table, layer).float()
    P = k.shape[2]
    qf = q.float().permute(0, 2, 1, 3, 4).reshape(B, K, rows, hd)
    s = torch.einsum("bkrh,bkph->bkrp", qf, k) * (1.0 / math.sqrt(hd))
    qn = q_lens.long().clamp(0, S)
    row_q = torch.arange(rows) // G
    vis = torch.clamp(starts.long()[:, None] + row_q[None, :] + 1, max=P)
    live = row_q[None, :] < qn[:, None]  # [B, rows]
    mask = (torch.arange(P)[None, None, :] < vis[:, :, None]) & live[:, :, None]
    s = torch.where(mask[:, None], s, torch.full_like(s, tk.NEG_INF))
    tile = torch.arange(rows) // tile_rows
    n_tiles = int(tile.max()) + 1
    lim = torch.zeros((B, n_tiles), dtype=torch.long)
    for t in range(n_tiles):
        last = (live & (tile == t)[None, :]).long() * (torch.arange(rows) + 1)[None, :]
        last_q = (last.max(1).values - 1) // G  # the tile's last live query
        has = last.max(1).values > 0
        lim[:, t] = torch.where(has, torch.clamp(starts.long() + last_q + 1, max=P), 0)
    lim_row = lim[:, tile]  # [B, rows]
    ms, ls, accs = [], [], []
    for c0 in range(0, P, span):
        sc = s[..., c0:c0 + span]
        m = sc.max(-1).values
        p = torch.where(sc <= tk.NEG_INF / 2, torch.zeros_like(sc), torch.exp(sc - m[..., None]))
        work = (c0 < lim_row)[:, None, :]  # the tile's block c computes nothing past lim
        ms.append(m)
        ls.append(torch.where(work, p.sum(-1), torch.zeros_like(m)))
        accs.append(torch.einsum("bkrp,bkph->bkrh", p, v[:, :, c0:c0 + span]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    m_star = torch.where(l > 0, m, torch.full_like(m, tk.NEG_INF)).max(0).values
    w = torch.where(l > 0, torch.exp(m - m_star), torch.zeros_like(m))
    total = (l * w).sum(0)
    merged = (w[..., None] * acc).sum(0)
    out = torch.where(
        total[..., None] > 0, merged / torch.clamp(total, min=1e-30)[..., None], torch.zeros_like(merged)
    )
    return out.reshape(B, K, S, G, hd).permute(0, 2, 1, 3, 4)


@functools.lru_cache(maxsize=None)
def _prefill_reference(S, G):
    """A suffix-prefill cohort (starts 0, 64, 128; two idle rows) and the
    reference kernel's output on it in interpret mode, layer 1."""
    case = prefill_case(S + G, B=6, S=S, K=1, G=G, hd=16, psz=16, p_max=16)
    ref = jref.ragged_paged_attention(*(jnp.asarray(a) for a in case), 1, interpret=True)
    return case, np.asarray(ref)


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("span", ["grid", "table", "warpgroup"])
def test_query_tiles_match_reference_kernel_interpret(S, G, span):
    """Prefill width (S*G of 256 to 1,024 rows): cutting the window into
    query tiles, each with its own causal limit and splits, and merging as
    the CUDA kernel does gives the reference kernel's output (interpret
    mode) and the plain version's, fp32 to 2e-5; pads and idle rows stay
    exact zeros. `grid` takes the mma_sync design's 64-row tiles and split
    count for this batch on a 132-SM card, `table` 64-row tiles and one
    split over the whole table, `warpgroup` the warpgroup design's tiles and
    split rule."""
    case, ref = _prefill_reference(S, G)
    q, kp, vp, table, starts, q_lens = case
    psz, p_max = kp.shape[3], table.shape[1]
    tile_rows, size = _grid(6, S, 1, G, p_max, psz, design="warpgroup" if span == "warpgroup" else "mma_sync")
    if span == "table":
        size = p_max * psz
    args = as_torch(*case)
    out = _tile_split_and_merge(*args, 1, tile_rows, size)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    plain = tk.ragged_paged_attention_reference(*args, 1)
    np.testing.assert_allclose(plain.numpy(), ref, **TOL)
    for b, ql in enumerate(q_lens):
        assert np.all(out[b, ql:].numpy() == 0.0) and np.all(plain[b, ql:].numpy() == 0.0)


def _warpgroup_case(kind):
    """The warpgroup design's domain at shapes the cases above miss, with
    numpy draws: ``hd256`` (G 8, hd 256, 16-token pages), ``off_page``
    (16-token pages, starts inside a page), ``idle_beside_full`` (q_len 0
    rows beside rows at q_len S: whole pad-only tiles), ``split`` (a B 4
    cohort over 64 pages, where the design splits positions)."""
    if kind == "hd256":
        return prefill_case(1, B=3, S=64, G=8, hd=256, psz=16, p_max=16, idle=1)
    if kind == "off_page":
        return prefill_case(2, B=4, S=128, G=4, hd=32, psz=16, p_max=16, starts=(5, 37, 70, 127), idle=1)
    if kind == "idle_beside_full":
        case = list(prefill_case(3, B=4, S=64, G=4, hd=32, psz=16, p_max=16, idle=0))
        case[5] = np.asarray([64, 0, 64, 0], np.int32)
        return tuple(case)
    return prefill_case(4, B=4, S=64, G=8, hd=32, psz=16, p_max=64, starts=(64, 80, 112, 520), idle=1)


@pytest.mark.parametrize("kind", ["hd256", "off_page", "idle_beside_full", "split"])
def test_warpgroup_tiles_match_reference_kernel_interpret(kind):
    """The plain version and the warpgroup design's tile and split
    arithmetic (its tiles, its split rule on a 132-SM card) against the
    reference kernel in interpret mode, fp32 to 2e-5, at the design's
    domain shapes; pads and idle rows exact zeros. The split case does
    split (more than one span of positions)."""
    case = _warpgroup_case(kind)
    q, kp, vp, table, starts, q_lens = case
    B, S, K, G, hd = q.shape
    psz, p_max = kp.shape[3], table.shape[1]
    assert tk.kernel_design(S, G, hd, psz, torch.bfloat16, kp.size // hd) == "warpgroup"
    ref = np.asarray(jref.ragged_paged_attention(*(jnp.asarray(a) for a in case), 1, interpret=True))
    args = as_torch(*case)
    plain = tk.ragged_paged_attention_reference(*args, 1)
    np.testing.assert_allclose(plain.numpy(), ref, **TOL)
    tile_rows, size = _grid(B, S, K, G, p_max, psz, design="warpgroup")
    assert (size < p_max * psz) == (kind == "split")
    out = _tile_split_and_merge(*args, 1, tile_rows, size)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    for b, ql in enumerate(q_lens):
        assert np.all(out[b, ql:].numpy() == 0.0) and np.all(plain[b, ql:].numpy() == 0.0)


def test_routing_pins_each_kernel_phase_shape_to_its_design():
    """The route is shapes alone: each of chip_smoke's kernel-phase cells
    (bf16) takes the design named here: the suffix- and tier-prefill
    windows (S*G of 256 to 1,024 rows) the warpgroup design, every one-tile
    window (decode, fast-forward, verify, tier decode) the rowwise design,
    and so do phase 28's one-token steps. float32 and hd % 16 == 8 stay on
    mma_sync, in one tile or more; so do page sizes that do not tile a
    64-position stage in 8-row atoms and pools past a 32-bit TMA row."""
    import chip_smoke

    shapes = {None: (64, 8), "prefill": (16, 128), "tier_prefill": (4, 64), "tier_decode": (4, 1)}
    for cell, G, hd, L, live, psz, pmax in chip_smoke.CELLS:
        B, S = shapes.get(live, (64, 5) if isinstance(live, tuple) else (64, 8))
        rows = L * (B * pmax + 1) * psz
        want = "warpgroup" if live in ("prefill", "tier_prefill") else "rowwise"
        if live == "tier_decode" and hd == 256:
            want = "mma_sync"  # 8 rows at hd 256: see below
        assert tk.kernel_design(S, G, hd, psz, torch.bfloat16, rows) == want, cell
        assert tk.kernel_design(S, G, hd, psz, torch.float32, rows) == "mma_sync", cell
    # decode_step_paged at B 8, 64-token pages: test's S 1 rows on rowwise;
    # 8 rows or fewer at hd 256 (2b's S 1) stay on mma_sync, which ran them
    # as fast or faster; 16 rows there take rowwise.
    assert tk.kernel_design(1, 4, 32, 64, torch.bfloat16, 2 * 33 * 64) == "rowwise"
    assert tk.kernel_design(1, 8, 256, 64, torch.bfloat16, 18 * 33 * 64) == "mma_sync"
    assert tk.kernel_design(2, 8, 256, 64, torch.bfloat16, 18 * 33 * 64) == "rowwise"
    assert tk.kernel_design(8, 1, 128, 64, torch.bfloat16, 4096) == "rowwise"
    for S in (1, 8, 128):
        assert tk.kernel_design(S, 4, 40, 16, torch.bfloat16, 4096) == "mma_sync"
        assert tk.kernel_design(S, 4, 24, 64, torch.bfloat16, 4096) == "mma_sync"
        assert tk.kernel_design(S, 4, 32, 4, torch.bfloat16, 4096) == "mma_sync"
        assert tk.kernel_design(S, 4, 32, 16, torch.bfloat16, 2**31) == "mma_sync"
    assert tk.kernel_design(16, 4, 32, 16, torch.bfloat16, 4096) == "rowwise"  # S*G 64: one tile
    assert tk.kernel_design(17, 4, 32, 16, torch.bfloat16, 4096) == "warpgroup"


def _rowwise_grid(B, K, p_max, psz, sms=132):
    """The rowwise design's span (``grid_of`` in the CUDA source) on a card
    with ``sms`` SMs: the whole table up to 256 positions; a longer one
    splits while the B*K row blocks stay within one an SM, into spans of
    256 to 2,048 positions."""
    total = p_max * psz
    want = max(-(-total // 2048), max(1, min(-(-total // 256), sms // max(1, B * K))))
    return -(-(-(-total // want)) // 64) * 64


def _rowwise_split_and_merge(q, kp, vp, table, starts, q_lens, layer, span, groups):
    """The rowwise design's arithmetic in plain PyTorch (fp32): a block per
    (row, kv head) and split of ``span`` positions; inside it, 64-position
    stage t goes to warpgroup t % ``groups``, which keeps its own (m, l,
    unnormalised acc) over its stages; the warpgroups merge in warpgroup
    order (l == 0 skipped, rescaled to the largest m), then the splits in
    split order, writing acc / l where l > 0 and exact zeros elsewhere."""
    B, S, K, G, hd = q.shape
    rows = S * G
    k = tk._gather_pages(kp, table, layer).float()
    v = tk._gather_pages(vp, table, layer).float()
    P = k.shape[2]
    qf = q.float().permute(0, 2, 1, 3, 4).reshape(B, K, rows, hd)
    s = torch.einsum("bkrh,bkph->bkrp", qf, k) * (1.0 / math.sqrt(hd))
    qn = q_lens.long().clamp(0, S)
    row_q = torch.arange(rows) // G
    vis = torch.clamp(starts.long()[:, None] + row_q[None, :] + 1, max=P)
    live = row_q[None, :] < qn[:, None]
    mask = (torch.arange(P)[None, None, :] < vis[:, :, None]) & live[:, :, None]
    s = torch.where(mask[:, None], s, torch.full_like(s, tk.NEG_INF))
    pos = torch.arange(P)

    def merged(parts):
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        m_star = torch.where(l > 0, m, torch.full_like(m, tk.NEG_INF)).max(0).values
        w = torch.where(l > 0, torch.exp(m - m_star), torch.zeros_like(m))
        return m_star, (l * w).sum(0), (w[..., None] * acc).sum(0)

    splits = []
    for c0 in range(0, P, span):
        groups_parts = []
        for g in range(groups):
            mine = (pos >= c0) & (pos < c0 + span) & (((pos - c0) // 64) % groups == g)
            sc = torch.where(mine, s, torch.full_like(s, tk.NEG_INF))
            m = sc.max(-1).values
            p = torch.where(sc <= tk.NEG_INF / 2, torch.zeros_like(sc), torch.exp(sc - m[..., None]))
            groups_parts.append((m, p.sum(-1), torch.einsum("bkrp,bkph->bkrh", p, v)))
        splits.append(merged(groups_parts))
    _, total, acc = merged(splits)
    out = torch.where(total[..., None] > 0, acc / torch.clamp(total, min=1e-30)[..., None], torch.zeros_like(acc))
    return out.reshape(B, K, S, G, hd).permute(0, 2, 1, 3, 4)


# (B, S, G, hd, Psz, Pmax): the serving window, a verify window, a
# two-token window at hd 256, and 1,024- and 2,048-position tables, where
# the rowwise design splits.
ROWWISE_CASES = {
    "serve": (6, 8, 4, 32, 64, 4), "verify": (6, 5, 4, 64, 32, 8), "step_hd256": (4, 2, 8, 256, 16, 16),
    "long1024": (4, 8, 4, 32, 64, 16), "long2048": (4, 1, 8, 128, 64, 32),
}


@pytest.mark.parametrize("kind", list(ROWWISE_CASES))
def test_rowwise_split_matches_reference_kernel_interpret(kind):
    """The rowwise design's split between its two warpgroups inside a block
    and among blocks of a long table, merged in fixed order as the CUDA
    kernel does,
    gives the reference kernel's output (interpret mode) and the plain
    version's, fp32 to 2e-5; pads and idle rows exact zeros. The serving
    tables take one split; the long ones split."""
    B, S, G, hd, psz, p_max = ROWWISE_CASES[kind]
    case = mixed_case(len(kind), B=B, S=S, K=1, G=G, hd=hd, psz=psz, p_max=p_max)
    assert tk.kernel_design(S, G, hd, psz, torch.bfloat16, case[1].size // hd) == "rowwise"
    span = _rowwise_grid(B, 1, p_max, psz)
    assert (span < p_max * psz) == kind.startswith("long")
    ref = np.asarray(jref.ragged_paged_attention(*(jnp.asarray(a) for a in case), 1, interpret=True))
    args = as_torch(*case)
    out = _rowwise_split_and_merge(*args, 1, span, 2)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(tk.ragged_paged_attention_reference(*args, 1).numpy(), ref, **TOL)
    for b, ql in enumerate(case[5]):
        assert np.all(out[b, ql:].numpy() == 0.0)


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
    # Prefill widths are in the domain: the kernel cuts S*G into query tiles.
    tk._check(torch.zeros((6, 9, 2, 8, 16)), kp, vp, table, starts, q_lens, 0)  # S*G 72
    tk._check(torch.zeros((6, 256, 2, 8, 16)), kp, vp, table, starts, q_lens, 0)  # S*G 2,048
    wide_hd = [torch.zeros(t.shape[:-1] + (264,)) for t in (q, kp, vp)]
    with pytest.raises(EngineError, match="unsupported shape"):
        tk._check(*wide_hd, table, starts, q_lens, 0)  # hd 264 > 256
    odd_hd = [torch.zeros(t.shape[:-1] + (20,)) for t in (q, kp, vp)]
    with pytest.raises(EngineError, match="unsupported shape"):
        tk._check(*odd_hd, table, starts, q_lens, 0)  # hd 20, not a multiple of 8
    tk._check(q, kp, vp, table, starts, q_lens, 1)
