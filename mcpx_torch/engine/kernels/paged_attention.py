"""Ragged mixed-phase paged attention: the CUDA kernel's wrapper and its
plain PyTorch version.

PyTorch port of ``mcpx/engine/kernels/paged_attention.py``. One kernel
serves every attention shape the engine dispatches against the shared page
pools (``[K, L, N_pages, page_size, head_dim]``, every layer in one tensor):
row ``b`` of the padded ``[B, S_max, ...]`` window holds ``q_lens[b]`` live
queries — decode rows (1), fast-forward or verify windows (``1 < q_len <=
S``), prefill rows (``S``) and idle rows (0). Query ``i < q_lens[b]`` attends
cache positions ``< start_pos[b] + i + 1``; pad queries and idle rows output
exact zeros.

The route is the tensor's device, nothing else: on a CPU tensor the wrapper
computes the plain version below; on a CUDA tensor it launches the kernel
(``csrc/ragged_paged_attention.cu``) or raises. The plain versions gather
pages exactly like the reference package's jnp references (same fp32 logits
and softmax, weights cast to the value dtype before the value product), so
CPU runs of the port match the reference package's ``use_pallas=False``
path.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from mcpx_torch.core.errors import EngineError
from mcpx_torch.engine.kernels import build

NEG_INF = -1e30
TILE_ROWS = 64  # query rows (S * G, the GQA group folded in) a block holds, in every design
WARPGROUP_HEAD_DIMS = (32, 64, 128, 256)  # the warpgroup and rowwise designs' instantiations
WARPGROUP_PAGE_SIZES = (8, 16, 32, 64)  # whole 8-row swizzle atoms tiling a 64-position stage
MAX_HEAD_DIM = 256
MAX_PAGE_SIZE = 64
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
NARROW_ROWS = 8  # query rows (S * G) of the narrow design's windows at most
NARROW_MAX_POSITIONS = 16 * 2048  # a table the narrow design takes: 16 blocks of 2,048 positions
DESIGN_CODES = {"mma_sync": 0, "warpgroup": 1, "rowwise": 2, "narrow": 3}

# Launch counts by kernel name: the wrapper adds one where it launches the
# kernel and nowhere else (the plain path never counts). A call made while
# its stream is capturing a CUDA graph launches nothing: it adds one to
# CAPTURED instead, and whoever replays the graph adds the launches its
# capture recorded to LAUNCHES with ``count_replay``. Several engines may
# launch from their worker threads at once: the counts, the thread's own
# count (``count_into``) and the ticket registry below change under _LOCK.
LAUNCHES = {"ragged_paged_attention": 0}  # mcpx: owner[_LOCK]
CAPTURED = {"ragged_paged_attention": 0}  # mcpx: owner[_LOCK]
# The same launches by the kernel's design (``kernel_design``), outside
# graphs and replays included, and as recorded into graphs.
DESIGNS = dict.fromkeys(DESIGN_CODES, 0)  # mcpx: owner[_LOCK]
CAPTURED_DESIGNS = dict.fromkeys(DESIGN_CODES, 0)  # mcpx: owner[_LOCK]
# Launches made outside a graph, by card index (a replay's are counted by
# kernel name only): what each card of a mesh launched.
BY_CARD: dict[int, int] = {}  # mcpx: owner[_LOCK]
_LOCK = threading.Lock()
_THREAD = threading.local()


def kernel_launches() -> dict[str, int]:
    with _LOCK:
        return dict(LAUNCHES)


def reset_kernel_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        for k in DESIGNS:
            DESIGNS[k] = 0
        BY_CARD.clear()


def kernel_designs() -> dict[str, int]:
    """The kernel's launches since the last reset by design: ``warpgroup``
    (the multi-tile bf16 windows), ``rowwise`` (the one-tile bf16 windows),
    ``narrow`` (those of at most 8 rows at hd 256) and ``mma_sync`` (every
    other); replays of captured graphs included where ``count_replay`` is
    given them."""
    with _LOCK:
        return dict(DESIGNS)


def captured_designs() -> dict[str, int]:
    """Calls recorded into CUDA graphs so far, by design."""
    with _LOCK:
        return dict(CAPTURED_DESIGNS)


def launches_by_card() -> dict[int, int]:
    """The kernel's launches outside CUDA graphs since the last reset, by
    card index."""
    with _LOCK:
        return dict(BY_CARD)


def captured_launches() -> dict[str, int]:
    """Calls recorded into CUDA graphs so far, by kernel name: the
    difference across one capture is what each replay of it launches."""
    with _LOCK:
        return dict(CAPTURED)


def count_into(counts: Optional[dict[str, int]]) -> None:
    """Add what this thread launches from now on (replays counted here
    included) to ``counts`` too, by kernel name; None stops it. An engine's
    worker thread counts its own launches so."""
    _THREAD.counts = counts


def _count(
    captured: bool, launches: dict[str, int], card: Optional[int] = None,
    designs: Optional[dict[str, int]] = None,
) -> None:
    """Add ``launches`` (and ``designs``, the same launches by design) to
    CAPTURED (calls recorded into a graph) or to LAUNCHES and this thread's
    own count (and, for a launch on ``card``, to BY_CARD)."""
    own = None if captured else getattr(_THREAD, "counts", None)
    with _LOCK:
        table = CAPTURED if captured else LAUNCHES
        for k, n in launches.items():
            table[k] += n
            if own is not None:
                own[k] = own.get(k, 0) + n
        by_design = CAPTURED_DESIGNS if captured else DESIGNS
        for k, n in (designs or {}).items():
            by_design[k] += n
        if card is not None and not captured:
            BY_CARD[card] = BY_CARD.get(card, 0) + sum(launches.values())


def count_replay(launches: dict[str, int], designs: Optional[dict[str, int]] = None) -> None:
    """One replay of a captured graph ran ``launches`` (by kernel name) and,
    by design, ``designs``."""
    _count(False, launches, designs=designs)


# ---------------------------------------------------------------- plain
def _gather_pages(pages: torch.Tensor, page_table: torch.Tensor, layer: int) -> torch.Tensor:
    """[K, L, N, Psz, hd] pools -> [B, K, Pmax*Psz, hd] for one layer."""
    K, _, _, psz, hd = pages.shape
    B, p_max = page_table.shape
    g = pages[:, layer][:, page_table.long()]  # [K, B, Pmax, Psz, hd]
    return g.permute(1, 0, 2, 3, 4).reshape(B, K, p_max * psz, hd)


def paged_attention_reference(q, k_pages, v_pages, page_table, seq_lens, layer: int = 0):
    """Single-query semantics: q [B, K, G, hd]; ``seq_lens`` counts the
    token just written. Returns [B, K, G, hd] in q.dtype."""
    hd = q.shape[-1]
    k = _gather_pages(k_pages, page_table, layer)
    v = _gather_pages(v_pages, page_table, layer)
    logits = torch.einsum("bkgh,bksh->bkgs", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    pos = torch.arange(k.shape[2], device=q.device)
    mask = pos[None, :] < seq_lens.long()[:, None]
    logits = torch.where(mask[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgs,bksh->bkgh", w.to(v.dtype), v).to(q.dtype)


def paged_attention_chunk_reference(q, k_pages, v_pages, page_table, start_pos, layer: int = 0):
    """Chunk semantics, q [B, S, K, G, hd]: query i of row b attends cache
    positions through ``start_pos[b] + i``; every window slot is computed.
    Returns [B, S, K, G, hd] in q.dtype."""
    S, hd = q.shape[1], q.shape[-1]
    k = _gather_pages(k_pages, page_table, layer)
    v = _gather_pages(v_pages, page_table, layer)
    logits = torch.einsum("bskgh,bklh->bskgl", q.float(), k.float()) * (1.0 / math.sqrt(hd))
    vis = start_pos.long()[:, None] + torch.arange(S, device=q.device) + 1  # [B, S]
    mask = torch.arange(k.shape[2], device=q.device)[None, None, :] < vis[:, :, None]
    logits = torch.where(
        mask[:, :, None, None, :], logits, torch.full_like(logits, NEG_INF)
    )
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bskgl,bklh->bskgh", w.to(v.dtype), v).to(q.dtype)


def ragged_paged_attention_reference(
    q, k_pages, v_pages, page_table, start_pos, q_lens, layer: int = 0
):
    """Ragged semantics: the chunk reference with window slots past each
    row's ``q_lens`` set to exact zeros. Returns [B, S, K, G, hd]."""
    out = paged_attention_chunk_reference(q, k_pages, v_pages, page_table, start_pos, layer)
    valid = torch.arange(q.shape[1], device=q.device)[None, :] < q_lens.long()[:, None]
    return torch.where(valid[:, :, None, None, None], out, torch.zeros_like(out)).to(q.dtype)


def ragged_n_pages(start, qn, page_size: int, p_max: int):
    """Pages a row streams: through its last live query's visible position,
    clamped to the table width; exactly zero for an idle row (``qn == 0``).
    The kernel computes the same count per block."""
    start = torch.as_tensor(start)
    qn = torch.as_tensor(qn)
    n = torch.clamp((start + qn + page_size - 1) // page_size, max=p_max)
    return torch.where(qn > 0, n, torch.zeros_like(n))


# ---------------------------------------------------------------- kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAP_ERROR = 10000  # the launcher's code for a refused tensor map: 10000 + CUresult


def _check(q, k_pages, v_pages, page_table, start_pos, q_lens, layer: int) -> None:
    if q.dim() != 5 or k_pages.dim() != 5 or k_pages.shape != v_pages.shape:
        raise EngineError(
            f"ragged_paged_attention: q must be [B, S, K, G, hd] and the pools "
            f"[K, L, N, Psz, hd]; got {tuple(q.shape)}, {tuple(k_pages.shape)}, "
            f"{tuple(v_pages.shape)}"
        )
    B, S, K, G, hd = q.shape
    Kp, L, _, psz, hdp = k_pages.shape
    if Kp != K or hdp != hd:
        raise EngineError("ragged_paged_attention: q and pools disagree on kv heads or head_dim")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise EngineError(
            f"ragged_paged_attention: q and pools must share float32 or bfloat16; got "
            f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}"
        )
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise EngineError(f"ragged_paged_attention: page_table must be [B, Pmax], got {tuple(page_table.shape)}")
    if tuple(start_pos.shape) != (B,) or tuple(q_lens.shape) != (B,):
        raise EngineError("ragged_paged_attention: start_pos and q_lens must be [B]")
    if any(t.dtype != torch.int32 for t in (page_table, start_pos, q_lens)):
        raise EngineError("ragged_paged_attention: page_table, start_pos and q_lens must be int32")
    tensors = (q, k_pages, v_pages, page_table, start_pos, q_lens)
    if any(t.device != q.device for t in tensors):
        raise EngineError("ragged_paged_attention: every tensor must be on the same CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise EngineError("ragged_paged_attention: every tensor must be contiguous")
    if hd > MAX_HEAD_DIM or hd % 8 or not 1 <= psz <= MAX_PAGE_SIZE:
        raise EngineError(
            f"ragged_paged_attention: unsupported shape hd={hd} (multiple of 8, "
            f"<= {MAX_HEAD_DIM}), page_size={psz} (<= {MAX_PAGE_SIZE})"
        )
    if not 0 <= layer < L:
        raise EngineError(f"ragged_paged_attention: layer {layer} outside [0, {L})")
    positions = page_table.shape[1] * psz
    if kernel_design(S, G, hd, psz, q.dtype, K * L * k_pages.shape[2] * psz) == "narrow" and (
        positions > NARROW_MAX_POSITIONS
    ):
        raise EngineError(
            f"ragged_paged_attention: unsupported shape: a table of {positions} positions "
            f"(the narrow design takes at most {NARROW_MAX_POSITIONS})"
        )


def kernel_design(S: int, G: int, hd: int, page_size: int, dtype: torch.dtype, pool_rows: int) -> str:
    """Which of the kernel's four designs serves a [B, S, K, G, hd] window
    over pools of ``pool_rows`` = K*L*N*Psz rows. bf16 windows at the
    head_dims the TMA designs are built for, pages that tile their
    64-position stages in whole swizzle atoms, and rows a 32-bit TMA
    coordinate reaches take ``warpgroup`` (wgmma, a producer warp beside a
    consumer warpgroup, 64 query rows a block) where they hold more than one
    64-row query tile; ``narrow`` (a cluster of blocks a row, 64 or more
    positions a block, the 8 rows on the n of mma.sync) where they hold at
    most 8 rows at hd 256 (2b's one-token steps), which a 64-row tile would
    mostly waste and one SM a row could not stream fast enough; and
    ``rowwise`` (one block a row, its positions split among warpgroups
    inside the block) where they hold one tile otherwise. ``mma_sync``
    serves every other window (float32, hd 24 or 40, 4-token pages, ...).
    Shapes alone decide, never data, an option or the environment, so one
    captured graph serves any mix of rows."""
    if (
        dtype == torch.bfloat16 and hd in WARPGROUP_HEAD_DIMS
        and page_size in WARPGROUP_PAGE_SIZES and pool_rows < 2**31
    ):
        if S * G > TILE_ROWS:
            return "warpgroup"
        if S * G <= NARROW_ROWS and hd > 128:
            return "narrow"
        return "rowwise"
    return "mma_sync"


def _lib() -> ctypes.CDLL:
    lib = build.load("ragged_paged_attention")
    if not getattr(lib, "_mcpx_bound", False):
        fn = lib.mcpx_ragged_paged_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        plan = lib.mcpx_ragged_paged_attention_plan
        plan.restype = ctypes.c_size_t
        plan.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
        lib._mcpx_bound = True
    return lib


def _plan(q: torch.Tensor, k_pages: torch.Tensor, p_max: int) -> tuple[str, list[int], int]:
    """(design, [tiles a window, rows a tile, splits a tile, positions a
    split], dynamic shared memory a block) of a launch over these shapes,
    from the kernel's own rule on the current device."""
    B, S, K, G, hd = q.shape
    _, L, N, psz, _ = k_pages.shape
    design = kernel_design(S, G, hd, psz, q.dtype, K * L * N * psz)
    grid = (ctypes.c_int * 4)()
    smem = _lib().mcpx_ragged_paged_attention_plan(
        B, S, K, G, hd, psz, p_max, _DTYPES[q.dtype], DESIGN_CODES[design], grid
    )
    return design, list(grid), int(smem)


def launch_plan(q: torch.Tensor, k_pages: torch.Tensor, page_table: torch.Tensor) -> dict:
    """What a launch over these shapes runs on q's card: its design, grid
    (blocks by splits), query tiles a window, rows a tile, splits a tile,
    positions a split and shared memory a block. Needs the built kernel
    (the card)."""
    with torch.cuda.device(q.device):
        design, (tiles, rows, n_split, span), smem = _plan(q, k_pages, page_table.shape[1])
    B, K = q.shape[0], q.shape[2]
    return dict(
        design=design, grid=[B * K * tiles, n_split], tiles=tiles, tile_rows=rows,
        n_split=n_split, span=span, smem=smem,
    )


# One int32 ticket counter per (row, kv-head, query tile), per (device,
# stream). The kernel's last block of each resets its counter to 0, so a
# buffer is zero again when its launch ends. Launches on one stream run one
# after another, so each finds its buffer zero; launches on different
# streams may overlap, so each stream has a buffer of its own. The buffer
# is made on its stream, so growing it is ordered with that stream's work.
# A CUDA graph captured on a stream bakes in the address of that stream's
# buffer: ``hold_tickets`` sizes it for the largest launch the graphs will
# hold and keeps it from being replaced until ``release_tickets``.
_TICKETS: dict[tuple[torch.device, int], torch.Tensor] = {}  # mcpx: owner[_LOCK]
_HELD: dict[tuple[torch.device, int], int] = {}  # mcpx: owner[_LOCK]


def ticket_count(B: int, S: int, K: int, G: int) -> int:
    """Ticket counters a launch over a [B, S, K, G, hd] window uses."""
    return B * K * -(-S * G // TILE_ROWS)


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The ticket buffer of ``stream``, grown to ``n`` counters if it is
    smaller. Under _LOCK: engines on several threads share the buffer of a
    stream they all launch on (the legacy default stream)."""
    key = (device, stream)
    with _LOCK:
        buf = _TICKETS.get(key)
        if buf is None or buf.numel() < n:
            if _HELD.get(key):
                raise EngineError(
                    f"ragged_paged_attention: this stream's ticket buffer ({0 if buf is None else buf.numel()} "
                    f"counters) is held by captured CUDA graphs and cannot grow to {n}"
                )
            if torch.cuda.is_current_stream_capturing():
                # Its zeros would exist only when the graph replays.
                raise EngineError(
                    "ragged_paged_attention: launch once on this stream, at this batch "
                    "size, before capturing it in a CUDA graph"
                )
            buf = torch.zeros(n, dtype=torch.int32, device=device)
            _TICKETS[key] = buf
        return buf


def hold_tickets(device: torch.device, stream: int, n: int) -> None:
    """Make the ticket buffer of ``stream`` at least ``n`` counters (called
    on that stream, before any capture on it) and keep it in place: a graph
    captured on the stream reads it at the address it had then."""
    key = (device, stream)
    _tickets(device, stream, n)
    with _LOCK:
        _HELD[key] = _HELD.get(key, 0) + 1


def release_tickets(device: torch.device, stream: int) -> None:
    """Undo one ``hold_tickets``: the graphs that read the buffer are gone.
    The last release drops the buffer too (a later launch on the stream
    makes a new one), so a closed engine's capturing stream keeps nothing
    on the card."""
    key = (device, stream)
    with _LOCK:
        if _HELD.get(key, 0) > 1:
            _HELD[key] -= 1
        else:
            _HELD.pop(key, None)
            _TICKETS.pop(key, None)


def ticket_counters() -> list[torch.Tensor]:
    """The kernel's ticket buffers, one per device and stream it has run on
    (the streams that capture CUDA graphs included); every entry is 0
    whenever no launch or replay is in flight."""
    with _LOCK:
        return list(_TICKETS.values())


def ragged_paged_attention(q, k_pages, v_pages, page_table, start_pos, q_lens, layer: int = 0):
    """The ragged kernel: q [B, S, K, G, hd]; pools [K, L, N, Psz, hd];
    page_table [B, Pmax], start_pos [B], q_lens [B] (int32). Returns
    [B, S, K, G, hd] in q.dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream."""
    layer = int(layer)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, page_table, start_pos, q_lens, layer
        )
    if q.device.type != "cuda":
        raise EngineError(f"ragged_paged_attention: no route for device {q.device}")
    _check(q, k_pages, v_pages, page_table, start_pos, q_lens, layer)
    B, S, K, G, hd = q.shape
    _, L, N, psz, _ = k_pages.shape
    dtype = _DTYPES[q.dtype]
    p_max = page_table.shape[1]
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise EngineError("ragged_paged_attention: q and the pools must start on 16-byte boundaries")
    # The launcher reads the current device for its SM count and its
    # shared-memory grant: q's card, whatever the calling thread's device.
    with torch.cuda.device(q.device):
        lib = _lib()
        design, (n_tiles, t_rows, n_split, _), smem = _plan(q, k_pages, p_max)
        if smem > SMEM_LIMIT:
            raise EngineError(f"ragged_paged_attention: needs {smem} B of shared memory (> {SMEM_LIMIT})")
        out = torch.empty_like(q)
        # fp32 scratch: the per-split unnormalised accumulators [B*K*tiles,
        # n_split, t_rows, hd], then their (max, sum) [B*K*tiles, n_split, 2,
        # t_rows]. A warpgroup or rowwise launch of one split writes its rows
        # directly and needs none; a narrow launch merges its splits inside
        # a cluster and needs none, nor tickets.
        blocks = B * K * n_tiles * n_split
        n_acc = blocks * t_rows * hd
        if design == "narrow" or (design != "mma_sync" and n_split == 1):
            n_acc = blocks = 0
        scratch = torch.empty(n_acc + blocks * 2 * t_rows, dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # Held until the launch is enqueued: another thread may replace the
        # stream's buffer meanwhile, and a freed buffer's memory is handed to
        # the next allocation on the stream, which would then run before it.
        tickets = None if design == "narrow" else _tickets(q.device, stream, ticket_count(B, S, K, G))
        rc = lib.mcpx_ragged_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            start_pos.data_ptr(), q_lens.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch.data_ptr() + 4 * n_acc, None if tickets is None else tickets.data_ptr(),
            B, S, K, G, hd, L, N, psz, p_max, layer, dtype, DESIGN_CODES[design], stream,
        )
        if rc >= _MAP_ERROR:
            raise EngineError(
                f"ragged_paged_attention: the driver refused the pools' tensor map (CUresult {rc - _MAP_ERROR})"
            )
        if rc != 0:
            raise EngineError(f"ragged_paged_attention: CUDA launch failed (cudaError {rc})")
        _count(
            torch.cuda.is_current_stream_capturing(), {"ragged_paged_attention": 1}, q.device.index,
            {design: 1},
        )
    return out


def paged_attention_chunk(q, k_pages, v_pages, page_table, start_pos, layer: int = 0):
    """Dense-window chunk attention: the ``q_lens = S`` case of the kernel."""
    B, S = q.shape[0], q.shape[1]
    q_lens = torch.full((B,), S, dtype=torch.int32, device=q.device)
    return ragged_paged_attention(q, k_pages, v_pages, page_table, start_pos, q_lens, layer)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, layer: int = 0):
    """Single-query paged attention, q [B, K, G, hd]: the ``S = 1`` case;
    ``seq_lens`` counts the just-written token."""
    out = paged_attention_chunk(
        q[:, None].contiguous(), k_pages, v_pages, page_table,
        (seq_lens - 1).to(torch.int32), layer,
    )
    return out[:, 0]
