"""Paged KV cache: host-side page allocator + device page pools.

PyTorch port of ``mcpx/engine/kv_cache.py``. The pools are laid out
kv-head-major with every layer in one tensor, ``[K, L, N_pages, page_size,
head_dim]``, so one attention block per (row, kv head) reads contiguous
``[page_size, head_dim]`` tiles, and each layer's decode write is one
scatter into the flattened token-slot view ``[K, L, N*page_size, hd]``.
Page 0 is the null page: rows and chunks with nowhere to go write there,
and nothing reads it.

The allocator is host-side, synchronous and single-writer (the engine's
worker thread owns it); its invariants are enforced and tested
(alloc/free balance, no double free, no page aliasing).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mcpx_torch.core.errors import EngineError
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import kv_at, torch_dtype
from mcpx_torch.parallel.transfer import kv_tree, send, trees
from mcpx_torch.utils.ownership import owned_by


@dataclass
class PageStats:
    total_pages: int
    free_pages: int
    sequences: int

    @property
    def utilization(self) -> float:
        return 1.0 - self.free_pages / max(1, self.total_pages)


@owned_by("engine-worker")
class PageAllocator:
    """Free-list page allocator; page 0 is reserved as the null page.
    Single-writer by construction: the engine worker thread owns it, and
    the ``owned_by`` marks (class + mutators) let mcpxlint's
    thread-ownership pass prove no other thread can reach a mutation."""

    def __init__(self, n_pages: int, page_size: int, max_pages_per_seq: int) -> None:
        if n_pages < 2:
            raise EngineError("need at least 2 pages (page 0 is reserved)")
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.n_pages = n_pages
        self._free: list[int] = list(range(n_pages - 1, 0, -1))  # stack; 0 reserved
        self._seq_pages: dict[int, list[int]] = {}

    # ------------------------------------------------------------------ api
    def can_allocate(self, n_tokens: int) -> bool:
        return len(self._free) >= self.pages_needed(n_tokens)

    def pages_needed(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_size))

    @owned_by("engine-worker")
    def allocate(self, seq_id: int, n_tokens: int) -> list[int]:
        """Allocate pages to hold ``n_tokens``; returns the page list."""
        if seq_id in self._seq_pages:
            raise EngineError(f"sequence {seq_id} already has pages")
        need = self.pages_needed(n_tokens)
        if need > self.max_pages_per_seq:
            raise EngineError(
                f"sequence needs {need} pages > max_pages_per_seq={self.max_pages_per_seq}"
            )
        if need > len(self._free):
            raise EngineError(f"out of KV pages: need {need}, free {len(self._free)}")
        pages = [self._free.pop() for _ in range(need)]
        self._seq_pages[seq_id] = pages
        return list(pages)

    @owned_by("engine-worker")
    def extend(self, seq_id: int, n_tokens_total: int) -> list[int]:
        """Grow a sequence's page list to cover ``n_tokens_total``; returns
        the (possibly unchanged) full page list."""
        pages = self._seq_pages.get(seq_id)
        if pages is None:
            raise EngineError(f"unknown sequence {seq_id}")
        need = self.pages_needed(n_tokens_total)
        if need > self.max_pages_per_seq:
            raise EngineError(
                f"sequence {seq_id} exceeds max_pages_per_seq={self.max_pages_per_seq}"
            )
        while len(pages) < need:
            if not self._free:
                raise EngineError("out of KV pages during extend")
            pages.append(self._free.pop())
        return list(pages)

    @owned_by("engine-worker")
    def split(self, src_id: int, dst_id: int, n_head_pages: int) -> list[int]:
        """Move ownership of ``src_id``'s FIRST ``n_head_pages`` pages to a
        new sequence ``dst_id``; returns them. No device work — page ids are
        bookkeeping — which is what lets the radix prefix cache split a
        cached KV run at a page boundary without touching HBM
        (engine/prefix_cache.py). The moved pages keep their ids, so page
        tables already naming them stay valid."""
        pages = self._seq_pages.get(src_id)
        if pages is None:
            raise EngineError(f"unknown sequence {src_id}")
        if dst_id in self._seq_pages:
            raise EngineError(f"sequence {dst_id} already has pages")
        if not 0 < n_head_pages < len(pages):
            raise EngineError(
                f"split of {len(pages)} pages at {n_head_pages} leaves an "
                "empty side (both sequences must keep at least one page)"
            )
        self._seq_pages[dst_id] = pages[:n_head_pages]
        self._seq_pages[src_id] = pages[n_head_pages:]
        return list(self._seq_pages[dst_id])

    @owned_by("engine-worker")
    def free(self, seq_id: int) -> None:
        pages = self._seq_pages.pop(seq_id, None)
        if pages is None:
            return
        for p in pages:
            if p <= 0 or p >= self.n_pages:
                raise EngineError(f"corrupt page id {p}")
            self._free.append(p)

    def pages_of(self, seq_id) -> list[int]:
        return list(self._seq_pages.get(seq_id, []))

    def stats(self) -> PageStats:
        return PageStats(
            total_pages=self.n_pages,
            free_pages=len(self._free),
            sequences=len(self._seq_pages),
        )

    def check_invariants(self) -> None:
        """Test hook: free list + allocated pages partition [1, n_pages)."""
        seen: set[int] = set()
        for p in self._free:
            if p in seen:
                raise EngineError(f"page {p} double-present in free list")
            seen.add(p)
        for seq, pages in self._seq_pages.items():
            for p in pages:
                if p in seen:
                    raise EngineError(f"page {p} aliased (seq {seq})")
                seen.add(p)
        if seen != set(range(1, self.n_pages)):
            raise EngineError("page leak: free+allocated != all pages")


# ------------------------------------------------------------------- device
def init_paged_kv(
    cfg: GemmaConfig, n_pages: int, page_size: int, device="cpu", dtype: str | None = None, layout=None
) -> dict[str, torch.Tensor]:
    """Device page pools: ``[K, L, N_pages, page_size, head_dim]``. A model
    shard's KV heads are a leading-dim view of them (``pool_shards``). On a
    ``layout`` of several devices, each holds all ``N_pages`` pages of the
    KV heads its coordinates read (``transfer.kv_tree``), replicated over
    ``data`` as the reference's pools are."""
    d = torch_dtype(dtype or cfg.dtype)

    def zeros(k_heads, dev):
        shape = (k_heads, cfg.n_layers, n_pages, page_size, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=d, device=dev), "v": torch.zeros(shape, dtype=d, device=dev)}

    return kv_tree(layout, device, cfg.n_kv_heads, zeros)


def pool_shards(paged: dict[str, torch.Tensor], layout) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(k, v) pool views of each of ``layout``'s attention shards: the
    leading-dim range of the KV heads it reads, contiguous since the pools
    are KV-head-major (the whole pools when the heads stay whole, as MQA's
    do), of data coordinate 0's cards on a layout of cards."""
    out = []
    for a, shard in enumerate(layout.attn):
        k, v, base = kv_at(paged, layout, (0, a))
        out.append((k[shard.kv[0] - base:shard.kv[1] - base], v[shard.kv[0] - base:shard.kv[1] - base]))
    return out


def commit_prefill_to_pages(
    paged: dict[str, torch.Tensor],
    dense: dict[str, torch.Tensor],
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    page_size: int,
    layout=None,
) -> dict[str, torch.Tensor]:
    """Scatter a dense prefill cache ``[L, B, T, K, hd]`` into the page pools
    (in place; the pools are returned). The write fills every model
    shard's view of the pools (``pool_shards``) at once.

    ``page_table`` is [B, Pmax] int32 (0 = null page). Chunks beyond a
    sequence's pages are routed to the reserved null page 0, which is never
    read (positions are masked at attention time), so the duplicate writes
    that land there are harmless. On a ``layout`` (``init_paged_kv``'s),
    each device's dense cache (every row, its KV heads) goes into its own
    pools, the page table sent there from the control device.
    """
    if layout is not None:
        for dev, pools in trees(paged, layout).items():
            coord = next(c for c, x in layout.coords().items() if x == dev)
            commit_prefill_to_pages(pools, trees(dense, layout)[dev], send(page_table, (0, 0), coord, layout),
                                    seq_lens, page_size)
        return paged
    L, B, T, K, hd = dense["k"].shape
    n_chunks = T // page_size
    if T % page_size:
        raise EngineError(f"prefill length {T} not a multiple of page_size {page_size}")
    dest = page_table[:, :n_chunks].reshape(B * n_chunks).long()  # page id per chunk
    for name in ("k", "v"):
        pool, arr = paged[name], dense[name]
        # dense [L, B, T, K, hd] -> [K, L, B*n_chunks, page_size, hd]
        chunks = arr.reshape(L, B, n_chunks, page_size, K, hd)
        chunks = chunks.permute(4, 0, 1, 2, 3, 5).reshape(K, L, B * n_chunks, page_size, hd)
        pool[:, :, dest] = chunks.to(pool.dtype)
    return paged
