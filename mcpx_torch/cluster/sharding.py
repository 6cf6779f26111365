"""Registry sharding: the service-embedding table partitioned row-wise.

The PyTorch port of ``mcpx/cluster/sharding.py``. At 100k services the
``[N, d]`` embedding table stops being a thing every replica should hold
whole next to its model weights. The sharded index splits the table into
contiguous row ranges — one shard per replica by default — places each as
the parent places a table (on the index's device, on CUDA on the index's own
stream; under a mesh its rows split again over the ``model`` axis), ranks
each with the parent's ``_device_topk`` (score descending, row ascending on
ties) and merges the per-shard (score, global_row) candidates on the host:
k floats + k ints per shard.

The merge is exact: the global top-k is always contained in the union of
shard-local top-ks (every global winner is a winner of its own shard), so
sharded and unsharded shortlists agree wherever scores are distinct.

Host-mode registries (below ``device_threshold``) run the identical
shard/merge arithmetic over the numpy mirror. ``save`` and ``load`` are the
parent's: a snapshot written by either package loads into either package's
sharded index.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mcpx_torch.core.config import RetrievalConfig
from mcpx_torch.retrieval.index import RetrievalIndex
from mcpx_torch.utils.ownership import owned_by


@owned_by("event_loop")
class ShardedRetrievalIndex(RetrievalIndex):
    def __init__(
        self,
        config: Optional[RetrievalConfig] = None,
        *,
        n_shards: int = 2,
        embedder=None,
        device: "torch.device | str | None" = None,
        mesh=None,
    ) -> None:
        super().__init__(config, embedder=embedder, device=device, mesh=mesh)
        self.n_shards = max(1, int(n_shards))
        self._shards: list = []  # per-shard device tables (or their RowShards under a mesh)
        self._offsets: list[int] = []  # global row of each shard's row 0

    # ------------------------------------------------------------- placement
    @owned_by("event_loop")
    def _place(self, table: np.ndarray):
        """Split into near-equal contiguous row ranges and place each as the
        parent places a table. Returns None: the full-table device copy is
        REPLACED by the shard list (``_base_order`` dispatches on it), which
        also keeps the parent's host-mode branch intact."""
        shards, offsets = [], []
        n = table.shape[0]
        per = -(-n // self.n_shards)  # ceil
        for s in range(self.n_shards):
            lo, hi = s * per, min(n, (s + 1) * per)
            if lo >= hi:
                break
            offsets.append(lo)
            shards.append(super()._place(np.ascontiguousarray(table[lo:hi])))
        self._shards, self._offsets = shards, offsets
        return None

    @property
    def shard_sizes(self) -> list[int]:
        if self._shards:
            return [int(t.shape[0]) for t in self._shards]
        if self._table_np is None:
            return []
        n = self._table_np.shape[0]
        per = -(-n // self.n_shards)
        return [min(n, (s + 1) * per) - s * per for s in range(self.n_shards) if s * per < n]

    # ----------------------------------------------------------------- query
    def _base_order(self, q: np.ndarray, k: int) -> list[int]:
        if self._shards:
            merged: list[tuple[float, int]] = []
            for off, shard in zip(self._offsets, self._shards):
                scores, idx = self._device_topk(q, min(k, int(shard.shape[0])), shard)
                merged.extend((s, off + i) for s, i in zip(scores, idx))
        else:
            if self._table_np is None:
                return []
            merged = self._host_shard_candidates(q, k)
        # Host-side merge: score descending, global row ascending on ties
        # (deterministic regardless of shard arrival order).
        merged.sort(key=lambda t: (-t[0], t[1]))
        return [r for _, r in merged[:k]]

    def _host_shard_candidates(self, q: np.ndarray, k: int) -> list[tuple[float, int]]:
        n = self._table_np.shape[0]
        per = -(-n // self.n_shards)
        out: list[tuple[float, int]] = []
        for s in range(self.n_shards):
            lo, hi = s * per, min(n, (s + 1) * per)
            if lo >= hi:
                break
            scores = self._table_np[lo:hi] @ q
            kk = min(k, hi - lo)
            part = np.argpartition(scores, -kk)[-kk:]
            out.extend((float(scores[i]), lo + int(i)) for i in part)
        return out
