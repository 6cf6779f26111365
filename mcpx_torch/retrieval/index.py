"""Service-embedding table with a host-side (numpy) top-k shortlist.

The PyTorch port of ``mcpx.retrieval.index``: the same refresh, coverage-
greedy shortlist and snapshot logic, scoring on the host. The reference
package scores on the host too below ``RetrievalConfig.device_threshold``
rows (``compute="auto"``); its on-device table (``lax.top_k``) is not
ported yet, so this index scores every registry size on the host.
"""

from __future__ import annotations

import asyncio
import re
from typing import Optional

import numpy as np

from mcpx_torch.core.config import RetrievalConfig
from mcpx_torch.registry.base import RegistryBackend
from mcpx_torch.retrieval.embed import HashedNGramEmbedder

_WORD_RE = re.compile(r"[a-z0-9]+")


class RetrievalIndex:
    def __init__(
        self,
        config: Optional[RetrievalConfig] = None,
        *,
        embedder: Optional[HashedNGramEmbedder] = None,
    ) -> None:
        self.config = config or RetrievalConfig()
        self.embedder = embedder or HashedNGramEmbedder(self.config.embed_dim)
        self._lock = asyncio.Lock()
        self._names: list[str] = []
        self._table_np: Optional[np.ndarray] = None  # [N, d]
        self._version: int = -1
        # Coverage-greedy shortlist support (see ``shortlist``): per-record
        # word sets and an inverted word -> row-ids index over schema text.
        self._word_sets: Optional[list[frozenset[str]]] = None
        self._word_index: Optional[dict[str, list[int]]] = None

    # ---------------------------------------------------------------- build
    async def refresh(
        self,
        registry: RegistryBackend,
        *,
        force: bool = False,
        known_version: Optional[int] = None,
    ) -> bool:
        """Rebuild the table if the registry changed. Returns True if
        a rebuild happened. ``known_version`` lets callers that already
        fetched ``registry.version()`` skip the duplicate round-trip."""
        version = known_version if known_version is not None else await registry.version()
        if not force and version == self._version:
            return False
        async with self._lock:
            version = await registry.version()
            if not force and version == self._version:
                return False
            services = await registry.list_services()
            names = [s.name for s in services]
            texts = [s.schema_text() for s in services]
            table = await asyncio.to_thread(self.embedder.embed_texts, texts)
            self._table_np = table
            self._names = names
            self._build_word_index([s.topic_text() for s in services])
            self._version = version
            return True

    def _build_word_index(self, texts: list[str]) -> None:
        word_sets = [frozenset(_WORD_RE.findall(t.lower())) for t in texts]
        index: dict[str, list[int]] = {}
        for row, words in enumerate(word_sets):
            for w in words:
                index.setdefault(w, []).append(row)
        self._word_sets = word_sets
        self._word_index = index

    # ---------------------------------------------------------------- query
    async def shortlist(self, intent: str, k: int) -> list[str]:
        """Top-k service names for an intent.

        Two modes (``RetrievalConfig.shortlist_mode``):

        - ``"topk"``: plain embedding similarity, scored on the host.
        - ``"residual"`` (default): coverage-greedy. Plain top-k ranks a
          multi-clause intent's services by similarity to the WHOLE intent,
          so dominant clauses crowd out minority ones and the shortlist —
          the planner's entire universe — structurally cannot cover the
          intent (measured on the reference: shortlist coverage ceiling 0.74 on 2-4
          clause intents; the trained planner's 0.64 coverage was capped
          here, not in the model). Residual mode greedily picks the record
          covering the most still-uncovered intent words (via a host-side
          inverted word index — exact at any N, no extra device work),
          ties broken by embedding score, then fills remaining slots from
          the plain ranking. Cost: O(|intent words| * df) set ops per pick.
        """
        if not self._names or k <= 0:
            return []
        k = min(k, len(self._names))
        q = self.embedder.embed(intent)
        base = self._base_order(q, k)
        if self.config.shortlist_mode != "residual" or self._word_index is None:
            return [self._names[i] for i in base]
        picked = self._cover_greedy(intent, q, k)
        for i in base:
            if len(picked) >= k:
                break
            if i not in picked:
                picked.append(i)
        return [self._names[i] for i in picked]

    def _base_order(self, q: np.ndarray, k: int) -> list[int]:
        scores = self._table_np @ q
        part = np.argpartition(scores, -k)[-k:]
        return [int(i) for i in part[np.argsort(scores[part])[::-1]]]

    def _cover_greedy(self, intent: str, q: np.ndarray, k: int) -> list[int]:
        """Greedy weighted set cover of the intent's discriminative words.

        Words with document frequency > max(32, N/4) are dropped from the
        residual — they appear in a quarter of the registry (boilerplate
        like "data"/"composition" in every description), carry no routing
        signal, and would otherwise blow up the candidate union."""
        assert self._word_index is not None and self._word_sets is not None
        n = len(self._names)
        df_cap = max(32, n // 4)
        residual = {
            w
            for w in set(_WORD_RE.findall(intent.lower()))
            if w in self._word_index and len(self._word_index[w]) <= df_cap
        }
        picked: list[int] = []
        picked_set: set[int] = set()
        while residual and len(picked) < k:
            cand: set[int] = set()
            for w in residual:
                cand.update(self._word_index[w])
            cand -= picked_set
            if not cand:
                break
            rows = sorted(cand)
            gains = np.array(
                [len(self._word_sets[r] & residual) for r in rows], np.int32
            )
            scores = self._table_np[rows] @ q
            # max gain, then max embedding score, then name (deterministic).
            best = max(
                range(len(rows)),
                key=lambda j: (gains[j], scores[j], self._names[rows[j]]),
            )
            if gains[best] <= 0:
                break
            r = rows[best]
            picked.append(r)
            picked_set.add(r)
            residual -= self._word_sets[r]
        return picked

    def scores_for(self, intent: str, names: list[str]) -> dict[str, float]:
        """Embedding similarity of an already-chosen shortlist: the scores a
        plan decision record carries (``telemetry/provenance.py``), on the
        host. Unknown names are skipped."""
        if self._table_np is None or not names:
            return {}
        q = self.embedder.embed(intent)
        rows = {name: i for i, name in enumerate(self._names)}
        out: dict[str, float] = {}
        for n in names:
            i = rows.get(n)
            if i is not None:
                out[n] = round(float(self._table_np[i] @ q), 4)
        return out

    async def maybe_refresh(
        self, registry: RegistryBackend, version: Optional[int] = None
    ) -> None:
        if self.config.auto_refresh:
            await self.refresh(registry, known_version=version)

    @property
    def size(self) -> int:
        return len(self._names)

    @property
    def version(self) -> int:
        return self._version
