"""Service-embedding table with a top-k shortlist, on the device or the host.

The PyTorch port of ``mcpx.retrieval.index``. The ``[N, d]`` table is
rebuilt when ``registry.version()`` changes, under an asyncio lock, and
kept as a host (numpy) mirror. ``RetrievalConfig.compute`` decides where
the shortlist's plain ranking is scored: ``"device"``, or ``"auto"`` at or
above ``device_threshold`` rows, places a float32 copy on the index's
device once per refresh and scores it with ``torch.mv`` and ``torch.topk``
there (the reference's jitted ``einsum`` and ``lax.top_k``); ``"host"``,
or ``"auto"`` below the threshold, scores with numpy. On CUDA the scoring
runs on a stream of the index's own, so a shortlist never queues behind
the engine's decode windows on the default stream, and only that stream
is waited on. The coverage-greedy picks and ``scores_for`` read the host
mirror. ``save``/``load`` write and read the reference's snapshot file
(table, names, per-record words), so a snapshot crosses between the two
packages.

Under a mesh (``parallel/mesh.py``) the device table's rows are split over
the ``model`` axis when they divide, as the reference shards them: each row
shard is ranked on its own, and the shards' candidates are merged on the
host by (-score, row), so the shortlist equals the unmeshed one's, ties
lowest row first. Only a virtual mesh of the index's device is served; a
mesh of other devices is refused (ROADMAP Queue A item 5c).
"""

from __future__ import annotations

import asyncio
import contextlib
import re
from typing import Optional

import numpy as np
import torch

from mcpx_torch.core.config import RetrievalConfig
from mcpx_torch.core.errors import EngineError
from mcpx_torch.device import resolve_device
from mcpx_torch.parallel.mesh import MODEL_AXIS, indices_map, is_virtual
from mcpx_torch.registry.base import RegistryBackend
from mcpx_torch.retrieval.embed import HashedNGramEmbedder

_WORD_RE = re.compile(r"[a-z0-9]+")


class RowShards:
    """A device table split by rows: ``parts[i]`` holds the global rows from
    ``offsets[i]`` on."""

    def __init__(self, offsets: list[int], parts: list[torch.Tensor]) -> None:
        self.offsets, self.parts = offsets, parts

    @property
    def shape(self) -> tuple[int, int]:
        return sum(int(p.shape[0]) for p in self.parts), int(self.parts[0].shape[1])


class RetrievalIndex:
    def __init__(
        self,
        config: Optional[RetrievalConfig] = None,
        *,
        embedder: Optional[HashedNGramEmbedder] = None,
        device: "torch.device | str | None" = None,
        mesh=None,
    ) -> None:
        """``device``: where a device table lives (the control plane's
        resolved device; the factory passes it). ``None`` is CUDA, as for
        every entry point of the port; it is only touched when ``compute``
        puts the table on the device. ``mesh``: the table's rows split over
        its ``model`` axis where they divide; only a virtual mesh of
        ``device`` is served (a mesh of other devices raises, ROADMAP Queue A
        item 5c)."""
        self.config = config or RetrievalConfig()
        self.embedder = embedder or HashedNGramEmbedder(self.config.embed_dim)
        self.device = torch.device("cuda" if device is None else device)
        if mesh is not None and not is_virtual(mesh, self.device):
            raise EngineError(
                f"RetrievalIndex on {mesh}: row shards live on the index's own device ({self.device}) only; "
                "shards on several cards are ROADMAP Queue A item 5c"
            )
        self._mesh = mesh
        self._lock = asyncio.Lock()
        self._names: list[str] = []
        # [N, d] float32 on the device, or its RowShards under a mesh.
        self._table: "Optional[torch.Tensor | RowShards]" = None
        self._table_np: Optional[np.ndarray] = None  # [N, d] host mirror
        self._stream: "Optional[torch.cuda.Stream]" = None  # the index's own, on CUDA
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
            placed = await asyncio.to_thread(self._place, table) if self._on_device(len(names)) else None
            self._table_np = table
            self._table = placed
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

    def _on_device(self, n_rows: int) -> bool:
        mode = self.config.compute
        if mode == "device":
            return True
        if mode == "host":
            return False
        return n_rows >= self.config.device_threshold

    def _copy(self, host: torch.Tensor) -> torch.Tensor:
        """``host`` copied to the index's device; on CUDA on the index's
        stream, which the copy finishes on before this returns."""
        if self.device.type != "cuda":
            return host.to(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            placed = host.pin_memory().to(self.device, non_blocking=True)
        self._stream.synchronize()
        return placed

    def _place(self, table: np.ndarray) -> "torch.Tensor | RowShards":
        """The table as float32 on the index's device, copied once per
        refresh. Under a mesh its rows split over ``model`` when they
        divide (the reference's ``P(model, None)``), one part per distinct
        row block. A device without a card raises here."""
        resolve_device(self.device)
        host = torch.from_numpy(np.ascontiguousarray(table, np.float32))
        if self._mesh is None:
            return self._copy(host)
        m = self._mesh.shape.get(MODEL_AXIS, 1)
        spec = (MODEL_AXIS if m > 1 and table.shape[0] % m == 0 else None, None)
        blocks = sorted({idx[0].indices(table.shape[0])[:2] for idx in indices_map(table.shape, spec,
                                                                                    self._mesh).values()})
        if len(blocks) == 1:
            return self._copy(host)
        return RowShards([lo for lo, _ in blocks], [self._copy(host[lo:hi]) for lo, hi in blocks])

    # ---------------------------------------------------------------- query
    async def shortlist(self, intent: str, k: int) -> list[str]:
        """Top-k service names for an intent.

        Two modes (``RetrievalConfig.shortlist_mode``):

        - ``"topk"``: plain embedding similarity. Scored on the device
          table when ``compute`` placed one (``"device"``, or ``"auto"`` at
          or above ``device_threshold`` rows), else on the host: below the
          threshold the product is microseconds there, while a device
          dispatch per request would wait on a busy card.
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
        if self._table is not None:
            return self._device_topk(q, k)[1]
        return self._host_order(q, k)

    def _host_order(self, q: np.ndarray, k: int) -> list[int]:
        scores = self._table_np @ q
        part = np.argpartition(scores, -k)[-k:]
        return [int(i) for i in part[np.argsort(scores[part])[::-1]]]

    def _device_topk(
        self, q: np.ndarray, k: int, table: Optional[torch.Tensor] = None
    ) -> tuple[list[float], list[int]]:
        """The ``k`` best rows of the device table (or of ``table``, a
        placed part of it) and their scores, by score descending then index
        ascending: ``lax.top_k``'s order, which ``torch.topk`` does not
        promise for equal scores. ``k + 1`` are taken, so a tie across the
        ``k``-th place shows; such a query ranks the whole score vector by a
        stable sort instead. On CUDA the work runs on the index's stream,
        and only its event is waited on. The product is strict fp32: TF32
        must be off."""
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("retrieval scores in strict fp32; torch.backends.cuda.matmul.allow_tf32 is on")
        table = self._table if table is None else table
        if isinstance(table, RowShards):
            # Each shard ranked on its device, merged by (-score, row): the
            # k best overall are among the shards' own k best.
            merged = []
            for off, part in zip(table.offsets, table.parts):
                scores, idx = self._device_topk(q, min(k, int(part.shape[0])), part)
                merged += [(-s, off + i) for s, i in zip(scores, idx)]
            merged.sort()
            return [-s for s, _ in merged[:k]], [i for _, i in merged[:k]]
        cuda = table.device.type == "cuda"
        stream = self._stream
        take = min(k + 1, table.shape[0])
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            scores = torch.mv(table, torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(table.device))
            vals, idx = torch.topk(scores, take)
            vals, idx = vals.to("cpu", non_blocking=cuda), idx.to("cpu", non_blocking=cuda)
            if cuda:
                done = torch.cuda.Event()
                done.record(stream)
        if cuda:
            done.synchronize()
        top = sorted(zip((-vals).tolist(), idx.tolist()))
        if take > k and top[k - 1][0] == top[k][0]:
            with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
                vals, idx = torch.sort(scores, descending=True, stable=True)
                return vals[:k].tolist(), idx[:k].tolist()
        return [-v for v, _ in top[:k]], [i for _, i in top[:k]]

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

    # ------------------------------------------------------------- snapshot
    def save(self, path: str) -> None:
        """Write the reference's snapshot file at exactly ``path``: the
        host table, the names and each record's topic words."""
        if self._table_np is None:
            raise ValueError("nothing to snapshot: table not built")
        words = (
            np.asarray([" ".join(sorted(ws)) for ws in self._word_sets], dtype=object)
            if self._word_sets is not None
            else None
        )
        with open(path, "wb") as f:  # exact path (np.savez would append .npz)
            payload = dict(table=self._table_np, names=np.asarray(self._names, dtype=object))
            if words is not None:
                payload["words"] = words
            np.savez(f, **payload)

    def load(self, path: str) -> None:
        """Load a table snapshot, placed by ``compute`` as a refresh places
        it. The snapshot is provisional: the registry version counter is not
        comparable across registry instances, so ``_version`` stays -1 and
        the first ``maybe_refresh`` revalidates against the live registry
        (the snapshot covers the window between process start and that
        first refresh)."""
        with np.load(path, allow_pickle=True) as z:
            table = z["table"].astype(np.float32)
            names = [str(n) for n in z["names"]]
            word_texts = [str(w) for w in z["words"]] if "words" in z.files else None
        self._table = self._place(table) if self._on_device(len(names)) else None
        self._table_np = table
        self._names = names
        if word_texts is not None:
            self._build_word_index(word_texts)
        else:
            # A snapshot without words: the coverage-greedy data is missing
            # until the first refresh, and shortlist ranks by plain top-k.
            self._word_sets = self._word_index = None
        self._version = -1
