"""Radix-tree prefix KV cache: cross-request reuse of prompt-head KV pages.

Port of ``mcpx/engine/prefix_cache.py``, trimmed to the single-tier,
ungoverned cache: no host spill tier and no per-tenant governor (both wait
for the KV tier). A radix tree over token-id sequences whose nodes own runs
of KV pages in the engine's page pools. On admission the engine matches
each request's prompt against the tree, pins the matched run (refcount),
and prefills only the unmatched suffix through the ragged paged-attention
kernel, whose per-row start offsets are data. The page-aligned remainder of
every admitted prompt is inserted back into the tree, so the next request
sharing that head re-prefills none of it.

What the module holds to:

  - **Page granularity.** KV is shareable only in whole pages: edges are
    token runs whose length is a positive multiple of ``page_size``, and a
    partial edge match floors to the page boundary, splitting the edge
    there (bookkeeping only, via ``PageAllocator.split``: no device copy).
  - **Read-only by position.** A node's pages hold KV for positions
    ``[node_start, node_end)`` of every sequence referencing them; rows
    only write at positions at or past their full prompt length, which land
    in row-private pages, so tree pages are written once (by the prefill
    that inserted them) and then only read.
  - **Single writer.** The engine's worker thread owns the tree, as it owns
    the page allocator: no locks. Other threads (``queue_stats``) read only
    plain integer counters.
  - **Pending epoch.** Nodes inserted for an admission cohort are
    ``pending`` until that cohort's prefill has been launched: a row of the
    same cohort must not attend pages the same launch is still writing.
    ``seal()`` ends the epoch; later launches on the stream run after the
    writes.
  - **Refcounted eviction.** Rows (and external pins) pin the deepest node
    they reference; eviction removes only refcount-0 leaves, least recently
    used first, under pool pressure or over budget, so a pinned run is never
    reclaimed from under a reader and interior nodes are protected by their
    children.
"""

from __future__ import annotations

import heapq
from typing import Any, Optional, Sequence

from mcpx_torch.engine.kv_cache import PageAllocator


class PrefixNode:
    """One radix edge: ``tokens`` (a positive multiple of the page size
    long) backed by ``pages`` of the pools, allocated under the node's own
    ``sid``. ``refs`` counts live pinners (resident slab rows and external
    pins); ``stamp`` is the LRU clock; ``pending`` marks a node whose prefill
    has not been launched yet."""

    __slots__ = ("tokens", "pages", "children", "parent", "refs", "stamp", "pending", "sid")

    def __init__(
        self,
        tokens: tuple,
        pages: list[int],
        parent: Optional["PrefixNode"],
        sid: Any,
        *,
        pending: bool = False,
    ) -> None:
        self.tokens = tokens
        self.pages = pages
        # Children keyed by their edge's first PAGE of tokens: two branches
        # that diverge inside a page share nothing, so they must coexist as
        # siblings (a first-token key would collide them).
        self.children: dict[tuple, PrefixNode] = {}
        self.parent = parent
        self.refs = 0
        self.stamp = 0
        self.pending = pending
        self.sid = sid


class RadixPrefixCache:
    """Radix tree over page-aligned prompt heads. Every method that changes
    the tree is called by the engine's worker thread only."""

    def __init__(
        self, allocator: PageAllocator, page_size: int, *, max_nodes: int = 512, max_tokens: int = 0
    ) -> None:
        self._alloc = allocator
        self.page_size = page_size
        self.max_nodes = max(0, max_nodes)
        # 0 = auto: at most half the pool, so a warm tree never starves the
        # slab of row pages beyond what one eviction pass reclaims.
        self.max_tokens = max_tokens if max_tokens > 0 else (allocator.n_pages // 2) * page_size
        self.root = PrefixNode((), [], None, None)
        self._clock = 0
        self._sid_counter = 0
        # Counters other threads may read.
        self.n_nodes = 0
        self.resident_tokens = 0
        self.hits = 0
        self.misses = 0
        self.matched_tokens = 0
        self.inserted_tokens = 0
        self.evictions = 0
        # Nodes inserted since the last seal().
        self._pending_nodes: list[PrefixNode] = []

    def __len__(self) -> int:
        return self.n_nodes

    # ------------------------------------------------------------- helpers
    def _aligned(self, n: int) -> int:
        return (n // self.page_size) * self.page_size

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _new_sid(self) -> tuple:
        self._sid_counter += 1
        return ("pfx", self._sid_counter)

    def match_cap(self, n_prompt: int) -> int:
        """Longest usable match for an ``n_prompt``-token prompt: page
        aligned, leaving at least one suffix token to prefill (the engine
        samples from the suffix's last logit)."""
        return self._aligned(max(0, n_prompt - 1))

    def _limit(self, ids: Sequence[int], cap: Optional[int]) -> int:
        if cap is None:
            return self.match_cap(len(ids))
        return min(self._aligned(cap), self._aligned(len(ids)))

    # ------------------------------------------------------------- descent
    def _descend(
        self, ids: Sequence[int], limit: int, *, mutate: bool
    ) -> tuple[int, list[int], Optional[PrefixNode]]:
        """The radix walk probe() and match() share: follow ready children
        by first-page key, scan edge tokens, stop at ``limit``. With
        ``mutate`` a partial edge match splits at the page boundary (so the
        returned node covers exactly the match) and the path is stamped for
        LRU; without it the walk only reads. Returns (depth, pages, deepest
        node)."""
        depth = 0
        node = self.root
        pages: list[int] = []
        psz = self.page_size
        tick = self._tick() if mutate else 0
        while depth + psz <= limit:
            child = node.children.get(tuple(ids[depth : depth + psz]))
            if child is None or child.pending:
                break
            el = child.tokens
            span = min(len(el), limit - depth)
            common = psz
            while common < span and el[common] == ids[depth + common]:
                common += 1
            if common == len(el):
                if mutate:
                    child.stamp = tick
                    pages.extend(child.pages)
                depth += common
                node = child
                continue
            k = self._aligned(common)
            if k > 0 and mutate:
                node = self._split(child, k)
                node.stamp = tick
                pages.extend(node.pages)
            depth += k
            break
        return depth, pages, (node if node is not self.root else None)

    def probe(self, ids: Sequence[int], cap: Optional[int] = None) -> int:
        """Read-only matched depth (tokens) for ``ids``: never splits,
        never stamps (the locality sort's key). An explicit ``cap`` replaces
        the leave-a-suffix default."""
        return self._descend(ids, self._limit(ids, cap), mutate=False)[0]

    def match(
        self, ids: Sequence[int], cap: Optional[int] = None, *, record: bool = True
    ) -> tuple[int, list[int], Optional[PrefixNode]]:
        """Longest ready page-aligned match for ``ids``: ``(n_tokens,
        pages, deepest_node)``. Counts a hit or a miss when ``record`` and
        stamps the path. The caller pins ``deepest_node`` (refs += 1) for as
        long as a page table names ``pages``."""
        depth, pages, node = self._descend(ids, self._limit(ids, cap), mutate=True)
        if record:
            if depth > 0:
                self.hits += 1
                self.matched_tokens += depth
            else:
                self.misses += 1
        return depth, pages, node

    def _split(self, child: PrefixNode, k: int) -> PrefixNode:
        """Split ``child``'s edge at ``k`` tokens (a page boundary): a new
        node owns the first ``k`` tokens and their pages, ``child`` keeps
        the tail. Page ids do not change, so live page tables stay valid."""
        psz = self.page_size
        kp = k // psz
        parent = child.parent
        mid = PrefixNode(child.tokens[:k], [], parent, self._new_sid())
        mid.pages = self._alloc.split(child.sid, mid.sid, kp)
        mid.stamp = child.stamp
        mid.children = {child.tokens[k : k + psz]: child}
        parent.children[child.tokens[:psz]] = mid
        child.tokens = child.tokens[k:]
        child.pages = child.pages[kp:]
        child.parent = mid
        self.n_nodes += 1
        return mid

    def lookup(self, ids: Sequence[int]) -> Optional[PrefixNode]:
        """Deepest ready node whose whole path prefixes ``ids`` (no
        splitting): the handle an external pin holds. None when nothing
        matches."""
        depth = 0
        node = self.root
        psz = self.page_size
        limit = self.match_cap(len(ids))
        while depth + psz <= limit:
            child = node.children.get(tuple(ids[depth : depth + psz]))
            if child is None or child.pending:
                break
            el = child.tokens
            if depth + len(el) > limit or tuple(ids[depth : depth + len(el)]) != el:
                break
            depth += len(el)
            node = child
        return node if node is not self.root else None

    # -------------------------------------------------------------- insert
    def can_insert(self, ids: Sequence[int], depth: int) -> int:
        """Tokens insertable at ``depth`` (the end of a match): the
        page-aligned remainder of ``ids``, or 0 when a sibling edge has the
        same first page (a pending cohort-mate's branch)."""
        end = self._aligned(len(ids))
        if depth >= end:
            return 0
        node = self._node_at(ids, depth)
        if node is None:
            return 0
        if node.children.get(tuple(ids[depth : depth + self.page_size])) is not None:
            return 0
        return end - depth

    def _node_at(self, ids: Sequence[int], depth: int) -> Optional[PrefixNode]:
        """The node whose path ends exactly at ``depth`` along ``ids``,
        pending edges included (an insert must see cohort-mates' branches
        to refuse colliding with them)."""
        d = 0
        node = self.root
        psz = self.page_size
        while d < depth:
            child = node.children.get(tuple(ids[d : d + psz]))
            if child is None or d + len(child.tokens) > depth:
                return None
            if tuple(ids[d : d + len(child.tokens)]) != child.tokens:
                return None
            d += len(child.tokens)
            node = child
        return node

    def insert(self, ids: Sequence[int], depth: int, n_tokens: int) -> Optional[PrefixNode]:
        """Attach a pending node covering ``ids[depth : depth + n_tokens]``
        (page aligned) and allocate its pages: the caller puts
        ``node.pages`` in the admitting row's page table and the cohort
        prefill writes the KV. Returns None, allocating nothing, on a
        collision, or when one eviction pass cannot make room. The node is
        born pinned (refs = 1) by its inserting row; call ``seal()`` once
        the prefill is launched."""
        if n_tokens <= 0 or n_tokens % self.page_size:
            return None
        if self.can_insert(ids, depth) < n_tokens:
            return None
        parent = self._node_at(ids, depth)
        if parent is None:
            return None
        # Budget consult before growing: the eviction pass makes headroom
        # (refcount-0 LRU subtrees first); if the tree is still over (all
        # pinned), skip caching. Serving never waits on the cache.
        if self.resident_tokens + n_tokens > self.max_tokens or self.n_nodes + 1 > self.max_nodes:
            self.evict(need_resident=n_tokens)
        if self.resident_tokens + n_tokens > self.max_tokens or self.n_nodes + 1 > self.max_nodes:
            return None
        if not self._alloc.can_allocate(n_tokens):
            self.evict(n_tokens)
            if not self._alloc.can_allocate(n_tokens):
                return None
        sid = self._new_sid()
        pages = self._alloc.allocate(sid, n_tokens)
        node = PrefixNode(tuple(ids[depth : depth + n_tokens]), pages, parent, sid, pending=True)
        node.stamp = self._tick()
        node.refs = 1
        parent.children[node.tokens[: self.page_size]] = node
        self.n_nodes += 1
        self.resident_tokens += n_tokens
        self.inserted_tokens += n_tokens
        self._pending_nodes.append(node)
        return node

    def seal(self) -> None:
        """End the pending epoch of everything inserted since the last
        seal: the prefill writing those nodes' KV has been launched."""
        for n in self._pending_nodes:
            n.pending = False
        self._pending_nodes.clear()

    # ------------------------------------------------------------ eviction
    @staticmethod
    def _leaf(c: PrefixNode) -> bool:
        """Reclaimable: unpinned, sealed, and childless."""
        return c.refs == 0 and not c.pending and not c.children

    def evict(self, need_tokens: int = 0, need_resident: int = 0) -> int:
        """Reclaim refcount-0 leaf subtrees, least recently used first,
        until the tree is within its node and token budgets, the allocator
        can satisfy ``need_tokens``, and ``need_resident`` more tokens fit
        the token budget. Returns tokens reclaimed."""

        def over() -> bool:
            return (
                self.n_nodes + (1 if need_resident else 0) > self.max_nodes
                or self.resident_tokens + need_resident > self.max_tokens
                or (need_tokens > 0 and not self._alloc.can_allocate(need_tokens))
            )

        return self._reclaim(over)

    def _reclaim(self, over) -> int:
        """One tree walk gathers the reclaimable leaves into a heap by LRU
        stamp; a reclaimed leaf that leaves its parent reclaimable pushes
        the parent, so a cascade of k leaves costs O(n + k log n)."""
        if not over():
            return 0
        heap: list[tuple[int, int, PrefixNode]] = []
        seq = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                if c.children:
                    stack.append(c)
                if self._leaf(c):
                    seq += 1
                    heapq.heappush(heap, (c.stamp, seq, c))
        freed = 0
        while heap and over():
            _stamp, _seq, victim = heapq.heappop(heap)
            if victim.parent is None or not self._leaf(victim):
                continue  # dropped, re-pinned, or grew a child
            parent = victim.parent
            freed += len(victim.tokens)
            self._drop(victim)
            if parent is not self.root and self._leaf(parent):
                seq += 1
                heapq.heappush(heap, (parent.stamp, seq, parent))
        return freed

    def _drop(self, node: PrefixNode) -> None:
        """Remove a leaf node and free its pages."""
        self._alloc.free(node.sid)
        node.parent.children.pop(node.tokens[: self.page_size], None)
        node.parent = None
        self.n_nodes -= 1
        self.resident_tokens -= len(node.tokens)
        self.evictions += 1

    def rollback(self, node: PrefixNode) -> None:
        """Detach a node whose prefill never completed (an admission
        unwound by page pressure or a failed prefill): pages back to the
        pool, insertion accounting reversed; not an eviction."""
        node.refs = 0
        self._drop(node)
        self.evictions -= 1
        self.inserted_tokens -= len(node.tokens)
        if node in self._pending_nodes:
            self._pending_nodes.remove(node)

    def drop_all(self) -> None:
        """Free every node: after a failed prefill the pools may hold
        partial writes, so no cached KV may be served from them."""
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self._alloc.free(n.sid)
        self.root.children.clear()
        self.n_nodes = 0
        self.resident_tokens = 0
        self._pending_nodes.clear()

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Counter snapshot (plain integer reads; safe from any thread)."""
        lookups = self.hits + self.misses
        touched = self.matched_tokens + self.inserted_tokens
        return {
            "nodes": self.n_nodes,
            "resident_tokens": self.resident_tokens,
            "resident_pages": self.resident_tokens // self.page_size,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "matched_tokens": self.matched_tokens,
            "inserted_tokens": self.inserted_tokens,
            "token_hit_rate": self.matched_tokens / touched if touched else 0.0,
            "evictions": self.evictions,
        }

    def check_invariants(self) -> None:
        """Test hook: edge alignment, page/token consistency, child keys,
        parent links, and the node and token counters."""
        n_nodes = 0
        tokens = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            for first_page, child in node.children.items():
                assert child.tokens, "empty edge"
                assert child.tokens[: self.page_size] == first_page, "child key != first page"
                assert len(child.tokens) % self.page_size == 0, "unaligned edge"
                assert child.parent is node, "broken parent link"
                assert child.refs >= 0, "negative refcount"
                assert len(child.pages) == len(child.tokens) // self.page_size, "page/token mismatch"
                tokens += len(child.tokens)
                n_nodes += 1
                stack.append(child)
        assert n_nodes == self.n_nodes, (n_nodes, self.n_nodes)
        assert tokens == self.resident_tokens, (tokens, self.resident_tokens)
