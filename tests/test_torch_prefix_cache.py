"""The port's radix prefix cache, page allocator and locality sort against
the reference package's, step for step: the same seeded operation streams
(match, insert, seal, pin, evict under pressure, rollback, drop) go through
both, and after every step the matched depths, page ids, ``stats()`` and
both sides' invariants must agree. Pure host bookkeeping: no tolerance."""

import random

import pytest

from mcpx.engine.kv_cache import PageAllocator as JAllocator
from mcpx.engine.prefix_cache import RadixPrefixCache as JCache
from mcpx.scheduler.locality import locality_order as jlocality_order
from mcpx_torch.engine.kv_cache import PageAllocator
from mcpx_torch.engine.prefix_cache import RadixPrefixCache
from mcpx_torch.scheduler.locality import locality_order

PAGE = 4


def blocks(*ids):
    """Token stream of 4-token blocks; block k starts with k * 100, so
    divergence between streams lands on a page boundary."""
    out = []
    for k in ids:
        out.extend([k * 100, k * 100 + 1, k * 100 + 2, k * 100 + 3])
    return out


class Twin:
    """One reference cache and one port cache over their own allocators,
    driven by the same calls; every call checks the two answers agree."""

    def __init__(self, n_pages=64, max_nodes=64, max_tokens=0):
        self.ja = JAllocator(n_pages=n_pages, page_size=PAGE, max_pages_per_seq=32)
        self.ta = PageAllocator(n_pages=n_pages, page_size=PAGE, max_pages_per_seq=32)
        self.jc = JCache(self.ja, PAGE, max_nodes=max_nodes, max_tokens=max_tokens)
        self.tc = RadixPrefixCache(self.ta, PAGE, max_nodes=max_nodes, max_tokens=max_tokens)

    @staticmethod
    def _same_node(jn, tn):
        assert (jn is None) == (tn is None)
        if jn is not None:
            assert jn.tokens == tn.tokens and jn.pages == tn.pages and jn.sid == tn.sid
            assert jn.refs == tn.refs and jn.pending == tn.pending

    def match(self, ids, cap=None, record=True):
        jn, jp, jnode = self.jc.match(ids, cap, record=record)
        tn, tp, tnode = self.tc.match(ids, cap, record=record)
        assert (jn, jp) == (tn, tp), (ids, jn, tn)
        self._same_node(jnode, tnode)
        return tn, tp, (jnode, tnode)

    def probe(self, ids, cap=None):
        d = self.tc.probe(ids, cap)
        assert d == self.jc.probe(ids, cap)
        return d

    def insert(self, ids, depth, n):
        assert self.jc.can_insert(ids, depth) == self.tc.can_insert(ids, depth)
        jnode = self.jc.insert(ids, depth, n)
        tnode = self.tc.insert(ids, depth, n)
        self._same_node(jnode, tnode)
        return None if tnode is None else (jnode, tnode)

    def lookup(self, ids):
        jnode, tnode = self.jc.lookup(ids), self.tc.lookup(ids)
        self._same_node(jnode, tnode)
        return None if tnode is None else (jnode, tnode)

    def each(self, name, *args, **kw):
        out = getattr(self.jc, name)(*args, **kw), getattr(self.tc, name)(*args, **kw)
        assert out[0] == out[1], (name, out)
        return out[1]

    def set_max_nodes(self, n):
        self.jc.max_nodes = self.tc.max_nodes = n

    def check(self):
        self.jc.check_invariants()
        self.tc.check_invariants()
        self.ja.check_invariants()
        self.ta.check_invariants()
        js, ts = self.jc.stats(), self.tc.stats()
        assert {k: js[k] for k in ts} == ts
        # The reference's host-tier fields stay at zero single-tier.
        assert js["spilled_nodes"] == js["host_tokens"] == js["host_pages"] == 0
        assert vars(self.ja.stats()) == vars(self.ta.stats())
        assert self.ja._seq_pages == self.ta._seq_pages and self.ja._free == self.ta._free


def insert_all(tw, ids):
    """Match and insert the page-aligned rest, as admission does; the
    inserting "row" then retires (its pin dropped) and the epoch seals."""
    n, _pages, _nodes = tw.match(ids)
    want = (len(ids) // PAGE) * PAGE - n
    pair = tw.insert(ids, n, want) if want > 0 else None
    if pair is not None:
        for node in pair:
            node.refs -= 1
    tw.each("seal")
    tw.check()
    return n, pair


def test_match_insert_split_basic():
    tw = Twin()
    a = blocks(1, 2, 3) + [7]
    n, pair = insert_all(tw, a)
    assert n == 0 and pair is not None and len(pair[1].tokens) == 12
    assert tw.match(a)[0] == 12
    b = blocks(1, 9) + [7]  # shares one block: the 3-block edge splits
    n3, pages3, nodes = tw.match(b)
    assert n3 == 4 and len(pages3) == 1 and len(nodes[1].tokens) == 4
    tw.check()
    insert_all(tw, b)
    assert tw.match(b)[0] == 8 and tw.match(a)[0] == 12
    tw.check()


def test_within_page_divergence_caches_siblings():
    tw = Twin()
    a = [5, 6, 7, 8, 5, 5, 5, 5, 9]
    insert_all(tw, a)
    b = [5, 6, 99, 8, 1, 2, 3, 4, 9]  # diverges inside the first page
    assert tw.match(b)[0] == 0
    assert tw.each("can_insert", b, 0) == 8
    insert_all(tw, b)
    assert tw.match(a, record=False)[0] == 8 and tw.match(b, record=False)[0] == 8
    tw.check()


def test_pinned_run_survives_eviction_pressure():
    tw = Twin()
    a, b = blocks(1, 2, 3) + [7], blocks(4, 5) + [7]
    insert_all(tw, a)
    insert_all(tw, b)
    _n, _p, nodes_a = tw.match(a)
    for node in nodes_a:
        node.refs += 1
    tw.set_max_nodes(0)
    tw.each("evict")
    tw.check()
    assert tw.match(b, record=False)[0] == 0 and tw.match(a, record=False)[0] == 12
    for node in nodes_a:
        node.refs -= 1
    tw.each("evict")
    assert len(tw.tc) == 0 and tw.ta.stats().sequences == 0
    tw.check()


def test_eviction_is_lru_and_cascades():
    tw = Twin()
    old, new = blocks(1, 2) + [7], blocks(3, 4) + [7]
    insert_all(tw, old)
    insert_all(tw, new)
    tw.match(new)  # refresh new's stamp: old is least recently used
    tw.set_max_nodes(1)
    tw.each("evict")
    assert tw.match(new, record=False)[0] == 8 and tw.match(old, record=False)[0] == 0
    tw.check()


@pytest.mark.parametrize("seed", range(6))
def test_seeded_operation_streams_agree_step_for_step(seed):
    """A seeded stream of admissions (match, pin, insert; a third of the
    inserted runs rolled back as if the row were pushed back), retirements
    (pins dropped), seals, external pins, eviction passes under node and
    page pressure, and an occasional drop of the whole tree. Small pools
    keep the allocator under pressure."""
    rng = random.Random(seed)
    tw = Twin(n_pages=40, max_nodes=24)
    live = []  # pinned (ref, port) node pairs of admitted "rows"
    pins = []
    for step in range(250):
        op = rng.random()
        seq = blocks(*(rng.randrange(5) for _ in range(rng.randint(1, 6)))) + [7] * rng.randint(1, 3)
        if op < 0.55:  # an admission
            cap = rng.choice([None, rng.randrange(0, 32)])
            tw.probe(seq, cap)
            n, _pages, nodes = tw.match(seq, cap, record=rng.random() < 0.5)
            if nodes[1] is not None:
                for node in nodes:
                    node.refs += 1
                live.append(nodes)
            want = (len(seq) // PAGE) * PAGE - n
            pair = tw.insert(seq, n, want) if want > 0 else None
            if pair is not None:
                if rng.random() < 0.33:
                    tw.jc.rollback(pair[0])
                    tw.tc.rollback(pair[1])
                else:
                    live.append(pair)
            if rng.random() < 0.7:
                tw.each("seal")
        elif op < 0.75 and live:  # a row retires
            for node in live.pop(rng.randrange(len(live))):
                node.refs -= 1
        elif op < 0.82:  # an external pin, or its release
            if pins and rng.random() < 0.5:
                for node in pins.pop():
                    node.refs -= 1
            else:
                pair = tw.lookup(seq)
                if pair is not None:
                    for node in pair:
                        node.refs += 1
                    pins.append(pair)
        elif op < 0.97:  # eviction under pressure
            tw.each("seal")
            tw.set_max_nodes(rng.randrange(0, 24))
            tw.each("evict", rng.choice([0, 8, 32, 64]))
            tw.set_max_nodes(24)
        else:
            tw.each("drop_all")
            live, pins = [], []
        tw.check()
    assert tw.tc.hits + tw.tc.misses > 0 and tw.tc.evictions > 0, seed


class _Req:
    def __init__(self, depth, enq, deadline=None):
        self.depth, self.enq, self.deadline = depth, enq, deadline


def _both(items, now=100.0, age_cap=0.5, slack=0.1):
    kw = dict(
        now=now, depth_of=lambda r: r.depth, enqueued_of=lambda r: r.enq,
        deadline_of=lambda r: r.deadline, age_cap_s=age_cap, deadline_slack_s=slack,
    )
    out = locality_order(items, **kw)
    assert out == jlocality_order(items, **kw)
    return out


def _cases():
    a, b, c, d = _Req(0, 99.7), _Req(8, 99.8), _Req(8, 99.9), _Req(4, 99.95)
    yield "groups_by_depth_fifo_within", [a, b, c, d], [b, c, d, a]
    now = 100.0
    urgent_late = _Req(0, 99.9, deadline=now + 0.05)
    urgent_old = _Req(0, 99.0)
    deep = _Req(64, 99.95, deadline=now + 10.0)
    deeper = _Req(128, 99.96)
    yield "respects_edf", [deep, urgent_late, deeper, urgent_old], [urgent_late, urgent_old, deeper, deep]
    reqs = [_Req(0, 99.9 + i * 0.001) for i in range(5)]
    yield "empty_tree_is_identity", reqs, list(reqs)


@pytest.mark.parametrize("name", [c[0] for c in _cases()])
def test_locality_order_matches_reference(name):
    items, want = next((i, w) for n, i, w in _cases() if n == name)
    assert _both(items) == want
