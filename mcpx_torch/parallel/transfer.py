"""Data that crosses between the coordinates of a serving mesh.

The cross-device half of the parallel package, for one controller over the
cards of one host (as the reference drives every chip it sees from one
process). Each coordinate ``(d, m)`` of a ``parallel.mesh.ServeLayout``
computes on its card (``layout.card(d, m)``); every tensor one coordinate
hands to another goes through ``send``: a peer copy ``x.to(card,
non_blocking=True)``, which PyTorch orders after the work already issued on
both cards' current streams and before what either issues next. On a
virtual mesh (one device at every coordinate) the copy is ``x`` itself, so
the same per-coordinate program runs on one card or on the CPU. A mesh of
distinct indexed CPU devices (``cpu:0..n-1``, as the reference's tests'
host devices) copies between them as cards do, so the CPU runs the
cross-card code too.

What crosses, per row block ``d`` of a forward (``models/gemma/model.py``,
``engine/paged_decode.py``):

  - ``Inputs``: the block's integer inputs (tokens, positions, page table,
    query lengths), packed into one int32 tensor made on the control card
    (coordinate (0, 0)) and sent once to each coordinate that reads it;
  - the normed activations from the block's reducing coordinate ``(d, 0)``
    to each model shard, and each shard's partial output after ``wo`` and
    ``w_down`` back to it, summed there in shard order (``reduce``, fp32 for
    a lower-precision model);
  - each KV write, to every data replica of its head range (``homes``), so
    a page any row reads holds the same bytes on every card that holds it;
  - the vocabulary shards' logits, joined in vocabulary order on the control
    card (``join``);
  - a dense prefill's page table, to each other card whose pools take the
    commit (``engine/kv_cache.commit_prefill_to_pages``).

Outside the forward, ``copy_to`` moves a tensor between two devices: each
hop of ring attention (``parallel/ring_attention.py``) and a training
replica's batch rows, gradients and stepped parameters
(``models/train.py``). The KV tier's two copies (``engine/spill.py``) move a
run of pages between the pools and host memory: ``gather_run`` reads each
distinct KV-head span from data coordinate 0's card into its slice of one
host run, ``readmit_run`` writes each span's slice into every card whose
pools hold those heads. The host run keeps the unmeshed layout ``[K, L, n,
page_size, head_dim]``, so host budgets and snapshots do not depend on the
mesh; unmeshed and on a virtual mesh each copy is the one pool pair's.

Counts: every move between two distinct coordinates of a forward counts one
transfer of the tensor's bytes, whether or not their devices differ, so a
virtual mesh counts what the same mesh of cards copies; ``copy_to`` counts
the copies it makes. ``counts()`` also holds the sharded forwards run, and
the tier's copies on their own keys (``tier_copies``: one for each device a
copy reads or writes; ``tier_bytes``: the K and V bytes moved there); a
captured graph's replays run no Python and count nothing.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import torch

Coord = tuple[int, int]

_LOCK = threading.Lock()
_COUNTS = {"forwards": 0, "transfers": 0, "bytes": 0, "tier_copies": 0, "tier_bytes": 0}  # mcpx: owner[_LOCK]


def reset_counts() -> None:
    with _LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0


def counts() -> dict[str, int]:
    """Sharded forwards run, the transfers and bytes they moved, and the KV
    tier's copies and bytes, since the last ``reset_counts``."""
    with _LOCK:
        return dict(_COUNTS)


def _add(key: str, n: int, nbytes: int = 0, bytes_key: str = "bytes") -> None:
    with _LOCK:
        _COUNTS[key] += n
        _COUNTS[bytes_key] += nbytes


def count_forward() -> None:
    _add("forwards", 1)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def send(x: torch.Tensor, src: Coord, dst: Coord, layout) -> torch.Tensor:
    """``x``, computed at coordinate ``src``, as coordinate ``dst`` reads
    it: on ``dst``'s card."""
    if src != dst:
        _add("transfers", 1, _nbytes(x))
    dev = layout.card(*dst)
    return x if x.device == dev else x.to(dev, non_blocking=True)


def shard_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """Partial outputs summed in shard order, in fp32 for a lower-precision
    model (one part as it is)."""
    if len(parts) == 1:
        return parts[0]
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(parts[0].dtype)


def reduce(parts: list[tuple[Coord, torch.Tensor]], dst: Coord, layout) -> torch.Tensor:
    """The model shards' partial outputs ``(coordinate, part)`` summed in
    shard order on ``dst``'s card."""
    return shard_sum([send(p, c, dst, layout) for c, p in parts])


def join(parts: list[tuple[Coord, torch.Tensor]], dst: Coord, layout) -> torch.Tensor:
    """Vocabulary shards' logits concatenated in order on ``dst``'s card."""
    moved = [send(p, c, dst, layout) for c, p in parts]
    return moved[0] if len(moved) == 1 else torch.cat(moved, dim=-1)


def homes(layout, a: Optional[int]) -> list[tuple[Coord, tuple[int, int], bool]]:
    """Where the keys and values attention shard ``a`` writes go (None:
    every KV head, projected once): ``(coordinate, (k0, k1) heads, fresh)``
    for each data replica of each attention shard whose pools hold them.
    ``fresh`` is False where an earlier home's write already filled the
    same heads of the same device's pools (every replica of a virtual
    mesh): the tensor is still sent there (and counted), not written."""
    out, done = [], set()
    for s in (range(len(layout.attn)) if a is None else (a,)):
        heads = layout.attn[s].kv
        for d in range(layout.data):
            key = (layout.card(d, s), heads)
            out.append(((d, s), heads, key not in done))
            done.add(key)
    return out


class Inputs:
    """A row block's integer inputs, made on the control card and handed to
    each coordinate that reads them: one packed int32 tensor per coordinate
    (counted once each), unpacked into contiguous views and copied once per
    device, so a virtual mesh copies nothing. ``derive(coord, fn)`` memoizes
    what a device computes from them (``fn(views)``)."""

    def __init__(self, layout, src: Coord, **tensors: Optional[torch.Tensor]) -> None:
        self.layout, self.src = layout, src
        self._specs = [(k, tuple(t.shape)) for k, t in tensors.items() if t is not None]
        flat = [t.to(torch.int32).reshape(-1) for t in tensors.values() if t is not None]
        self._packed = flat[0] if len(flat) == 1 else torch.cat(flat)
        self._seen: set = {src}
        self._views: dict[torch.device, dict[str, torch.Tensor]] = {}
        self._derived: dict[tuple, Any] = {}

    def at(self, coord: Coord) -> dict[str, torch.Tensor]:
        if coord not in self._seen:
            self._seen.add(coord)
            _add("transfers", 1, _nbytes(self._packed))
        dev = self.layout.card(*coord)
        views = self._views.get(dev)
        if views is None:
            packed = self._packed if self._packed.device == dev else self._packed.to(dev, non_blocking=True)
            views, at = {}, 0
            for name, shape in self._specs:
                n = 1
                for s in shape:
                    n *= s
                views[name] = packed[at:at + n].view(shape)
                at += n
            self._views[dev] = views
        return views

    def derive(self, coord: Coord, name: str, fn) -> Any:
        views = self.at(coord)
        key = (self.layout.card(*coord), name)
        if key not in self._derived:
            self._derived[key] = fn(views)
        return self._derived[key]


class OnCards:
    """A tree on each device of a mesh of several: ``trees[device]`` is the
    tree the coordinates on that device read (``params.on_cards``; the
    per-card caches of ``kv_tree``). Not a mapping, so code that reads one
    tree picks its coordinate's (``tree_at``) and a reader that does not
    know of cards fails."""

    def __init__(self, trees: dict) -> None:
        self.trees = trees


def trees(x: Any, layout) -> dict:
    """Each device's tree of ``x`` on ``layout``: an ``OnCards``' own, else
    the one tree of a virtual mesh (every shard of it) on the control
    device."""
    return x.trees if isinstance(x, OnCards) else {layout.control: x}


def tree_at(x: Any, layout, coord: Coord) -> Any:
    """The tree coordinate ``coord`` reads: its device's."""
    return trees(x, layout)[layout.card(*coord)]


def kv_tree(layout, device, n_kv_heads: int, make) -> Any:
    """A KV cache or pool pair, ``make(k_heads, device)``: over every KV
    head on ``device``, or, on a mesh of several devices, an ``OnCards``
    of each device's over the heads its coordinates read
    (``layout.kv_range``), every page or row of them (replicated over
    ``data``, as the reference's pools are)."""
    if layout is None or not layout.cross:
        return make(n_kv_heads, device)
    spans = {dev: layout.kv_range(dev) for dev in layout.devices}
    return OnCards({dev: make(s[1] - s[0], dev) for dev, s in spans.items() if s is not None})


def copy_to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``x`` on ``dev``, counted as one transfer where that copies (a ring
    hop or a training replica's tensors between two devices)."""
    if x.device == dev:
        return x
    _add("transfers", 1, _nbytes(x))
    return x.to(dev, non_blocking=True)


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, counted as ``copy_to`` counts."""
    if dst.device != src.device:
        _add("transfers", 1, _nbytes(src))
    dst.copy_(src, non_blocking=True)


def join_streams(layout) -> None:
    """Make the control card's current stream wait for every other card's
    current stream: an event recorded after a forward on the control card
    then covers the work of every card (the KV writes mirrored to cards
    whose results never came back to it included)."""
    if layout is None or not layout.cross or layout.control.type != "cuda":
        return
    main = torch.cuda.current_stream(layout.control)
    for dev in layout.devices:
        if dev != layout.control:
            main.wait_stream(torch.cuda.current_stream(dev))


def pools_on(paged: Any, layout) -> list[tuple[torch.device, tuple[int, int], dict]]:
    """Each device's pool pair with the KV heads ``(k0, k1)`` it holds: the
    one pair over every head unmeshed or on a virtual mesh, else each card's
    (``kv_tree``), every data replica of its heads."""
    if layout is None or not layout.cross:
        return [(paged["k"].device, (0, paged["k"].shape[0]), paged)]
    return [(dev, layout.kv_range(dev), t) for dev, t in paged.trees.items()]


def _readers(paged: Any, layout) -> list[tuple[torch.device, tuple[int, int], dict]]:
    """For each distinct KV-head span, in head order, the pools of the first
    card that holds it: data coordinate 0's. The spans tile every head."""
    if layout is None or not layout.cross:
        return pools_on(paged, layout)
    out: dict[tuple[int, int], tuple] = {}
    for m in range(layout.model):
        dev = layout.card(0, m)
        span = layout.kv_range(dev)
        if span is not None and span not in out:
            out[span] = (dev, span, paged.trees[dev])
    spans = sorted(out)
    if spans[0][0] != 0 or any(a[1] != b[0] for a, b in zip(spans, spans[1:])):
        raise ValueError(f"the KV-head spans {spans} of data coordinate 0 do not tile the heads")
    return [out[s] for s in spans]


def _page_ids(pages: list[int], devices: list[torch.device]) -> dict[torch.device, torch.Tensor]:
    """A run's page ids on each device: one int64 host tensor (pinned where
    a card reads it, so no upload waits for the card's queue) copied once to
    each. The allocator's ids are global, the same on every card. Page 0,
    the null page that idle rows and pad slots write, differs between data
    replicas and never belongs to a run."""
    if 0 in pages:
        raise ValueError(f"a KV tier run names page 0 (the null page): {pages}")
    host = torch.tensor(pages, dtype=torch.int64)
    if any(d.type == "cuda" for d in devices):
        host = host.pin_memory()
    return {d: host if host.device == d else host.to(d, non_blocking=True) for d in devices}


def _record(dev: torch.device) -> Any:
    """An event after the work issued so far on ``dev``'s current stream."""
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return event


def gather_run(paged: Any, layout, pages: list[int]) -> tuple:
    """The KV tier's gather of ``pages``: each distinct KV-head span read
    from data coordinate 0's card into a fresh device tensor (the run as it
    is now: a later write to the freed pages is ordered after this read on
    that card's current stream) and copied without blocking into its slice
    of one pinned host tensor per pool, in the unmeshed layout ``[K, L, n,
    page_size, head_dim]``. Returns ``(k, v, events, src)``: one event per
    card read, recorded after its copies, and what the copies read (kept
    until every event has passed). On the CPU the host run is ready at once
    (no event); one span's gather is the tensor itself."""
    readers = _readers(paged, layout)
    ids = _page_ids(pages, [dev for dev, _, _ in readers])
    parts = [(dev, span, pool["k"].index_select(2, ids[dev]), pool["v"].index_select(2, ids[dev]))
             for dev, span, pool in readers]
    _add("tier_copies", len(parts), sum(_nbytes(k) + _nbytes(v) for _, _, k, v in parts), "tier_bytes")
    if readers[0][0].type != "cuda":
        if len(parts) == 1:
            return parts[0][2], parts[0][3], (), None
        return torch.cat([p[2] for p in parts]), torch.cat([p[3] for p in parts]), (), None
    k0_part = parts[0][2]
    shape = (readers[-1][1][1],) + tuple(k0_part.shape[1:])
    k_host = torch.empty(shape, dtype=k0_part.dtype, pin_memory=True)
    v_host = torch.empty(shape, dtype=k0_part.dtype, pin_memory=True)
    events = []
    for dev, (h0, h1), k_dev, v_dev in parts:
        k_host[h0:h1].copy_(k_dev, non_blocking=True)
        v_host[h0:h1].copy_(v_dev, non_blocking=True)
        events.append(_record(dev))
    return k_host, v_host, tuple(events), (parts, ids)


def readmit_run(paged: Any, layout, k_host: torch.Tensor, v_host: torch.Tensor, pages: list[int]) -> tuple:
    """The KV tier's readmit: each device's KV-head slice of the host run
    ``[K, L, n, page_size, head_dim]`` copied without blocking to every
    device whose pools hold those heads (each data replica, as a KV write's
    ``homes``) and into ``pages`` there in place (``index_copy_``: a pool is
    never rebound), on that card's current stream, ahead of what it issues
    next. Returns one event per card written, recorded after its copies:
    the host run must stay referenced until each has passed (none on the
    CPU)."""
    targets = pools_on(paged, layout)
    ids = _page_ids(pages, [dev for dev, _, _ in targets])
    events, nbytes = [], 0
    for dev, (h0, h1), pool in targets:
        for name, host in (("k", k_host), ("v", v_host)):
            part = host if (h0, h1) == (0, host.shape[0]) else host[h0:h1]
            pool[name].index_copy_(2, ids[dev], part if part.device == dev else part.to(dev, non_blocking=True))
            nbytes += _nbytes(part)
        if dev.type == "cuda":
            events.append(_record(dev))
    _add("tier_copies", len(targets), nbytes, "tier_bytes")
    return tuple(events)
