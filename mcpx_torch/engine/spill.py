"""Host-RAM spill tier for the radix prefix KV cache.

Port of ``mcpx/engine/spill.py``. The radix tree (engine/prefix_cache.py)
caps its device residency at half the paged pool, and eviction destroys
refcount-0 subtrees: a working set one page past the budget decays the
token hit rate to zero. With this tier an evicted subtree moves its KV page
runs into pinned host buffers instead of being freed, and a later prefix
match against a spilled run readmits it with one host-to-device page copy,
far cheaper than prefilling the run through the model again.

The budgets, the accounting, the chaos draws and every counter are the
reference's. What changes is how a copy is held, because the port's pools
are written in place (and captured CUDA graphs read them at their
addresses), where the reference's functional arrays give a snapshot for
free:

  - **Spill.** The engine's gather (``parallel.transfer.gather_run``)
    copies the run's pages out of the pools into a fresh device tensor (the
    snapshot no later pool write can touch), copies that into a pinned host
    tensor without blocking, and records an event after the copy on each
    card it read (on a mesh of cards, data coordinate 0's card of each
    KV-head span); the pages are freed at once, and any later write to them
    is ordered after the gather on that card's stream. Until every event
    has passed a run keeps the pinned tensor, the device gathers and the
    events (``HostRun``); ``poll()`` completes it by ``event.query()`` and
    never waits. ``drain()`` waits, at shutdown and for the snapshot only.
  - **Readmit.** The engine's readmit (``parallel.transfer.readmit_run``)
    copies the pinned run to each card whose pools hold its heads and into
    freshly allocated pages in place (never rebinding a pool), before the
    prefill that reads them; its own hold keeps the pinned source
    referenced until an event after the copy on every such card has
    passed.
  - **Bounds.** A pinned-host byte budget and a per-admission-cycle copy
    budget in tokens (both directions share it) cap what the tier moves;
    past them it degrades to destructive eviction, counted
    (``destructive_evictions``, ``denied_readmits``), and admission never
    waits on the tier.
  - **Single writer.** The engine's worker thread owns the tier as it owns
    the tree and the allocator; other threads read plain integer counters.
  - **Chaos.** A seeded ``SpillChaos`` profile injects host-allocation
    failures, copy-latency spikes and snapshot corruption, drawn from
    ``random.Random(seed)`` in the reference's call order, so a seeded
    profile gives the reference's counts.

A host run keeps the unmeshed layout whatever the mesh, so the budgets,
the accounting and the snapshots do not depend on it. On the CPU a run's
handles are plain CPU tensors, ready at once (no event).
The tier itself imports neither torch nor numpy at module level: the
engine binds the device copies, and the tests bind numpy stubs.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
import time
from typing import Any, Callable, Optional

from mcpx_torch.utils.ownership import owned_by

log = logging.getLogger("mcpx_torch.engine.spill")


class SpillChaos:
    """Seeded fault injector for the spill tier: deterministic per seed,
    rewindable by ``reseed()`` so a run can replay the same fault sequence
    against the tier configurations it compares.

    Profile keys (all optional):
      - ``seed``: RNG seed (default 7)
      - ``host_alloc_fail_p``: probability a spill's host allocation fails
        (the spill degrades to destructive eviction)
      - ``copy_delay_p`` / ``copy_delay_s``: probability and size of a
        copy-latency spike: the landed run stays unusable for
        ``copy_delay_s`` after its data lands, as a slow DMA would
      - ``snapshot_corrupt``: truncate the warm-restart snapshot at save
        time (the restore path must skip it, never crash)
    """

    def __init__(self, profile: dict, clock: Callable[[], float] = time.monotonic) -> None:
        if not isinstance(profile, dict):
            raise ValueError("spill chaos profile must be a JSON object")
        self.profile = dict(profile)
        self.seed = int(profile.get("seed", 7))
        self.host_alloc_fail_p = float(profile.get("host_alloc_fail_p", 0.0))
        self.copy_delay_p = float(profile.get("copy_delay_p", 0.0))
        self.copy_delay_s = float(profile.get("copy_delay_s", 0.0))
        self.snapshot_corrupt = bool(profile.get("snapshot_corrupt", False))
        for name in ("host_alloc_fail_p", "copy_delay_p"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"spill chaos {name}={p} not in [0, 1]")
        self._clock = clock
        self._rng = random.Random(self.seed)

    @classmethod
    def from_config(cls, spec: str) -> "SpillChaos":
        """Build from a config string: a path to a JSON profile, or inline
        JSON (starts with '{')."""
        text = spec
        if not spec.lstrip().startswith("{"):
            with open(spec) as f:
                text = f.read()
        return cls(json.loads(text))

    def reseed(self) -> None:
        self._rng = random.Random(self.seed)

    def host_alloc_fails(self) -> bool:
        return self.host_alloc_fail_p > 0 and self._rng.random() < self.host_alloc_fail_p

    def copy_ready_at(self) -> float:
        """Monotonic time before which a just-landed copy must not be used
        (0.0 = no spike)."""
        if self.copy_delay_p > 0 and self._rng.random() < self.copy_delay_p:
            return self._clock() + self.copy_delay_s
        return 0.0


@dataclasses.dataclass
class HostRun:
    """One spilled KV page run, ``[K, L, pages, page_size, hd]`` per pool.
    While the device-to-host copy is in flight ``ready`` is False, ``k``/``v``
    are the pinned host tensors the copy is filling, ``events`` were
    recorded after the copy, one on each card it read, and ``src`` holds the
    device gathers it reads; ``poll()`` drops the last two once every event
    has passed. ``ready_at`` delays usability past landing (chaos
    copy-latency spikes)."""

    k: Any
    v: Any
    n_tokens: int
    nbytes: int
    tenant: str
    ready: bool = False
    ready_at: float = 0.0
    events: tuple = ()
    src: Any = None


def nbytes_of(a: Any) -> int:
    """Bytes of a host buffer: a numpy array's ``nbytes`` or a tensor's
    elements times their size."""
    n = getattr(a, "nbytes", None)
    if isinstance(n, int):
        return n
    return int(a.numel()) * int(a.element_size())


def _own(a: Any) -> Any:
    """An independent copy of a page-axis slice, so it holds no reference
    to the buffer it was cut from (a view would keep the whole base alive
    and the host-byte accounting would be wrong). A pinned tensor's copy is
    pinned too, so its readmit stays an asynchronous copy."""
    if hasattr(a, "is_pinned"):
        if a.is_pinned():
            import torch

            out = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            out.copy_(a)
            return out
        return a.clone()
    return a.copy()


@owned_by("engine-worker")
class HostSpillTier:
    """Budgeted host-RAM tier under the radix tree. The tree keeps custody
    of its nodes; this class owns only the host buffers, the copies in
    flight, the budgets and the accounting. The device copies are bound by
    the engine through ``bind()``:

      - ``gather(pages) -> (k, v, events, src)``: the run's host tensors,
        the events after their copy, one for each card it read (none when
        they are ready at once), and what the copy reads (kept until every
        event passes);
      - ``readmit(k, v, pages)``: copy a landed run into ``pages``.
    """

    def __init__(
        self,
        *,
        host_bytes: int,
        copy_tokens_per_cycle: int = 0,
        bytes_per_token: int = 0,
        chaos: Optional[SpillChaos] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.host_bytes = max(0, int(host_bytes))
        self.copy_tokens_per_cycle = max(0, int(copy_tokens_per_cycle))
        # Budget-check estimate for a spill decision (the exact bytes are
        # known when the copy lands); the engine binds the true per-token
        # KV footprint at setup.
        self.bytes_per_token = max(1, int(bytes_per_token))
        self.chaos = chaos
        self._clock = clock
        self._gather: Optional[Callable] = None
        self._readmit: Optional[Callable] = None
        # Device-to-host copies in flight, (node, HostRun) in dispatch
        # order; each entry is polled on its own.
        self._pending: list[tuple[Any, HostRun]] = []
        # Counters other threads may read (plain ints).
        self.host_tokens = 0
        self.host_bytes_used = 0
        self.spills = 0
        self.readmits = 0
        self.readmit_tokens = 0
        self.host_evictions = 0
        self.destructive_evictions = 0
        self.denied_spills = 0
        self.denied_readmits = 0
        self.chaos_alloc_failures = 0
        self._cycle_tokens_left = self.copy_tokens_per_cycle or -1

    # ------------------------------------------------------------- binding
    def bind(self, gather: Callable, readmit: Callable, bytes_per_token: int) -> None:
        """Attach the engine's device copies (worker thread, at setup).
        Until bound, every spill degrades to destructive eviction, counted
        like any other overrun."""
        self._gather = gather
        self._readmit = readmit
        self.bytes_per_token = max(1, int(bytes_per_token))

    @property
    def bound(self) -> bool:
        return self._gather is not None

    # ------------------------------------------------------------- budgets
    @owned_by("engine-worker")
    def begin_cycle(self) -> None:
        """Reset the per-admission-cycle copy budget (worker, at the top of
        each admission pass)."""
        self._cycle_tokens_left = self.copy_tokens_per_cycle or -1

    def _take_cycle_tokens(self, n: int) -> bool:
        if self._cycle_tokens_left < 0:  # unlimited
            return True
        if self._cycle_tokens_left < n:
            return False
        self._cycle_tokens_left -= n
        return True

    def host_room(self, nbytes: int) -> bool:
        return self.host_bytes_used + nbytes <= self.host_bytes

    # --------------------------------------------------------------- spill
    @owned_by("engine-worker")
    def spill(self, node: Any, pages: list[int]) -> bool:
        """Start the device-to-host copy of ``node``'s page run and take
        host-budget custody of it. Returns False (the caller evicts
        destructively, counted) when the tier is unbound, the copy or host
        budget cannot afford the run, or chaos fails the host allocation.
        On True the caller frees the device pages at once: the gather has
        already copied them, ahead of any later write on the stream."""
        n = int(node_tokens(node))
        est = n * self.bytes_per_token
        if self._gather is None or not self.host_room(est):
            self.denied_spills += 1
            return False
        if not self._take_cycle_tokens(n):
            self.denied_spills += 1
            return False
        if self.chaos is not None and self.chaos.host_alloc_fails():
            self.chaos_alloc_failures += 1
            self.denied_spills += 1
            return False
        k_h, v_h, events, src = self._gather(pages)
        run = HostRun(k=k_h, v=v_h, n_tokens=n, nbytes=est, tenant=node.tenant, events=events, src=src)
        node.host = run
        self._pending.append((node, run))
        self.host_tokens += n
        self.host_bytes_used += est
        self.spills += 1
        return True

    @owned_by("engine-worker")
    def adopt(self, node: Any, k_host: Any, v_host: Any, tenant: str) -> bool:
        """Take custody of a run already in host memory (warm-restart
        snapshot load): no copy, only budget and accounting. Returns False
        when the host budget cannot afford it."""
        n = int(node_tokens(node))
        nbytes = nbytes_of(k_host) + nbytes_of(v_host)
        if not self.host_room(nbytes):
            self.denied_spills += 1
            return False
        node.host = HostRun(k=k_host, v=v_host, n_tokens=n, nbytes=nbytes, tenant=tenant, ready=True)
        self.host_tokens += n
        self.host_bytes_used += nbytes
        return True

    # ---------------------------------------------------------------- poll
    def _land(self, run: HostRun) -> None:
        run.k, run.v = self._trim(run, run.k, run.v)
        true_bytes = nbytes_of(run.k) + nbytes_of(run.v)
        self.host_bytes_used += true_bytes - run.nbytes
        run.nbytes = true_bytes
        run.events = ()
        run.src = None
        run.ready = True

    @owned_by("engine-worker")
    def poll(self) -> None:
        """Complete the device-to-host copies whose events have all passed
        (a non-blocking ``query()`` each; worker, once per iteration, a
        no-op when nothing is in flight). A chaos latency spike keeps a
        landed run unusable until ``ready_at``."""
        if not self._pending:
            return
        still: list[tuple[Any, HostRun]] = []
        for node, run in self._pending:
            if node.host is not run:
                continue  # dropped (host eviction or reset) while in flight
            if not all(e.query() for e in run.events):
                still.append((node, run))
                continue
            self._land(run)
            if self.chaos is not None:
                run.ready_at = self.chaos.copy_ready_at()
        self._pending = still

    @owned_by("engine-worker")
    def drain(self) -> None:
        """Wait for every copy in flight and complete it (shutdown and
        snapshot only: the worker is gone, nothing races)."""
        for node, run in self._pending:
            if node.host is not run:
                continue
            for e in run.events:
                e.synchronize()
            self._land(run)
            run.ready_at = 0.0
        self._pending = []

    @staticmethod
    def _trim(run: HostRun, k: Any, v: Any) -> tuple:
        """A landed run holds ``ceil(n_tokens / page_size)`` pages (page axis
        2, tokens per page on axis 3): any page past that is cut off, by a
        copy, so the cut base is freed. The port's gathers copy exactly the
        run's pages, so this cuts only a run longer than its tokens."""
        psz = max(1, int(k.shape[3]))
        real = max(1, -(-run.n_tokens // psz))
        if k.shape[2] > real:
            k = _own(k[:, :, :real])
            v = _own(v[:, :, :real])
        return k, v

    # -------------------------------------------------------------- readmit
    def readmit_usable(self, node: Any) -> bool:
        """Whether ``node``'s spilled run could serve a match now (landed,
        past any chaos delay). Read-only."""
        run = node.host
        return run is not None and run.ready and (run.ready_at <= 0.0 or self._clock() >= run.ready_at)

    @owned_by("engine-worker")
    def readmit(self, node: Any, pages: list[int]) -> bool:
        """Copy ``node``'s run into the freshly allocated ``pages`` and
        release host custody. Returns False (the caller leaves the node
        spilled and the match ends there) when the run is not usable yet or
        the cycle's copy budget is spent."""
        run = node.host
        if run is None or self._readmit is None or not self.readmit_usable(node):
            self.denied_readmits += 1
            return False
        if not self._take_cycle_tokens(run.n_tokens):
            self.denied_readmits += 1
            return False
        self._readmit(run.k, run.v, pages)
        self.host_tokens -= run.n_tokens
        self.host_bytes_used -= run.nbytes
        self.readmits += 1
        self.readmit_tokens += run.n_tokens
        node.host = None
        return True

    @owned_by("engine-worker")
    def split_host(self, child: Any, mid: Any, head_pages: int, head_tokens: int) -> None:
        """Split ``child``'s landed host run at ``head_pages`` pages /
        ``head_tokens`` tokens: ``mid`` takes the head, ``child`` keeps the
        tail. Each half is its own copy (``_own``), so its lifetime and the
        byte accounting are independent of the original buffer."""
        run = child.host
        k_head, v_head = _own(run.k[:, :, :head_pages]), _own(run.v[:, :, :head_pages])
        k_tail, v_tail = _own(run.k[:, :, head_pages:]), _own(run.v[:, :, head_pages:])
        mid.host = HostRun(
            k=k_head, v=v_head, n_tokens=head_tokens, nbytes=nbytes_of(k_head) + nbytes_of(v_head),
            tenant=run.tenant, ready=True, ready_at=run.ready_at,
        )
        child.host = HostRun(
            k=k_tail, v=v_tail, n_tokens=run.n_tokens - head_tokens,
            nbytes=nbytes_of(k_tail) + nbytes_of(v_tail),
            tenant=run.tenant, ready=True, ready_at=run.ready_at,
        )
        self.host_bytes_used += mid.host.nbytes + child.host.nbytes - run.nbytes

    # ------------------------------------------------------------- reclaim
    @owned_by("engine-worker")
    def drop_host(self, node: Any) -> None:
        """Release host custody of a spilled run (host-tier eviction,
        destructive subtree drop, reset). An entry in flight is skipped by
        poll() once the node no longer owns the run."""
        run = node.host
        if run is None:
            return
        self.host_tokens -= run.n_tokens
        self.host_bytes_used -= run.nbytes
        node.host = None

    @owned_by("engine-worker")
    def reset(self) -> None:
        """Drop everything, copies in flight included (tree reset,
        shutdown): device and host buffers are released, the accounting
        returns to zero."""
        for node, run in self._pending:
            if node.host is run:
                node.host = None
        self._pending.clear()
        self.host_tokens = 0
        self.host_bytes_used = 0

    # --------------------------------------------------------------- stats
    def pending_copies(self) -> int:
        return len(self._pending)

    def stats(self) -> dict:
        """Counter snapshot (plain int reads; safe from any thread)."""
        return {
            "host_tokens": self.host_tokens,
            "host_bytes": self.host_bytes_used,
            "host_bytes_budget": self.host_bytes,
            "pending_copies": len(self._pending),
            "spills": self.spills,
            "readmits": self.readmits,
            "readmit_tokens": self.readmit_tokens,
            "host_evictions": self.host_evictions,
            "destructive_evictions": self.destructive_evictions,
            "denied_spills": self.denied_spills,
            "denied_readmits": self.denied_readmits,
            "chaos_alloc_failures": self.chaos_alloc_failures,
        }


def node_tokens(node: Any) -> int:
    return len(node.tokens)
