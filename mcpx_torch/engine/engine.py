"""InferenceEngine: continuously batched, grammar-constrained generation on
the GPU.

A small PyTorch counterpart of ``mcpx/engine/engine.py`` with the surface the
LLM planner uses (``start``/``aclose``, ``tokenizer``, ``generate``,
``prompt_capacity``) and both of the reference's slabs:

  - requests funnel through a thread-safe queue into one worker thread that
    owns a slab of ``max_batch_size`` decode rows;
  - admission takes a cohort into free rows. The homogeneous slab (the
    default) admits requests compatible with the slab (same constrained
    flag, temperature and grammar object); the heterogeneous slab
    (``engine.hetero_batch``) admits in strict queue order, each row with
    its own temperature, constrained flag and grammar slot. With the radix
    prefix cache on (``engine.prefix_cache``, the default) each prompt is
    matched against the tree of resident prompt heads: the matched pages
    are pinned and put first in the row's page table, and a cohort with any
    match prefills only its suffixes in one ``decode_chunk_paged`` call at
    prefill width (the ragged kernel with per-row start offsets). A cohort
    with no match takes a dense prefill of the padded prompts and a scatter
    of its K/V into the page pools. The page-aligned rest of every prompt
    is inserted into the tree for the next request sharing it. Then comes
    the first sample under the budget mask;
  - decode runs in segments of up to ``steps_per_dispatch`` windows of
    ``decode_steps_per_tick`` forwards each. Every forward is one
    ``decode_chunk_paged`` call over the whole slab.
    ``q_lens`` carries each row's live width, so decode, drafted, forced and
    idle rows (``q_lens = 0``) share one kernel launch. Four bodies fill the
    window:
      * prompt drafting (homogeneous, ``draft_mode="prompt"``, the default;
        constrained greedy rows): after the last (prev, cur) bigram match in
        the row's own prompt suffix, the prompt's continuation is proposed
        wherever the grammar does not force the token. The forward returns
        logits over the grammar's active columns at every window slot
        (compact unembed), and the proposals are verified against the
        budget-masked greedy argmax: the accepted prefix plus one correction
        token are emitted, exactly what one-token greedy decode would emit;
      * fast-forward (homogeneous otherwise): the sampled token plus the
        chain of grammar-forced tokens after it;
      * the heterogeneous fast-forward: the same per row, through the row's
        slot of the stacked grammar tables, with per-row temperature (every
        row draws compact-column and full-vocabulary; a select keeps the one
        that applies);
      * speculative (heterogeneous, ``engine.speculative``): the recurrent
        drafter (``engine/speculative.py``) proposes K tokens a row through
        its grammar, one ``[B, K+1]`` verify forward samples every position,
        and the longest draft prefix the samples reproduce is accepted with
        the first mismatch as the correction. A speculative segment is one
        window of ``decode_steps_per_tick`` forwards;
  - a window is one function over fixed device state (``_window``): on
    CUDA it is captured once per key into a CUDA graph and replayed, so a
    window costs one host call; on the CPU the same function runs eagerly.
    The key holds what the graph bakes in: the body, the temperature class
    (per-row temperature is data, so no heterogeneous key holds one), the
    window width, the batch, the grammar-table shape and the forwards. A
    captured window runs all its forwards, rows that are done idling at
    ``q_lens = 0``; ``captures`` in ``queue_stats()`` counts the captures
    made while serving, as the reference counts compiles;
  - segments are pipelined (``pipeline_depth``): a segment is enqueued with
    no blocking call inside it. Its early exit reads an all-done flag one
    window late (copied to a pinned host slot without blocking, outside the
    graph), so a segment runs at most ``2 * decode_steps_per_tick - 1``
    forwards in which every row is idle. At its end the
    segment's flags, emitted counts and output buffer are packed into that
    segment's own host buffer by one copy without blocking; the harvest
    waits on the oldest segment only once ``pipeline_depth`` are in flight,
    and retires only rows whose generation counter still matches the
    segment's snapshot (a row released and re-admitted since is left to its
    new request);
  - between segments the worker retires finished rows and admits new ones.
    Every write to slab state is an operation on the device's stream, and
    uploads go through fresh pinned blocks, so a queued segment always
    reads the state its dispatch saw.

The slab latches its batching mode and speculation settings when it refills
from empty: a live flip of ``hetero_batch`` or ``speculative`` pauses
admission until the rows admitted under the old mode drain.

Telemetry, at the reference's sites and names: the ``mcpx_engine_*`` and
``mcpx_kv_prefix_*`` metrics (``metrics``, shared with the control plane),
the worker thread's ``engine.queue_wait`` / ``engine.prefill`` /
``engine.segment`` / ``engine.decode`` spans under the request's
``engine.generate`` span (explicit timestamps, no contextvar crosses the
thread), the cost registry (``costs``: analytic FLOPs and bytes per
executable, and the capture sentinel), the worker-loop profiler
(``telemetry.flight.profile_worker``, attachable live) and the cost ledger
(``telemetry.ledger``, switchable live): the slab's per-row accumulators
bill each request its suffix tokens, matched prefix, forwards, accepted
speculative tokens, readmit copies, page-seconds and integer shares of the
executed FLOPs and bytes (an admission's over its cohort, a segment's over
the rows resident at its dispatch), returned as ``GenerateResult.bill``.
Every metric, span and bill item reads host values the worker already
holds (the per-row accepted tokens ride the segment's one packed copy,
ledger on or off): telemetry adds no device synchronisation and nothing
that changes a captured window.

The tiered KV cache (``engine.kv_tier``, off by default): a host spill
tier (``engine/spill.py``) and per-tenant governance
(``engine/cache_governor.py``) under the radix tree, and a warm-restart
snapshot. Eviction spills a victim run's pages to pinned host memory (a
gather into a fresh device tensor, then a copy to the host completed by an
event the worker polls, never waits on); a match against a spilled run
copies it back into fresh pages in place, before the prefill that reads
them. Both copies run on the worker's stream, so device order protects the
pages, and neither rebinds a pool. On a mesh of cards
(``parallel.transfer.gather_run``/``readmit_run``) the gather reads each
KV-head span from data coordinate 0's card into its slice of one host run
in the unmeshed layout, and the readmit writes each span into every data
replica of it, on each card's stream; a run lands once every card's copy
has passed. A clean ``aclose`` writes the resident
and spilled runs, the declared heads and the governor's weights to
``snapshot_path``; the next engine restores them as spilled nodes (or, when
its weights differ, the declared heads as ids to rebuild on first use).
With the tier off the tree is the single-tier one, byte for byte.

``model.quantize="int8"`` serves weight-only int8 (``models/gemma/
quant.py``): int8 weights with f32 per-channel scales, each layer
dequantized inside the forwards' layer loop (in the captured windows too,
whose dequantized temporaries come from the graph's pool), the embedding
gathered and the unembedding scaled per row; the KV pools stay in the
model's dtype, so attention still goes through the ragged kernel.

The mesh (``parallel/mesh.py``): ``mesh=None`` builds ``_mesh_axes`` over
the engine's one device (1 x 1, as the reference on one chip), or, with
``engine.data_axis`` or ``model_axis`` explicit on CUDA, over the visible
cards, the engine's own first. An injected mesh is a virtual mesh (one
device at every coordinate) or a distinct card at each, its first
coordinate the engine's device (the control card: the slab, page tables and
sampler live there). On it the engine serves TP/DP as the reference's
per-coordinate program (``parallel.mesh.ServeLayout``, ``_layout``): the
weights are laid out shard-major (``params.shard_major``; on cards each
card holds its shard's blocks, ``params.on_cards``), and every forward it
dispatches (dense and suffix prefill, the decode windows, drafting, verify,
and the projections around ring prefill) runs each row block over ``data``
at its data coordinate, each model shard projecting its heads on its card,
launching the ragged kernel over them against its card's KV-head pools, and
its partial outputs after ``wo`` and ``w_down`` summed with the others' in
shard order; the logits are joined in vocabulary order on the control card
before the grammar mask and the sampler read them. What crosses between
coordinates goes through ``parallel/transfer.py`` (each KV write mirrored to
every data replica of its heads); on a virtual mesh every copy is the tensor
itself. A forward so launches the kernel ``n_layers`` times per attention
shard and row block. Captured windows key on the layout; on a mesh of cards
the windows run eagerly (``queue_stats()["eager_windows"]``: a CUDA graph
captures one card's stream). The cost registry
bills the whole mesh's work once (``forward_cost`` from the model's
shapes), and the span rooflines' peaks count the mesh's distinct devices,
not its coordinates: one card's on a virtual mesh.
Long-prompt ring prefill (``engine.ring_prefill_min_tokens``): a full
prefill whose bucket reaches the threshold and divides the seq axis runs
``parallel.ring_attention.ring_prefill`` over ``_seq_mesh`` (an injected
seq axis, else the data devices viewed as one), eagerly as dense prefill
runs; ``metrics.ring_prefills`` counts the serving ones.

The device is explicit: ``device=None`` means CUDA and raises when CUDA is
absent; tests pass ``device="cpu"``. The tensors' device decides the
attention route (kernel on CUDA, plain version on the CPU); the engine reads
neither ``engine.use_pallas`` nor ``engine.interpret``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import math
import os
import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional

import numpy as np
import torch

from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.errors import EngineError
from mcpx_torch.device import resolve_device
from mcpx_torch.engine.kernels.paged_attention import (
    captured_designs,
    captured_launches,
    count_into,
    count_replay,
    hold_tickets,
    kernel_launches,
    release_tickets,
    ticket_count,
)
from mcpx_torch.engine.cache_governor import CacheGovernor
from mcpx_torch.engine.kv_cache import PageAllocator, commit_prefill_to_pages, init_paged_kv
from mcpx_torch.engine.paged_decode import decode_chunk_paged
from mcpx_torch.engine.prefix_cache import PrefixNode, RadixPrefixCache
from mcpx_torch.engine.sampling import (
    NEG_INF,
    accept_rows,
    exponential_noise,
    sample,
    sample_rows,
    sample_window_rows,
)
from mcpx_torch.engine.speculative import advance_drafter_state, draft_window
from mcpx_torch.engine.spill import HostSpillTier, SpillChaos, nbytes_of
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import init_kv_cache, prefill, torch_dtype, whole_embed
from mcpx_torch.models.gemma.params import leaf_blocks, load_or_init
from mcpx_torch.models.tokenizer import make_tokenizer
from mcpx_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    ServeLayout,
    canonical,
    make_mesh,
    serve_layout,
    serving_devices,
)
from mcpx_torch.parallel.ring_attention import ring_prefill
from mcpx_torch.parallel.transfer import gather_run, join_streams, pools_on, readmit_run
from mcpx_torch.planner.grammar import (
    _DIST_INF,
    PlanGrammar,
    _col_bucket,
    build_plan_grammar,
    build_trivial_grammar,
    stack_shape,
)
from mcpx_torch.scheduler.admission import ewma_update
from mcpx_torch.scheduler.locality import locality_order
from mcpx_torch.telemetry import ledger as ledger_mod
from mcpx_torch.telemetry import tracing
from mcpx_torch.telemetry.costs import (
    CostRegistry,
    device_peaks,
    forward_cost,
    rounded_roofline,
    spill_copy_cost,
    window_cost,
)
from mcpx_torch.telemetry.flight import WorkerProfiler
from mcpx_torch.telemetry.metrics import Metrics
from mcpx_torch.utils.ownership import owned_by

log = logging.getLogger("mcpx_torch.engine")

# One engine's device work at a time in the process. Engines in one process
# (a replica pool) each run a worker thread; every worker iteration's device
# work, its setup and shutdown, and every CUDA-graph capture hold this lock.
# The card runs their kernels on one stream in turn anyway. Two engines
# capturing at once no longer need it (captures take ``_CAPTURE_LOCK``).
# Two 2b engines serving without it gave the locked runs' token streams in
# 20 of 20 full runs of the card test file since that test waits for an
# idle engine (one earlier run differed, cause unknown); that does not show
# they serve correctly without it, nor whether they would serve faster
# (ROADMAP Queue C and P9). Re-entrant: a capture happens inside an
# iteration.
DEVICE_LOCK = threading.RLock()

# One CUDA-graph capture at a time in the process, held from capture_begin
# to capture_end: a capture's launch record (``captured_launches``) counts
# what every thread records into graphs, and PyTorch's default CUDA
# generator, registered with every graph, keeps one capture state.
_CAPTURE_LOCK = threading.Lock()

# Capturing streams of closed engines, for the next engines to take: PyTorch
# keeps a 32 MiB cuBLAS workspace for every (handle, stream) a thread has run
# a product on, so a new stream for every engine (a pool's every rejoin)
# would add one each time.
_SPARE_STREAMS: list = []  # mcpx: owner[DEVICE_LOCK]


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The most recently closed engine's capturing stream on ``device``, or
    a new one."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with DEVICE_LOCK:
        for i in reversed(range(len(_SPARE_STREAMS))):
            if _SPARE_STREAMS[i].device.index == index:
                return _SPARE_STREAMS.pop(i)
    return torch.cuda.Stream(device)


@dataclasses.dataclass
class GenerateRequest:  # mcpx: request-payload
    prompt_ids: list[int]
    max_new_tokens: int
    constrained: bool
    temperature: float
    future: "asyncio.Future[GenerateResult]"
    loop: asyncio.AbstractEventLoop
    enqueued_at: float
    # Grammar to constrain with (None = the engine's generic plan grammar).
    # Requests sharing a grammar OBJECT share the slab.
    grammar: Optional[PlanGrammar] = None
    # The first `shared_prefix_len` prompt ids are common to many requests
    # (the planner's fixed header): with the prefix cache on, the engine
    # builds that head into the radix tree before the cohort prefills, so
    # even the first cohort shares it. Matching itself is per request
    # against the whole tree. 0 disables the hint.
    shared_prefix_len: int = 0
    # EDF deadline (time.monotonic) from the serving scheduler: the
    # locality sort never regroups a request that cannot afford the wait.
    deadline_at: Optional[float] = None
    # Tenant of the request (cache governance): radix-tree insertions are
    # charged to it, and its weighted-fair quota bounds its resident KV.
    tenant: str = "default"
    # Tracing parent (telemetry/tracing.Span): the worker thread hangs the
    # queue-wait / prefill / per-segment decode child spans off it with
    # explicit timestamps. None (tracing off, no active trace) keeps the
    # decode hot path free of tracing work.
    span: Optional[Any] = None

    def prefix_key(self, page_size: int) -> Optional[tuple]:
        """Page-aligned shared prefix as the cache key (None = no sharing).
        Alignment truncates, and at least one token stays in the suffix
        (the engine samples from the suffix prefill's last logit)."""
        n = min(self.shared_prefix_len, len(self.prompt_ids) - 1)
        n = (n // page_size) * page_size
        if n < page_size:
            return None
        return tuple(self.prompt_ids[:n])


@dataclasses.dataclass
class _PinPrefixOp:
    """Worker-queue op: pin the deepest resident radix node whose path
    prefixes ``ids``; resolves ``future`` with the node, or None when
    nothing is resident. The worker applies it between segments."""

    ids: list[int]
    future: "asyncio.Future[Optional[PrefixNode]]"
    loop: asyncio.AbstractEventLoop


@dataclasses.dataclass
class _UnpinPrefixOp:
    """Worker-queue op: release a ``_PinPrefixOp`` pin."""

    node: PrefixNode


@dataclasses.dataclass
class _DropUnpinnedOp:
    """Worker-queue op: evict every radix run no row or caller pins;
    resolves ``future`` with the nodes left."""

    future: "asyncio.Future[int]"
    loop: asyncio.AbstractEventLoop


@dataclasses.dataclass
class GenerateResult:
    token_ids: list[int]
    text: str
    prompt_tokens: int
    generated_tokens: int
    queue_ms: float
    prefill_ms: float
    decode_ms: float
    # The engine's part of the request's cost-ledger bill
    # (telemetry/ledger.py): a fresh dict built by the worker at retirement,
    # handed across the thread by value and folded into the request's bill
    # by generate(). None while telemetry.ledger is off.
    bill: Optional[dict] = None


# The engine's lifecycle: the legal transitions out of each state.
_ENGINE_STATES: dict[str, tuple[str, ...]] = {
    "cold": ("warming",),
    "warming": ("ready", "failed", "closed"),
    "ready": ("closed",),
    "failed": ("closed",),
    "closed": (),
}


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise EngineError(f"length {n} exceeds largest bucket {buckets[-1]}")


@owned_by("engine-worker")
class _Slab:
    """The persistent decode batch. Host side: the request and page
    bookkeeping per row, and ``gen``, each row's generation counter, bumped
    at every admission and release (an in-flight segment's snapshot of it
    keeps a lagged done flag off the row's next request). Device side
    (``dev``): cur, pos, st, emitted, done, budgets, page_table, out_buf
    and the draft state (``prompt_toks`` [B, prompt_cap] and
    ``prompt_lens``: the row's prompt suffix; ``prev``: the token before
    ``cur``), the heterogeneous slab's per-row ``temp``, ``cons``, ``dfa``
    and ``hstate`` (the drafter's state), plus the segment's counters
    (``counts``: live forwards, drafted and accepted tokens, and the
    drafted and accepted tokens of constrained rows; ``acc_rows``: the
    accepted speculative tokens of each row) and the last window's
    all-done flag (``all_done``). Every one is a fixed buffer for the slab's
    lifetime, since captured windows read and write them at their
    addresses: it is written in place (windows by ``copy_``, admission and
    release by indexed writes), only by the worker thread, always by
    operations on the device's stream. ``out_buf`` has one spare column past ``steps``:
    scatters route slots they must drop there, so no write ever wraps into
    a live slot."""

    def __init__(
        self, B: int, steps: int, pmax: int, pad_id: int, prompt_cap: int, draft_dim: int, device
    ) -> None:
        self.B = B
        self.steps = steps
        self.prompt_cap = max(2, prompt_cap)
        self.req: list[Optional[GenerateRequest]] = [None] * B
        self.sid: list[Optional[tuple]] = [None] * B
        self.gen = np.zeros((B,), np.int64)
        # Radix nodes each row pins (its matched and inserted runs) and its
        # matched depth in tokens; released with the row.
        self.prefix: list[tuple] = [()] * B
        self.prefix_toks = np.zeros((B,), np.int64)
        self.queue_ms = np.zeros((B,), np.float64)
        self.prefill_ms = np.zeros((B,), np.float64)
        self.t_decode0 = np.zeros((B,), np.float64)
        # Traced rows only: tokens emitted as of the last harvest (the
        # segment span's delta), the decode cost totals and the worker
        # profile's phase totals at admission (the decode span's residency
        # roofline and breakdown). n_traced counts the resident rows whose
        # request carries a span: 0 keeps every tracing branch off.
        self.emitted = np.zeros((B,), np.int64)
        self.cost0 = np.zeros((B, 3), np.float64)
        self.prof0: list[Optional[dict]] = [None] * B
        self.n_traced = 0
        # Per-row cost-ledger accumulators (telemetry/ledger.py), written
        # only while the ledger is on and cleared with the row; the
        # retirement bill reads them. FLOPs and bytes hold whole numbers
        # (integer shares of the executed costs).
        self.bill_flops = np.zeros((B,), np.float64)
        self.bill_bytes = np.zeros((B,), np.float64)
        self.bill_fwd = np.zeros((B,), np.int64)     # live forwards while resident
        self.bill_spec = np.zeros((B,), np.int64)    # accepted speculative tokens
        self.bill_copy = np.zeros((B,), np.int64)    # readmit copy tokens
        self.bill_pages = np.zeros((B,), np.int32)   # row-private KV pages
        self.suffix_toks = np.zeros((B,), np.int32)  # suffix tokens prefilled
        self.admit_t = np.zeros((B,), np.float64)    # admission time (0: unbilled)
        # The homogeneous slab's compatibility triple (reset when empty).
        self.constrained = True
        self.temperature = 0.0
        self.grammar: Optional[PlanGrammar] = None
        # Host mirror of each row's grammar slot (heterogeneous slab; slot 0
        # = the trivial grammar of free rows): its reference is dropped at
        # release.
        self.dfa = np.zeros((B,), np.int64)
        # The batching mode and speculation settings the current occupancy
        # was admitted under, latched when the slab refills from empty: the
        # rows carry that mode's page slack and decode under it, so a live
        # flip waits for them to drain. Dispatch reads these, never the
        # live config.
        self.hetero = False
        self.spec = False
        self.spec_k = 0
        self.spec_draft = "recurrent"
        i64 = dict(dtype=torch.int64, device=device)
        self.dev = {
            "cur": torch.full((B,), pad_id, **i64),
            "pos": torch.zeros((B,), **i64),
            "st": torch.zeros((B,), **i64),
            "emitted": torch.zeros((B,), **i64),
            "done": torch.ones((B,), dtype=torch.bool, device=device),
            "budgets": torch.zeros((B,), **i64),
            "page_table": torch.zeros((B, pmax), dtype=torch.int32, device=device),
            "out_buf": torch.full((B, steps + 1), pad_id, **i64),
            "prompt_toks": torch.full((B, self.prompt_cap), pad_id, **i64),
            "prompt_lens": torch.zeros((B,), **i64),
            "prev": torch.full((B,), pad_id, **i64),
            # Per-row sampling config of the heterogeneous slab:
            # temperature, constrained flag, grammar slot; and the recurrent
            # drafter's state (zeros for a fresh row).
            "temp": torch.zeros((B,), dtype=torch.float32, device=device),
            "cons": torch.zeros((B,), dtype=torch.bool, device=device),
            "dfa": torch.zeros((B,), **i64),
            "hstate": torch.zeros((B, max(1, draft_dim)), dtype=torch.float32, device=device),
            "counts": torch.zeros((5,), **i64),
            # The segment's accepted speculative tokens per row: written by
            # the speculative body whether the ledger is on or off, so a
            # live flip of the ledger changes nothing a captured window
            # writes; harvested in the segment's one packed copy.
            "acc_rows": torch.zeros((B,), **i64),
            "all_done": torch.ones((), dtype=torch.bool, device=device),
        }

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.req)

    def free_rows(self) -> list[int]:
        return [i for i, r in enumerate(self.req) if r is None]

    def compatible(self, r: GenerateRequest) -> bool:
        return (
            r.constrained == self.constrained
            and r.temperature == self.temperature
            and (not r.constrained or r.grammar is self.grammar)
        )


# The slab state a window advances, in the order the bodies take and return it.
_STATE = ("cur", "pos", "st", "emitted", "done", "prev")


class _Tables:
    """One pad bucket's grammar tables on the device: ``trans`` [S, C]
    int32, ``mask`` [S, C] bool, ``dist`` [S] int32, ``ids`` [C] and
    ``eos`` [C] (token id and EOS flag per compact column) and ``inv`` [V]
    (token id to column, -1 where active nowhere). Fixed buffers for the
    engine's lifetime, so one captured window serves every grammar of the
    bucket: ``load`` copies a grammar in, as stream operations. The rows
    past the loaded grammar's states are never indexed (every state a
    grammar's tables name is below its state count); the rows it covers,
    and those the last grammar covered, hold the reference's padding
    (transitions to the dead state, mask False, distance infinite)."""

    def __init__(self, S: int, C: int, vocab: int, device) -> None:
        self.trans = torch.empty((S, C), dtype=torch.int32, device=device)
        self.mask = torch.empty((S, C), dtype=torch.bool, device=device)
        self.dist = torch.empty((S,), dtype=torch.int32, device=device)
        self.ids = torch.empty((C,), dtype=torch.int64, device=device)
        self.eos = torch.empty((C,), dtype=torch.bool, device=device)
        self.inv = torch.empty((vocab,), dtype=torch.int64, device=device)
        self.grammar: Optional[PlanGrammar] = None
        self.rows = 0  # state rows the last load wrote

    @property
    def dfa(self) -> tuple:
        return self.trans, self.mask, self.dist, self.ids, self.eos, self.inv

    def load(self, grammar: PlanGrammar, upload_into) -> None:
        """Copy ``grammar``'s compact tables in: the rows either grammar
        covers reset to padding, then its own block on top."""
        n, c = grammar.ctrans.shape
        C, V = self.ids.shape[0], self.inv.shape[0]
        rows = max(n, self.rows)
        self.trans[:rows].fill_(grammar.cdead)
        self.mask[:rows].fill_(False)
        self.dist[:rows].fill_(_DIST_INF)
        upload_into(self.trans[:n, :c], grammar.ctrans)
        upload_into(self.mask[:n, :c], grammar.cmask)
        upload_into(self.dist[:n], grammar.dist)
        ids = np.full((C,), grammar.tokenizer.pad_id, np.int64)
        ids[:c] = grammar.active_ids
        eos = np.zeros((C,), bool)
        eos[:c] = grammar.eos_cols
        inv = np.full((V,), -1, np.int64)
        inv[grammar.active_ids] = np.arange(c)
        upload_into(self.ids, ids)
        upload_into(self.eos, eos)
        upload_into(self.inv, inv)
        self.grammar = grammar
        self.rows = n


class _Stack:
    """The heterogeneous slab's grammar tables on the device, one slot per
    resident grammar (slot 0: the trivial grammar of free rows), padded to
    one shape: ``trans`` [G, S, C] int32, ``mask`` [G, S, C] bool, ``dist``
    [G, S] int32, ``ids`` and ``eos`` [G, C] (token id and EOS flag per
    column) and, once speculation is armed, ``dist_succ`` [G, S, C] int32
    (the distance after each transition) and ``inv`` [G, V] (token id to
    column, -1 where inactive): ``planner/grammar.py``'s ``stacked_tables``
    and ``stacked_spec_tables``, laid out on the card. Fixed buffers for the
    engine's lifetime, as ``_Tables`` are: a slot that changes owner is
    rewritten in place by stream operations, and no other slot is
    touched."""

    def __init__(self, G: int, S: int, C: int, vocab: int, device) -> None:
        self.trans = torch.empty((G, S, C), dtype=torch.int32, device=device)
        self.mask = torch.empty((G, S, C), dtype=torch.bool, device=device)
        self.dist = torch.empty((G, S), dtype=torch.int32, device=device)
        self.ids = torch.empty((G, C), dtype=torch.int64, device=device)
        self.eos = torch.empty((G, C), dtype=torch.bool, device=device)
        self.dist_succ: Optional[torch.Tensor] = None
        self.inv: Optional[torch.Tensor] = None
        self.vocab = vocab
        self.grammars: list[Optional[PlanGrammar]] = [None] * G  # what each slot holds

    @property
    def shape(self) -> tuple:
        return tuple(self.trans.shape)

    @property
    def dfa(self) -> tuple:
        return self.trans, self.mask, self.dist, self.ids, self.eos

    @property
    def spec_dfa(self) -> tuple:
        return self.dfa + (self.dist_succ, self.inv)

    def load(self, k: int, grammar: PlanGrammar, upload_into, resident: "Optional[_Tables]") -> None:
        """Write ``grammar`` into slot ``k``: the slot reset to padding, then
        the grammar's block, copied on the card from ``resident`` (its
        ``_Tables``, where it is loaded) or uploaded from the host."""
        n, c = grammar.ctrans.shape
        C = self.ids.shape[1]
        self.trans[k].fill_(grammar.cdead)
        self.mask[k].fill_(False)
        self.dist[k].fill_(_DIST_INF)
        if resident is not None:
            self.trans[k, :n, :c].copy_(resident.trans[:n, :c])
            self.mask[k, :n, :c].copy_(resident.mask[:n, :c])
            self.dist[k, :n].copy_(resident.dist[:n])
        else:
            upload_into(self.trans[k, :n, :c], grammar.ctrans)
            upload_into(self.mask[k, :n, :c], grammar.cmask)
            upload_into(self.dist[k, :n], grammar.dist)
        ids = np.full((C,), grammar.tokenizer.pad_id, np.int64)
        ids[:c] = grammar.active_ids
        eos = np.zeros((C,), bool)
        eos[:c] = grammar.eos_cols
        upload_into(self.ids[k], ids)
        upload_into(self.eos[k], eos)
        self.grammars[k] = grammar
        if self.dist_succ is not None:
            self._load_spec(k, grammar, upload_into)

    def arm_spec(self, upload_into) -> None:
        """Allocate the speculative companions (once) and fill them for every
        loaded slot."""
        if self.dist_succ is not None:
            return
        G, S, C = self.shape
        self.dist_succ = torch.empty((G, S, C), dtype=torch.int32, device=self.trans.device)
        self.inv = torch.empty((G, self.vocab), dtype=torch.int64, device=self.trans.device)
        for k, g in enumerate(self.grammars):
            if g is not None:
                self._load_spec(k, g, upload_into)

    def _load_spec(self, k: int, grammar: PlanGrammar, upload_into) -> None:
        # dist_succ[k][s, c] = dist[k][trans[k][s, c]], gathered on the card.
        torch.index_select(self.dist[k], 0, self.trans[k].reshape(-1), out=self.dist_succ[k].reshape(-1))
        inv = np.full((self.vocab,), -1, np.int64)
        inv[grammar.active_ids] = np.arange(grammar.n_active)
        upload_into(self.inv[k], inv)


@dataclasses.dataclass
class _Inflight:
    """A dispatched segment awaiting harvest: its end state packed into a
    host buffer of its own (``out_buf`` rows, then emitted, then done, then
    the segment's ``counts``, then ``acc_rows``), the event after that copy
    (None on the CPU, where the copy is done when issued), the slab's
    generation counters at dispatch, whether it was speculative (its
    drafted and accepted counts feed the ``mcpx_engine_spec_*`` series),
    the forwards it dispatched, and for segments with a traced row the
    dispatch time and the segment's cost (FLOPs, bytes)."""

    host: torch.Tensor
    event: Optional["torch.cuda.Event"]
    gen: np.ndarray
    spec: bool = False
    forwards: int = 0
    t_disp: float = 0.0
    cost: Optional[tuple[float, float]] = None


# Host slots of the windows' all-done flags: the flag of window n is read
# before window n + 2 is issued, so four slots are never overwritten early.
FLAG_SLOTS = 4


class InferenceEngine:
    def __init__(
        self,
        config: Optional[MCPXConfig] = None,
        model_cfg: Optional[GemmaConfig] = None,
        *,
        device: "torch.device | str | None" = None,
        metrics: Optional[Metrics] = None,
        mesh=None,
    ) -> None:
        self.config = config or MCPXConfig()
        ecfg = self.config.engine
        # Weight-only int8 (models/gemma/quant.py): the forwards dequantize
        # one layer at a time; the costs bill one byte a weight.
        self._quantized = self.config.model.quantize == "int8"
        self.device = resolve_device(device)
        if mesh is not None:
            serving_devices(mesh)
            first = canonical(mesh.devices.flat[0])
            if first != canonical(self.device):
                raise EngineError(f"{mesh}: the mesh's first coordinate, {first}, is not the engine's device "
                                  f"({self.device}), where its slab and sampler live")
        # The serving mesh (built in _setup when not injected), its seq
        # view for ring prefill (None: every full prefill is dense) and the
        # layout every forward runs on (None: nothing splits on the mesh).
        self._mesh = mesh
        self._seq_mesh = None
        self._layout: Optional[ServeLayout] = None  # mcpx: owner[engine-worker]
        # On a mesh of several cards the decode windows run eagerly (chosen
        # in _setup from the mesh: a CUDA graph captures one card's
        # stream), and the drafter's [V, D] embedding is joined on the
        # control card at its first use.
        self._eager_windows = False  # mcpx: owner[engine-worker]
        self._draft_embed = None  # mcpx: owner[engine-worker]
        self.tokenizer = make_tokenizer(self.config.model.vocab)
        self.model_cfg = model_cfg or GemmaConfig.named(
            self.config.model.size,
            max_seq_len=self.config.model.max_seq_len,
            vocab_size=self.tokenizer.vocab_size,
        )
        self.grammar: PlanGrammar = build_plan_grammar(self.tokenizer)
        # The control plane's registry, so the engine's series land on the
        # same /metrics surface as the API counters.
        self.metrics = metrics or Metrics()
        # Cost observatory (telemetry/costs.py): analytic costs per
        # executable and the capture sentinel. Made here, not in _setup, so
        # GET /costs can read an empty snapshot from a cold engine.
        self.costs = CostRegistry(metrics=self.metrics, enabled=self.config.telemetry.cost_accounting)
        # Datasheet peaks for span rooflines (None off a known card: spans
        # then carry achieved rates without an mfu or bound claim).
        self._peak_flops_total: Optional[float] = None
        self._peak_bytes_total: Optional[float] = None
        # Decode cost totals {flops, bytes, wall_s} of the segments
        # harvested while a resident row was traced: the residency delta
        # source of the engine.decode span's roofline. Worker thread only.
        self._seg_cost_totals = {"flops": 0.0, "bytes": 0.0, "wall_s": 0.0}  # mcpx: owner[engine-worker]
        # Worker-loop profiler (telemetry/flight.py). None = no clock reads
        # on the loop; the worker re-reads the field every iteration, so a
        # profiler can be attached to, or detached from, a live engine.
        self._profiler: Optional[WorkerProfiler] = (  # mcpx: owner[engine-worker, atomic]
            WorkerProfiler() if self.config.telemetry.flight.profile_worker else None
        )
        # The profiler the current iteration read: every lap and carve of
        # one iteration goes to the same one, so an attach or detach in
        # mid-iteration cannot carve time outside the laps' wall.
        self._iter_prof: Optional[WorkerProfiler] = None
        # Cost ledger (telemetry/ledger.py), read from the live config once
        # every worker iteration, so it can be switched on a live engine. While on, the worker fills the slab's per-row bill
        # accumulators and attaches a bill to every GenerateResult.
        # _ledger_seen is the cost registry's executed totals as of the
        # last apportionment (None while off); every apportionment hands
        # out the whole delta since then, so the bills add up exactly to
        # the executed totals. _ledger_totals is what was handed out
        # (swapped in whole: ledger_totals() reads it cross-thread).
        self._ledger_seen: Optional[dict] = None
        self._ledger_totals: dict = {"flops": 0, "bytes": 0, "by_executable": {}}  # mcpx: owner[engine-worker, atomic]
        # Prefix-cache counters already published to the metrics (the cache
        # itself stays metrics-free; the worker folds deltas).
        self._prefix_seen = {"hits": 0, "misses": 0, "evictions": 0, "matched_tokens": 0}  # mcpx: owner[engine-worker]
        self.state = "cold"
        self._state_lock = threading.Lock()
        self._queue: "queue.Queue[Optional[GenerateRequest]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stop = False
        self._startup_error: Optional[BaseException] = None  # mcpx: owner[engine-worker, atomic]
        self._params = None  # mcpx: owner[engine-worker]
        self._paged_kv: Optional[dict] = None  # mcpx: owner[engine-worker]
        self._slab: Optional[_Slab] = None
        # Grammar tables by pad bucket (state rows, columns), made at first
        # use and kept: captured windows read them at their addresses.
        self._tables: dict[tuple[int, int], _Tables] = {}  # mcpx: owner[engine-worker]
        # The heterogeneous slab's grammar slots (seeded in _setup: slot 0
        # the trivial grammar, slot 1 the generic plan grammar), the rows
        # holding each, and the stacked tables by shape (slots, state
        # rows, columns), made at first use and kept, as _tables are.
        self._trivial_grammar = build_trivial_grammar(self.tokenizer)  # mcpx: owner[engine-worker]
        self._dfa_slots: list[Optional[PlanGrammar]] = []  # mcpx: owner[engine-worker]
        self._dfa_slot_refs: list[int] = []  # mcpx: owner[engine-worker, atomic]
        self._stacks: dict[tuple[int, int, int], _Stack] = {}  # mcpx: owner[engine-worker]
        self._spec_degraded_logged = False
        # Captured windows by key (CUDA only), the kernel launches each
        # replay runs, and the captures made per key. The window's
        # capturing stream, the graphs' one memory pool and whether that
        # stream's ticket buffer is held are made in _setup.
        self._graphs: dict[tuple, "torch.cuda.CUDAGraph"] = {}
        self._graph_launches: dict[tuple, dict[str, int]] = {}
        self._graph_designs: dict[tuple, dict[str, int]] = {}  # the same launches by design
        self._captures: dict[tuple, int] = {}
        # The kernel launches this engine's worker thread made, replays
        # included (``own_launches``): the process-wide counts less other
        # engines'.
        self._launches: dict[str, int] = dict.fromkeys(kernel_launches(), 0)  # mcpx: owner[engine-worker, atomic]
        self._capture_stream = None
        self._graph_pool = None
        self._tickets_held = False
        self._seq_counter = 0  # mcpx: owner[engine-worker]
        self._last_admit_t = 0.0  # mcpx: owner[engine-worker]
        # The cost entry of the last prefill run (worker thread only): the
        # admission's engine.prefill spans read it.
        self._pf_entry = None
        self._generator: Optional[torch.Generator] = None
        # Worker-thread counters, read cross-thread by queue_stats():
        # prefill_tokens counts the tokens every prefill computed (prefix
        # builds included), suffix_prefills the prefills at a matched offset
        # and suffix_prefill_launches the kernel launches they made.
        # decode_forwards counts the forwards dispatched; live_forwards those
        # in which some row was live (counted on the device, fetched with
        # the harvest: the reference's forward count); windows the windows
        # dispatched (decode_forwards = windows * decode_steps_per_tick);
        # drafted and accepted the prompt-draft proposals (tokens the
        # grammar did not force) put in a forward and those its
        # verification accepted; decode_tokens the tokens retired requests
        # generated. captures counts the windows captured into CUDA graphs
        # while serving (the reference's retrace sentinel: a repeat of the
        # same traffic adds none), warmup_captures those captured at
        # startup under engine.warmup_compile, replays the windows run by
        # replaying a captured graph (on the CPU none: windows run eagerly).
        # prefix_pins counts the pin_prefix pins applied and not yet
        # released (0 whenever no caller holds one). Speculative windows
        # count their drafts (every proposal, forced ones included, as the
        # reference's speculative counters do) in drafted and accepted, and
        # spec_verify counts those windows: the verify path's dispatches.
        # The worker's blocking device waits by site: flag_waits the
        # early-exit reads of an all-done flag that waited on its copy's
        # event, harvest_waits the segments retired after waiting on theirs;
        # flag_reads_no_event and harvests_no_event the same reads made with
        # no event to wait on (the CPU). They count whether or not a profiler
        # is attached.
        self._stats = {  # mcpx: owner[engine-worker, atomic]
            "admissions": 0, "segments": 0, "windows": 0, "decode_forwards": 0,
            "live_forwards": 0, "drafted": 0, "accepted": 0, "retired": 0, "decode_tokens": 0,
            "prefill_tokens": 0, "suffix_prefills": 0, "suffix_prefill_launches": 0,
            "captures": 0, "warmup_captures": 0, "replays": 0, "prefix_pins": 0, "spec_verify": 0,
            "eager_windows": 0, "flag_waits": 0, "flag_reads_no_event": 0, "harvest_waits": 0,
            "harvests_no_event": 0,
        }
        # Speculative drafted and accepted tokens by row class (worker
        # writes, queue_stats reads; swapped in whole).
        self._spec_totals = {  # mcpx: owner[engine-worker, atomic]
            "drafted_constrained": 0, "accepted_constrained": 0, "drafted_free": 0, "accepted_free": 0,
        }
        # Dispatched segments awaiting harvest, oldest first.
        self._inflight: "deque[_Inflight]" = deque()  # mcpx: owner[engine-worker]
        # The all-done flag ring (made in _setup): windows issued so far,
        # and the first window whose flag may end a segment (flags from
        # before an admission are stale).
        self._window_seq = 0  # mcpx: owner[engine-worker]
        self._flags_from = 0
        self._flag_host: Optional[torch.Tensor] = None
        self._flag_np: Optional[np.ndarray] = None
        self._flag_events: list = []
        # Service-time EWMA (s) of retired requests: the locality sort's
        # deadline slack.
        self._ewma_service_s = 0.0  # mcpx: owner[engine-worker, atomic]
        self._allocator = PageAllocator(  # mcpx: owner[engine-worker]
            n_pages=max(2, ecfg.max_batch_size * ecfg.max_pages_per_seq + 1),
            page_size=ecfg.kv_page_size,
            max_pages_per_seq=ecfg.max_pages_per_seq,
        )
        # Tiered KV cache (engine.kv_tier): the host spill tier and the
        # per-tenant governor under the radix tree; None when off, and the
        # tree is then the single-tier one. Worker thread only after start;
        # other threads read their counters.
        self._spill_tier: Optional[HostSpillTier] = None  # mcpx: owner[engine-worker, atomic]
        self._governor: Optional[CacheGovernor] = None  # mcpx: owner[engine-worker, atomic]
        if ecfg.kv_tier.enabled:
            chaos = None
            if ecfg.kv_tier.chaos_profile:
                try:
                    chaos = SpillChaos.from_config(ecfg.kv_tier.chaos_profile)
                except Exception as e:  # a bad profile must not stop serving
                    log.warning("spill chaos profile unusable: %s", e)
            self._spill_tier = HostSpillTier(
                host_bytes=int(ecfg.kv_tier.host_mb * 1024 * 1024),
                copy_tokens_per_cycle=ecfg.kv_tier.copy_tokens_per_cycle,
                chaos=chaos,
            )
            if ecfg.kv_tier.governor:
                self._governor = CacheGovernor(ecfg.kv_tier.tenant_weights)
        self._prefix_cache = RadixPrefixCache(  # mcpx: owner[engine-worker, atomic]
            self._allocator, ecfg.kv_page_size, max_nodes=max(0, ecfg.prefix_cache_entries),
            spill=self._spill_tier, governor=self._governor,
        )
        # Declared shared-prefix heads served (token tuple -> tenant), an LRU
        # of 64: the warm-restart snapshot records them.
        self._declared_heads: "OrderedDict[tuple, str]" = OrderedDict()  # mcpx: owner[engine-worker]
        # Snapshot heads waiting for their lazy rebuild (when a snapshot's
        # ids restored but its KV could not): (ids, tenant), each consumed
        # by the first request it prefixes.
        self._warm_heads: list[tuple[tuple, str]] = []  # mcpx: owner[engine-worker]
        # Spill counters already published to the metrics (delta fold, as
        # _prefix_seen).
        self._spill_seen = {  # mcpx: owner[engine-worker]
            "spills": 0, "readmits": 0, "destructive_evictions": 0, "host_evictions": 0, "denied_readmits": 0,
        }
        # Readmits whose host-to-device copies may still read their pinned
        # source: (events, one for each card written; source tensors),
        # dropped once every event passes.
        self._readmit_holds: "deque[tuple[Any, tuple]]" = deque()
        self._prefill_buckets = tuple(
            b
            for b in (64, 128, 256, 512, 768, 1024, 1536, 2048)
            if b <= self.model_cfg.max_seq_len and b % ecfg.kv_page_size == 0
        )
        if not self._prefill_buckets:
            raise EngineError(
                f"no usable prefill bucket <= max_seq_len={self.model_cfg.max_seq_len} "
                f"that is a multiple of kv_page_size={ecfg.kv_page_size}"
            )
        auto = {1, 8, ecfg.max_batch_size}
        q = ecfg.max_batch_size
        while q >= 16:
            q //= 2
            auto.add(q)
        self._batch_buckets = tuple(
            sorted(
                {b for b in (tuple(ecfg.batch_buckets) or tuple(auto)) if b < ecfg.max_batch_size}
                | {ecfg.max_batch_size}
            )
        )
        # Unconstrained sampling mask: ids past the tokenizer's real vocab
        # are padding, and PAD itself is never sampled.
        n_real = getattr(self.tokenizer, "n_real", self.tokenizer.vocab_size)
        um = torch.zeros((self.tokenizer.vocab_size,), dtype=torch.bool)
        um[:n_real] = True
        um[self.tokenizer.pad_id] = False
        self._unconstrained_mask = um.to(self.device)
        # What a free row may draft: the same, less EOS (a stop comes from
        # the verified sample, never from a draft).
        self._draft_free_mask = self._unconstrained_mask.clone()
        self._draft_free_mask[self.tokenizer.eos_id] = False

    # ------------------------------------------------------------- lifecycle
    def _transition(self, to: str) -> bool:
        """Move the lifecycle state machine to ``to`` iff legal from the
        current state (``_ENGINE_STATES``); returns whether the transition
        happened. The lock makes check-and-set atomic across the event loop
        (start/aclose) and any coalescing start() callers: a close that
        lands mid-start wins and stays won."""
        with self._state_lock:
            if to in _ENGINE_STATES.get(self.state, ()):
                self.state = to
                return True
            return False

    async def start(self) -> None:
        """Load the weights onto the device and start the worker thread.
        Concurrent callers wait for the one start in flight. All state
        writes go through the guarded ``_transition``: exactly one caller
        wins cold->warming (and starts the worker thread), and a concurrent
        aclose() cannot be overwritten back to "ready"."""
        if self.state == "ready":
            return
        if self.state in ("closed", "failed"):
            raise EngineError(f"engine not startable (state={self.state})")
        if self._transition("warming"):
            self._thread = threading.Thread(target=self._worker, daemon=True, name="mcpx-torch-engine")
            self._thread.start()
        while not self._started.is_set():
            await asyncio.sleep(0.02)
        if self._startup_error is not None:
            self._transition("failed")
            raise EngineError(f"engine startup failed: {self._startup_error}")
        self._transition("ready")
        if self.state != "ready":
            # A concurrent aclose() closed the engine mid-start; the
            # transition above lost, and this caller must not serve.
            raise EngineError(f"engine not startable (state={self.state})")
        # From here every new executable key is a capture in the serving
        # path: the sentinel logs it at WARNING.
        self.costs.arm()

    async def aclose(self) -> None:
        with self._state_lock:
            self.state = "closed"  # terminal from any state, races included
        self._stop = True
        self._queue.put(None)
        if self._thread is not None:
            await asyncio.to_thread(self._thread.join, 30.0)
        if self._thread is None or not self._thread.is_alive():
            # The worker is gone: nothing else writes the tree, the tier or
            # the pools from here.
            tier = self._spill_tier
            if (
                tier is not None
                and self.config.engine.kv_tier.snapshot_path
                and self._started.is_set()
                and self._startup_error is None
                and self._params is not None  # mcpx: ignore[thread-ownership] - worker joined (guard above); teardown
            ):
                # A clean close writes the warm-restart snapshot before the
                # pools drop; the tier's drain completes the copies in
                # flight first. A failed save is logged: a close never
                # hangs on its snapshot.
                try:
                    with torch.inference_mode():
                        self._save_snapshot()
                except Exception:
                    log.warning("KV snapshot save failed", exc_info=True)
            if tier is not None:
                # Copies in flight and host runs drop after the snapshot:
                # no pinned buffer outlives the engine.
                tier.reset()  # mcpx: ignore[thread-ownership] - worker joined (guard above); teardown
                self._readmit_holds.clear()
            # Nothing of the engine stays on the card, even while a
            # reference to the closed engine lives on (a replica pool's
            # killed slot): weights, pools, slab, grammar tables, masks,
            # generator, flag ring, capturing stream and graph pool.
            self._params = None  # mcpx: ignore[thread-ownership] - worker joined (guard above); teardown
            self._paged_kv = None  # mcpx: ignore[thread-ownership] - worker joined (guard above); teardown
            self._draft_embed = None  # mcpx: ignore[thread-ownership] - worker joined (guard above); teardown
            self._slab = None
            self._tables.clear()  # mcpx: ignore[thread-ownership] - worker joined (guard above); teardown
            self._stacks.clear()  # mcpx: ignore[thread-ownership] - worker joined (guard above); teardown
            self._unconstrained_mask = self._draft_free_mask = None
            self._generator = None
            self._flag_host = self._flag_np = None
            self._flag_events = []
            if self._capture_stream is not None:
                with DEVICE_LOCK:
                    _SPARE_STREAMS.append(self._capture_stream)
            self._capture_stream = self._graph_pool = None
            if tier is not None:
                # The tree's spilled nodes lost their runs with the reset.
                self._prefix_cache.drop_all()  # mcpx: ignore[thread-ownership] - worker joined (guard above); cached KV dies with the pools

    # ------------------------------------------------------------------ api
    async def generate(
        self,
        prompt_ids: list[int],
        *,
        max_new_tokens: int = 0,
        constrained: bool = True,
        temperature: Optional[float] = None,
        grammar: Optional[PlanGrammar] = None,
        shared_prefix_len: int = 0,
        deadline_at: Optional[float] = None,
        tenant: str = "default",
    ) -> GenerateResult:
        """Decode a continuation of ``prompt_ids``. ``shared_prefix_len``
        declares a head common to many requests (built into the prefix
        cache before the cohort that needs it); ``deadline_at`` bounds what
        the locality sort may reorder; ``tenant`` rides along."""
        if self.state != "ready":
            raise EngineError(f"engine not ready (state={self.state})")
        ecfg = self.config.engine
        loop = asyncio.get_running_loop()
        with tracing.span(
            "engine.generate", prompt_tokens=len(prompt_ids), constrained=constrained
        ) as esp:
            req = GenerateRequest(
                prompt_ids=list(prompt_ids),
                max_new_tokens=max_new_tokens or ecfg.max_decode_len,
                constrained=constrained,
                temperature=ecfg.temperature if temperature is None else temperature,
                future=loop.create_future(),
                loop=loop,
                enqueued_at=time.monotonic(),
                grammar=grammar,
                shared_prefix_len=shared_prefix_len,
                deadline_at=deadline_at,
                tenant=tenant,
                span=esp,
            )
            self._queue.put(req)
            res = await req.future
            if res.bill is not None:
                # The worker's engine bill folds into the request's ledger
                # bill here, back on the request task.
                bill = ledger_mod.current_bill()
                if bill is not None:
                    bill.add_engine(res.bill)
            if esp is not None:
                esp.set(
                    tokens=res.generated_tokens,
                    queue_ms=round(res.queue_ms, 3),
                    prefill_ms=round(res.prefill_ms, 3),
                    decode_ms=round(res.decode_ms, 3),
                )
            return res

    async def pin_prefix(self, prompt_ids: list[int]) -> Optional[PrefixNode]:
        """Pin the deepest resident radix node whose path prefixes
        ``prompt_ids`` so eviction cannot reclaim it; returns a handle for
        ``unpin_prefix`` (None when nothing is resident, the cache is off or
        the engine is not serving). The worker applies the pin, as it
        applies every change to the tree."""
        if self.state != "ready" or not self.config.engine.prefix_cache:
            return None
        loop = asyncio.get_running_loop()
        fut: "asyncio.Future[Optional[PrefixNode]]" = loop.create_future()
        self._queue.put(_PinPrefixOp(list(prompt_ids), fut, loop))
        return await fut

    def unpin_prefix(self, handle: Optional[PrefixNode]) -> None:
        """Release a ``pin_prefix`` pin (None is ignored); the worker
        applies it at its next queue drain."""
        if handle is None or self.state == "closed":
            return
        self._queue.put(_UnpinPrefixOp(handle))

    async def drop_unpinned(self) -> int:
        """Evict every radix run that no resident row and no ``pin_prefix``
        caller holds, and return the nodes left in the tree (the pinned
        ones). The worker applies it between segments, as it applies every
        change to the tree; with no worker running it applies at once."""
        if self._thread is None or not self._thread.is_alive():
            return self._drop_unpinned()  # mcpx: ignore[thread-ownership] - no worker thread runs (not started, closed, or driven by hand): the caller is the only thread touching the tree
        loop = asyncio.get_running_loop()
        fut: "asyncio.Future[int]" = loop.create_future()
        self._queue.put(_DropUnpinnedOp(fut, loop))
        return await fut

    @owned_by("engine-worker")
    def _drop_unpinned(self) -> int:
        cache = self._prefix_cache
        cache.max_nodes = 0
        cache.evict()
        if cache.spill is not None:
            # Evicted runs spilled: drop every unpinned host run too.
            cache.evict_host(cache.spill.host_bytes + 1)
        self._evict_prefixes()  # the node cap back to the live config's
        return cache.n_nodes

    def prompt_capacity(self, max_new_tokens: int = 0, shared_prefix_len: int = 0) -> int:
        """Longest prompt (in tokens) the engine serves beside a
        ``max_new_tokens`` decode budget: the page-capacity and
        prefill-bucket geometry the planner trims its prompt to. With a
        shared prefix (and the cache on) the suffix must fit a prefill
        bucket beside the prefix's pages, which can bring the capacity below
        the full-prefill one; admission may still take the full path, so
        the answer is the smaller of the two."""
        ecfg = self.config.engine
        capacity = ecfg.max_pages_per_seq * ecfg.kv_page_size
        # The widest garbage-write slack either decode path needs: the
        # fast-forward window or the speculative verify window, whichever
        # the live config arms wider (the slab may serve either).
        chunk = max(self._spec_chunk(True), self._spec_k() + 1)
        slack = chunk if chunk > 1 else 0
        budget = min(
            max_new_tokens or ecfg.max_decode_len,
            max(1, min(ecfg.max_decode_len, capacity - 1 - slack)),
        )
        full_eligible = [b for b in self._prefill_buckets if b <= capacity]
        if not full_eligible:
            return 1
        full_cap = max(1, min(full_eligible[-1], capacity - budget - slack))
        P = 0
        if ecfg.prefix_cache and shared_prefix_len:
            P = (shared_prefix_len // ecfg.kv_page_size) * ecfg.kv_page_size
        if not P:
            return full_cap
        eligible = [b for b in self._prefill_buckets if b + P <= capacity]
        if not eligible:
            return full_cap
        prefix_cap = max(1, P + min(eligible[-1], capacity - P - budget - slack))
        return min(full_cap, prefix_cap)

    def kernel_launches(self) -> dict[str, int]:
        """Launches of each CUDA kernel in this process (the wrappers' own
        counters; CPU runs take the plain versions and count nothing)."""
        return kernel_launches()

    def own_launches(self) -> dict[str, int]:
        """Launches of each CUDA kernel made by this engine's worker thread,
        the replays of its graphs included; over engines that share the
        process they add up to ``kernel_launches()``."""
        return dict(self._launches)

    def kernel_paths(self) -> dict:
        """Per-path engagement of the ragged CUDA kernel, in the shape of
        the reference's ``pallas_paths()`` (``GET /costs``): whether each
        serving path that runs paged attention routes through the kernel
        (the engine's device decides) and how often it ran, with the reason
        where it does not or idles."""
        on = self.device.type == "cuda"
        blocked = None if on else f"device {self.device.type}: the plain PyTorch version"

        def path(dispatches: int, idle: Optional[str]) -> dict:
            return {"engaged": on, "dispatches": dispatches, "reason": blocked if not on else idle}

        st = self._stats
        return {
            "enabled": on,
            "interpret": False,
            "reason": blocked,
            "paths": {
                "decode": path(st["segments"], None),
                "prefill": path(
                    st["suffix_prefills"],
                    None if self.config.engine.prefix_cache else "idle: prefix_cache=off (no suffix prefills)",
                ),
                "spec_verify": path(
                    st["spec_verify"], None if self._spec_k() > 0 else "idle: speculative decoding off"
                ),
            },
        }

    def prefix_cache_stats(self) -> dict:
        """Counter snapshot of the radix prefix cache (the ``GET /cache``
        block); ``enabled`` is the live config flag. With the tiered cache
        on, ``tier`` holds the spill tier's accounting (host tokens and
        bytes, spills, readmits, destructive evictions) and ``governor``
        each tenant's residency and hit rates; both are None single-tier."""
        out = {
            "enabled": bool(self.config.engine.prefix_cache),
            **self._prefix_cache.stats(),
            "tier": None,
            "governor": None,
        }
        if self._spill_tier is not None:
            out["tier"] = {"enabled": True, **self._spill_tier.stats()}
        if self._governor is not None:
            out["governor"] = self._governor.stats(self._prefix_cache.max_tokens)
        return out

    def queue_stats(self) -> dict:
        slab = self._slab
        # The worker-loop profile, present only while a profiler is
        # attached (one read: a live detach must not race the use).
        prof = self._profiler
        extra = {"worker_profile": prof.snapshot()} if prof is not None else {}
        # Speculative acceptance overall and by row class (zeros while
        # speculation is off).
        sp = self._spec_totals
        drafted = sp["drafted_constrained"] + sp["drafted_free"]
        accepted = sp["accepted_constrained"] + sp["accepted_free"]
        ps = self._prefix_cache.stats()
        tier = self._spill_tier
        # The serving scheduler's floor (the reference's estimate): queued
        # requests that fit the slab's free rows admit at the next segment
        # boundary; only the overflow waits out service drains, a batch at a
        # time.
        active = slab.n_active if slab is not None else 0
        depth = self._queue.qsize()
        B = max(1, self.config.engine.max_batch_size)
        svc = self._ewma_service_s
        eta = math.ceil(max(0, depth - max(0, B - active)) / B) * svc + (svc if active >= B else 0.0)
        return {
            **extra,
            "queue_depth": depth,
            "active_rows": active,
            # Segments dispatched and not yet harvested: the worker's last
            # device waits of a burst come after its rows have retired.
            "inflight_segments": len(self._inflight),  # mcpx: ignore[thread-ownership] - len() of a deque is one GIL-atomic read
            "service_ewma_s": svc,
            "eta_s": eta,
            "kernel_launches": kernel_launches(),
            "prefix_token_hit_rate": ps["token_hit_rate"],
            # The tiered cache's tallies (zeros single-tier).
            "prefix_host_pages": ps["host_pages"],
            "prefix_spills": tier.spills if tier is not None else 0,
            "prefix_readmits": tier.readmits if tier is not None else 0,
            "prefix_destructive_evictions": tier.destructive_evictions if tier is not None else 0,
            "resident_grammars": sum(1 for n in self._dfa_slot_refs[1:] if n > 0),
            "spec_accept_rate": accepted / drafted if drafted else 0.0,
            "spec_accept_rate_constrained": (
                sp["accepted_constrained"] / sp["drafted_constrained"] if sp["drafted_constrained"] else 0.0
            ),
            "spec_accept_rate_free": sp["accepted_free"] / sp["drafted_free"] if sp["drafted_free"] else 0.0,
            **dict(self._stats),
        }

    @property
    def _ledger_on(self) -> bool:
        return bool(self.config.telemetry.ledger.enabled)

    def ledger_totals(self) -> dict:
        """What the cost ledger has apportioned to request bills: total
        FLOPs and bytes, and FLOPs per executable (a cross-thread read of a
        dict the worker swaps in whole). Over a run that ends with the slab
        empty, the bills retired in it add up exactly to its delta, which
        equals the cost registry's executed-totals delta."""
        t = self._ledger_totals
        return {"flops": t["flops"], "bytes": t["bytes"], "by_executable": dict(t["by_executable"])}

    def _ledger_account(self, slab: _Slab, rows: list[int]) -> None:
        """Apportion everything the cost registry executed since the last
        apportionment over ``rows`` (the cohort just admitted, or the rows
        resident at a segment's dispatch): per executable, integer shares
        of the FLOPs and bytes, the remainder to the first rows, into the
        rows' bill accumulators and the handed-out totals. Work no row was
        there to take (an admission that admitted none) waits for the next
        apportionment. Worker thread only; ``rows`` is never empty."""
        now = self.costs.executed()
        seen, self._ledger_seen = self._ledger_seen, now
        t = self._ledger_totals
        flops, nbytes, by = t["flops"], t["bytes"], dict(t["by_executable"])
        idx = np.asarray(rows)
        for name, (f1, b1) in now.items():
            f0, b0 = seen.get(name, (0, 0))
            df, db = f1 - f0, b1 - b0
            if not (df or db):
                continue
            slab.bill_flops[idx] += _shares(df, len(rows))
            slab.bill_bytes[idx] += _shares(db, len(rows))
            by[name] = by.get(name, 0) + df
            flops += df
            nbytes += db
        self._ledger_totals = {"flops": flops, "bytes": nbytes, "by_executable": by}

    def capture_counts(self) -> dict[str, int]:
        """Captures of the decode window per key (body, temperature class,
        window width, batch, grammar-table shape, forwards), startup ones
        included; more than one for a key, or a key new to repeated
        traffic, is a recapture the serving path paid for."""
        return {repr(k): n for k, n in self._captures.items()}

    # ------------------------------------------------------------- geometry
    def _spec_chunk(self, constrained: bool) -> int:
        """Fast-forward window width: ``speculate_k`` for constrained rows,
        degraded toward 1 when page capacity leaves no slack for the
        window's garbage writes past the decode budget."""
        ecfg = self.config.engine
        capacity = ecfg.max_pages_per_seq * ecfg.kv_page_size
        want = ecfg.speculate_k if (constrained and ecfg.speculate_k > 1) else 1
        budget_ceiling = min(ecfg.max_decode_len, capacity - 1)
        return max(1, min(want, capacity - budget_ceiling))

    def _spec_k(self) -> int:
        """Draft tokens per verify forward under speculative decoding: 0
        when it is off, when ``hetero_batch`` is off (the drafter's grammar
        pre-filter needs the per-row stacked tables), or when page capacity
        leaves no slack for the ``K+1``-wide window's garbage writes
        (degraded toward 0, logged once)."""
        ecfg = self.config.engine
        if not (ecfg.hetero_batch and ecfg.speculative.enabled):
            return 0
        capacity = ecfg.max_pages_per_seq * ecfg.kv_page_size
        budget_ceiling = min(ecfg.max_decode_len, capacity - 1)
        window = max(1, min(ecfg.speculative.k + 1, capacity - budget_ceiling))
        if window - 1 < ecfg.speculative.k and not self._spec_degraded_logged:
            self._spec_degraded_logged = True
            log.warning(
                "speculative window degraded k=%d -> %d: page capacity %d leaves no slack past "
                "max_decode_len=%d (raise max_pages_per_seq/kv_page_size or lower max_decode_len)",
                ecfg.speculative.k, window - 1, capacity, ecfg.max_decode_len,
            )
        return window - 1

    def _decode_iters(self, spec: bool) -> int:
        """Forwards a segment dispatches: ``decode_steps_per_tick`` times
        ``steps_per_dispatch`` (windows of ``decode_steps_per_tick`` each),
        except a speculative segment, which is one window: each of its
        forwards already covers a ``[B, K+1]`` window, and a longer one
        would pay verify compute on the drain tail."""
        ecfg = self.config.engine
        base = max(1, ecfg.decode_steps_per_tick)
        return base if spec else base * max(1, ecfg.steps_per_dispatch)

    def _upload_into(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """Copy a host array into ``dst`` in place, as ``_upload`` does:
        on CUDA from a fresh pinned block, without waiting for the stream."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device, without waiting for the stream: on
        CUDA through a fresh pinned block (the caching host allocator keeps
        it until the copy has run), so an upload never waits for queued
        segments and no queued kernel reads host memory written later. On
        the CPU: a tensor over the array."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _grammar_pad(self) -> int:
        """State-dim pad quantum of the grammar tables, the reference's
        (``engine.grammar_state_budget``, or 64 where the budget times the
        generic grammar's columns passes 64M): one bucket, one set of
        table buffers, one captured window for every grammar that fits."""
        budget = self.config.engine.grammar_state_budget
        if budget * self.grammar.n_active > 64_000_000:
            return 64
        return budget

    def _dfa_for(self, grammar: PlanGrammar) -> tuple:
        """(trans, mask, dist, active_ids, eos_cols, inv_cols) of
        ``grammar``: its pad bucket's table buffers, with ``grammar`` copied
        in when another grammar holds them. The homogeneous slab changes
        grammar only while it is empty, and the copy is a stream operation,
        so it lands after every segment still in flight."""
        pad = self._grammar_pad()
        key = (-(-grammar.n_states // pad) * pad, _col_bucket(grammar.n_active))
        tables = self._tables.get(key)
        if tables is None:
            tables = self._tables[key] = _Tables(*key, self.tokenizer.vocab_size, self.device)
        if tables.grammar is not grammar:
            tables.load(grammar, self._upload_into)
        return tables.dfa

    # ---------------------------------------- heterogeneous grammar slots
    def _stacked_dfa(self) -> _Stack:
        """The stacked tables of the resident grammar slots (free slots hold
        the trivial grammar), at the shape the slots need: that shape's fixed
        buffers, with each slot whose grammar changed rewritten in place
        (copied on the card where the grammar is loaded in ``_Tables``) and
        the speculative companions armed while speculation is. A slot changes
        owner only at refs 0, so no resident row reads a slot being
        rewritten; the writes are stream operations, after every segment in
        flight. Worker thread only."""
        pad = self._grammar_pad()
        slots = [g if g is not None else self._trivial_grammar for g in self._dfa_slots]
        key = (len(slots), *stack_shape(slots, pad))
        stack = self._stacks.get(key)
        if stack is None:
            stack = self._stacks[key] = _Stack(*key, self.tokenizer.vocab_size, self.device)
        if self._spec_k() > 0 or self._slab.spec:
            # The slab's latch keeps the companions through a live flip-off
            # drain: resident speculative rows still run their window.
            stack.arm_spec(self._upload_into)
        for k, g in enumerate(slots):
            if stack.grammars[k] is not g:
                resident = next((t for t in self._tables.values() if t.grammar is g), None)
                stack.load(k, g, self._upload_into, resident)
        return stack

    def _grammar_slot_for(self, grammar: PlanGrammar, reserved: set) -> Optional[int]:
        """The stacked slot for ``grammar``: the slot holding it, a free one,
        or a reclaimed one whose grammar no row holds; None when every slot
        past 0 holds a live grammar (the request then waits for one to
        drain). ``reserved`` protects the slots a cohort claimed earlier in
        the same admission (refs are taken at row assignment)."""
        for k, g in enumerate(self._dfa_slots):
            if g is grammar:
                return k
        for k in range(1, len(self._dfa_slots)):
            if self._dfa_slots[k] is None and k not in reserved:
                self._dfa_slots[k] = grammar
                return k
        for k in range(1, len(self._dfa_slots)):
            if self._dfa_slot_refs[k] == 0 and k not in reserved:
                self._dfa_slots[k] = grammar
                return k
        return None

    def _drop_row_grammar(self, slab: _Slab, i: int) -> None:
        """Release row ``i``'s slot reference (free rows hold none). The slot
        keeps its grammar, warm for the next admission, until another
        grammar reclaims it."""
        k = int(slab.dfa[i])
        if 0 < k < len(self._dfa_slot_refs) and self._dfa_slot_refs[k] > 0:
            self._dfa_slot_refs[k] -= 1
        self.metrics.resident_grammars.set(sum(1 for n in self._dfa_slot_refs[1:] if n > 0))

    @staticmethod
    def _stacked_budget_mask(sdfa: tuple, dfa_id, st, rem) -> torch.Tensor:
        """``_budget_mask`` per row over the stacked tables: row b's mask
        comes from slot ``dfa_id[b]``, in the stack's column space [B, C]."""
        strans, smask, sdist, _sactive, seos = sdfa[:5]
        legal = smask[dfa_id, st]  # [B, C]
        succ = strans[dfa_id, st]  # [B, C]
        finishable = legal & (seos[dfa_id] | (sdist[dfa_id[:, None], succ] <= rem[:, None]))
        return torch.where(finishable.any(dim=-1, keepdim=True), finishable, legal)

    @staticmethod
    def _budget_mask(dfa: tuple, st: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
        """Column c is allowed iff grammar-legal AND (c is EOS or its
        successor can still finish within ``rem`` more samples). When no
        column can finish in budget, degrade to the plain legal mask: the
        output is then a legal prefix, never garbage. [B, C] compact."""
        trans, mask_tab, dist, _active, eos_cols, _inv = dfa
        legal = mask_tab[st]
        finishable = legal & (eos_cols[None, :] | (dist[trans[st]] <= rem[:, None]))
        feasible = finishable.any(dim=-1, keepdim=True)
        return torch.where(feasible, finishable, legal)

    # --------------------------------------------------------------- worker
    def _mesh_axes(self, n_devices: int) -> tuple[int, int]:
        """(data, model) axis sizes, the reference's rule. Config 0 = auto:
        cover every device, TP over the largest head-dividing factor, but
        keep a data axis of at least 2 when possible. Explicit axes are
        clamped to the device count; an axis left at 0 beside an explicit
        one absorbs the remaining devices."""
        ecfg = self.config.engine
        if ecfg.model_axis > 0 or ecfg.data_axis > 0:
            if ecfg.model_axis > 0:
                model = min(ecfg.model_axis, n_devices)
                data = (
                    min(ecfg.data_axis, max(1, n_devices // model))
                    if ecfg.data_axis > 0
                    else max(1, n_devices // model)
                )
            else:
                data = min(ecfg.data_axis, n_devices)
                model = max(1, n_devices // data)
            return data, model
        model = math.gcd(n_devices, self.model_cfg.n_heads)
        if model == n_devices and model > 1:
            # Leave a data axis: shrink model by its smallest prime factor.
            spf = next(p for p in range(2, model + 1) if model % p == 0)
            model //= spf
        return n_devices // model, model

    def _setup(self) -> None:
        ecfg = self.config.engine
        if self._mesh is None:
            # Explicit axes on CUDA span the visible cards, the engine's own
            # first; auto axes keep its one device (the reference's auto
            # spans every chip: a declared difference).
            cards = [self.device]
            if self.device.type == "cuda" and (ecfg.data_axis > 0 or ecfg.model_axis > 0):
                cards += [c for c in (torch.device("cuda", i) for i in range(torch.cuda.device_count()))
                          if c != self.device]
            data, model = self._mesh_axes(len(cards))
            self._mesh = make_mesh(data=data, model=model, devices=cards[:data * model])
        self._layout = serve_layout(self._mesh, self.model_cfg)
        self._eager_windows = self._layout is not None and self._layout.cross
        self._params, source = load_or_init(
            self.model_cfg, self.config.model.checkpoint_path, device=self.device,
            quantize=self.config.model.quantize, mesh=self._mesh,
        )
        # Long-prompt routing: an injected mesh with a seq axis is used as it
        # is; otherwise the data devices are viewed again as a seq axis, in
        # the same order. Armed only when routing can trigger.
        self._seq_mesh = None
        if ecfg.ring_prefill_min_tokens > 0:
            n_data = self._mesh.shape.get(DATA_AXIS, 1)
            if self._mesh.shape.get(SEQ_AXIS, 1) > 1:
                self._seq_mesh = self._mesh
            elif n_data > 1:
                self._seq_mesh = make_mesh(
                    data=1, seq=n_data, model=self._mesh.shape.get(MODEL_AXIS, 1),
                    devices=list(self._mesh.devices.flat),
                )
        log.info("weights: %s on %s", source, self.device)
        self._paged_kv = init_paged_kv(
            self.model_cfg, self._allocator.n_pages, ecfg.kv_page_size, self.device, layout=self._layout
        )
        # The draft buffer holds a row's prompt suffix: the largest prefill
        # bucket within page capacity.
        capacity = ecfg.max_pages_per_seq * ecfg.kv_page_size
        fitting = [b for b in self._prefill_buckets if b <= capacity]
        self._slab = _Slab(
            ecfg.max_batch_size, ecfg.max_decode_len, ecfg.max_pages_per_seq,
            self.tokenizer.pad_id, max(fitting, default=2), self.model_cfg.d_model, self.device,
        )
        if ecfg.speculative.enabled and not ecfg.hetero_batch:
            log.warning(
                "speculative.enabled without hetero_batch has no effect: the grammar-aware drafter "
                "needs the per-row stacked grammar tables; set engine.hetero_batch=true to speculate"
            )
        if ecfg.hetero_batch and ecfg.draft_mode == "prompt":
            log.warning(
                "hetero_batch=on disables draft_mode='prompt' (its proposal chain is single-grammar); "
                "grammar fast-forward still applies per row; set draft_mode='off' to silence"
            )
        # Slot 0: the trivial grammar (free rows); slot 1: the generic plan
        # grammar, so the warm-up's stack is the common serving stack.
        n_slots = max(2, ecfg.hetero_grammar_slots)
        self._dfa_slots = [self._trivial_grammar, self.grammar] + [None] * (n_slots - 2)
        self._dfa_slot_refs = [0] * n_slots
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(time.time_ns() & 0x7FFFFFFF)
        cuda = self.device.type == "cuda"
        if cuda:
            # The span rooflines' denominators: the datasheet peaks of the
            # mesh's distinct cards (one on a virtual mesh, whatever its
            # coordinates).
            pk = device_peaks()
            n_cards = len(self._mesh.distinct_devices())
            self._peak_flops_total = pk["flops_per_chip"] * n_cards
            self._peak_bytes_total = pk["hbm_bytes_s_per_chip"] * n_cards
        self._flag_host = torch.zeros((FLAG_SLOTS,), dtype=torch.bool, pin_memory=cuda)
        self._flag_np = self._flag_host.numpy()
        self._flag_events = [torch.cuda.Event() if cuda else None for _ in range(FLAG_SLOTS)]
        if self._spill_tier is not None:
            # The tier's device copies, and its per-token KV footprint
            # (2 pools x K x L x hd x itemsize) for the spill decision.
            mc = self.model_cfg
            kv_bytes_per_token = 2 * mc.n_kv_heads * mc.n_layers * mc.head_dim * self._kv_itemsize()
            self._spill_tier.bind(self._spill_gather, self._spill_readmit, kv_bytes_per_token)
            if ecfg.kv_tier.snapshot_path:
                self._load_snapshot()
        if cuda:
            self._capture_stream = _capture_stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
            if ecfg.warmup_compile and not self._eager_windows:
                self._warm_windows()

    def _warm_windows(self) -> None:
        """Capture the hot windows at startup. Homogeneous: the generic
        grammar's bucket at the configured temperature and draft mode, the
        body /plan requests run. Heterogeneous: its window over the seeded
        stack (one key for every request mix) and, with speculation armed,
        the speculative window too. Their first run happens on the empty
        slab, where every row idles (its writes land in the null page and
        the drop column). Counted as warm-up, not as serving captures."""
        ecfg = self.config.engine
        slab = self._slab
        slab.constrained, slab.temperature, slab.grammar = True, ecfg.temperature, None
        slab.hetero, slab.spec_k, slab.spec_draft = ecfg.hetero_batch, self._spec_k(), ecfg.speculative.draft
        specs = (False, True) if slab.hetero and slab.spec_k > 0 else (False,)
        for spec in specs:
            slab.spec = spec
            key, dfa = self._window_plan(slab)
            self._record_window(key)
            self._capture(key, lambda: self._window(slab, key, dfa), serving=False)

    def _worker(self) -> None:  # mcpx: thread-entry[engine-worker]
        count_into(self._launches)
        try:
            with torch.inference_mode(), DEVICE_LOCK:
                self._setup()
        except BaseException as e:  # mcpx: ignore[broad-except] - stored as _startup_error, surfaced via start() and /healthz
            self._startup_error = e
            self._started.set()
            return
        self._started.set()
        slab = self._slab
        pending: "deque[GenerateRequest]" = deque()
        with torch.inference_mode():
            while True:
                # The profiler's laps tile each iteration into the
                # reference's phases; it is re-read every iteration, so a
                # live attach or detach lands at the next one.
                prof = self._iter_prof = self._profiler
                if prof is not None:
                    prof.loop_tick()
                self._drain_queue(
                    pending, block=not pending and slab.n_active == 0 and not self._inflight
                )
                swapped = self._profiler
                if swapped is not prof:
                    # Attached or detached while the drain waited for work:
                    # the work that woke the worker is served under the
                    # profiler attached now, so one attached before a burst
                    # sees all of it, whenever in the idle poll it arrives.
                    if prof is not None:
                        prof.lap("drain")
                    prof = self._iter_prof = swapped
                    if prof is not None:
                        prof.loop_tick()
                # The ledger switches here, after the (possibly blocking)
                # drain, so the requests that woke the worker are billed:
                # switched on, it bills from the cost registry's totals as
                # they stand.
                if not self._ledger_on:
                    self._ledger_seen = None
                elif self._ledger_seen is None:
                    self._ledger_seen = self.costs.executed()
                if prof is not None:
                    prof.lap("drain")
                if self._stop:
                    break
                with DEVICE_LOCK:
                    self._refresh_queue_gauges(pending)
                    if self._spill_tier is not None:
                        # Complete the spill copies that have landed, and
                        # release finished readmits' sources (event queries,
                        # never a wait).
                        if prof is not None:
                            prof.lap("host_bookkeeping")
                        self._spill_tier.poll()
                        self._prune_readmit_holds()
                        if prof is not None:
                            prof.lap("spill_copy")
                    self._reap_cancelled(slab)
                    if prof is not None:
                        prof.lap("host_bookkeeping")
                    try:
                        if pending and slab.n_active < slab.B:
                            self._admit(slab, pending)
                            if prof is not None:
                                prof.lap("admit")
                        if slab.n_active:
                            # Dispatch first, then harvest a lagged segment: its
                            # wait overlaps the segment just enqueued.
                            self._dispatch_segment(slab)
                            if prof is not None:
                                prof.lap("dispatch_submit")
                            self._harvest(slab, keep_inflight=max(0, self.config.engine.pipeline_depth - 1))
                            if prof is not None:
                                prof.lap("harvest")
                        elif self._inflight:
                            # Nothing resident by the host's view: drain what is
                            # in flight, so that blocking on the queue is safe.
                            self._harvest(slab, keep_inflight=0)
                            if prof is not None:
                                prof.lap("harvest")
                    except BaseException as e:  # keep the worker alive
                        log.exception("engine step failed; failing resident rows")
                        self._inflight.clear()
                        failed = self._release_rows(slab)
                        # The pools may hold partial writes: serve no cached KV.
                        # Every state change is made before a caller hears of it.
                        self._drop_tree_after_failure()
                        _fail(failed, e)
            with DEVICE_LOCK:
                self._shutdown(slab, pending)

    def _drop_tree_after_failure(self) -> None:
        """After a failed device step: the pools may hold partial writes, so
        the whole tree drops (the reference's pool reset, counted as one)."""
        self._prefix_cache.drop_all()
        self.metrics.engine_resets.inc()

    def _refresh_queue_gauges(self, pending: "deque[GenerateRequest]") -> None:
        """Publish the pending line's per-class depth and fold the prefix
        cache's counters (and the spill tier's, and each tenant's resident
        tokens) into the metrics as deltas. Worker thread only."""
        m = self.metrics
        n_cons = sum(1 for r in pending if r.constrained)
        m.queue_depth_class.labels(cls="constrained").set(n_cons)
        m.queue_depth_class.labels(cls="free").set(len(pending) - n_cons)
        c = self._prefix_cache
        seen = self._prefix_seen
        for attr, metric in (
            ("hits", m.prefix_hits),
            ("misses", m.prefix_misses),
            ("evictions", m.prefix_evictions),
            ("matched_tokens", m.prefix_matched_tokens),
        ):
            cur = getattr(c, attr)
            if cur > seen[attr]:
                metric.inc(cur - seen[attr])
            seen[attr] = cur
        m.prefix_shared_pages.set(c.resident_tokens // max(1, c.page_size))
        tier = self._spill_tier
        if tier is not None:
            seen = self._spill_seen
            for attr, metric in (
                ("spills", m.kv_spills),
                ("readmits", m.kv_readmits),
                ("destructive_evictions", m.kv_destructive_evictions),
                ("host_evictions", m.kv_host_evictions),
                ("denied_readmits", m.kv_denied_readmits),
            ):
                cur = getattr(tier, attr)
                if cur > seen[attr]:
                    metric.inc(cur - seen[attr])
                    seen[attr] = cur
            m.kv_host_tokens.set(tier.host_tokens)
            m.kv_host_bytes.set(tier.host_bytes_used)
        if self._governor is not None:
            # The governor folds tenants past its cardinality cap into
            # "other", so the label space is bounded.
            for tenant, tokens in self._governor.resident_by_tenant().items():
                m.kv_tenant_resident_tokens.labels(tenant=tenant).set(tokens)

    def _shutdown(self, slab: _Slab, pending: "deque[GenerateRequest]") -> None:
        """Harvest what the device already finished (a request one lagged
        harvest away from delivery resolves), then fail every resident,
        pending and queued request."""
        if self._inflight:
            try:
                self._harvest(slab, keep_inflight=0)
            except Exception:  # closing anyway: the rows fail below
                log.exception("final harvest failed during shutdown")
            self._inflight.clear()
        self._graphs.clear()
        self._graph_launches.clear()
        self._graph_designs.clear()
        if self._tickets_held:
            release_tickets(self.device, self._capture_stream.cuda_stream)
            self._tickets_held = False
        closed = EngineError("engine closed")
        _fail(self._release_rows(slab), closed)
        for r in pending:
            r.loop.call_soon_threadsafe(_resolve, r.future, None, closed)
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(r, GenerateRequest):
                r.loop.call_soon_threadsafe(_resolve, r.future, None, closed)
            elif isinstance(r, _PinPrefixOp):
                r.loop.call_soon_threadsafe(_resolve, r.future, None, None)
            elif isinstance(r, _DropUnpinnedOp):
                r.loop.call_soon_threadsafe(_resolve, r.future, self._drop_unpinned(), None)

    def _drain_queue(self, pending: "deque[GenerateRequest]", block: bool) -> None:
        """Move queued requests into ``pending``. When idle, wait for the
        first arrival, then hold a 3 ms gather window so a burst forms one
        admission cohort. The blocking waits are the profiler's ``idle``."""
        prof = self._iter_prof
        try:
            if block:
                t_idle = prof.mark() if prof is not None else 0.0
                try:
                    item = self._queue.get(timeout=0.05)
                finally:
                    if prof is not None:
                        prof.carve("idle", t_idle)
            else:
                item = self._queue.get_nowait()
        except queue.Empty:
            return
        first_arrival = item is not None and block
        while True:
            if item is None:
                self._stop = True
                return
            if not self._apply_prefix_op(item):
                pending.append(item)
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
        if first_arrival:
            deadline = time.monotonic() + 0.003
            while (remaining := deadline - time.monotonic()) > 0:
                t_idle = prof.mark() if prof is not None else 0.0
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    return
                finally:
                    if prof is not None:
                        prof.carve("idle", t_idle)
                if item is None:
                    self._stop = True
                    return
                if not self._apply_prefix_op(item):
                    pending.append(item)

    def _apply_prefix_op(self, item: Any) -> bool:
        """Apply a pin, an unpin or a drop riding the request queue; returns
        whether ``item`` was one. They travel through the queue so that only
        the worker changes the tree."""
        if isinstance(item, _PinPrefixOp):
            node = self._prefix_cache.lookup(item.ids)
            if node is not None:
                node.refs += 1
                self._stats["prefix_pins"] += 1
            item.loop.call_soon_threadsafe(_resolve, item.future, node, None)
            return True
        if isinstance(item, _DropUnpinnedOp):
            item.loop.call_soon_threadsafe(_resolve, item.future, self._drop_unpinned(), None)
            return True
        if isinstance(item, _UnpinPrefixOp):
            # A node dropped since the pin (drop_all after a failed
            # admission) is detached: its count changes nothing.
            if item.node.refs > 0:
                item.node.refs -= 1
            self._stats["prefix_pins"] -= 1
            return True
        return False

    def _reap_cancelled(self, slab: _Slab) -> None:
        for i in range(slab.B):
            r = slab.req[i]
            if r is not None and r.future.cancelled():
                self._release_row(slab, i)
                self.metrics.reaped_rows.inc()

    def _release_row(self, slab: _Slab, i: int) -> None:
        """Pages back to the allocator, the row's radix pins released, its
        generation bumped, the row's device state cleared: its page-table
        row zeroed (later writes land on the null page) and its draft state
        emptied, its grammar slot reference dropped and its sampling config
        and drafter state zeroed. A segment still in flight that wrote the
        freed pages ran before any later owner's prefill, on the same
        stream."""
        self._allocator.free(slab.sid[i])
        self._drop_row_grammar(slab, i)
        for node in slab.prefix[i]:
            node.refs -= 1
        slab.prefix[i] = ()
        slab.prefix_toks[i] = 0
        slab.bill_flops[i] = 0.0
        slab.bill_bytes[i] = 0.0
        slab.bill_fwd[i] = 0
        slab.bill_spec[i] = 0
        slab.bill_copy[i] = 0
        slab.bill_pages[i] = 0
        slab.suffix_toks[i] = 0
        slab.admit_t[i] = 0.0
        if slab.req[i] is not None and slab.req[i].span is not None:
            slab.n_traced -= 1
            slab.prof0[i] = None
        slab.req[i] = None
        slab.sid[i] = None
        slab.gen[i] += 1
        slab.dfa[i] = 0
        d = slab.dev
        d["prompt_toks"][i] = self.tokenizer.pad_id
        d["prompt_lens"][i] = 0
        d["prev"][i] = self.tokenizer.pad_id
        d["done"][i] = True
        d["page_table"][i] = 0
        d["pos"][i] = 0
        d["st"][i] = 0
        d["emitted"][i] = 0
        d["budgets"][i] = 0
        d["cur"][i] = self.tokenizer.pad_id
        d["temp"][i] = 0.0
        d["cons"][i] = False
        d["dfa"][i] = 0
        d["hstate"][i] = 0.0
        self.metrics.kv_page_utilization.set(self._allocator.stats().utilization)
        self.metrics.batch_occupancy.set(slab.n_active)

    def _release_rows(self, slab: _Slab) -> list[GenerateRequest]:
        """Release every resident row; returns their requests, for the
        caller to fail once it has finished its own state changes."""
        released = []
        for i in range(slab.B):
            r = slab.req[i]
            if r is not None:
                self._release_row(slab, i)
                released.append(r)
        return released

    # ------------------------------------------------------------ admission
    def _admit(self, slab: _Slab, pending: "deque[GenerateRequest]") -> None:
        """Admission gate. An empty slab latches the batching mode and the
        speculation settings from the live config; while rows admitted under
        other settings are resident, admission waits for them to drain.
        Homogeneous: an empty slab takes the head request's sampling config;
        an incompatible head that has waited ``fairness_timeout_s`` stops
        admissions so the slab drains. Heterogeneous: any request fits any
        free row, in strict queue order. Either way a busy slab with few free
        rows waits (up to ``admit_max_wait_s``) for a worthwhile cohort.
        With the prefix cache on, the pending line is sorted by resident
        prefix depth (EDF-safe) and the head request's declared shared
        prefix is built into the tree first, held for the whole
        admission."""
        ecfg = self.config.engine
        free = slab.free_rows()
        if self._spill_tier is not None:
            # A new admission cycle: the tier's copy budget resets (spills
            # and readmits share it; past it they degrade, never wait).
            self._spill_tier.begin_cycle()
        if slab.n_active == 0:
            slab.hetero = ecfg.hetero_batch
            slab.spec_k = self._spec_k()
            slab.spec = slab.spec_k > 0
            slab.spec_draft = ecfg.speculative.draft
        elif slab.hetero != ecfg.hetero_batch or slab.spec_k != self._spec_k() or (
            slab.spec and slab.spec_draft != ecfg.speculative.draft
        ):
            return
        hetero = slab.hetero
        if not hetero and slab.n_active == 0:
            head = pending[0]
            slab.constrained = head.constrained
            slab.temperature = head.temperature
            slab.grammar = head.grammar
        elif not hetero and not slab.compatible(pending[0]) and (
            time.monotonic() - pending[0].enqueued_at > ecfg.fairness_timeout_s
        ):
            return
        elif slab.n_active and len(free) < (ecfg.admit_min_free or max(1, slab.B // 4)) and (
            time.monotonic() - self._last_admit_t < ecfg.admit_max_wait_s
        ):
            return
        prof = self._iter_prof
        if ecfg.prefix_cache:
            t_ls = prof.mark() if prof is not None else 0.0
            self._locality_sort(slab, pending)
            if prof is not None:
                prof.carve("locality_sort", t_ls)
        if hetero:
            head_req = next((r for r in pending if not r.future.cancelled()), None)
        else:
            head_req = next((r for r in pending if slab.compatible(r)), None)
        if head_req is None:
            return
        head_key = head_req.prefix_key(ecfg.kv_page_size) if ecfg.prefix_cache else None
        warm_head = self._pop_warm_head(head_req) if ecfg.prefix_cache and self._warm_heads else None
        if head_key is not None and self._spill_tier is not None:
            # The snapshot records the declared heads served (an LRU of 64).
            self._declared_heads[head_key] = head_req.tenant
            self._declared_heads.move_to_end(head_key)
            while len(self._declared_heads) > 64:
                self._declared_heads.popitem(last=False)
        hold: Optional[PrefixNode] = None
        if head_key is not None or warm_head is not None:
            # A snapshot head whose KV could not be restored is rebuilt
            # here, at the first request it prefixes.
            t_pm = prof.mark() if prof is not None else 0.0
            try:
                if warm_head is not None and self._ensure_prefix(warm_head[0], tenant=warm_head[1]) is None:
                    # Refused (pages, geometry): it waits for the next
                    # request it prefixes.
                    self._warm_heads.append(warm_head)
                if head_key is not None:
                    hold = self._ensure_prefix(head_key, tenant=head_req.tenant)
            except BaseException as e:  # the build's failure fails the residents
                if warm_head is not None:
                    self._warm_heads.append(warm_head)
                log.exception("prefix build failed; failing resident rows")
                failed = self._release_rows(slab)
                self._drop_tree_after_failure()
                _fail(failed, e)
                return
            finally:
                if prof is not None:
                    prof.carve("prefix_match", t_pm)
        if hold is not None:
            # Page-pressure eviction inside the cohort must not free the
            # head this admission wires into page tables.
            hold.refs += 1
        try:
            self._admit_cohort(slab, pending)
        finally:
            if hold is not None:
                hold.refs -= 1

    def _locality_sort(self, slab: _Slab, pending: "deque[GenerateRequest]") -> None:
        """Reorder the pending line by shared-prefix depth against the
        resident tree, deepest first, through the EDF-safe sort: over-age
        requests and requests whose deadline cannot afford a regroup keep
        earliest-deadline-first order at the front. Stable, so an empty tree
        keeps arrival order; bounded to four slabs' worth of requests."""
        if len(pending) < 2 or not self._prefix_cache.n_nodes:
            return
        window = min(len(pending), 4 * slab.B)
        items = list(pending)
        head, tail = items[:window], items[window:]
        cache = self._prefix_cache
        ordered = locality_order(
            head,
            now=time.monotonic(),
            depth_of=lambda r: cache.probe(r.prompt_ids),
            enqueued_of=lambda r: r.enqueued_at,
            deadline_of=lambda r: r.deadline_at,
            age_cap_s=self.config.engine.fairness_timeout_s,
            # A request that is not urgent tolerates about one regrouped
            # cohort: two service intervals plus dispatch noise.
            deadline_slack_s=2.0 * self._ewma_service_s + 0.05,
        )
        if any(a is not b for a, b in zip(ordered, head)):
            pending.clear()
            pending.extend(ordered)
            pending.extend(tail)

    def _ensure_prefix(self, key: tuple, tenant: str = "default") -> Optional[PrefixNode]:
        """Make the declared shared head ``key`` resident in the tree,
        charged to ``tenant``, prefilling only what the tree does not hold
        yet (one row: a suffix prefill from the matched depth, or a dense
        prefill from 0; a spilled part of the match is readmitted first).
        Returns the deepest node covering ``key`` (unpinned), or None when
        it cannot be built now (pages, capacity); rows then reuse whatever
        is resident."""
        ecfg = self.config.engine
        cache = self._prefix_cache
        psz = ecfg.kv_page_size
        P = len(key)
        capacity = ecfg.max_pages_per_seq * psz
        n, pages, mnode = cache.match(key, cap=P, record=False)
        if n == P:
            return mnode
        # The head must leave room for a minimal suffix and decode budget,
        # and its unmatched rest must fit a prefill bucket: checked before
        # any page is allocated.
        R = P - n
        eligible = tuple(b for b in self._prefill_buckets if b + n <= capacity)
        if (
            not eligible
            or R > eligible[-1]
            or P + self._prefill_buckets[0] + ecfg.max_decode_len > capacity
        ):
            return None
        T = _bucket(R, eligible)
        if mnode is not None:
            mnode.refs += 1  # the insert below may evict under pressure
        node = cache.insert(key, n, R, tenant=tenant)
        if mnode is not None:
            mnode.refs -= 1
        if node is None:
            return None
        table = np.zeros((1, ecfg.max_pages_per_seq), np.int32)
        table[0, : n // psz] = pages
        table[0, n // psz : P // psz] = node.pages
        tokens = np.full((1, T), self.tokenizer.pad_id, np.int64)
        tokens[0, :R] = key[n:]
        up = self._upload
        lens = up(np.asarray([R], np.int64))
        try:
            if n > 0:
                self._suffix_prefill(up(tokens), lens, up(np.asarray([n], np.int64)), up(table))
            else:
                # Long shared heads are the prime ring workload: routed as
                # any full prefill.
                ring = self._ring_ok(T)
                if ring:
                    self.metrics.ring_prefills.inc()
                self._dense_prefill(up(tokens), lens, up(table), ring=ring)
        except BaseException:
            cache.rollback(node)
            raise
        # The build is prefill work, counted once per resident head.
        self._stats["prefill_tokens"] += R
        self.metrics.prefill_tokens.inc(R)
        cache.seal()
        node.refs -= 1  # drop the insert's pin; callers pin again
        return node

    def _evict_prefixes(self, need_tokens: int = 0) -> None:
        """Reclaim refcount-0 radix subtrees (LRU leaves first) while over
        the node cap or until ``need_tokens`` worth of pages can be
        allocated. The cap is read from the live config."""
        self._prefix_cache.max_nodes = max(0, self.config.engine.prefix_cache_entries)
        self._prefix_cache.evict(need_tokens)

    def _ring_ok(self, T: int) -> bool:
        """True when a ``T``-token full prefill takes the ring route: the
        threshold is met, a seq mesh exists, and the bucket divides the seq
        axis. A pure predicate: the metric counts at the serving call sites."""
        if self._seq_mesh is None or T < self.config.engine.ring_prefill_min_tokens:
            return False
        return T % self._seq_mesh.shape[SEQ_AXIS] == 0

    def _dense_prefill(self, tokens_d, lens_d, table_d, ring: bool = False) -> torch.Tensor:
        """Full prefill of [A, T] prompts from position 0, its K/V scattered
        into the page pools; returns each row's last-token logits. ``ring``:
        the causal pass runs as ring attention over ``_seq_mesh`` (no
        [A, T, T] mask or score matrix exists), with the same contract."""
        A, T = tokens_d.shape
        cfg = self.model_cfg
        self._pf_entry = self.costs.record("prefill", (A, T), lambda: forward_cost(
            cfg, batch=A, width=T, context=T, unembed_rows=A, unembed_cols=cfg.vocab_size,
            quantized=self._quantized,
        ))
        dense = init_kv_cache(self.model_cfg, A, T, device=self.device, layout=self._layout)
        if ring:
            last, dense = ring_prefill(
                self._params, self.model_cfg, tokens_d, lens_d, self._seq_mesh, dense, last_only=True,
                layout=self._layout,
            )
        else:
            last, dense = prefill(
                self._params, self.model_cfg, tokens_d, lens_d, dense, last_only=True, layout=self._layout
            )
        commit_prefill_to_pages(self._paged_kv, dense, table_d, lens_d, self.config.engine.kv_page_size,
                                layout=self._layout)
        return last

    def _suffix_prefill(self, tokens_d, lens_d, pos_d, table_d) -> torch.Tensor:
        """Prefill only the prompt suffixes: one ``decode_chunk_paged``
        forward at prefill width whose queries start at each row's matched
        depth and attend the tree's read-only pages and themselves. Per-row
        suffix lengths are the kernel's ``q_lens``. Pad slots past a row's
        suffix write K/V in the row's private pages or the null page, which
        decode later overwrites or nothing reads. Returns each row's
        last-suffix-token logits."""
        A, T = tokens_d.shape
        cfg, ecfg = self.model_cfg, self.config.engine
        self._pf_entry = self.costs.record("suffix_prefill", (A, T), lambda: forward_cost(
            cfg, batch=A, width=T, context=ecfg.max_pages_per_seq * ecfg.kv_page_size,
            unembed_rows=A, unembed_cols=cfg.vocab_size, quantized=self._quantized,
        ))
        n0 = kernel_launches()["ragged_paged_attention"]
        last, _ = decode_chunk_paged(
            self._params, self.model_cfg, tokens_d, pos_d, table_d, self._paged_kv,
            logits_at=lens_d - 1, q_lens=lens_d, layout=self._layout,
        )
        self._stats["suffix_prefills"] += 1
        self._stats["suffix_prefill_launches"] += kernel_launches()["ragged_paged_attention"] - n0
        return last

    # ------------------------------------------ tiered KV cache: page copies
    def _kv_itemsize(self) -> int:
        """Bytes of one element of the KV pools (every card's alike)."""
        return pools_on(self._paged_kv, self._layout)[0][2]["k"].element_size()

    def _copy_cost(self, n_pages: int):
        """The cost function of one tier copy of ``n_pages`` pages: the
        unmeshed run's bytes, billed once whatever the cards it touches."""
        psz, elt = self.config.engine.kv_page_size, self._kv_itemsize()
        return lambda: spill_copy_cost(self.model_cfg, pages=n_pages, page_size=psz, elt_bytes=elt)

    @owned_by("engine-worker")
    def _spill_gather(self, pages: list[int]) -> tuple:
        """The tier's gather (``parallel.transfer.gather_run``): ``pages`` of
        both pools copied into a fresh device tensor on each card it reads
        (the run as it is now: a later write to the freed pages is ordered
        after this copy on that card's stream), then into the KV-head slices
        of pinned host tensors without blocking, with an event recorded
        after the copies on each card. Returns (k, v, events, what the
        copies read); on the CPU the gathered tensors themselves, ready at
        once. Counted in ``costs`` as ``spill_gather`` by the bytes it moves
        (eager: never a capture)."""
        n = len(pages)
        self.costs.record("spill_gather", (n,), self._copy_cost(n))
        return gather_run(self._paged_kv, self._layout, pages)

    @owned_by("engine-worker")
    def _spill_readmit(self, k_host: torch.Tensor, v_host: torch.Tensor, pages: list[int]) -> None:
        """The tier's readmit (``parallel.transfer.readmit_run``): a landed
        run copied without blocking to every card whose pools hold its heads
        (each data replica), then into ``pages`` of the pools in place (a
        pool is never rebound: captured windows read them at their
        addresses), ahead of the prefill that reads them on each card's
        stream. The pinned source is held until the event after the copies
        on every card has passed. The run must cover exactly ``pages``: the
        reference pads both copies to a page bucket whose pad lanes drop,
        the port copies the run as it is."""
        n = len(pages)
        if k_host.shape[2] != n or v_host.shape != k_host.shape:
            raise EngineError(f"readmit of a {tuple(k_host.shape)} run into {n} pages")
        self.costs.record("spill_readmit", (n,), self._copy_cost(n))
        self._prune_readmit_holds()
        events = readmit_run(self._paged_kv, self._layout, k_host, v_host, pages)
        if events:
            self._readmit_holds.append((events, (k_host, v_host)))

    def _prune_readmit_holds(self) -> None:
        """Release the pinned sources of readmits whose copies are done
        (an ``event.query()`` each, never a wait)."""
        holds = self._readmit_holds
        while holds and all(e.query() for e in holds[0][0]):
            holds.popleft()

    # --------------------------------- tiered KV cache: warm-restart snapshot
    _SNAPSHOT_VERSION = 1

    def _snapshot_meta(self) -> dict:
        """What a snapshot must agree on to be restored, as the reference
        writes it (``dtype`` by its numpy name, "bfloat16"), so a snapshot
        written by either package validates in the other."""
        mc = self.model_cfg
        return {
            "version": self._SNAPSHOT_VERSION,
            "page_size": self.config.engine.kv_page_size,
            "n_kv_heads": mc.n_kv_heads,
            "n_layers": mc.n_layers,
            "head_dim": mc.head_dim,
            "dtype": str(torch_dtype(mc.dtype)).removeprefix("torch."),
            "vocab_size": self.tokenizer.vocab_size,
        }

    def _params_fingerprint(self) -> Optional[float]:
        """The reference's identity check of the weights a snapshot's KV was
        computed under: the position-weighted fp32 abs-sum over the leaves
        in ``jax.tree_util.tree_leaves`` order (sorted dict keys at every
        level), so the same weights give the same number in both packages
        and on every layout (within the restore's 1e-3 relative tolerance):
        each leaf is read exactly once, through the blocks that hold it on
        a mesh of cards (``params.leaf_blocks``). Snapshot path only."""
        try:
            total = 0.0
            blocks = leaf_blocks(self._params, self._layout)  # mcpx: ignore[thread-ownership] - worker thread (setup) or post-join teardown (aclose guard)
            for i, parts in enumerate(blocks):
                total += (i + 1.0) * sum(float(b.abs().float().sum()) for b in parts)
            return total
        except Exception:  # no fingerprint: no KV restore
            log.debug("params fingerprint unavailable", exc_info=True)
            return None

    def _save_snapshot(self) -> None:
        """Write the warm-restart snapshot: a versioned JSON manifest (tree
        structure root first, declared heads, governor weights, model
        identity) and a sidecar ``.npz`` of the runs' raw KV bytes, within
        the tier's host byte budget, each file replaced atomically. Called
        by ``aclose`` once the worker has joined, before the pools drop."""
        ecfg = self.config.engine
        path = os.path.expanduser(ecfg.kv_tier.snapshot_path)
        tier = self._spill_tier
        cache = self._prefix_cache
        tier.drain()  # mcpx: ignore[thread-ownership] - worker joined (aclose guard); blocking shutdown drain
        nodes_out: list[dict] = []
        arrays: dict[str, np.ndarray] = {}
        budget = tier.host_bytes or (256 << 20)
        total = 0
        # Root-first BFS: every entry's parent precedes it, the order
        # RadixPrefixCache.restore_spilled needs.
        todo = deque([(cache.root, ())])
        while todo:
            node, prefix = todo.popleft()
            for child in node.children.values():
                cpath = prefix + child.tokens
                if child.pending:
                    continue
                if child.host is not None and child.host.ready:
                    k, v = child.host.k, child.host.v
                elif child.pages:
                    k, v, events, _src = gather_run(self._paged_kv, self._layout, child.pages)  # mcpx: ignore[thread-ownership] - worker joined (aclose guard); teardown read
                    for e in events:
                        e.synchronize()
                else:
                    continue
                nbytes = nbytes_of(k) + nbytes_of(v)
                if total + nbytes > budget:
                    continue  # keep walking: a smaller sibling may fit
                total += nbytes
                key = f"n{len(nodes_out)}"
                arrays[f"{key}_k"] = _raw_bytes(k)
                arrays[f"{key}_v"] = _raw_bytes(v)
                nodes_out.append({
                    "path": [int(t) for t in cpath],
                    "edge": len(child.tokens),
                    "tenant": child.tenant,
                    "key": key,
                    "shape": list(k.shape),
                })
                todo.append((child, cpath))
        manifest = {
            **self._snapshot_meta(),
            "fingerprint": self._params_fingerprint(),
            "governor": self._governor.snapshot() if self._governor is not None else {},
            "declared_heads": [
                {"ids": [int(t) for t in k], "tenant": t}
                for k, t in self._declared_heads.items()  # mcpx: ignore[thread-ownership] - worker joined (aclose guard); teardown read
            ],
            "nodes": nodes_out,
        }
        chaos = tier.chaos
        with open(path + ".npz.tmp", "wb") as f:
            np.savez(f, **arrays)
        os.replace(path + ".npz.tmp", path + ".npz")
        with open(path + ".tmp", "w") as f:
            if chaos is not None and chaos.snapshot_corrupt:
                f.write(json.dumps(manifest)[:40] + "...TRUNCATED")
            else:
                json.dump(manifest, f)
        os.replace(path + ".tmp", path)
        log.info(
            "KV snapshot saved: %d runs, %.1f MiB, %d declared heads -> %s",
            len(nodes_out), total / (1 << 20),
            len(self._declared_heads),  # mcpx: ignore[thread-ownership] - worker joined (aclose guard); teardown read
            path,
        )

    def _load_snapshot(self) -> None:
        """Restore a snapshot written by a clean ``aclose`` (of either
        package): its runs become spilled nodes, readmitted by the standard
        page copy at their first match. A corrupt, stale or mismatched
        snapshot is logged and skipped, never fatal; when the weights'
        fingerprint differs, only the declared heads' ids are kept, rebuilt
        lazily by the first request each prefixes. Worker thread, at
        setup."""
        path = os.path.expanduser(self.config.engine.kv_tier.snapshot_path)
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                manifest = json.load(f)
            for k, want in self._snapshot_meta().items():
                if manifest.get(k) != want:
                    raise ValueError(f"snapshot {k}={manifest.get(k)!r} != engine {want!r}")
        except Exception as e:  # corrupt or stale: start cold
            log.warning("KV snapshot unusable, starting cold: %s", e)
            return
        if self._governor is not None:
            try:
                self._governor.restore(manifest.get("governor") or {})
            except Exception:  # the governor's weights are advisory
                log.warning("snapshot governor state unusable", exc_info=True)
        heads = [
            (tuple(int(t) for t in h.get("ids", ())), str(h.get("tenant", "default")))
            for h in manifest.get("declared_heads", ())
            if h.get("ids")
        ]
        fp_then = manifest.get("fingerprint")
        fp_now = self._params_fingerprint()
        kv_ok = fp_then is not None and fp_now is not None and abs(fp_then - fp_now) <= 1e-3 * max(1.0, abs(fp_then))
        restored = 0
        if kv_ok:
            try:
                dtype = torch_dtype(self.model_cfg.dtype)
                with np.load(path + ".npz") as npz:
                    for ent in manifest.get("nodes", ()):
                        shape = tuple(int(x) for x in ent["shape"])
                        k = self._host_run(npz[ent["key"] + "_k"], shape, dtype)
                        v = self._host_run(npz[ent["key"] + "_v"], shape, dtype)
                        if self._prefix_cache.restore_spilled(
                            [int(t) for t in ent["path"]], int(ent["edge"]), k, v, str(ent.get("tenant", "default"))
                        ):
                            restored += 1
            except Exception as e:  # a partial restore still serves; the rest rebuilds
                log.warning("KV snapshot arrays unusable past %d runs: %s", restored, e)
        if not kv_ok or restored == 0:
            self._warm_heads = [h for h in heads if h[0]]
            log.info(
                "KV snapshot ids-only restore: %d heads queued for lazy re-prefill (kv_ok=%s)",
                len(self._warm_heads), kv_ok,
            )
        else:
            log.info("KV snapshot restored %d runs into the host tier", restored)
        for k, t in heads:
            self._declared_heads[k] = t

    def _host_run(self, raw: np.ndarray, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """A snapshot run's raw bytes as a host tensor of ``dtype`` (bf16
        read as 16-bit integers and viewed as bf16: the same bits), pinned
        on CUDA so its readmit is an asynchronous copy."""
        store = {torch.bfloat16: np.int16, torch.float16: np.float16, torch.float32: np.float32}[dtype]
        t = torch.from_numpy(np.frombuffer(raw.tobytes(), store).reshape(shape).copy())
        if dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _pop_warm_head(self, req: GenerateRequest) -> Optional[tuple]:
        """The longest snapshot head strictly prefixing ``req``'s prompt
        (ids-only restore), popped for its one lazy rebuild."""
        best = None
        best_i = -1
        for i, (ids, tenant) in enumerate(self._warm_heads):
            if len(ids) < len(req.prompt_ids) and tuple(req.prompt_ids[: len(ids)]) == ids:
                if best is None or len(ids) > len(best[0]):
                    best, best_i = (ids, tenant), i
        if best is not None:
            self._warm_heads.pop(best_i)
        return best

    def _admit_cohort(self, slab: _Slab, pending: "deque[GenerateRequest]") -> None:
        """Admit a cohort in three stages: the candidate scan; the
        prefill-bucket fix-point over matched depths (every row keeps
        ``P + T <= capacity``, so a suffix window's pad slots index the page
        table inside its width); then, row by row, match and pin, insert the
        prompt's aligned rest, allocate the row's private pages (evicting
        tree leaves under pressure) or push the row back. The cohort then
        prefills in one call: the suffix prefill when any row matched, the
        dense prefill otherwise. On the heterogeneous slab every constrained
        candidate takes a grammar slot at the scan, and one that finds none
        waits (and, once it has waited ``fairness_timeout_s``, holds back
        everything behind it until a slot drains)."""
        ecfg = self.config.engine
        tok = self.tokenizer
        free = slab.free_rows()
        cache = self._prefix_cache
        use_prefix = bool(ecfg.prefix_cache)
        psz = ecfg.kv_page_size
        hetero = slab.hetero  # the latched mode, not the live flag
        # Every row's pages carry its window's garbage-write slack: the
        # speculative window's K+1, else the fast-forward chunk (the
        # heterogeneous slab always runs the constrained width).
        if hetero and slab.spec:
            chunk = slab.spec_k + 1
        else:
            chunk = self._spec_chunk(True if hetero else slab.constrained)
        slack = chunk if chunk > 1 else 0
        capacity = ecfg.max_pages_per_seq * psz
        eligible = tuple(b for b in self._prefill_buckets if b <= capacity)
        if min(slab.steps, capacity - 1 - slack) < 1 or not eligible:
            err = EngineError(
                f"page capacity {capacity} (max_pages_per_seq*kv_page_size) "
                "cannot fit any decode budget/prefill bucket"
            )
            while pending:
                r = pending.popleft()
                r.loop.call_soon_threadsafe(_resolve, r.future, None, err)
            return

        # Stage 1: candidates, not cancelled, up to the free rows: compatible
        # ones (homogeneous), or each with its grammar slot (heterogeneous).
        cands: list[GenerateRequest] = []
        slots: list[int] = []
        reserved: set = set()
        defer: list[GenerateRequest] = []
        while pending and len(cands) < len(free):
            r = pending.popleft()
            if r.future.cancelled():
                continue
            slot = 0
            if hetero and r.constrained:
                slot = self._grammar_slot_for(r.grammar or self.grammar, reserved)
                if slot is None:
                    defer.append(r)
                    if time.monotonic() - r.enqueued_at > ecfg.fairness_timeout_s:
                        break
                    continue
                reserved.add(slot)
            elif not hetero and not slab.compatible(r):
                defer.append(r)
                continue
            cands.append(r)
            slots.append(slot)

        def geometry(r: GenerateRequest, P: int) -> tuple[int, list[int]]:
            """(decode budget, suffix ids) of ``r`` admitted at matched
            depth ``P``; the prompt head is kept on overflow (the planner
            ranks its best candidates first)."""
            budget = max(1, min(r.max_new_tokens, min(slab.steps, capacity - 1 - slack - P)))
            last = max(b for b in eligible if b + P <= capacity)
            longest = min(last, capacity - P - budget - slack)
            return budget, r.prompt_ids[P : P + longest] or [tok.bos_id]

        def usable_depth(r: GenerateRequest, cap_tokens: int) -> int:
            """Matched depth of ``r`` under ``cap_tokens``; 0 when that
            depth leaves no room for a decode budget or a prefill bucket."""
            if not use_prefix or cap_tokens <= 0:
                return 0
            P = cache.probe(r.prompt_ids, min(cap_tokens, cache.match_cap(len(r.prompt_ids))))
            if P <= 0:
                return 0
            if min(slab.steps, capacity - 1 - slack - P) < 1 or not any(
                b + P <= capacity for b in eligible
            ):
                return 0
            return P

        # Stage 2: per-row depths and the cohort's bucket T depend on each
        # other (a shallower match grows the suffix, which can grow T).
        # Plan under a T, recompute the T the plan needs, repeat while it
        # grows: T only grows, so this ends within len(eligible) passes of
        # read-only probes.
        prof = self._iter_prof
        t_pm = prof.mark() if prof is not None else 0.0
        T = eligible[0]
        while True:
            planned = []
            worst = 1
            for r in cands:
                P = usable_depth(r, capacity - T)
                budget, ids = geometry(r, P)
                planned.append((P, budget, ids))
                worst = max(worst, len(ids))
            need_T = _bucket(worst, eligible)
            if need_T <= T:
                break
            T = need_T
        if prof is not None:
            # The radix-probe fix-point is admission's prefix-matching cost.
            prof.carve("prefix_match", t_pm)

        # Stage 3: match and pin, insert, allocate.
        cohort: list[tuple] = []  # (req, budget, ids, sid, pages, P, tree pages, mnode, inode)
        cohort_slots: list[int] = []
        pushback: list[GenerateRequest] = []
        # Cost ledger: the readmit copy tokens each admitted row's match
        # pulled host-to-device (the tier's counter delta around it).
        ledger_on = self._ledger_seen is not None
        tier = self._spill_tier
        copy_toks: list[int] = []
        readmitted = lambda: tier.readmit_tokens if tier is not None else 0  # noqa: E731
        for r, slot, (P, budget, ids) in zip(cands, slots, planned):
            if pushback:
                pushback.append(r)  # FIFO: wait for pages, order kept
                continue
            copy0 = readmitted()
            mnode: Optional[PrefixNode] = None
            mpages: list[int] = []
            if P > 0:
                # record=False: hits and misses count only rows that admit.
                P2, mpages, mnode = cache.match(
                    r.prompt_ids, min(capacity - T, cache.match_cap(len(r.prompt_ids))), record=False
                )
                if P2 != P:
                    # A cohort-mate's insert evicted a planned node: take the
                    # depth actually matched (P only shrinks) and clamp the
                    # regrown suffix to T, so every row keeps P + T <= capacity.
                    P = P2 if P2 and min(slab.steps, capacity - 1 - slack - P2) >= 1 else 0
                    if P == 0:
                        mpages, mnode = [], None
                    budget, ids = geometry(r, P)
                    ids = ids[:T]
            if mnode is not None:
                mnode.refs += 1
            # The prompt's page-aligned rest goes into the tree for the next
            # request sharing it; a collision or budget pressure skips the
            # caching, never the admission.
            inode: Optional[PrefixNode] = None
            ins = 0
            if use_prefix:
                want = ((P + len(ids)) // psz) * psz - P
                if want > 0:
                    inode = cache.insert(r.prompt_ids, P, want, tenant=r.tenant)
                    if inode is not None:
                        ins = want
            need = len(ids) - ins + budget + slack
            if not self._allocator.can_allocate(need):
                self._evict_prefixes(need)
                if not self._allocator.can_allocate(need):
                    if inode is not None:
                        cache.rollback(inode)
                    if mnode is not None:
                        mnode.refs -= 1
                    pushback.append(r)
                    continue
            self._seq_counter += 1
            sid = ("seq", self._seq_counter)
            pages = self._allocator.allocate(sid, need)
            if use_prefix:
                if P > 0:
                    cache.hits += 1
                    cache.matched_tokens += P
                else:
                    cache.misses += 1
                if self._governor is not None:
                    # Per-tenant reuse: matched against prefilled tokens.
                    self._governor.on_lookup(r.tenant, P, len(ids))
            tree_pages = mpages + (inode.pages if inode is not None else [])
            cohort.append((r, budget, ids, sid, pages, P, tree_pages, mnode, inode))
            cohort_slots.append(slot)
            copy_toks.append(readmitted() - copy0)
        for r in reversed(pushback):
            pending.appendleft(r)
        for r in reversed(defer):
            pending.appendleft(r)
        if not cohort:
            return

        A = _bucket(len(cohort), self._batch_buckets)
        n = len(cohort)
        tokens = np.full((A, T), tok.pad_id, np.int64)
        seq_lens = np.ones((A,), np.int64)
        positions = np.zeros((A,), np.int64)  # each row's suffix start
        active = np.zeros((A,), bool)
        budgets = np.zeros((A,), np.int64)
        # Per-row sampling config: each request's own on the heterogeneous
        # slab, the slab's on the homogeneous one (pad lanes stay inert).
        temp = np.zeros((A,), np.float32)
        cons = np.zeros((A,), bool)
        dfa = np.zeros((A,), np.int64)
        dfa[:n] = cohort_slots
        table = np.zeros((A, ecfg.max_pages_per_seq), np.int32)
        for j, (r, budget, ids, _sid, pages, P, tree_pages, _m, _i) in enumerate(cohort):
            ids = ids[:T]
            tokens[j, : len(ids)] = ids
            seq_lens[j] = len(ids)
            positions[j] = P
            active[j] = True
            budgets[j] = budget
            temp[j] = r.temperature if hetero else slab.temperature
            cons[j] = r.constrained if hetero else slab.constrained
            # Page table: [matched tree pages][inserted tree pages][private
            # pages]. Positions < P read the tree's run; the prefill writes
            # [P, P + len) into the inserted and private pages; pads and
            # decode land past the prompt, in private pages or the null page.
            table[j, : len(tree_pages)] = tree_pages
            table[j, len(tree_pages) : len(tree_pages) + len(pages)] = pages

        # Draft seed: each row's suffix tokens (what it prefills after its
        # radix match) and, as ``prev``, the last of them.
        ptoks = np.full((A, slab.prompt_cap), tok.pad_id, np.int64)
        ptoks[:, : min(T, slab.prompt_cap)] = tokens[:, : slab.prompt_cap]
        prev = tokens[np.arange(A), seq_lens - 1]

        t0 = time.monotonic()
        up = self._upload
        try:
            tokens_d, lens_d, pos_d = up(tokens), up(seq_lens), up(positions)
            table_d, budgets_d, active_d = up(table), up(budgets), up(active)
            ptoks_d, prev_d = up(ptoks), up(prev)
            temp_d, cons_d, dfa_d = up(temp), up(cons), up(dfa)
            if bool(positions.any()):
                last_logits = self._suffix_prefill(tokens_d, lens_d, pos_d, table_d)
            else:
                ring = self._ring_ok(tokens.shape[1])
                if ring:
                    self.metrics.ring_prefills.inc()
                last_logits = self._dense_prefill(tokens_d, lens_d, table_d, ring=ring)
            # The prefill writing this cohort's inserted nodes is launched:
            # later launches on the stream run after it, so they may read them.
            cache.seal()
            if hetero:
                cur0, st0, done0 = self._hetero_first_sample(
                    last_logits, budgets_d, active_d, temp_d, cons_d, dfa_d
                )
            else:
                cur0, st0, done0 = self._first_sample(slab, last_logits, budgets_d, active_d)
        except BaseException as e:  # fail the cohort and the resident rows
            log.exception("admission prefill failed; failing the cohort and resident rows")
            self._fail_admission(slab, cohort, e)
            return
        t1 = time.monotonic()
        self._last_admit_t = t1
        self._stats["admissions"] += 1
        self._stats["prefill_tokens"] += int(seq_lens[:n].sum())
        m = self.metrics
        m.prefill_tokens.inc(int(seq_lens[:n].sum()))
        m.admissions.inc()
        m.admitted_rows.inc(n)
        pf_entry = self._pf_entry

        rows = [free.pop(0) for _ in range(n)]
        slab.dfa[rows] = dfa[:n]
        for j, (i, (r, _budget, _ids, sid, pages, P, _tp, mnode, inode)) in enumerate(zip(rows, cohort)):
            slab.req[i] = r
            slab.sid[i] = sid
            slab.gen[i] += 1
            # The row owns the pins taken at stage 3 (match +1, insert
            # born pinned); _release_row drops them.
            slab.prefix[i] = tuple(x for x in (mnode, inode) if x is not None)
            slab.prefix_toks[i] = P
            slab.queue_ms[i] = (t0 - r.enqueued_at) * 1e3
            slab.prefill_ms[i] = (t1 - t0) * 1e3
            slab.t_decode0[i] = t1
            slab.emitted[i] = 0
            if dfa[j] > 0:
                self._dfa_slot_refs[int(dfa[j])] += 1
            m.hol_wait.observe(slab.queue_ms[i])
            if ledger_on:
                # Ledger admission facts: the suffix tokens the row
                # prefills, its private pages (the page-seconds base), the
                # readmit copy tokens its match pulled, the residency start.
                slab.suffix_toks[i] = int(seq_lens[j])
                slab.bill_pages[i] = len(pages)
                slab.bill_copy[i] = copy_toks[j]
                slab.admit_t[i] = t1
            if r.span is not None:
                self._trace_admission(slab, i, r, t0, t1, pf_entry)
        if ledger_on:
            # The admission's executed work (a declared head's build, tier
            # copies, the prefill and the first sample) over its cohort.
            self._ledger_account(slab, rows)
        # Scatter the cohort's rows into the slab; bucket-padding lanes
        # (j >= n) are dropped, never written.
        idx = up(np.asarray(rows, np.int64))
        d = slab.dev
        d["cur"][idx] = cur0[:n]
        d["pos"][idx] = pos_d[:n] + lens_d[:n]
        d["st"][idx] = st0[:n]
        d["emitted"][idx] = torch.where(done0[:n], 0, 1)
        d["done"][idx] = done0[:n]
        d["budgets"][idx] = budgets_d[:n]
        d["page_table"][idx] = table_d[:n]
        d["out_buf"][idx] = tok.pad_id
        d["out_buf"][idx, 0] = cur0[:n]
        d["prompt_toks"][idx] = ptoks_d[:n]
        d["prompt_lens"][idx] = lens_d[:n]
        d["prev"][idx] = prev_d[:n]
        d["temp"][idx] = temp_d[:n]
        d["cons"][idx] = cons_d[:n]
        d["dfa"][idx] = dfa_d[:n]
        d["hstate"][idx] = 0.0
        if hetero:
            m.resident_grammars.set(sum(1 for k in self._dfa_slot_refs[1:] if k > 0))
        # New live rows: an all-done flag from before this admission must
        # not end the next segment.
        self._flags_from = self._window_seq
        m.kv_page_utilization.set(self._allocator.stats().utilization)
        m.batch_occupancy.set(slab.n_active)

    def _trace_admission(self, slab: _Slab, i: int, r: GenerateRequest, t0: float, t1: float, pf_entry) -> None:
        """A traced row's admission: its ``engine.queue_wait`` (enqueue to
        admission start) and ``engine.prefill`` (admission start to the
        cohort's first sample enqueued, with the cohort prefill's
        roofline) spans, and the snapshots its ``engine.decode`` span will
        delta against."""
        slab.n_traced += 1
        tot = self._seg_cost_totals
        slab.cost0[i] = (tot["flops"], tot["bytes"], tot["wall_s"])
        prof = self._iter_prof
        if prof is not None:
            slab.prof0[i] = prof.totals_copy()
        r.span.child(
            "engine.queue_wait", t0=r.enqueued_at, t1=t0,
            cls="constrained" if r.constrained else "free", row=i,
        )
        pfx = (
            {"prefix_matched_tokens": int(slab.prefix_toks[i]), "prefix_hit": bool(slab.prefix_toks[i] > 0)}
            if self.config.engine.prefix_cache
            else {}
        )
        r.span.child(
            "engine.prefill", t0=t0, t1=t1, dfa_id=int(slab.dfa[i]), **pfx,
            # The cohort prefill's roofline over the admission window: the
            # whole cohort's cost, as the reference attributes it.
            **self._span_roofline(
                pf_entry.flops if pf_entry is not None else None,
                pf_entry.bytes_accessed if pf_entry is not None else None,
                t1 - t0,
            ),
        )

    def _span_roofline(self, flops: Optional[float], nbytes: Optional[float], wall_s: float) -> dict:
        """Rounded roofline attrs for engine spans: achieved FLOP/s and
        bytes/s, arithmetic intensity and, with a known card's peaks, mfu,
        bandwidth utilisation and the binding roof. Host-clock windows: with
        pipelined segments they overlap, so per-span rates are upper
        bounds; a phase's totals over its wall are the exact ones."""
        rl = rounded_roofline(
            flops, nbytes, wall_s,
            peak_flops=self._peak_flops_total, peak_bytes_s=self._peak_bytes_total,
        )
        out: dict[str, Any] = {
            k: rl[k]
            for k in ("achieved_flops_s", "achieved_bytes_s", "arithmetic_intensity", "mfu", "hbm_bw_util")
            if k in rl
        }
        if "bound" in rl:
            out["roofline_bound"] = rl["bound"]
        return out

    def _fail_admission(self, slab: _Slab, cohort: list[tuple], error: BaseException) -> None:
        """A failed admission prefill: the cohort's inserted nodes roll
        back, its matched runs are unpinned and its pages freed, the
        resident rows are released and the whole tree drops, since the
        pools may hold partial writes; only then are the cohort's and the
        residents' requests failed, so a caller that hears of the failure
        finds the engine's state whole. The pools are written in place, so
        they need no re-creation."""
        cache = self._prefix_cache
        failed = []
        for r, _b, _ids, sid, _p, _P, _tp, mnode, inode in reversed(cohort):
            if inode is not None:
                cache.rollback(inode)
            if mnode is not None:
                mnode.refs -= 1
            self._allocator.free(sid)
            failed.append(r)
        failed += self._release_rows(slab)
        self._drop_tree_after_failure()
        _fail(failed, error)

    def _first_sample(self, slab: _Slab, first_logits, budgets, active):
        """Each admitted row's first emission from its prefill logits:
        (cur0, state0, done0) with PAD substituted for finished rows.
        Constrained sampling runs in compact column space: gather the
        grammar's active columns, mask, sample a column, map it back to a
        token id. State 0 is the grammar start."""
        tok = self.tokenizer
        ecfg = self.config.engine
        A = budgets.shape[0]
        cols = first_logits.shape[-1]
        # The first sample reads the cohort's logits: no matmul work.
        self.costs.record("admit", (A, slab.constrained, cols), lambda: (0.0, 4.0 * A * cols))
        start = torch.zeros((A,), dtype=torch.int64, device=self.device)
        if slab.constrained:
            dfa = self._dfa_for(slab.grammar or self.grammar)
            trans, _mask, _dist, active_ids, eos_cols, _inv = dfa
            mask0 = self._budget_mask(dfa, start, budgets - 1)
            col = sample(
                first_logits[:, active_ids], self._generator,
                temperature=slab.temperature, top_k=ecfg.top_k, mask=mask0,
            )
            first = active_ids[col]
            done0 = eos_cols[col] | ~active | (budgets < 1)
            state0 = torch.where(done0, start, trans[start, col])
        else:
            first = sample(
                first_logits, self._generator,
                temperature=slab.temperature, top_k=ecfg.top_k, mask=self._unconstrained_mask,
            )
            done0 = (first == tok.eos_id) | ~active | (budgets < 1)
            state0 = start
        cur0 = torch.where(done0, torch.full_like(first, tok.pad_id), first)
        return cur0, state0, done0

    def _hetero_first_sample(self, first_logits, budgets, active, temp_v, cons_v, dfa_id):
        """The first emission of a heterogeneous cohort: (cur0, state0,
        done0). Every row draws two ways from one noise tensor:
        compact-column under its slot's budget mask, and full-vocabulary;
        the constrained flag selects. Temperature is a per-row vector
        (``sample_rows``), so one body serves every request mix."""
        tok = self.tokenizer
        A, V = first_logits.shape
        self.costs.record("admit", ("hetero", A, V), lambda: (0.0, 4.0 * A * V))
        sdfa = self._stacked_dfa().dfa
        strans, _smask, _sdist, sactive, seos = sdfa
        start = torch.zeros((A,), dtype=torch.int64, device=self.device)
        act_rows = sactive[dfa_id]  # [A, C]
        mask0 = self._stacked_budget_mask(sdfa, dfa_id, start, budgets - 1)
        top_k = self.config.engine.top_k
        noise = exponential_noise((A, V), self._generator, self.device)
        col = sample_rows(
            torch.gather(first_logits, 1, act_rows), self._generator, temp_v,
            top_k=top_k, mask=mask0, noise=torch.gather(noise, 1, act_rows),
        )
        u_first = sample_rows(
            first_logits, self._generator, temp_v, top_k=top_k, mask=self._unconstrained_mask, noise=noise
        )
        first = torch.where(cons_v, act_rows[torch.arange(A, device=self.device), col], u_first)
        ended = torch.where(cons_v, seos[dfa_id, col], u_first == tok.eos_id)
        done0 = ended | ~active | (budgets < 1)
        state0 = torch.where(done0 | ~cons_v, start, strans[dfa_id, start, col])
        cur0 = torch.where(done0, torch.full_like(first, tok.pad_id), first)
        return cur0, state0, done0

    # --------------------------------------------------------------- decode
    def _flag_says_all_done(self) -> bool:
        """Whether the window before the last one issued left every row
        done. Its flag was copied to a host slot without blocking; waiting
        on that window's event alone keeps the last window queued on the
        card. Flags from before the last admission are stale."""
        m = self._window_seq - 2
        if m < self._flags_from:
            return False
        slot = m % FLAG_SLOTS
        event = self._flag_events[slot]
        if event is not None:
            prof = self._iter_prof
            t_sync = prof.mark() if prof is not None else 0.0
            event.synchronize()
            if prof is not None:
                prof.carve("sync", t_sync)
            self._stats["flag_waits"] += 1
        else:
            self._stats["flag_reads_no_event"] += 1
        return bool(self._flag_np[slot])

    def _note_window(self, all_done: torch.Tensor) -> None:
        """After a window: its all-done flag into its host slot, without
        blocking, and the event that marks the copy (both outside any
        graph)."""
        slot = self._window_seq % FLAG_SLOTS
        self._flag_host[slot].copy_(all_done, non_blocking=True)
        event = self._flag_events[slot]
        if event is not None:
            event.record()
        self._window_seq += 1

    def _window_plan(self, slab: _Slab) -> tuple[tuple, Optional[tuple]]:
        """(key, grammar tables) of the slab's next window. Heterogeneous
        slab: the speculative body while the slab's latch says so, else the
        heterogeneous fast-forward, over the stacked tables. Homogeneous:
        the prompt draft for constrained greedy rows with
        ``draft_mode="prompt"`` (read from the live config) and a window
        wider than one, else fast-forward. The key holds everything a
        captured window bakes in: the body, the temperature class (greedy,
        or the temperature and top-k, constants of the graph; ``("rows",
        ...)`` where temperature is per-row data, with the speculative
        draft mode), the window width, the batch, the grammar-table bucket
        (the stack's shape, heterogeneous) and the forwards, then on a mesh
        the layout's signature. The key is also the ``window`` executable's
        signature in ``costs``."""
        key, dfa = self._window_body(slab)
        return (key if self._layout is None else key + (self._layout.signature(),)), dfa

    def _window_body(self, slab: _Slab) -> tuple[tuple, Optional[tuple]]:
        """``_window_plan``'s key without the layout, and its tables."""
        ecfg = self.config.engine
        forwards = max(1, ecfg.decode_steps_per_tick)
        if slab.hetero:
            stack = self._stacked_dfa()
            if slab.spec:
                key = ("spec", ("rows", slab.spec_draft), slab.spec_k + 1, slab.B, stack.shape, forwards)
                return key, stack.spec_dfa
            return ("hetero", ("rows",), self._spec_chunk(True), slab.B, stack.shape, forwards), stack.dfa
        constrained = slab.constrained
        chunk = self._spec_chunk(constrained)
        dfa = self._dfa_for(slab.grammar or self.grammar) if constrained else None
        use_draft = (
            ecfg.draft_mode == "prompt" and constrained and chunk > 1 and slab.temperature <= 0.0
        )
        temp = ("greedy",) if slab.temperature <= 0.0 else ("sampled", slab.temperature, ecfg.top_k)
        bucket = None if dfa is None else tuple(dfa[0].shape)
        return ("draft" if use_draft else "fast", temp, chunk, slab.B, bucket, forwards), dfa

    def _window(self, slab: _Slab, key: tuple, dfa: Optional[tuple]) -> None:
        """One window: ``key``'s forwards of its body over the slab's fixed
        state, rows that are done idling. The state is read from the slab's
        buffers and written back with ``copy_``; the forwards' live count
        and draft counts add to ``counts``; ``all_done`` is set from the
        last forward. Issues no blocking call and allocates only
        temporaries, so a CUDA graph can capture it."""
        body = {
            "draft": self._draft_forward, "fast": self._fast_forward,
            "hetero": self._hetero_forward, "spec": self._spec_forward,
        }[key[0]]
        chunk, forwards = key[2], key[5]
        d = slab.dev
        counts = d["counts"]
        state = tuple(d[k] for k in _STATE)
        for _ in range(forwards):
            counts[0].add_((~state[4]).any().long())
            state, drafts = body(slab, dfa, chunk, *state)
            if drafts is not None:
                counts[1 : 1 + drafts.shape[0]].add_(drafts)
        for k, v in zip(_STATE, state):
            d[k].copy_(v)
        d["all_done"].copy_(state[4].all())

    def _run_window(self, slab: _Slab, key: tuple, dfa: Optional[tuple]) -> None:
        """Run one window: on the CPU eagerly; on CUDA by replaying its
        captured graph, capturing it first when the key is new (that first
        run is the capture's warm-up, eager on the capturing stream)."""
        self._record_window(key)
        if self.device.type != "cuda" or self._eager_windows:
            self._window(slab, key, dfa)
            self._stats["eager_windows"] += self._eager_windows
            return
        graph = self._graphs.get(key)  # mcpx: ignore[jit-static-branch] - homogeneous-mode debt: per-request temperature/constrained ARE trace statics here, bounded by the slab-wide compat triple (one config per occupancy, drain-to-switch); hetero_batch moves both into per-row device state
        if graph is None:
            self._capture(key, lambda: self._window(slab, key, dfa), serving=True)
            return
        graph.replay()
        count_replay(self._graph_launches[key], self._graph_designs[key])
        self._stats["replays"] += 1

    def _record_window(self, key: tuple) -> None:
        """Count one run of the window ``key`` in ``costs``: the key's first
        run is its capture on CUDA (its first eager run on the CPU). Its
        cost is ``telemetry.costs.window_cost`` of the body at the key's
        width, batch, grammar columns and forwards."""
        cfg, ecfg = self.model_cfg, self.config.engine
        body, _temp, chunk, B, bucket, forwards = key[:6]
        self.costs.record("window", key, lambda: window_cost(
            cfg, body, batch=B, width=chunk, context=ecfg.max_pages_per_seq * ecfg.kv_page_size,
            columns=bucket[-1] if bucket is not None else cfg.vocab_size, forwards=forwards,
            quantized=self._quantized,
        ))

    def _capture(self, key: tuple, fn, serving: bool) -> None:
        """Run ``fn`` once eagerly on the capturing stream (its real work,
        and the warm-up that sizes every buffer), then capture it into a
        CUDA graph in the engine's one memory pool. The stream's ticket
        buffer is held for the widest window first, so no capture bakes in
        a buffer that a later launch replaces. A sampled window's graph has
        the engine's generator registered, so each replay draws anew; so has
        every heterogeneous window's, whose temperature is per-row data. A
        failed capture raises EngineError; there is no eager retry. The
        capture itself holds ``_CAPTURE_LOCK``, so its launch record holds
        its own launches alone whether or not ``DEVICE_LOCK`` is held."""
        with DEVICE_LOCK:
            stream = self._capture_stream
            main = torch.cuda.current_stream(self.device)
            stream.wait_stream(main)
            try:
                with torch.cuda.stream(stream):
                    if not self._tickets_held:
                        cfg = self.model_cfg
                        widest = max(self._spec_chunk(True), self.config.engine.speculative.k + 1)
                        hold_tickets(
                            self.device, stream.cuda_stream,
                            ticket_count(self._slab.B, widest, cfg.n_kv_heads, cfg.q_per_kv),
                        )
                        self._tickets_held = True
                    fn()
                graph = torch.cuda.CUDAGraph()
                if key[1][0] in ("sampled", "rows"):
                    graph.register_generator_state(self._generator)
                # capture_begin/capture_end, not the ``torch.cuda.graph``
                # context: its entry synchronizes the whole device, illegal
                # while another thread's stream is capturing (the call
                # raises "operation not permitted when stream is capturing"
                # and the other capture is invalidated). The capturing
                # stream already waits on the worker's stream above.
                with _CAPTURE_LOCK, torch.cuda.stream(stream):
                    before, before_designs = captured_launches(), captured_designs()
                    graph.capture_begin(pool=self._graph_pool, capture_error_mode="thread_local")
                    try:
                        fn()
                    finally:
                        graph.capture_end()
                    launches = {k: n - before[k] for k, n in captured_launches().items()}
                    designs = {k: n - before_designs[k] for k, n in captured_designs().items()}
            except Exception as e:
                raise EngineError(f"capture of the decode window {key} failed: {e}") from e
            finally:
                main.wait_stream(stream)
            self._graphs[key] = graph  # mcpx: ignore[jit-static-branch] - homogeneous-mode debt: per-request temperature/constrained ARE trace statics here, bounded by the slab-wide compat triple (one config per occupancy, drain-to-switch); hetero_batch moves both into per-row device state
            self._graph_launches[key] = launches
            self._graph_designs[key] = designs
            self._captures[key] = self._captures.get(key, 0) + 1
            self._stats["captures" if serving else "warmup_captures"] += 1

    def _dispatch_segment(self, slab: _Slab) -> None:
        """Enqueue up to ``steps_per_dispatch`` windows over the whole slab
        (one speculative window: ``_decode_iters``), with no blocking call,
        and push the segment's in-flight record: its
        end state packed into a host buffer of its own by one copy without
        blocking. Between windows, the early exit reads the all-done flag
        of the window before the last one. Rows of a segment dispatched
        later may already have moved on; the record keeps what this one
        saw."""
        key, dfa = self._window_plan(slab)
        spec = key[0] == "spec"
        d = slab.dev
        d["counts"].zero_()
        d["acc_rows"].zero_()
        n_win = 0
        self.metrics.segments.inc()
        self.metrics.segment_active_rows.inc(slab.n_active)
        for _ in range(self._decode_iters(spec) // key[5]):
            if self._flag_says_all_done():
                break
            self._run_window(slab, key, dfa)
            self._note_window(d["all_done"])
            n_win += 1
        if spec:
            self._stats["spec_verify"] += n_win
        join_streams(self._layout)
        packed = torch.cat([d["out_buf"].reshape(-1), d["emitted"], d["done"].long(), d["counts"], d["acc_rows"]])
        event = None
        if self.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = packed
        rec = _Inflight(host, event, slab.gen.copy(), spec=spec, forwards=n_win * key[5])
        if slab.n_traced:
            # Only a segment with a traced row reads the clock: its spans
            # run from dispatch to harvest.
            rec.t_disp = time.monotonic()
            entry = self.costs.entry("window", key)
            if entry is not None:
                rec.cost = (entry.flops * n_win, entry.bytes_accessed * n_win)
        self._inflight.append(rec)
        if self._ledger_seen is not None:
            # The segment's windows over the rows resident at dispatch:
            # every one of them is billed before it retires, since its
            # retirement comes at a later harvest.
            self._ledger_account(slab, [i for i in range(slab.B) if slab.req[i] is not None])
        self._stats["segments"] += 1
        self._stats["windows"] += n_win
        self._stats["decode_forwards"] += n_win * key[5]

    @owned_by("engine-worker")
    def _fast_forward(self, slab: _Slab, dfa, chunk: int, cur, pos, st, e, done, prev):
        """One forward of the fast-forward body: ``cur`` plus, for
        constrained rows, the chain of grammar-forced tokens after it, then
        one sample at the chain's end. Returns the new (cur, pos, st,
        emitted, done, prev) and no draft counts."""
        ecfg = self.config.engine
        tok = self.tokenizer
        d = slab.dev
        B, W = slab.B, slab.steps  # out_buf column W is the drop slot
        pad, eos = tok.pad_id, tok.eos_id
        budgets, buf = d["budgets"], d["out_buf"]
        b_idx = torch.arange(B, device=self.device)
        if dfa is not None and chunk > 1:
            trans, mask_tab, _dist, active_ids, eos_cols, _inv = dfa
            # Fast-forward: the chain of grammar-forced tokens after `cur`.
            # Emission stops at the first state with more than one legal
            # column, at a forced EOS, or when the row's budget runs out
            # mid-chain (only reachable when the budget is below the
            # grammar's shortest completion).
            s, dd, er = st, done, e
            ff_toks, ff_emit = [], []
            for _ in range(chunk - 1):
                row = mask_tab[s]  # [B, C]
                t_c = torch.argmax(row.to(torch.uint8), dim=-1)
                forced = (row.sum(dim=-1) == 1) & ~dd
                is_eos = forced & eos_cols[t_c]
                emit = forced & ~is_eos & (er < budgets)
                over = forced & ~is_eos & (er >= budgets)
                s = torch.where(emit, trans[s, t_c], s)
                dd = dd | is_eos | over
                er = er + emit.long()
                ff_toks.append(torch.where(emit, active_ids[t_c], pad))
                ff_emit.append(emit)
            st1, done1, e1 = s, dd, er
            ff_toks_t = torch.stack(ff_toks, dim=1)  # [B, chunk-1]
            ff_emit_t = torch.stack(ff_emit, dim=1)
            slot = e[:, None] + torch.cumsum(ff_emit_t.long(), dim=1) - 1
            buf[b_idx[:, None], torch.where(ff_emit_t, slot, W)] = ff_toks_t
            chunk_toks = torch.cat([cur[:, None], ff_toks_t], dim=1)
            adv_extra = ff_emit_t.long().sum(dim=1)
        else:
            st1, done1, e1 = st, done, e
            chunk_toks = cur[:, None]
            adv_extra = 0
        # One forward consumes [cur, forced...]; `adv` is each row's live
        # window (0 for done rows, which idle through the forward).
        adv = torch.where(done, 0, 1) + adv_extra
        logits, _ = decode_chunk_paged(
            self._params, self.model_cfg, chunk_toks, pos, d["page_table"], self._paged_kv,
            logits_at=torch.clamp(adv - 1, min=0), q_lens=adv, layout=self._layout,
        )
        if dfa is not None:
            trans, _mask, _dist, active_ids, eos_cols, _inv = dfa
            mask = self._budget_mask(dfa, st1, budgets - e1 - 1)
            col = sample(
                logits[:, active_ids], self._generator,
                temperature=slab.temperature, top_k=ecfg.top_k, mask=mask,
            )
            nxt_id = active_ids[col]
            newly_done = done1 | eos_cols[col] | (e1 >= budgets)
            st_next = torch.where(newly_done, st1, trans[st1, col])
        else:
            nxt_id = sample(
                logits, self._generator,
                temperature=slab.temperature, top_k=ecfg.top_k, mask=self._unconstrained_mask,
            )
            newly_done = done1 | (nxt_id == eos) | (e1 >= budgets)
            st_next = st1
        nxt = torch.where(newly_done, pad, nxt_id)
        buf[b_idx, torch.where(newly_done, W, e1)] = nxt
        # prev: the token just before the new cur, the chain's last.
        prev2 = torch.where(done | newly_done, prev, chunk_toks[b_idx, torch.clamp(adv - 1, min=0)])
        e2 = e1 + torch.where(newly_done, 0, 1)
        return (nxt, pos + adv, st_next, e2, newly_done, prev2), None

    @owned_by("engine-worker")
    def _draft_forward(self, slab: _Slab, dfa, chunk: int, cur, pos, st, e, done, prev):
        """One forward of the prompt-draft body (constrained, greedy):
          1. the continuation after the last (prev, cur) bigram match in the
             row's own prompt suffix (the latest match is the most local);
          2. a proposal chain of ``chunk - 1`` tokens: a forced token
             always, a continuation token while the chain stays in step
             with the continuation and the token is legal and not EOS;
          3. one forward over [cur, proposals] with logits over the
             grammar's active columns at every slot (``q_lens`` = 1 + the
             proposals, 0 for done rows);
          4. verification: the accepted prefix is where each proposal is the
             budget-masked greedy argmax at its slot;
          5. the correction token, sampled at the first unaccepted slot.
        Emits the accepted prefix and the correction: what one-token greedy
        decode would emit, in fewer forwards. Returns the new (cur, pos,
        st, emitted, done, prev) and the forward's drafted and accepted
        counts (proposals the grammar did not force), stacked."""
        trans, mask_tab, dist, active_ids, eos_cols, inv = dfa
        ecfg = self.config.engine
        d = slab.dev
        dev = self.device
        pad = self.tokenizer.pad_id
        B, W = slab.B, slab.steps
        budgets, buf = d["budgets"], d["out_buf"]
        ptoks, plens = d["prompt_toks"], d["prompt_lens"]
        J, Lp = chunk - 1, ptoks.shape[1]
        b_idx = torch.arange(B, device=dev)
        j_ar = torch.arange(J, device=dev)

        # 1. The continuation after the last bigram match.
        m = (ptoks[:, :-1] == prev[:, None]) & (ptoks[:, 1:] == cur[:, None])
        m &= (torch.arange(Lp - 1, device=dev)[None, :] + 2) < plens[:, None]
        has = m.any(dim=1)
        last_i = (Lp - 2) - torch.argmax(m.flip(1).to(torch.uint8), dim=1)
        cont_idx = last_i[:, None] + 2 + j_ar[None, :]
        cont_ok = has[:, None] & (cont_idx < plens[:, None])
        cont = torch.gather(ptoks, 1, cont_idx.clamp(0, Lp - 1))
        cont = torch.where(cont_ok, cont, pad)  # [B, J]
        cont_col = inv[cont]  # -1: active in no state

        # 2. The proposal chain.
        s, alive, in_step = st, ~done, torch.ones_like(done)
        p_toks, p_cols, p_use, p_forced, s_before = [], [], [], [], []
        for j in range(J):
            row = mask_tab[s]  # [B, C]
            f_col = torch.argmax(row.to(torch.uint8), dim=-1)
            forced = row.sum(dim=-1) == 1
            c_col = cont_col[:, j]
            c_col_c = c_col.clamp(min=0)
            legal = (
                cont_ok[:, j] & (c_col >= 0)
                & torch.gather(row, 1, c_col_c[:, None])[:, 0] & ~eos_cols[c_col_c]
            )
            col = torch.where(forced, f_col, c_col_c)
            use = alive & torch.where(forced, ~eos_cols[f_col], in_step & legal)
            tok_j = active_ids[col]
            s_before.append(s)
            p_toks.append(torch.where(use, tok_j, pad))
            p_cols.append(col)
            p_use.append(use)
            p_forced.append(forced)
            s = torch.where(use, trans[s, col], s)
            alive = use
            in_step = in_step & (tok_j == cont[:, j])
        p_toks_t, p_cols_t = torch.stack(p_toks, 1), torch.stack(p_cols, 1)  # [B, J]
        p_use_t, forced_t = torch.stack(p_use, 1), torch.stack(p_forced, 1)
        s_bef = torch.stack(s_before, 1)

        # 3. One forward, compact logits at every slot: [B, chunk, C].
        chunk_toks = torch.cat([cur[:, None], p_toks_t], dim=1)
        logits_c, _ = decode_chunk_paged(
            self._params, self.model_cfg, chunk_toks, pos, d["page_table"], self._paged_kv,
            active_cols=active_ids, q_lens=torch.where(done, 0, 1 + p_use_t.long().sum(dim=1)),
            layout=self._layout,
        )

        # 4. Verify: the budget mask of _budget_mask at every slot.
        rem_j = budgets[:, None] - e[:, None] - j_ar[None, :] - 1
        legal_j = mask_tab[s_bef]  # [B, J, C]
        finish_j = legal_j & (eos_cols[None, None, :] | (dist[trans[s_bef]] <= rem_j[..., None]))
        mask_j = torch.where(finish_j.any(dim=-1, keepdim=True), finish_j, legal_j)
        greedy_j = torch.argmax(torch.where(mask_j, logits_c[:, :J], NEG_INF), dim=-1)
        ok = p_use_t & (greedy_j == p_cols_t) & (e[:, None] + j_ar[None, :] < budgets[:, None])
        acc = torch.cumprod(ok.long(), dim=1).bool()
        a = acc.long().sum(dim=1)  # accepted count; 0 on done rows

        # 5. The correction token at slot a.
        st1 = torch.cat([s_bef, s[:, None]], dim=1)[b_idx, a]
        e1 = e + a
        mask = self._budget_mask(dfa, st1, budgets - e1 - 1)
        col = sample(
            logits_c[b_idx, a], self._generator,
            temperature=slab.temperature, top_k=ecfg.top_k, mask=mask,
        )
        newly_done = done | eos_cols[col] | (e1 >= budgets)
        st_next = torch.where(newly_done, st1, trans[st1, col])
        nxt = torch.where(newly_done, pad, active_ids[col])
        buf[b_idx[:, None], torch.where(acc, e[:, None] + j_ar[None, :], W)] = p_toks_t
        buf[b_idx, torch.where(newly_done, W, e1)] = nxt
        adv = torch.where(done, 0, 1) + a
        prev2 = torch.where(done | newly_done, prev, chunk_toks[b_idx, a])
        e2 = e1 + torch.where(newly_done, 0, 1)
        drafted = (p_use_t & ~forced_t).long().sum()
        accepted_n = (acc & ~forced_t).long().sum()
        return (nxt, pos + adv, st_next, e2, newly_done, prev2), torch.stack([drafted, accepted_n])

    @owned_by("engine-worker")
    def _hetero_forward(self, slab: _Slab, sdfa, chunk: int, cur, pos, st, e, done, prev):
        """One forward of the heterogeneous body: each row's ``cur`` plus,
        for constrained rows, the chain of tokens its grammar slot forces
        after it (the trivial slot 0 has two legal columns everywhere, so a
        free row never forces), then one sample at the chain's end. Every
        row draws two ways from one noise tensor, compact-column under its
        slot's budget mask and full-vocabulary, at its own temperature; the
        constrained flag selects. Greedy rows mask and take the argmax as
        the homogeneous bodies do, so their outputs equal a homogeneous
        run's. Returns the new (cur, pos, st, emitted, done, prev) and no
        draft counts."""
        tok = self.tokenizer
        d = slab.dev
        B, W = slab.B, slab.steps  # out_buf column W is the drop slot
        pad, eos = tok.pad_id, tok.eos_id
        budgets, buf = d["budgets"], d["out_buf"]
        temp_v, cons_v, dfa_id = d["temp"], d["cons"], d["dfa"]
        strans, smask, _sdist, sactive, seos = sdfa
        b_idx = torch.arange(B, device=self.device)
        if chunk > 1:
            s, dd, er = st, done, e
            ff_toks, ff_emit = [], []
            for _ in range(chunk - 1):
                row = smask[dfa_id, s]  # [B, C]
                t_c = torch.argmax(row.to(torch.uint8), dim=-1)
                forced = cons_v & (row.sum(dim=-1) == 1) & ~dd
                is_eos = forced & seos[dfa_id, t_c]
                emit = forced & ~is_eos & (er < budgets)
                over = forced & ~is_eos & (er >= budgets)
                s = torch.where(emit, strans[dfa_id, s, t_c], s)
                dd = dd | is_eos | over
                er = er + emit.long()
                ff_toks.append(torch.where(emit, sactive[dfa_id, t_c], pad))
                ff_emit.append(emit)
            st1, done1, e1 = s, dd, er
            ff_toks_t = torch.stack(ff_toks, dim=1)  # [B, chunk-1]
            ff_emit_t = torch.stack(ff_emit, dim=1)
            slot = e[:, None] + torch.cumsum(ff_emit_t.long(), dim=1) - 1
            buf[b_idx[:, None], torch.where(ff_emit_t, slot, W)] = ff_toks_t
            chunk_toks = torch.cat([cur[:, None], ff_toks_t], dim=1)
            adv_extra = ff_emit_t.long().sum(dim=1)
        else:
            st1, done1, e1 = st, done, e
            chunk_toks = cur[:, None]
            adv_extra = 0
        adv = torch.where(done, 0, 1) + adv_extra
        logits, _ = decode_chunk_paged(
            self._params, self.model_cfg, chunk_toks, pos, d["page_table"], self._paged_kv,
            logits_at=torch.clamp(adv - 1, min=0), q_lens=adv, layout=self._layout,
        )
        act_rows = sactive[dfa_id]  # [B, C]
        mask = self._stacked_budget_mask(sdfa, dfa_id, st1, budgets - e1 - 1)
        top_k = self.config.engine.top_k
        noise = exponential_noise(logits.shape, self._generator, self.device)
        col = sample_rows(
            torch.gather(logits, 1, act_rows), self._generator, temp_v,
            top_k=top_k, mask=mask, noise=torch.gather(noise, 1, act_rows),
        )
        u_tok = sample_rows(
            logits, self._generator, temp_v, top_k=top_k, mask=self._unconstrained_mask, noise=noise
        )
        nxt_id = torch.where(cons_v, act_rows[b_idx, col], u_tok)
        ended = torch.where(cons_v, seos[dfa_id, col], u_tok == eos)
        newly_done = done1 | ended | (e1 >= budgets)
        st_next = torch.where(newly_done | ~cons_v, st1, strans[dfa_id, st1, col])
        nxt = torch.where(newly_done, pad, nxt_id)
        buf[b_idx, torch.where(newly_done, W, e1)] = nxt
        e2 = e1 + torch.where(newly_done, 0, 1)
        return (nxt, pos + adv, st_next, e2, newly_done, prev), None

    @owned_by("engine-worker")
    def _spec_forward(self, slab: _Slab, sdfa, chunk: int, cur, pos, st, e, done, prev):
        """One forward of the speculative body (``chunk`` = K + 1):
          1. draft: the drafter proposes up to K tokens a row through the
             row's grammar slot (``draft_window``), which also gives the
             verify window's admissibility masks;
          2. verify: one forward over the ``[B, K+1]`` window ``[cur,
             drafts]`` (``q_lens`` = 1 + the row's drafts, 0 for done rows:
             the ragged kernel's verify path), logits at every position;
             every position of every row is sampled in one vocabulary-space
             pass (``sample_window_rows``, one Gumbel draw per position) under
             its mask, gathered from column space through ``inv``;
          3. accept: the longest draft prefix the samples reproduce, then
             the sample at the first mismatch as the correction
             (``accept_rows``): what token-by-token decode would emit.
        Rejected positions wrote K/V past the accepted end, which the next
        window overwrites (admission reserves K + 1 tokens of slack). The
        drafter state advances over the accepted tokens. Returns the new
        (cur, pos, st, emitted, done, prev) and the forward's drafted and
        accepted tokens, all rows and constrained rows."""
        K = chunk - 1
        tok = self.tokenizer
        d = slab.dev
        B, W = slab.B, slab.steps
        pad, eos = tok.pad_id, tok.eos_id
        budgets, buf, h = d["budgets"], d["out_buf"], d["hstate"]
        temp_v, cons_v, dfa_id = d["temp"], d["cons"], d["dfa"]
        strans, smask, _sdist, sactive, seos, sdist_succ, sinv = sdfa
        if self._draft_embed is None:
            self._draft_embed = whole_embed(self._params, self._layout)
        embed = self._draft_embed
        b_idx = torch.arange(B, device=self.device)
        j_ar = torch.arange(K, device=self.device)

        # 1. Draft K tokens a row through the grammar pre-filter.
        p_toks, p_use, s_before, s_fin, masks_w = draft_window(
            embed, (strans, smask, sdist_succ, sactive, seos), dfa_id, st, cur, h, e, budgets,
            done, cons_v, self._draft_free_mask, pad, k=K, mode=slab.spec_draft,
        )
        # 2. One verify forward, then every position sampled at once.
        window = torch.cat([cur[:, None], p_toks], dim=1)
        n_drafted = p_use.long().sum(dim=1)
        logits_w, _ = decode_chunk_paged(
            self._params, self.model_cfg, window, pos, d["page_table"], self._paged_kv,
            q_lens=torch.where(done, 0, 1 + n_drafted), layout=self._layout,
        )  # [B, K+1, V]
        V = logits_w.shape[-1]
        col_of = sinv[dfa_id]  # [B, V] token -> column, -1 inactive
        vmask = torch.gather(
            masks_w, 2, torch.clamp(col_of, min=0)[:, None, :].expand(B, K + 1, V)
        ) & (col_of >= 0)[:, None, :]
        mask_w = torch.where(cons_v[:, None, None], vmask, self._unconstrained_mask[None, None, :])
        gumbel = -torch.log(exponential_noise(logits_w.shape, self._generator, self.device))
        tok_w = sample_window_rows(
            logits_w, temp_v, top_k=self.config.engine.top_k, mask=mask_w, gumbel=gumbel
        )  # [B, K+1]
        # 3. Accept; the sample at the first mismatch is the correction.
        acc, a = accept_rows(tok_w[:, :K], p_toks, p_use)
        e1 = e + a
        nxt_tok = tok_w[b_idx, a]
        col_a = torch.clamp(col_of[b_idx, nxt_tok], min=0)
        st1 = torch.cat([s_before, s_fin[:, None]], dim=1)[b_idx, a]
        ended = torch.where(cons_v, seos[dfa_id, col_a], nxt_tok == eos)
        newly_done = done | ended | (e1 >= budgets)
        st_next = torch.where(newly_done | ~cons_v, st1, strans[dfa_id, st1, col_a])
        nxt = torch.where(newly_done, pad, nxt_tok)
        buf[b_idx[:, None], torch.where(acc, e[:, None] + j_ar[None, :], W)] = p_toks
        buf[b_idx, torch.where(newly_done, W, e1)] = nxt
        adv = torch.where(done, 0, 1) + a  # done rows drafted nothing
        if slab.spec_draft == "recurrent":
            h.copy_(torch.where(done[:, None], h, advance_drafter_state(h, embed, window, a + 1)))
        e2 = e1 + torch.where(newly_done, 0, 1)
        d["acc_rows"].add_(a)
        cons_l = cons_v.long()
        drafts = torch.stack([n_drafted.sum(), a.sum(), (n_drafted * cons_l).sum(), (a * cons_l).sum()])
        return (nxt, pos + adv, st_next, e2, newly_done, prev), drafts

    def _harvest(self, slab: _Slab, keep_inflight: int) -> None:
        """Retire rows of in-flight segments, oldest first, until at most
        ``keep_inflight`` remain: one wait a segment, on the copy of its
        packed end state, then the rows it saw finish whose generation
        still matches go back to their requests. Done rows stop emitting,
        so a lagged out_buf row is final for a row it reports done."""
        B, W1 = slab.B, slab.steps + 1
        n_buf = B * W1
        m = self.metrics
        while len(self._inflight) > keep_inflight:
            rec = self._inflight.popleft()
            if rec.event is not None:
                prof = self._iter_prof
                t_sync = prof.mark() if prof is not None else 0.0
                rec.event.synchronize()
                if prof is not None:
                    prof.carve("sync", t_sync)
                self._stats["harvest_waits"] += 1
            else:
                self._stats["harvests_no_event"] += 1
            flat = rec.host.numpy()
            buf = flat[:n_buf].reshape(B, W1)
            e = flat[n_buf : n_buf + B]
            done = flat[n_buf + B : n_buf + 2 * B] != 0
            live, drafted, accepted, dr_cons, ac_cons = (int(x) for x in flat[n_buf + 2 * B : n_buf + 2 * B + 5])
            acc_rows = flat[n_buf + 2 * B + 5 :]
            self._stats["live_forwards"] += live
            self._stats["drafted"] += drafted
            self._stats["accepted"] += accepted
            if rec.spec:
                self._account_speculation(dr_cons, ac_cons, drafted - dr_cons, accepted - ac_cons)
            t1 = time.monotonic()
            # The reference's forward count: forwards in which a row was live.
            m.decode_forwards.inc(live)
            if rec.t_disp:
                self._trace_segment(slab, rec, e, done, live, t1)
            ledger_on = self._ledger_seen is not None
            if ledger_on:
                # Every row live in this segment was resident for its
                # forwards and keeps the speculative tokens it accepted.
                # The forwards are the reference's count for the body: the
                # live ones, but every dispatched one of a speculative
                # window (the reference's verify segment has no early exit).
                rows = np.fromiter((r is not None for r in slab.req), bool, B) & (rec.gen == slab.gen)
                slab.bill_fwd[rows] += rec.forwards if rec.spec else live
                if rec.spec:
                    slab.bill_spec[rows] += acc_rows[rows]
            for i in range(B):
                r = slab.req[i]
                if r is None or not done[i] or rec.gen[i] != slab.gen[i]:
                    continue
                ids = [int(t) for t in buf[i, : e[i]]]
                res = GenerateResult(
                    token_ids=ids,
                    text=self.tokenizer.decode(ids),
                    prompt_tokens=len(r.prompt_ids),
                    generated_tokens=len(ids),
                    queue_ms=float(slab.queue_ms[i]),
                    prefill_ms=float(slab.prefill_ms[i]),
                    decode_ms=(t1 - slab.t_decode0[i]) * 1e3,
                )
                if ledger_on:
                    # A row admitted before the ledger switched on has no
                    # residency start: its residency items stay 0.
                    resident_s = t1 - slab.admit_t[i] if slab.admit_t[i] > 0 else 0.0
                    res.bill = {
                        "engine_queue_ms": float(res.queue_ms),
                        "prefill_ms": float(res.prefill_ms),
                        "decode_ms": float(res.decode_ms),
                        "prefill_tokens": int(slab.suffix_toks[i]),
                        "prefix_saved_tokens": int(slab.prefix_toks[i]),
                        "decode_tokens": len(ids),
                        "decode_forwards": int(slab.bill_fwd[i]),
                        "spec_accepted_tokens": int(slab.bill_spec[i]),
                        "spill_copy_tokens": int(slab.bill_copy[i]),
                        "kv_pages": int(slab.bill_pages[i]),
                        "kv_page_seconds": float(int(slab.bill_pages[i]) * resident_s),
                        "flops": float(slab.bill_flops[i]),
                        "hbm_bytes": float(slab.bill_bytes[i]),
                    }
                self._ewma_service_s = ewma_update(
                    self._ewma_service_s,
                    (res.prefill_ms + res.decode_ms) / 1e3,
                    self.config.scheduler.ewma_alpha,
                )
                m.decode_tokens.inc(len(ids))
                m.engine_queue_seconds.observe(res.queue_ms / 1e3)
                m.engine_prefill_seconds.observe(res.prefill_ms / 1e3)
                exemplar = None
                if r.span is not None:
                    self._trace_decode(slab, i, r, len(ids), t1)
                    if self.config.tracing.exemplars and r.span.record.sampled:
                        exemplar = {"trace_id": r.span.trace_id}
                m.engine_decode_seconds.observe(res.decode_ms / 1e3, exemplar=exemplar)
                self._release_row(slab, i)
                self._stats["retired"] += 1
                self._stats["decode_tokens"] += len(ids)
                r.loop.call_soon_threadsafe(_resolve, r.future, res, None)

    def _account_speculation(self, dc: int, acc_c: int, df: int, acc_f: int) -> None:
        """Fold one harvested speculative segment's drafted and accepted
        tokens, by row class, into the running totals, the
        ``mcpx_engine_spec_*`` counters and the accept-rate gauges."""
        if not (dc or df):
            return
        t = self._spec_totals
        t = {
            "drafted_constrained": t["drafted_constrained"] + dc,
            "accepted_constrained": t["accepted_constrained"] + acc_c,
            "drafted_free": t["drafted_free"] + df,
            "accepted_free": t["accepted_free"] + acc_f,
        }
        self._spec_totals = t
        m = self.metrics
        for cls, n_dr, n_ac in (("constrained", dc, acc_c), ("free", df, acc_f)):
            if n_dr:
                m.spec_drafted.labels(cls=cls).inc(n_dr)
                m.spec_accepted.labels(cls=cls).inc(n_ac)
                m.spec_accept_rate.labels(cls=cls).set(t[f"accepted_{cls}"] / t[f"drafted_{cls}"])
        m.spec_accept_rate.labels(cls="overall").set(
            (t["accepted_constrained"] + t["accepted_free"]) / (t["drafted_constrained"] + t["drafted_free"])
        )

    def _trace_segment(self, slab: _Slab, rec: _Inflight, e: np.ndarray, done: np.ndarray,
                       live: int, t1: float) -> None:
        """A harvested segment with a traced row: its cost into the decode
        totals, and an ``engine.segment`` span (dispatch to harvest, with
        the tokens the row gained and the whole slab's segment roofline)
        for each traced row that emitted or finished in it."""
        wall = t1 - rec.t_disp
        flops, nbytes = rec.cost if rec.cost is not None else (None, None)
        if rec.cost is not None:
            tot = self._seg_cost_totals
            tot["flops"] += flops
            tot["bytes"] += nbytes
            tot["wall_s"] += wall
        attrs = self._span_roofline(flops, nbytes, wall)
        for i in range(slab.B):
            r = slab.req[i]
            if r is None or r.span is None or rec.gen[i] != slab.gen[i]:
                continue
            delta = int(e[i]) - int(slab.emitted[i])
            slab.emitted[i] = e[i]
            if delta <= 0 and not done[i]:
                continue
            r.span.child(
                "engine.segment", t0=rec.t_disp, t1=t1, tokens=delta, dfa_id=int(slab.dfa[i]),
                cls="constrained" if r.constrained else "free", forwards=live, **attrs,
            )

    def _trace_decode(self, slab: _Slab, i: int, r: GenerateRequest, tokens: int, t1: float) -> None:
        """A traced row's ``engine.decode`` span: admission to delivery,
        with the decode totals' delta over its residency as its roofline
        and, with a profiler attached, the worker loop's phases over it."""
        tot = self._seg_cost_totals
        prof_attrs = {}
        prof = self._iter_prof
        if prof is not None and slab.prof0[i] is not None:
            prof_attrs["worker_phases_ms"] = WorkerProfiler.delta_ms(slab.prof0[i], prof.totals)
        r.span.child(
            "engine.decode", t0=slab.t_decode0[i], t1=t1, tokens=tokens, row=i, **prof_attrs,
            **self._span_roofline(
                tot["flops"] - slab.cost0[i, 0] or None,
                tot["bytes"] - slab.cost0[i, 1] or None,
                t1 - slab.t_decode0[i],
            ),
        )


def _shares(total: float, n: int) -> np.ndarray:
    """``total`` split over ``n`` rows: integer shares (the remainder to the
    first rows) for an integral total, so the shares add up to it exactly;
    equal float shares otherwise."""
    if isinstance(total, int):
        q, r = divmod(total, n)
        return q + (np.arange(n) < r)
    return np.full(n, total / n)


def _fail(requests: list[GenerateRequest], error: BaseException) -> None:
    for r in requests:
        r.loop.call_soon_threadsafe(_resolve, r.future, None, error)


def _resolve(future: "asyncio.Future", result: Any, error: Optional[BaseException]) -> None:
    if future.cancelled():
        return
    if error is not None:
        future.set_exception(error)
    else:
        future.set_result(result)


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as uint8 (bf16 through its 16-bit pattern):
    the snapshot's storage, the same bytes the reference writes."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.frombuffer(t.numpy().tobytes(), np.uint8)
