"""InferenceEngine: continuously batched, grammar-constrained generation on
the GPU.

A small PyTorch counterpart of ``mcpx/engine/engine.py`` with the surface the
LLM planner uses (``start``/``aclose``, ``tokenizer``, ``generate``,
``prompt_capacity``) and the reference's homogeneous-slab semantics:

  - requests funnel through a thread-safe queue into one worker thread that
    owns a slab of ``max_batch_size`` decode rows;
  - admission takes a cohort of compatible requests (same constrained flag,
    temperature and grammar object) into free rows: a dense prefill of the
    padded prompts, a scatter of its K/V into the page pools, and the first
    constrained sample under the budget mask;
  - decode runs in segments of up to ``decode_steps_per_tick *
    steps_per_dispatch`` forwards. Every forward is one ``decode_chunk_paged``
    call over the whole slab whose window is ``speculate_k`` wide: the
    sampled token plus the chain of grammar-forced tokens after it
    (fast-forward). ``q_lens`` carries each row's live width, so decode,
    fast-forward and idle rows (``q_lens = 0``) share one kernel launch;
  - between segments the worker retires finished rows and admits new ones.

Left out for later slices: pipelined dispatch, the heterogeneous slab,
prompt drafting and speculative decoding, the radix prefix cache (the
``shared_prefix_len`` hint is accepted and ignored), spill and snapshots,
multi-GPU, and telemetry. Greedy outputs do not depend on any of them.

The device is explicit: ``device=None`` means CUDA and raises when CUDA is
absent; tests pass ``device="cpu"``. The tensors' device decides the
attention route (kernel on CUDA, plain version on the CPU); the engine reads
neither ``engine.use_pallas`` nor ``engine.interpret``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.errors import EngineError
from mcpx_torch.device import resolve_device
from mcpx_torch.engine.kernels.paged_attention import kernel_launches
from mcpx_torch.engine.kv_cache import PageAllocator, commit_prefill_to_pages, init_paged_kv
from mcpx_torch.engine.paged_decode import decode_chunk_paged
from mcpx_torch.engine.sampling import sample
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import init_kv_cache, prefill
from mcpx_torch.models.gemma.params import load_or_init
from mcpx_torch.models.tokenizer import make_tokenizer
from mcpx_torch.planner.grammar import PlanGrammar, build_plan_grammar

log = logging.getLogger("mcpx_torch.engine")


@dataclasses.dataclass
class GenerateRequest:
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


@dataclasses.dataclass
class GenerateResult:
    token_ids: list[int]
    text: str
    prompt_tokens: int
    generated_tokens: int
    queue_ms: float
    prefill_ms: float
    decode_ms: float


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise EngineError(f"length {n} exceeds largest bucket {buckets[-1]}")


class _Slab:
    """The persistent decode batch. Host side: the request and page
    bookkeeping per row. Device side (``dev``): cur, pos, st, emitted, done,
    budgets, page_table and out_buf, mutated only by the worker thread.
    ``out_buf`` has one spare column past ``steps``: scatters route slots
    they must drop there, so no write ever wraps into a live slot."""

    def __init__(self, B: int, steps: int, pmax: int, pad_id: int, device) -> None:
        self.B = B
        self.steps = steps
        self.req: list[Optional[GenerateRequest]] = [None] * B
        self.sid: list[Optional[tuple]] = [None] * B
        self.queue_ms = np.zeros((B,), np.float64)
        self.prefill_ms = np.zeros((B,), np.float64)
        self.t_decode0 = np.zeros((B,), np.float64)
        # The homogeneous slab's compatibility triple (reset when empty).
        self.constrained = True
        self.temperature = 0.0
        self.grammar: Optional[PlanGrammar] = None
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


class InferenceEngine:
    def __init__(
        self,
        config: Optional[MCPXConfig] = None,
        model_cfg: Optional[GemmaConfig] = None,
        *,
        device: "torch.device | str | None" = None,
    ) -> None:
        self.config = config or MCPXConfig()
        self.device = resolve_device(device)
        ecfg = self.config.engine
        self.tokenizer = make_tokenizer(self.config.model.vocab)
        self.model_cfg = model_cfg or GemmaConfig.named(
            self.config.model.size,
            max_seq_len=self.config.model.max_seq_len,
            vocab_size=self.tokenizer.vocab_size,
        )
        self.grammar: PlanGrammar = build_plan_grammar(self.tokenizer)
        self.state = "cold"
        self._queue: "queue.Queue[Optional[GenerateRequest]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._stop = False
        self._startup_error: Optional[BaseException] = None
        self._params = None
        self._paged_kv: Optional[dict] = None
        self._slab: Optional[_Slab] = None
        self._dfa_cache: dict[int, tuple] = {}
        self._seq_counter = 0
        self._last_admit_t = 0.0
        self._generator: Optional[torch.Generator] = None
        # Worker-thread counters, read cross-thread by queue_stats().
        self._stats = {"admissions": 0, "segments": 0, "decode_forwards": 0, "retired": 0}
        self._allocator = PageAllocator(
            n_pages=max(2, ecfg.max_batch_size * ecfg.max_pages_per_seq + 1),
            page_size=ecfg.kv_page_size,
            max_pages_per_seq=ecfg.max_pages_per_seq,
        )
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

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        """Load the weights onto the device and start the worker thread.
        Concurrent callers wait for the one start in flight."""
        if self.state == "ready":
            return
        if self.state in ("closed", "failed"):
            raise EngineError(f"engine not startable (state={self.state})")
        if self.state == "cold":
            self.state = "warming"
            self._thread = threading.Thread(target=self._worker, daemon=True, name="mcpx-torch-engine")
            self._thread.start()
        while not self._started.is_set():
            await asyncio.sleep(0.02)
        if self._startup_error is not None:
            self.state = "failed"
            raise EngineError(f"engine startup failed: {self._startup_error}")
        if self.state == "warming":
            self.state = "ready"
        if self.state != "ready":
            raise EngineError(f"engine not startable (state={self.state})")

    async def aclose(self) -> None:
        self.state = "closed"
        self._stop = True
        self._queue.put(None)
        if self._thread is not None:
            await asyncio.to_thread(self._thread.join, 30.0)
        if self._thread is None or not self._thread.is_alive():
            self._params = None
            self._paged_kv = None
            self._slab = None
            self._dfa_cache.clear()

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
        """Decode a continuation of ``prompt_ids``. ``shared_prefix_len``,
        ``deadline_at`` and ``tenant`` are accepted for the planner's call
        shape; this engine has no prefix cache or locality sort to use them."""
        del shared_prefix_len, deadline_at, tenant
        if self.state != "ready":
            raise EngineError(f"engine not ready (state={self.state})")
        ecfg = self.config.engine
        loop = asyncio.get_running_loop()
        req = GenerateRequest(
            prompt_ids=list(prompt_ids),
            max_new_tokens=max_new_tokens or ecfg.max_decode_len,
            constrained=constrained,
            temperature=ecfg.temperature if temperature is None else temperature,
            future=loop.create_future(),
            loop=loop,
            enqueued_at=time.monotonic(),
            grammar=grammar,
        )
        self._queue.put(req)
        return await req.future

    def prompt_capacity(self, max_new_tokens: int = 0, shared_prefix_len: int = 0) -> int:
        """Longest prompt (in tokens) the engine serves beside a
        ``max_new_tokens`` decode budget — the page-capacity and
        prefill-bucket geometry the planner trims its prompt to."""
        del shared_prefix_len  # no prefix cache: the full-prefill geometry holds
        ecfg = self.config.engine
        capacity = ecfg.max_pages_per_seq * ecfg.kv_page_size
        chunk = self._spec_chunk(True)
        slack = chunk if chunk > 1 else 0
        budget = min(
            max_new_tokens or ecfg.max_decode_len,
            max(1, min(ecfg.max_decode_len, capacity - 1 - slack)),
        )
        eligible = [b for b in self._prefill_buckets if b <= capacity]
        if not eligible:
            return 1
        return max(1, min(eligible[-1], capacity - budget - slack))

    def kernel_launches(self) -> dict[str, int]:
        """Launches of each CUDA kernel in this process (the wrappers' own
        counters; CPU runs take the plain versions and count nothing)."""
        return kernel_launches()

    def queue_stats(self) -> dict:
        slab = self._slab
        return {
            "queue_depth": self._queue.qsize(),
            "active_rows": slab.n_active if slab is not None else 0,
            "kernel_launches": kernel_launches(),
            **dict(self._stats),
        }

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

    def _dfa_for(self, grammar: PlanGrammar) -> tuple:
        """(trans, mask, dist, active_ids, eos_cols) of ``grammar`` on the
        device, cached per grammar object (the cache holds the grammar so
        its id cannot be reused while cached)."""
        hit = self._dfa_cache.get(id(grammar))
        if hit is not None:
            return hit[1]
        trans, mask, dist, ids, eos, _inv = grammar.device_tables(64)
        dev = self.device
        tables = (
            torch.from_numpy(trans).to(dev, torch.int64),
            torch.from_numpy(mask).to(dev),
            torch.from_numpy(dist).to(dev, torch.int64),
            torch.from_numpy(ids).to(dev, torch.int64),
            torch.from_numpy(eos).to(dev),
        )
        self._dfa_cache[id(grammar)] = (grammar, tables)
        while len(self._dfa_cache) > 8:
            self._dfa_cache.pop(next(iter(self._dfa_cache)))
        return tables

    @staticmethod
    def _budget_mask(dfa: tuple, st: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
        """Column c is allowed iff grammar-legal AND (c is EOS or its
        successor can still finish within ``rem`` more samples). When no
        column can finish in budget, degrade to the plain legal mask: the
        output is then a legal prefix, never garbage. [B, C] compact."""
        trans, mask_tab, dist, _active, eos_cols = dfa
        legal = mask_tab[st]
        finishable = legal & (eos_cols[None, :] | (dist[trans[st]] <= rem[:, None]))
        feasible = finishable.any(dim=-1, keepdim=True)
        return torch.where(feasible, finishable, legal)

    # --------------------------------------------------------------- worker
    def _setup(self) -> None:
        ecfg = self.config.engine
        self._params, source = load_or_init(
            self.model_cfg, self.config.model.checkpoint_path, device=self.device
        )
        log.info("weights: %s on %s", source, self.device)
        self._paged_kv = init_paged_kv(
            self.model_cfg, self._allocator.n_pages, ecfg.kv_page_size, self.device
        )
        self._slab = _Slab(
            ecfg.max_batch_size, ecfg.max_decode_len, ecfg.max_pages_per_seq,
            self.tokenizer.pad_id, self.device,
        )
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(time.time_ns() & 0x7FFFFFFF)

    def _worker(self) -> None:
        try:
            with torch.inference_mode():
                self._setup()
        except BaseException as e:  # surfaced by start()
            self._startup_error = e
            self._started.set()
            return
        self._started.set()
        slab = self._slab
        pending: "deque[GenerateRequest]" = deque()
        with torch.inference_mode():
            while True:
                self._drain_queue(pending, block=not pending and slab.n_active == 0)
                if self._stop:
                    break
                self._reap_cancelled(slab)
                try:
                    if pending and slab.n_active < slab.B:
                        self._admit(slab, pending)
                    if slab.n_active:
                        self._segment(slab)
                        self._harvest(slab)
                except BaseException as e:  # keep the worker alive
                    log.exception("engine step failed; failing resident rows")
                    self._fail_rows(slab, e)
        closed = EngineError("engine closed")
        self._fail_rows(slab, closed)
        for r in pending:
            r.loop.call_soon_threadsafe(_resolve, r.future, None, closed)
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                r.loop.call_soon_threadsafe(_resolve, r.future, None, closed)

    def _drain_queue(self, pending: "deque[GenerateRequest]", block: bool) -> None:
        """Move queued requests into ``pending``. When idle, wait for the
        first arrival, then hold a 3 ms gather window so a burst forms one
        admission cohort."""
        try:
            item = self._queue.get(timeout=0.05) if block else self._queue.get_nowait()
        except queue.Empty:
            return
        first_arrival = item is not None and block
        while True:
            if item is None:
                self._stop = True
                return
            pending.append(item)
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
        if first_arrival:
            deadline = time.monotonic() + 0.003
            while (remaining := deadline - time.monotonic()) > 0:
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    return
                if item is None:
                    self._stop = True
                    return
                pending.append(item)

    def _reap_cancelled(self, slab: _Slab) -> None:
        for i in range(slab.B):
            r = slab.req[i]
            if r is not None and r.future.cancelled():
                self._release_row(slab, i)

    def _release_row(self, slab: _Slab, i: int) -> None:
        """Pages back to the allocator, the row's device state cleared: its
        page-table row zeroed (later writes land on the null page)."""
        self._allocator.free(slab.sid[i])
        slab.req[i] = None
        slab.sid[i] = None
        d = slab.dev
        d["done"][i] = True
        d["page_table"][i] = 0
        d["pos"][i] = 0
        d["st"][i] = 0
        d["emitted"][i] = 0
        d["budgets"][i] = 0
        d["cur"][i] = self.tokenizer.pad_id

    def _fail_rows(self, slab: _Slab, error: BaseException) -> None:
        for i in range(slab.B):
            r = slab.req[i]
            if r is None:
                continue
            self._release_row(slab, i)
            r.loop.call_soon_threadsafe(_resolve, r.future, None, error)

    # ------------------------------------------------------------ admission
    def _admit(self, slab: _Slab, pending: "deque[GenerateRequest]") -> None:
        """Admission gate of the homogeneous slab: an empty slab takes the
        head request's sampling config; an incompatible head that has waited
        ``fairness_timeout_s`` stops admissions so the slab drains; a busy
        slab with few free rows waits (up to ``admit_max_wait_s``) for a
        worthwhile cohort."""
        ecfg = self.config.engine
        free = slab.free_rows()
        if slab.n_active == 0:
            head = pending[0]
            slab.constrained = head.constrained
            slab.temperature = head.temperature
            slab.grammar = head.grammar
        elif not slab.compatible(pending[0]) and (
            time.monotonic() - pending[0].enqueued_at > ecfg.fairness_timeout_s
        ):
            return
        elif len(free) < (ecfg.admit_min_free or max(1, slab.B // 4)) and (
            time.monotonic() - self._last_admit_t < ecfg.admit_max_wait_s
        ):
            return
        if not any(slab.compatible(r) for r in pending):
            return
        self._admit_cohort(slab, pending)

    def _admit_cohort(self, slab: _Slab, pending: "deque[GenerateRequest]") -> None:
        ecfg = self.config.engine
        tok = self.tokenizer
        dev = self.device
        free = slab.free_rows()
        chunk = self._spec_chunk(slab.constrained)
        slack = chunk if chunk > 1 else 0
        capacity = ecfg.max_pages_per_seq * ecfg.kv_page_size
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

        # Candidates: compatible, not cancelled, up to the free rows.
        cands: list[GenerateRequest] = []
        defer: list[GenerateRequest] = []
        while pending and len(cands) < len(free):
            r = pending.popleft()
            if r.future.cancelled():
                continue
            (cands if slab.compatible(r) else defer).append(r)

        # Geometry: decode budget and the prompt head that fits beside it
        # (the head is kept on overflow: the planner ranks its best
        # candidates first).
        planned = []
        for r in cands:
            budget = max(1, min(r.max_new_tokens, min(slab.steps, capacity - 1 - slack)))
            longest = min(eligible[-1], capacity - budget - slack)
            planned.append((budget, r.prompt_ids[:longest] or [tok.bos_id]))
        T = _bucket(max([len(ids) for _, ids in planned] + [1]), eligible)

        cohort: list[tuple[GenerateRequest, int, list[int], tuple, list[int]]] = []
        pushback: list[GenerateRequest] = []
        for r, (budget, ids) in zip(cands, planned):
            need = len(ids) + budget + slack
            if pushback or not self._allocator.can_allocate(need):
                pushback.append(r)  # FIFO: wait for pages, order kept
                continue
            self._seq_counter += 1
            sid = ("seq", self._seq_counter)
            cohort.append((r, budget, ids, sid, self._allocator.allocate(sid, need)))
        for r in reversed(pushback + defer):
            pending.appendleft(r)
        if not cohort:
            return

        A = _bucket(len(cohort), self._batch_buckets)
        n = len(cohort)
        tokens = np.full((A, T), tok.pad_id, np.int64)
        seq_lens = np.ones((A,), np.int64)
        active = np.zeros((A,), bool)
        budgets = np.zeros((A,), np.int64)
        table = np.zeros((A, ecfg.max_pages_per_seq), np.int32)
        for j, (r, budget, ids, _sid, pages) in enumerate(cohort):
            tokens[j, : len(ids)] = ids
            seq_lens[j] = len(ids)
            active[j] = True
            budgets[j] = budget
            table[j, : len(pages)] = pages

        t0 = time.monotonic()
        tokens_d = torch.from_numpy(tokens).to(dev)
        lens_d = torch.from_numpy(seq_lens).to(dev)
        table_d = torch.from_numpy(table).to(dev)
        budgets_d = torch.from_numpy(budgets).to(dev)
        active_d = torch.from_numpy(active).to(dev)
        dense = init_kv_cache(self.model_cfg, A, T, device=dev)
        last_logits, dense = prefill(self._params, self.model_cfg, tokens_d, lens_d, dense, last_only=True)
        commit_prefill_to_pages(self._paged_kv, dense, table_d, lens_d, ecfg.kv_page_size)
        del dense
        cur0, st0, done0 = self._first_sample(slab, last_logits, budgets_d, active_d)
        t1 = time.monotonic()
        self._last_admit_t = t1
        self._stats["admissions"] += 1

        rows = [free.pop(0) for _ in range(n)]
        for i, (r, _budget, _ids, sid, _pages) in zip(rows, cohort):
            slab.req[i] = r
            slab.sid[i] = sid
            slab.queue_ms[i] = (t0 - r.enqueued_at) * 1e3
            slab.prefill_ms[i] = (t1 - t0) * 1e3
            slab.t_decode0[i] = t1
        # Scatter the cohort's rows into the slab; bucket-padding lanes
        # (j >= n) are dropped, never written.
        idx = torch.tensor(rows, dtype=torch.int64, device=dev)
        d = slab.dev
        d["cur"][idx] = cur0[:n]
        d["pos"][idx] = lens_d[:n]
        d["st"][idx] = st0[:n]
        d["emitted"][idx] = torch.where(done0[:n], 0, 1)
        d["done"][idx] = done0[:n]
        d["budgets"][idx] = budgets_d[:n]
        d["page_table"][idx] = table_d[:n]
        d["out_buf"][idx] = tok.pad_id
        d["out_buf"][idx, 0] = cur0[:n]

    def _first_sample(self, slab: _Slab, first_logits, budgets, active):
        """Each admitted row's first emission from its prefill logits:
        (cur0, state0, done0) with PAD substituted for finished rows.
        Constrained sampling runs in compact column space: gather the
        grammar's active columns, mask, sample a column, map it back to a
        token id. State 0 is the grammar start."""
        tok = self.tokenizer
        ecfg = self.config.engine
        A = budgets.shape[0]
        start = torch.zeros((A,), dtype=torch.int64, device=self.device)
        if slab.constrained:
            dfa = self._dfa_for(slab.grammar or self.grammar)
            trans, _mask, _dist, active_ids, eos_cols = dfa
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

    # --------------------------------------------------------------- decode
    def _segment(self, slab: _Slab) -> None:
        """Up to ``decode_steps_per_tick * steps_per_dispatch`` forwards over
        the whole slab, stopping early once every row is done."""
        ecfg = self.config.engine
        tok = self.tokenizer
        cfg = self.model_cfg
        dev = self.device
        d = slab.dev
        B = slab.B
        W = slab.steps  # out_buf column W is the drop slot
        pad, eos = tok.pad_id, tok.eos_id
        constrained = slab.constrained
        chunk = self._spec_chunk(constrained)
        dfa = self._dfa_for(slab.grammar or self.grammar) if constrained else None
        iters = max(1, ecfg.decode_steps_per_tick) * max(1, ecfg.steps_per_dispatch)
        b_idx = torch.arange(B, device=dev)
        cur, pos, st, e, done = d["cur"], d["pos"], d["st"], d["emitted"], d["done"]
        budgets, page_table, buf = d["budgets"], d["page_table"], d["out_buf"]
        pad_col = torch.full((B,), W, dtype=torch.int64, device=dev)
        n_fwd = 0
        for _ in range(iters):
            if bool(done.all()):
                break
            if constrained and chunk > 1:
                trans, mask_tab, _dist, active_ids, eos_cols = dfa
                # Fast-forward: the chain of grammar-forced tokens after
                # `cur`. Emission stops at the first state with more than
                # one legal column, at a forced EOS, or when the row's
                # budget runs out mid-chain (only reachable when the budget
                # is below the grammar's shortest completion).
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
            # One forward consumes [cur, forced...]; `adv` is each row's
            # live window (0 for done rows, which idle through the forward).
            adv = torch.where(done, 0, 1) + adv_extra
            logits, _ = decode_chunk_paged(
                self._params, cfg, chunk_toks, pos, page_table, self._paged_kv,
                logits_at=torch.clamp(adv - 1, min=0), q_lens=adv,
            )
            n_fwd += 1
            if constrained:
                trans, _mask, _dist, active_ids, eos_cols = dfa
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
            nxt = torch.where(newly_done, torch.full_like(nxt_id, pad), nxt_id)
            buf[b_idx, torch.where(newly_done, pad_col, e1)] = nxt
            cur, pos, st = nxt, pos + adv, st_next
            e = e1 + torch.where(newly_done, 0, 1)
            done = newly_done
        d.update(cur=cur, pos=pos, st=st, emitted=e, done=done)
        self._stats["segments"] += 1
        self._stats["decode_forwards"] += n_fwd

    def _harvest(self, slab: _Slab) -> None:
        """Retire rows whose requests finished: one fetch of the flags and
        the output buffer, then the result to the request's event loop."""
        done = slab.dev["done"].cpu().numpy()
        e = slab.dev["emitted"].cpu().numpy()
        buf = slab.dev["out_buf"].cpu().numpy()
        t1 = time.monotonic()
        for i in range(slab.B):
            r = slab.req[i]
            if r is None or not done[i]:
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
            self._release_row(slab, i)
            self._stats["retired"] += 1
            r.loop.call_soon_threadsafe(_resolve, r.future, res, None)


def _resolve(future: "asyncio.Future", result: Any, error: Optional[BaseException]) -> None:
    if future.cancelled():
        return
    if error is not None:
        future.set_exception(error)
    else:
        future.set_result(result)
