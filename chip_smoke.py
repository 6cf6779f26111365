"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, one line each (every number beside the card's name and power limit):
  1. device: the card as nvidia-smi reports it;
  2. build: every CUDA kernel of the port, compiled from the sources in this
     checkout (one nvcc per source, all started together);
  3. kernel vs plain: each kernel against its plain PyTorch version on
     seeded batches at the serving shapes (bf16): a mixed batch, the
     serving bursts' mix of a few live rows among idle ones, and a
     suffix-prefill cohort at prefill width (S 128); with its time,
     the plain version's and one PyTorch library call's (a yardstick the
     port never calls), each by back-to-back eager calls (``ms``, host work
     included) and as device time by CUDA-graph replays (``device_ms``),
     and the least time the card could take (``bound_ms``). The attention
     kernel's ticket counters must be back at 0 after the phase;
  4. forward check: prefill plus one paged decode forward of the trained
     checkpoint in float32, on the card (through the kernel) against the CPU
     (plain path);
  5. serve the trained checkpoint: 16 concurrent /plan requests through
     ``ControlPlane.plan``, every plan LLM-authored and valid;
  6. serve at full width: the 2b preset (random weights from seed 0), 8
     concurrent /plan requests;
  7. serve with prefix reuse, on the engines of phases 5 and 6: a stream
     that repeats its intents (8 x 4 on the trained checkpoint, 4 x 4 at
     2b), 16 in flight, with the radix prefix cache off and then on (a live
     flip on an idle slab). Every plan valid, the same plans in both modes,
     tree hits and suffix prefills through the kernel, and fewer prefill
     tokens per request with the cache on;
then the kernels line, the card line and the result line. ``--profile`` adds,
after each serving phase of 5 and 6, one more pass of its requests under
``torch.profiler`` with the device time by kernel and the idle share. Any failed phase
exits non-zero before the result line. The kernel launch counters are set to
0 just before each serving run and read just after it.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import random
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "mcpx", "models", "checkpoints", "planner_test_bpe.npz")
ATOL = RTOL = 2e-2  # bf16 inputs and output, fp32 accumulation
HBM_BYTES_S = 3.35e12  # H100 SXM memory rate
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
KERNELS = {
    "ragged_paged_attention": {
        "route": "cuda",
        "source": "mcpx_torch/engine/kernels/csrc/ragged_paged_attention.cu",
        "replaces": "mcpx/engine/kernels/paged_attention.py:151",
    },
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def emit(phase: str, card: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": card, **fields}), flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, calls: int = 20, replays: int = 20, warm_s: float = 0.1) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph
    and replayed, so the calls' host work (checks, allocation, the launch
    itself) stays out of the number. The calls run eagerly first on the
    stream that captures them, and the graph is replayed for ``warm_s``
    before the timing, so the card runs at its working clock."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    t0 = time.monotonic()
    while time.monotonic() - t0 < warm_s:
        graph.replay()
        torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (calls * replays)


# ------------------------------------------------------------ kernel phase
def mixed_batch(seed, B, S, K, G, hd, L, psz, pmax, dtype, live=None):
    """Random distinct pages and, with ``live=None``, rows with q_len = S,
    1, 1 < q_len < S and 0, then random, at random start offsets (the
    reference package's mixed-batch property test, at serving shapes).
    With ``live=n``: the serving bursts' mix, n random live rows with q_len
    uniform in 1..S and start uniform in [0, Pmax*Psz - S), the rest idle."""
    rng = random.Random(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n_pages = B * pmax + 1
    q = torch.randn((B, S, K, G, hd), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((K, L, n_pages, psz, hd), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((K, L, n_pages, psz, hd), generator=gen, device="cuda").to(dtype)
    pages = list(range(1, n_pages))
    rng.shuffle(pages)
    table = torch.tensor(pages[: B * pmax], dtype=torch.int32).reshape(B, pmax).cuda()
    if live is None:
        fixed = [S, 1, rng.randint(2, S - 1), 0]
        q_lens = [fixed[b] if b < 4 else rng.randint(0, S) for b in range(B)]
        starts = [rng.randint(0, pmax * psz - max(1, q_lens[b]) - 1) for b in range(B)]
    else:
        rows = set(rng.sample(range(B), live))
        q_lens = [rng.randint(1, S) if b in rows else 0 for b in range(B)]
        starts = [rng.randint(0, pmax * psz - S - 1) for b in range(B)]
    as_i32 = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")  # noqa: E731
    return q, kp, vp, table, as_i32(starts), as_i32(q_lens)


def prefill_batch(seed, B, S, K, G, hd, L, psz, pmax, dtype, starts=(0, 64, 128), idle=2):
    """A suffix-prefill cohort: random distinct pages, q_len uniform in
    1..S, each row's start drawn from ``starts`` (those that leave room for
    S queries), ``idle`` idle rows among them."""
    rng = random.Random(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n_pages = B * pmax + 1
    q = torch.randn((B, S, K, G, hd), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((K, L, n_pages, psz, hd), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((K, L, n_pages, psz, hd), generator=gen, device="cuda").to(dtype)
    pages = list(range(1, n_pages))
    rng.shuffle(pages)
    table = torch.tensor(pages[: B * pmax], dtype=torch.int32).reshape(B, pmax).cuda()
    fits = [s for s in starts if s + S <= pmax * psz]
    idle_rows = set(rng.sample(range(B), idle))
    q_lens = [0 if b in idle_rows else rng.randint(1, S) for b in range(B)]
    st = [rng.choice(fits) for _ in range(B)]
    as_i32 = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")  # noqa: E731
    return q, kp, vp, table, as_i32(st), as_i32(q_lens)


def attention_bound(q, k_pages, table, starts, q_lens):
    """(bound_ms, bound_by, bytes, flops) of what the function needs: the
    live queries of q, each live row's visible K and V positions (through
    min(start + q_len, Pmax*Psz)) and their page-table entries once, out in
    full, and start_pos and q_lens; flops = QK^T and PV over each live
    query's visible positions, at the bf16 peak."""
    B, S, K, G, hd = q.shape
    psz, elt, total = k_pages.shape[3], q.element_size(), table.shape[1] * k_pages.shape[3]
    live_q = visible = pages = flops = 0
    for st, ql in zip(starts.tolist(), q_lens.tolist()):
        if ql <= 0:
            continue
        lim = min(st + ql, total)
        live_q += ql
        visible += lim
        pages += -(-lim // psz)
        for i in range(ql):
            flops += K * G * 4 * hd * min(st + i + 1, total)
    nbytes = (
        live_q * K * G * hd * elt + visible * K * hd * 2 * elt + q.numel() * elt
        + 4 * (pages + 2 * B)
    )
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def sdpa_yardstick(q, k_pages, v_pages, table, starts, layer):
    """One scaled_dot_product_attention call on the pre-gathered dense K/V
    with the boolean visibility mask (the port never calls it)."""
    import torch.nn.functional as F

    from mcpx_torch.engine.kernels.paged_attention import _gather_pages

    B, S, K, G, hd = q.shape
    k = _gather_pages(k_pages, table, layer)  # [B, K, Lk, hd]
    v = _gather_pages(v_pages, table, layer)
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, hd)
    vis = starts.long()[:, None] + torch.arange(S, device=q.device) + 1
    mask = (torch.arange(k.shape[2], device=q.device)[None, None, :] < vis[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask, enable_gqa=True)


# (cell, G, hd, L, live): the trained `test` preset and the full-width `2b`
# preset, at the serving geometry B=64, S=speculate_k=8, Psz=64, Pmax=4;
# live=None is the mixed batch, live=n the serving bursts' mix (16 or 8
# live rows of 64, the rest idle: where splitting pays). live="prefill" is
# a suffix-prefill cohort at prefill width: B 16, S 128 (the prefill
# bucket), starts 0, 64 or 128, two idle rows.
CELLS = (
    ("test", 4, 32, 2, None), ("2b", 8, 256, 18, None),
    ("test/serve_mix", 4, 32, 2, 16), ("2b/serve_mix", 8, 256, 18, 8),
    ("test/prefill", 4, 32, 2, "prefill"), ("2b/prefill", 8, 256, 18, "prefill"),
)


def cell_batch(seed: int, G: int, hd: int, L: int, live):
    if live == "prefill":
        return prefill_batch(seed, 16, 128, 1, G, hd, L, 64, 4, torch.bfloat16)
    return mixed_batch(seed, 64, 8, 1, G, hd, L, 64, 4, torch.bfloat16, live)


def kernel_times(q, kp, vp, table, starts, q_lens, L) -> dict:
    """The kernel, its plain version and one SDPA call on one batch (the
    layer turning over on every call), by two methods in one call:
      * ms, plain_ms, library_ms: back-to-back eager calls, host work
        included (plain, kernel, kernel, plain; then SDPA);
      * device_ms, plain_device_ms, library_device_ms: device time by
        CUDA-graph replays, in the same order."""
    from mcpx_torch.engine.kernels.paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_reference,
    )

    layers = iter(range(10**9))
    run_k = lambda: ragged_paged_attention(  # noqa: E731
        q, kp, vp, table, starts, q_lens, next(layers) % L
    )
    run_p = lambda: ragged_paged_attention_reference(  # noqa: E731
        q, kp, vp, table, starts, q_lens, next(layers) % L
    )
    sdpa = sdpa_yardstick(q, kp, vp, table, starts, 0)
    p1, k1, k2, p2 = time_ms(run_p, 10), time_ms(run_k), time_ms(run_k), time_ms(run_p, 10)
    library_ms = time_ms(sdpa)
    dp1, dk1, dk2, dp2 = graph_ms(run_p), graph_ms(run_k), graph_ms(run_k), graph_ms(run_p)
    return dict(
        ms=min(k1, k2), plain_ms=min(p1, p2), library_ms=library_ms,
        device_ms=min(dk1, dk2), plain_device_ms=min(dp1, dp2), library_device_ms=graph_ms(sdpa),
    )


def kernel_phase(card: str) -> list[dict]:
    from mcpx_torch.engine.kernels.paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_reference,
    )

    rows = []
    for cell, G, hd, L, live in CELLS:
        worst = 0.0
        for seed in range(3):
            q, kp, vp, table, starts, q_lens = cell_batch(seed, G, hd, L, live)
            for layer in (0, L - 1):
                out = ragged_paged_attention(q, kp, vp, table, starts, q_lens, layer)
                torch.cuda.synchronize()
                ref = ragged_paged_attention_reference(q, kp, vp, table, starts, q_lens, layer)
                err = (out.float() - ref.float()).abs()
                worst = max(worst, float(err.max()))
                if bool((err > ATOL + RTOL * ref.float().abs()).any()):
                    raise SystemExit(f"{cell}: kernel disagrees with plain version (max {worst})")
                for b, ql in enumerate(q_lens.tolist()):
                    if bool((out[b, ql:] != 0).any()):
                        raise SystemExit(f"{cell}: row {b} pads are not exact zeros")
        q, kp, vp, table, starts, q_lens = cell_batch(0, G, hd, L, live)
        times = kernel_times(q, kp, vp, table, starts, q_lens, L)
        bound_ms, bound_by, nbytes, flops = attention_bound(q, kp, table, starts, q_lens)
        row = dict(
            cell=cell, B=q.shape[0], S=q.shape[1], K=1, G=G, hd=hd, L=L, page_size=64, max_pages=4,
            live_rows=int((q_lens > 0).sum()), dtype="bfloat16", max_abs_err=worst,
            atol=ATOL, rtol=RTOL, **times, bound_ms=bound_ms, bound_by=bound_by,
            ms_over_bound=times["ms"] / bound_ms,
            device_ms_over_bound=times["device_ms"] / bound_ms, bytes=nbytes, flops=flops,
        )
        emit("kernel_vs_plain", card, kernel="ragged_paged_attention", **row)
        rows.append(row)
    check_tickets("kernel phase")
    return rows


def check_tickets(where: str) -> None:
    """The kernel's ticket counters are all 0 between launches."""
    from mcpx_torch.engine.kernels.paged_attention import ticket_counters

    torch.cuda.synchronize()
    left = sum(int(t.abs().sum()) for t in ticket_counters())
    if left:
        raise SystemExit(f"{where}: ticket counters not reset ({left})")


# ------------------------------------------------------------ serving
def config(size: str, checkpoint: str, batch: int):
    from mcpx_torch.core.config import MCPXConfig

    return MCPXConfig.from_dict({
        "model": {"size": size, "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": checkpoint},
        # The reference bench's headline engine settings: 64-token pages,
        # 4 pages a row, 64-token decode budget, greedy, fast-forward 8,
        # homogeneous slab, no drafting, no prefix cache.
        "engine": {
            "max_batch_size": batch, "kv_page_size": 64, "max_pages_per_seq": 4,
            "max_decode_len": 64, "temperature": 0.0, "speculate_k": 8,
            "hetero_batch": False, "prefix_cache": False, "draft_mode": "off",
        },
        "planner": {"kind": "llm"},
    })


def forward_check(card: str) -> None:
    """The trained checkpoint in float32: prefill, commit to pages and one
    ragged paged decode forward, on the card against the CPU."""
    from mcpx_torch.engine.kv_cache import commit_prefill_to_pages, init_paged_kv
    from mcpx_torch.engine.paged_decode import decode_chunk_paged
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.models.gemma.model import init_kv_cache, prefill
    from mcpx_torch.models.gemma.params import load_npz

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072), dtype="float32")
    rng = torch.Generator().manual_seed(0)
    B, T, psz, pmax = 4, 64, 64, 4
    tokens = torch.randint(0, 3000, (B, T), generator=rng)
    lens = torch.tensor([64, 17, 40, 5])
    table = torch.arange(1, B * pmax + 1, dtype=torch.int32).reshape(B, pmax)
    chunk = torch.randint(0, 3000, (B, 8), generator=rng)
    q_lens = torch.tensor([8, 1, 3, 0], dtype=torch.int32)
    outs = []
    for dev in ("cuda", "cpu"):
        params = load_npz(CKPT, dev, torch.float32)
        pools = init_paged_kv(cfg, B * pmax + 1, psz, dev)
        dense = init_kv_cache(cfg, B, T, device=dev)
        first, dense = prefill(params, cfg, tokens.to(dev), lens.to(dev), dense, last_only=True)
        commit_prefill_to_pages(pools, dense, table.to(dev), lens.to(dev), psz)
        logits, _ = decode_chunk_paged(
            params, cfg, chunk.to(dev), lens.to(dev), table.to(dev), pools,
            logits_at=(q_lens.long() - 1).clamp(min=0).to(dev), q_lens=q_lens.to(dev),
        )
        outs.append((first.cpu(), logits.cpu()))
    err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    finite = all(bool(torch.isfinite(t).all()) for t in outs[0])
    shapes = [list(t.shape) for t in outs[0]]
    emit("forward_check", card, dtype="float32", max_abs_err=err, atol=1e-3, finite=finite, shapes=shapes)
    if not finite or err > 1e-3 or shapes != [[B, 3072], [B, 3072]]:
        raise SystemExit(f"forward check failed: err {err}, finite {finite}, shapes {shapes}")


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_breakdown(prof, wall_s: float, top: int = 8) -> dict:
    """Device time by kernel over the profiled window: the busiest kernels,
    their sum, and the device's idle share of the window's wall time."""
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    return dict(
        wall_ms=wall_s * 1e3, device_busy_ms=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / (wall_s * 1e3)),
        top=[{"name": k[:80], "device_ms": us / 1e3, "calls": n} for us, k, n in rows[:top]],
    )


async def serve(
    size: str, checkpoint: str, n_intents: int, card: str, batch: int, profile: bool = False,
    after=None,
) -> tuple[dict, list, object]:
    """Serve ``n_intents`` concurrent /plan requests on a fresh control
    plane; then, on the same engine, ``after(cp, records)`` when given.
    Returns (stats, plans, what ``after`` returned)."""
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    cp = build_control_plane(config(size, checkpoint, batch))  # device=None: the card
    records = synth_registry(1000, seed=0)
    for rec in records:
        await cp.registry.put(rec)
    try:
        t0 = time.monotonic()
        await cp.startup()
        startup_s = time.monotonic() - t0
        rng = random.Random(0)
        intents = [intent_for(records, rng) for _ in range(n_intents)]
        engine = cp.planner.engine
        fwd0 = engine.queue_stats()["decode_forwards"]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_kernel_launches()
        t0 = time.monotonic()
        results = await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
        wall = time.monotonic() - t0
        launches = kernel_launches()
        plans = [p for p, _ in results]
        lat = sorted(ms for _, ms in results)
        for p in plans:
            p.validate()
        stats = dict(
            model=size, intents=n_intents, wall_s=wall, plans_per_s=n_intents / wall,
            p50_ms=lat[len(lat) // 2], max_ms=lat[-1], startup_s=startup_s,
            decode_forwards=engine.queue_stats()["decode_forwards"] - fwd0,
            origins={o: sum(p.origin == o for p in plans) for o in {p.origin for p in plans}},
            launches=launches, max_memory_allocated=torch.cuda.max_memory_allocated(),
        )
        emit(f"serve_{size}", card, **stats)
        if profile:
            # The same requests once more under the profiler, after the
            # measured run, so the profiler's cost stays out of its numbers.
            with _profiler() as prof:
                t0 = time.monotonic()
                await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            emit(f"profile_{size}", card, **device_breakdown(prof, wall))
        extra = await after(cp, records) if after is not None else None
        return stats, plans, extra
    finally:
        await cp.aclose()


async def prefix_reuse(cp, records, size: str, n_unique: int, reps: int, card: str) -> dict:
    """Serve a stream that repeats its intents (``n_unique`` intents,
    ``reps`` times each, 16 in flight; the pool built as the reference
    bench's prefix phase builds it) with the radix prefix cache off, then
    on, on one engine (a live flip on an idle slab). Prints each mode's
    line and fails unless every plan is valid, the two modes give the same
    plans, the cache hits, suffix prefills run through the kernel, and the
    prefill tokens per request fall with the cache on."""
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.utils.synth import intent_for

    engine = cp.planner.engine
    ecfg = engine.config.engine
    rng = random.Random(23)
    pool = [f"{intent_for(records, rng)} [pfx{i}]" for i in range(n_unique)]
    intents = [pool[i % n_unique] for i in range(n_unique * reps)]
    n = len(intents)

    async def run(on: bool) -> tuple[dict, list]:
        while engine.queue_stats()["active_rows"] or engine.queue_stats()["queue_depth"]:
            await asyncio.sleep(0.05)
        ecfg.prefix_cache = on
        sem = asyncio.Semaphore(16)

        async def one(intent: str):
            async with sem:
                return await cp.plan(intent, use_cache=False)

        q0, c0 = engine.queue_stats(), engine.prefix_cache_stats()
        torch.cuda.synchronize()
        reset_kernel_launches()
        t0 = time.monotonic()
        results = await asyncio.gather(*(one(i) for i in intents))
        wall = time.monotonic() - t0
        launches = kernel_launches()
        q1, c1 = engine.queue_stats(), engine.prefix_cache_stats()
        plans = [p for p, _ in results]
        lat = sorted(ms for _, ms in results)
        for p in plans:
            p.validate()
        stats = dict(
            model=size, prefix_cache=on, intents=n, unique=n_unique, in_flight=16, wall_s=wall,
            plans_per_s=n / wall, p50_ms=lat[n // 2],
            **{k: c1[k] - c0[k] for k in ("hits", "misses", "matched_tokens")},
            prefill_tokens_per_request=(q1["prefill_tokens"] - q0["prefill_tokens"]) / n,
            suffix_prefills=q1["suffix_prefills"] - q0["suffix_prefills"],
            suffix_prefill_launches=q1["suffix_prefill_launches"] - q0["suffix_prefill_launches"],
            origins={o: sum(p.origin == o for p in plans) for o in {p.origin for p in plans}},
            launches=launches,
        )
        emit(f"serve_prefix_{size}", card, **stats)
        return stats, plans

    try:
        off, off_plans = await run(False)
        on, on_plans = await run(True)
    finally:
        ecfg.prefix_cache = False
    differ = [i for i, (a, b) in enumerate(zip(off_plans, on_plans)) if a.to_json() != b.to_json()]
    if differ:
        raise SystemExit(f"serve_prefix_{size}: plans differ between the modes at {differ}")
    if on["hits"] <= 0 or on["suffix_prefills"] <= 0 or on["suffix_prefill_launches"] <= 0:
        raise SystemExit(f"serve_prefix_{size}: no reuse through the kernel: {on}")
    if not on["prefill_tokens_per_request"] < off["prefill_tokens_per_request"]:
        raise SystemExit(f"serve_prefix_{size}: the cache did not cut prefill tokens: {off} {on}")
    return {"off": off, "on": on}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--profile", action="store_true",
        help="after each serving phase, serve its requests once more under "
        "torch.profiler and print device time by kernel and the idle share",
    )
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU", file=sys.stderr)
        return 2
    from mcpx_torch.engine.kernels import build

    card = card_line()
    emit("device", card, kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.monotonic()
    libs = build.build_all()
    emit("build", card, seconds=time.monotonic() - t0, libraries=sorted(libs),
         per_kernel_s={k: v["seconds"] for k, v in build.build_log.items()})

    rows = kernel_phase(card)
    forward_check(card)

    trained, _, trained_pfx = asyncio.run(serve(
        "test", CKPT, 16, card, batch=64, profile=args.profile,
        after=lambda cp, recs: prefix_reuse(cp, recs, "test", 8, 4, card),
    ))
    if trained["origins"] != {"llm": 16}:
        raise SystemExit(f"trained checkpoint: not every plan is LLM-authored: {trained['origins']}")
    for mode in ("off", "on"):
        if trained_pfx[mode]["origins"] != {"llm": 32}:
            raise SystemExit(f"serve_prefix_test {mode}: not every plan is LLM-authored")
    full, _, full_pfx = asyncio.run(serve(
        "2b", "", 8, card, batch=64, profile=args.profile,
        after=lambda cp, recs: prefix_reuse(cp, recs, "2b", 4, 4, card),
    ))
    runs = [trained, full] + [r[m] for r in (trained_pfx, full_pfx) for m in ("off", "on")]
    for name in KERNELS:
        for st in runs:
            if st["launches"][name] <= 0:
                raise SystemExit(f"{name} was not launched while serving {st['model']}")
    check_tickets("serving")

    headline = rows[0]
    kernels = [
        {
            "name": name, **meta,
            "launches": sum(st["launches"][name] for st in runs),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: headline[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "plain_device_ms", "library_device_ms",
            )},
            "by_shape": rows,
        }
        for name, meta in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main(sys.argv[1:]))
