"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--cards N]

Phases, one line each (every number beside the card's name and power limit):
  1. device: the card as nvidia-smi reports it;
  2. build: every CUDA kernel of the port, compiled from the sources in this
     checkout (one nvcc per source, all started together);
  3. kernel vs plain: each kernel against its plain PyTorch version on
     seeded batches at the serving shapes (bf16): a mixed batch, the
     serving bursts' mix of a few live rows among idle ones, and a
     suffix-prefill cohort at prefill width (S 128), at 64-token pages and
     again the last two at the execute phases' 16-token pages, the
     speculative verify window (S 5, q_len 5 on the live rows, 0 on the
     rest) at 64-token pages, and the tier phases' suffix prefill over
     readmitted prefixes and decode (B 4, 16-token pages); with its time,
     the plain version's and one PyTorch library call's (a yardstick the
     port never calls), each by back-to-back eager calls (``ms``, host work
     included) and as device time by CUDA-graph replays (``device_ms``),
     and the least time the card could take (``bound_ms``). The attention
     kernel's ticket counters must be back at 0 after the phase;
  4. forward check: prefill plus one paged decode forward of the trained
     checkpoint in float32, on the card (through the kernel) against the CPU
     (plain path), at 64-token and at 16-token pages;
  5. serve the trained checkpoint: 16 concurrent /plan requests through
     ``ControlPlane.plan``, every plan LLM-authored and valid, at the
     reference's default decode loop (prompt drafting, pipeline depth 2,
     prefix cache on), with the decode window captured at startup
     (``warmup_compile``) and replayed; then the same requests once more,
     which must capture no new window, and in that repeat, at its first
     segment with live rows, ``graph_window``: from one snapshot of the
     slab state and KV pools, the window run eagerly and by replay of its
     graph in turns, every buffer and pool byte equal, with host ms and
     device ms per window for both routes. The first burst starts from an
     emptied tree, reaches the engine as one cohort (``one_cohort``), is
     traced, runs with a ``WorkerProfiler`` attached, and prints its latency
     attribution, its worker-loop breakdown and the executable keys it ran
     for the first time;
  6. serve at full width: the 2b preset (random weights from seed 0), 8
     concurrent /plan requests, the same settings and checks;
  7. decode-loop modes, on the engines of phases 5 and 6: the burst's
     intents once more as (draft off, depth 1), (draft on, depth 1) and
     (draft on, depth 2), live flips on an idle slab. Every plan valid, no
     more live forwards with drafting on (on the trained checkpoint:
     drafted tokens accepted and fewer live forwards), and the same plans
     in every mode (at 2b a differing plan passes only as a near-tie: top-2
     margin of the masked logits under 1e-3 at the first differing token,
     printed with both plans);
  8. serve with prefix reuse, on the same engines: a stream that repeats
     its intents (8 x 4 on the trained checkpoint, 4 x 4 at 2b), 16 in
     flight, with the radix prefix cache off and then on (a live flip on an
     idle slab). Every plan valid, the same plans in both modes, tree hits
     and suffix prefills through the kernel, and fewer prefill tokens per
     request with the cache on;
  9. telemetry (``telemetry_test``, ``telemetry_2b``), on the same engines:
     the burst's intents once more, from an emptied tree and as one cohort
     as the burst ran, with a fresh ``Tracer`` (every trace
     kept) and a ``WorkerProfiler`` attached live, each request under a
     root span as the reference bench's traced rounds run it. Fails unless
     every plan equals the burst's, every trace holds ``plan``,
     ``engine.generate``, ``engine.queue_wait``, ``engine.prefill``,
     ``engine.decode`` and an ``engine.segment``, nothing is captured, the
     ``mcpx_engine_decode_forwards_total`` delta equals the live forwards',
     the profile's phases tile the worker's wall within 5%, the metrics
     exposition parses with the reference's 71 families, and the achieved
     FLOP/s of the ``/costs`` totals over the phase wall is at or below the
     card's datasheet peak. Prints the latency attribution by phase, the
     planner's time outside the engine, the worker profile, the achieved
     rates, the HBM gauges, and the burst's p50 with telemetry on and off
     in three interleaved pairs;
 10. execute (``execute_test``, ``execute_2b``): ``plan_and_execute`` on
     each configuration's intents at once, over in-process services of
     which the first service of every other intent's plan always fails, so
     that plans are replanned around them with the plan's prompt prefix
     pinned, the executions run in rounds (``Lockstep``); the reference
     bench's replan probe, warm against cold; and the pass again with the
     telemetry store reset, equal to the first at test but for the tools'
     measured latency in replan prompts (``p50=``, host noise; see
     ``execute_phase``);
 11. mixed traffic (``mixed_test``, ``mixed_2b``), on the serving engines
     after phase 9: the reference bench's five request classes by direct
     ``engine.generate`` calls with the homogeneous slab, then with the
     heterogeneous one (``mixed_phase``);
 12. the heterogeneous slab with speculative decoding through ``/plan``
     (``serve_hetero_test``, after phase 5): the first burst's intents on a
     control plane with ``hetero_batch`` and speculation (k 4) on, whose
     plans must equal phase 5's (``serve_hetero``);
 13. speculation (``spec_test``, ``spec_2b``), after phase 10: the reference
     bench's speculation scenario on a dedicated heterogeneous engine, off
     (one token a forward) against on (k 4, the recurrent drafter) in
     interleaved rounds (``spec_phase``);
 14. the tiered KV cache (``tier_test``, ``tier_2b``): the reference bench's
     tier scenario on dedicated engines at its geometry, single tier,
     tiered with a warm restart from its snapshot, a thrash tenant against
     a victim, and a seeded chaos profile (``tier_phase``);
 15. the tier's copies held bit for bit (``tier_roundtrip_test``,
     ``tier_roundtrip_2b``): spill, page reuse, readmit into other pages and
     the kernel over them, alone and beside a replaying graph
     (``tier_roundtrip``); phase 3 times the kernel at the tier's shapes;
 16. weight-only int8 (``int8_test`` after phase 12, ``int8_2b`` after
     phase 6): the first burst on a control plane with
     ``model.quantize="int8"`` at the same settings, then a repeat that
     captures nothing with ``graph_window_int8_*``; the weights' bytes, p50,
     plans/s, live forwards, peak memory and device ms a window against the
     bf16 burst's, and how many plans equal its (``int8_phase``); phase 4
     runs again on the int8 tree of the checkpoint;
 17. overload (``overload_test``, ``overload_2b``), on the serving engines
     after phase 11: the reference bench's overload scenario, an admission
     scheduler attached live and unique intents offered open loop at four
     times the width's burst rate (``overload_phase``);
 18. chaos (``chaos_test``), on phase 16's test control plane: the
     reference bench's chaos scenario, ``/execute`` over seeded faulty
     in-process tools with resilience off, then on (``chaos_phase``);
 19. the observatory (``observatory_test``, ``observatory_2b`` on the
     serving engines after phase 9, ``observatory_spec_test`` on phase 12's
     speculative control plane): telemetry's default-off parts (the cost
     ledger, the SLO tracker, decision provenance, the flight recorder)
     attached live, the burst served with them off and on in three
     interleaved rounds, each request wrapped as the HTTP middleware wraps
     it. Fails unless the plans are equal, nothing is captured, the ``sync``
     waits are as many, the bills add up exactly to the ledger's and the
     ``/costs`` totals, the explanations and a bundle are valid and the
     kernel matches its plain version at the engine's pages; prints the
     overhead fractions and p50 by arm (``observatory_phase``);
 20. a 100k-service deployment (``registry_index``, ``registry_100k_test``,
     ``registry_100k_2b``, ``registry_snapshot``): ``gen-registry``'s file of
     100,000 services (seed 7) served by the file backend, the retrieval
     table built once (its host seconds printed) and placed on the card at
     ``compute="auto"`` (102.4 MB, float32), shared by a control plane at
     each width with shortlist-constrained names; a burst of 16 (test) or 8
     (2b) ``/plan``s, a repeat that captures nothing, the shortlist's device
     ranking against host numpy timed during the repeat and on an idle card,
     and equal to the host's on every intent but near-ties (printed); the
     table saved and reloaded onto the card with equal shortlists, and
     loaded into a sharded index of two row shards whose shortlists equal
     the unsharded one's but near-ties (``registry_sharded``)
     (``config_surface``);
 21. a SentencePiece vocabulary (``sp_2b``): the 2b preset with
     ``model.vocab="sp:<path>"`` (``tiny_model()``'s file), random weights,
     8 ``/plan``s and a repeat that captures nothing; every plan
     LLM-authored, valid, and its steps JSON parses (``sp_phase``);
 22. the cluster (``cluster_test``, ``cluster_2b``): ``cluster.enabled``
     with two engine replicas on the card behind the pool, prefix affinity,
     burn-aware placement, the sharded registry and warm-restart snapshots;
     phases 5-6's intents, their repeat, a burst during which the busy
     replica is killed, its warm rejoin, a burst during which the other
     drains, its rejoin (``cluster_phase``);
 23. the offline path (``offline_phase``): the planner corpus (512 rows over
     1,000 services, ``corpus``); the test preset trained from the committed
     checkpoint in float32 on the card and on the CPU, every step's loss
     within 1e-3 relative (``train_parity_test``); trained from random init,
     200 steps, the final loss under 0.7 of the first, with host ms against
     device ms a step (``train_test``); the 2b preset at full width from
     random float32 weights, 6 steps at batch 8, finite and falling losses,
     peak memory and achieved FLOP/s against the float32 peak
     (``train_2b``); the parity run's weights saved, loaded and served
     through the kernel, 16 ``/plan``s and a repeat that captures nothing
     (``train_serve_test``); and ``evaluate_planner`` over the committed
     checkpoint, 48 intents at the registry and shortlist tiers and int8,
     each within 0.05 of the reference's own CPU quality (``eval_test``,
     with the plans whose least top-2 margin is a near-tie);
 24. the parallel package (``parallel_phase``), every mesh a virtual mesh
     of the card (one device at every coordinate: the ring's algebra in
     full, its hops no-ops; no multi-card number): ring attention at 2b's
     attention shape (K 1, G 8, hd 256, B 2, T 4096) on seq meshes of 2, 4
     and 8 and data 2 x seq 4 against the dense ``_attend``, float32 within
     2e-5, bf16's worst error, each route's ms and peak bytes
     (``ring_attention_2b``); an engine on a ``seq=4`` mesh serving /plan
     prompts over a 64-service shortlist with ring prefill off, then at
     their bucket, then a repeat, then a short prompt: the test preset in
     float32 on the committed checkpoint, plans byte for byte
     (``ring_serve_test``), and the 2b preset in bf16, near-ties explained
     (``ring_serve_2b``); both again in float32 on a ``data=4`` mesh (its
     data coordinates viewed as the seq axis, the ring through the sharded
     forward; the dense route's prefill splits the rows in 4 blocks, so the
     ring is also held against a pass with the prefill's rows whole, and
     the blocked pass against that one: ``ring_serve_data4_*``); a
     one-cohort probe, the ring, the ring through the ``data=4`` layout and
     the blocked dense prefill within 1e-3 of dense in float32, and each
     route's bf16 error (``ring_probe_2b``); phase 20's table on a ``model=2`` mesh,
     shortlists equal (``retrieval_mesh``); phase 23's parity training on a
     ``data=2`` and a hybrid mesh against none, losses within 1e-5
     (``train_dp_test``); its wall time (``parallel``);
 25. static analysis (``lint``), on the host: the port's mcpxlint
     (``mcpx_torch.analysis.scan_paths``) over ``mcpx_torch/`` on this
     machine's Python, with its findings, the new ones and the stale
     entries against the port's baseline (``mcpx_torch/analysis/
     baseline.json``), the scan's seconds and its five slowest rules;
     fails on any new finding or stale entry;
 26. TP/DP serving (``tp_serve_test``, ``tp_serve_2b``): the burst's /plan
     intents (16 on the committed checkpoint, 8 at 2b on random weights,
     batch 64, greedy, float32 both) on the unmeshed engine and on one whose
     mesh is a virtual ``data=2, model=2`` mesh of the card, each model
     shard launching the ragged kernel over its own query heads for each
     row block; plans/s, p50, kernel launches a decode forward (the meshed
     engine's ``n_layers x 2 x 2``), captures on a repeat (0) and peak
     allocated bytes of both; plans byte for byte equal at test, token
     streams equal at 2b but where the unmeshed run's masked top-2 margin
     at the first differing token is under 1e-4; each shard's kernel launch
     at its row blocks and pool views against the plain version, the
     served MQA layout and a GQA one whose second view starts at an offset
     (``kernel_at_shards``; ``tp_phase``). The mesh's
     four coordinates are one card: its times are the shard loop's cost,
     not a multi-card speed-up;
 27. across cards (``cross_card_phase``), with two or more visible cards
     (on one it prints ``cross_card`` with ``ran: false``; ``--cards N``
     fails with fewer than N): the kernel on each card against its plain
     version there (``cross_kernel``); float32 weights on meshes of
     distinct cards (``data=2`` and ``model=2`` over cards 0-1, ``data=2,
     model=2`` over 0-3) against the same mesh shape virtual on card 0, one
     decode forward and one dense prefill: logits, every card's pools and
     dense cache bit for bit, the launches on each card and the transfers a
     forward (``cross_forward_*``, the test preset, 2b at 4 layers, and the
     7b preset's widths at 2 layers on ``model=4``, its 16 KV heads split
     over the cards, and 2b int8 at 4 layers on the widest mesh); phase
     26's bursts on each mesh against the unmeshed engine, windows eager
     (``cross_serve_test``, with an engine that builds its ``data=2`` mesh
     over cards 0-1 from explicit axes, ``cross_serve_2b``, and
     ``cross_serve_int8_test`` on ``model=2`` against the unmeshed int8
     engine); phase 24's ring serving on ``data=2`` over cards 0-1, the
     ring held against the dense route (``cross_ring_serve_data2_test``);
     phase 20's table in row shards on two cards (``retrieval_mesh_cards``);
     the ring on ``seq=4`` cards against dense (``cross_ring``); phase 23's
     parity training on ``data=2`` cards (``train_dp_cards``). Its serving
     launches count in the kernels line; its plans/s are first numbers,
     with nothing to compare them with;
then the kernels line, the card line and the result line. ``--profile`` adds,
after each serving phase of 5 and 6 and each mode of 7, one more pass of its
requests under ``torch.profiler`` with the device time by kernel and the
idle share. Any failed phase
exits non-zero before the result line. The kernel launch counters are set to
0 just before each serving run and read just after it; they include the
launches of every replayed window (``replay_launches``: replays times layers
times forwards a window), and every serving line carries the windows
captured in its run (``captures``), which must be 0 wherever the run repeats
traffic already served.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import contextvars
import dataclasses
import gc
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
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


def verify_batch(seed, B, S, K, G, hd, L, psz, pmax, dtype, live):
    """The speculative verify window: ``live`` random rows at q_len S (the
    current token and S - 1 drafts), the rest idle, random distinct pages,
    starts uniform in [0, Pmax*Psz - S)."""
    rng = random.Random(seed)
    q, kp, vp, table, _starts, _q_lens = mixed_batch(seed, B, S, K, G, hd, L, psz, pmax, dtype, live=B)
    rows = set(rng.sample(range(B), live))
    as_i32 = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")  # noqa: E731
    q_lens = [S if b in rows else 0 for b in range(B)]
    starts = [rng.randint(0, pmax * psz - S - 1) for _ in range(B)]
    return q, kp, vp, table, as_i32(starts), as_i32(q_lens)


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


# (cell, G, hd, L, live, Psz, Pmax): the trained `test` preset and the
# full-width `2b` preset, at the serving geometry B=64, S=speculate_k=8,
# Psz=64, Pmax=4; live=None is the mixed batch, live=n the serving bursts'
# mix (16 or 8 live rows of 64, the rest idle: where splitting pays).
# live="prefill" is a suffix-prefill cohort at prefill width: B 16, S 128
# (the prefill bucket), starts 0, 64 or 128, two idle rows. The /p16 cells
# are the execute phases' geometry: the same row capacity in 16-token pages.
# live=("verify", n) is the speculative verify window at k 4: B 64, S 5,
# q_len 5 on n live rows (the spec phases' requests in flight: 32 at test,
# 16 at 2b) and 0 on the rest. live="tier_prefill"/"tier_decode" are the
# tier phases' shapes (``tier_batch``): B 4, 16-token pages, 16 a row.
CELLS = (
    ("test", 4, 32, 2, None, 64, 4), ("2b", 8, 256, 18, None, 64, 4),
    ("test/serve_mix", 4, 32, 2, 16, 64, 4), ("2b/serve_mix", 8, 256, 18, 8, 64, 4),
    ("test/prefill", 4, 32, 2, "prefill", 64, 4), ("2b/prefill", 8, 256, 18, "prefill", 64, 4),
    ("test/serve_mix/p16", 4, 32, 2, 16, 16, 16), ("2b/serve_mix/p16", 8, 256, 18, 8, 16, 16),
    ("test/prefill/p16", 4, 32, 2, "prefill", 16, 16), ("2b/prefill/p16", 8, 256, 18, "prefill", 16, 16),
    ("test/verify", 4, 32, 2, ("verify", 32), 64, 4), ("2b/verify", 8, 256, 18, ("verify", 16), 64, 4),
    ("test/tier_prefill", 4, 32, 2, "tier_prefill", 16, 16), ("2b/tier_prefill", 8, 256, 18, "tier_prefill", 16, 16),
    ("test/tier_decode", 4, 32, 2, "tier_decode", 16, 16), ("2b/tier_decode", 8, 256, 18, "tier_decode", 16, 16),
)


def cell_batch(seed: int, G: int, hd: int, L: int, live, psz: int, pmax: int):
    if live in ("tier_prefill", "tier_decode"):
        return tier_batch(seed, live, G, hd, L, psz, pmax)
    if live == "prefill":
        return prefill_batch(seed, 16, 128, 1, G, hd, L, psz, pmax, torch.bfloat16)
    if isinstance(live, tuple):
        return verify_batch(seed, 64, 5, 1, G, hd, L, psz, pmax, torch.bfloat16, live[1])
    return mixed_batch(seed, 64, 8, 1, G, hd, L, psz, pmax, torch.bfloat16, live)


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
    for cell, G, hd, L, live, psz, pmax in CELLS:
        worst = 0.0
        for seed in range(3):
            q, kp, vp, table, starts, q_lens = cell_batch(seed, G, hd, L, live, psz, pmax)
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
        q, kp, vp, table, starts, q_lens = cell_batch(0, G, hd, L, live, psz, pmax)
        times = kernel_times(q, kp, vp, table, starts, q_lens, L)
        bound_ms, bound_by, nbytes, flops = attention_bound(q, kp, table, starts, q_lens)
        row = dict(
            cell=cell, B=q.shape[0], S=q.shape[1], K=1, G=G, hd=hd, L=L, page_size=psz, max_pages=pmax,
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

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    left = sum(int(t.abs().sum()) for t in ticket_counters())
    if left:
        raise SystemExit(f"{where}: ticket counters not reset ({left})")


# ------------------------------------------------------------ serving
def config(size: str, checkpoint: str, batch: int):
    from mcpx_torch.core.config import MCPXConfig

    return MCPXConfig.from_dict({
        "model": {"size": size, "vocab": "bpe", "max_seq_len": 2048, "checkpoint_path": checkpoint},
        # The reference bench's headline engine settings: 64-token pages,
        # 4 pages a row, 64-token decode budget, greedy, window 8; the rest
        # at the reference's defaults: the homogeneous slab, prompt drafting,
        # pipeline depth 2, 4 x 4 forwards a segment, the prefix cache on.
        "engine": {
            "max_batch_size": batch, "kv_page_size": 64, "max_pages_per_seq": 4,
            "max_decode_len": 64, "temperature": 0.0, "speculate_k": 8,
            # As the reference bench: the hot decode window is captured at
            # startup, so serving captures only what the warm-up missed.
            "warmup_compile": True,
        },
        "planner": {"kind": "llm"},
    })


def forward_check(card: str, quantize: bool = False) -> None:
    """The trained checkpoint in float32: prefill, commit to pages and one
    ragged paged decode forward, on the card against the CPU, in the
    serving phases' pages (64 tokens, 4 a row) and the execute phases'
    (16 tokens, 16 a row). With ``quantize`` the weights are the int8 tree
    (``quantize_params`` of the same checkpoint), dequantized to float32
    layer by layer inside the forwards."""
    from mcpx_torch.engine.kv_cache import commit_prefill_to_pages, init_paged_kv
    from mcpx_torch.engine.paged_decode import decode_chunk_paged
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.models.gemma.model import init_kv_cache, prefill
    from mcpx_torch.models.gemma.params import load_npz
    from mcpx_torch.models.gemma.quant import quantize_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(GemmaConfig.named("test", vocab_size=3072), dtype="float32")
    rng = torch.Generator().manual_seed(0)
    B, T = 4, 64
    tokens = torch.randint(0, 3000, (B, T), generator=rng)
    lens = torch.tensor([64, 17, 40, 5])
    chunk = torch.randint(0, 3000, (B, 8), generator=rng)
    q_lens = torch.tensor([8, 1, 3, 0], dtype=torch.int32)
    for psz, pmax in ((64, 4), (16, 16)):
        table = torch.arange(1, B * pmax + 1, dtype=torch.int32).reshape(B, pmax)
        outs = []
        for dev in ("cuda", "cpu"):
            params = load_npz(CKPT, dev, torch.float32)
            if quantize:
                params = quantize_params(params)
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
        emit("forward_check", card, dtype="float32", weights="int8" if quantize else "float32", page_size=psz,
             max_pages=pmax, max_abs_err=err, atol=1e-3, finite=finite, shapes=shapes)
        if not finite or err > 1e-3 or shapes != [[B, 3072], [B, 3072]]:
            raise SystemExit(f"forward check ({psz}-token pages, quantize {quantize}) failed: err {err}, "
                             f"finite {finite}, shapes {shapes}")


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
    after=None, name: str = "",
) -> tuple[dict, list, object]:
    """Serve ``n_intents`` concurrent /plan requests on a fresh control
    plane; then, on the same engine, ``after(cp, records, intents, plans,
    stats)`` when given. Returns (stats, plans, what ``after`` returned);
    the stats carry the weights' bytes and the repeat's ``graph_window``.
    The lines are ``serve_<size>`` and ``graph_window_<size>``, or ``name``
    and ``graph_window_<name>``."""
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.models.gemma.params import n_bytes
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.telemetry.flight import WorkerProfiler
    from mcpx_torch.telemetry.tracing import Tracer
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
        # The first burst from an emptied tree and as one cohort, as the
        # telemetry phase serves these intents again and requires the same
        # plans; traced, with the worker-loop profiler attached (the
        # telemetry phases print p50 with and without both).
        await engine.drop_unpinned()
        q0 = engine.queue_stats()
        c0 = engine.costs.snapshot()["executables"]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_kernel_launches()
        tracer = Tracer(enabled=True, sample_rate=1.0, ring_size=max(256, n_intents))
        engine._profiler = prof = WorkerProfiler()
        t0 = time.monotonic()
        try:
            with one_cohort(engine, n_intents):
                plans, recs = await traced_burst(cp, intents, tracer)
        finally:
            engine._profiler = None
        wall = time.monotonic() - t0
        launches = kernel_launches()
        await settle_profile()
        lat = sorted(r.total_ms for r in recs)
        for p in plans:
            p.validate()
        stats = dict(
            model=size, intents=n_intents, wall_s=wall, plans_per_s=n_intents / wall,
            p50_ms=lat[len(lat) // 2], max_ms=lat[-1], startup_s=startup_s,
            # Windows captured at startup: the engine's warm-up (the generic
            # grammar's bucket) and the planner's warm request (the registry
            # grammar's bucket, counted as serving).
            warmup_captures=q0["warmup_captures"], startup_captures=q0["captures"],
            capture_counts=engine.capture_counts(),
            **loop_counts(engine, q0, engine.queue_stats(), n_intents),
            origins={o: sum(p.origin == o for p in plans) for o in {p.origin for p in plans}},
            launches=launches, max_memory_allocated=torch.cuda.max_memory_allocated(),
            weight_bytes=n_bytes(engine._params),
            worker_profile=profile_summary(prof.snapshot()),
            attribution=attribution(recs),
            # Executable keys the burst ran for the first time (the
            # sentinel's compiles): eager prefill and sampling shapes too.
            first_sight=first_sight(c0, engine.costs.snapshot()["executables"]),
        )
        emit(name or f"serve_{size}", card, **stats)
        stats["graph_window"] = await repeat_with_graph_window(cp, intents, name or size, card)
        if profile:
            # The same requests once more under the profiler, after the
            # measured run, so the profiler's cost stays out of its numbers.
            q1 = engine.queue_stats()
            with _profiler() as prof:
                t0 = time.monotonic()
                await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            emit(f"profile_{size}", card, **device_breakdown(prof, wall),
                 **loop_counts(engine, q1, engine.queue_stats(), n_intents))
            no_new_captures(f"profile_{size}", q1, engine.queue_stats())
        extra = await after(cp, records, intents, plans, stats) if after is not None else None
        return stats, plans, extra
    finally:
        await cp.aclose()


async def idle(engine) -> None:
    """Wait until no row is resident and nothing is queued: config flips
    between runs land on an idle slab."""
    while engine.queue_stats()["active_rows"] or engine.queue_stats()["queue_depth"]:
        await asyncio.sleep(0.05)


LOOP_COUNTERS = (
    "segments", "windows", "decode_forwards", "live_forwards", "drafted", "accepted",
    "decode_tokens", "captures", "replays",
)


def loop_counts(engine, q0: dict, q1: dict, n_plans: int) -> dict:
    """The decode loop's counters over a run, from two ``queue_stats()``:
    segments, windows, forwards dispatched and live, drafted and accepted
    tokens, windows captured and replayed, the ragged-kernel launches the
    replays made (one a layer a forward), generated tokens per live
    forward and live forwards per plan."""
    d = {k: q1[k] - q0[k] for k in LOOP_COUNTERS}
    tick = max(1, engine.config.engine.decode_steps_per_tick)
    return dict(
        **d, replay_launches=d["replays"] * launches_per_forward(engine) * tick,
        tokens_per_live_forward=d["decode_tokens"] / max(1, d["live_forwards"]),
        live_forwards_per_plan=d["live_forwards"] / n_plans,
    )


def launches_per_forward(engine, batch: int = 0) -> int:
    """Ragged-kernel launches of one decode forward over ``batch`` rows (the
    slab's): one a layer, on a meshed engine one a layer for each attention
    shard and row block."""
    layout, n = engine._layout, engine.model_cfg.n_layers
    if layout is None:
        return n
    return n * len(layout.attn) * len(layout.rows(batch or engine.config.engine.max_batch_size))


def no_new_captures(where: str, q0: dict, q1: dict) -> None:
    """A run that repeats traffic already served captures no window."""
    if q1["captures"] != q0["captures"]:
        raise SystemExit(f"{where}: repeated traffic captured {q1['captures'] - q0['captures']} new windows")


# ------------------------------------------------------------ graph window
def window_state(engine) -> dict:
    """Copies of everything a decode window reads or writes that a later
    window can see: the slab's buffers and the KV pools."""
    state = {f"slab.{k}": t.clone() for k, t in engine._slab.dev.items()}
    state.update({f"kv.{k}": t.clone() for k, t in engine._paged_kv.items()})
    return state


def set_window_state(engine, state: dict) -> None:
    """Write a ``window_state`` back into the engine's buffers in place."""
    for name, t in state.items():
        where, k = name.split(".", 1)
        (engine._slab.dev if where == "slab" else engine._paged_kv)[k].copy_(t)


def window_routes(engine, turns: int = 2):
    """From one snapshot of the slab (it must have a live row and its
    window a captured graph; else None), the window once eagerly and once
    by replay, in turns (eager, replay, replay, eager) x ``turns``, each
    from the snapshot. Per route: host ms (until the call returns, before
    any wait) and ms between CUDA events around the call (the stream's time
    for the window, which for the eager route includes the card's waits on
    the host), least of the runs. ``differing`` lists the buffers whose end
    states are not bitwise equal across runs and routes. The snapshot is
    restored after, and the comparison's kernel launches are left out of
    the launch counts."""
    from mcpx_torch.engine.kernels.paged_attention import LAUNCHES

    slab = engine._slab
    key, dfa = engine._window_plan(slab)
    graph = engine._graphs.get(key)
    torch.cuda.synchronize()
    if graph is None or bool(slab.dev["done"].all()):
        return None
    launches = dict(LAUNCHES)
    snap = window_state(engine)
    times: dict = {"eager": [], "replay": []}
    first = None
    differing: set = set()
    for route in ("eager", "replay", "replay", "eager") * turns:
        set_window_state(engine, snap)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        if route == "eager":
            engine._window(slab, key, dfa)
        else:
            graph.replay()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        torch.cuda.synchronize()
        times[route].append((host_ms, a.elapsed_time(b)))
        end = window_state(engine)
        first = first or end
        differing |= {k for k in first if not torch.equal(first[k], end[k])}
    set_window_state(engine, snap)
    torch.cuda.synchronize()
    LAUNCHES.update(launches)
    return dict(
        key=repr(key), live_rows=int((~snap["slab.done"]).sum()), forwards=key[5],
        emitted=int((first["slab.emitted"] - snap["slab.emitted"]).sum()),
        host_ms_eager=min(h for h, _ in times["eager"]), host_ms_replay=min(h for h, _ in times["replay"]),
        device_ms_eager=min(d for _, d in times["eager"]), device_ms_replay=min(d for _, d in times["replay"]),
        runs=len(times["eager"]) + len(times["replay"]), differing=sorted(differing),
    )


async def repeat_with_graph_window(cp, intents: list, size: str, card: str) -> dict:
    """The burst's requests once more on the same engine: no new window may
    be captured. At the first segment with a live row, ``window_routes``
    runs in the worker before the segment is dispatched; every buffer and
    pool byte must agree between the routes (greedy: bitwise)."""
    engine = cp.planner.engine
    real = engine._dispatch_segment
    found: dict = {}

    def hooked(slab):
        if "routes" not in found:
            routes = window_routes(engine)
            if routes is not None:
                found["routes"] = routes
        real(slab)

    q0 = engine.queue_stats()
    engine._dispatch_segment = hooked
    try:
        await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
    finally:
        engine._dispatch_segment = real
    q1 = engine.queue_stats()
    counts = loop_counts(engine, q0, q1, len(intents))
    routes = found.get("routes")
    emit(f"graph_window_{size}", card, **(routes or {}), repeat=counts)
    no_new_captures(f"graph_window_{size}", q0, q1)
    if routes is None or routes["differing"] or routes["emitted"] <= 0:
        raise SystemExit(f"graph_window_{size}: replay and eager disagree or never ran: {routes}")
    return routes


# ------------------------------------------------------------ decode-loop modes
MODES = (("off", 1), ("prompt", 1), ("prompt", 2))  # (draft_mode, pipeline_depth)
NEAR_TIE = 1e-3  # top-2 margin of masked logits under which greedy picks may flip


def _allowed(engine, kw: dict, toks: list, k: int, tables) -> tuple:
    """(active ids, allowed columns) of the next token after ``toks[:k]``,
    masked as the engine masks them (grammar-legal, and able to finish
    within the decode budget: the call's ``max_new_tokens``, else
    ``max_decode_len``; a free call's mask is the real vocabulary)."""
    if not kw.get("constrained", True):
        return np.arange(engine.tokenizer.vocab_size), engine._unconstrained_mask.cpu().numpy()
    trans, mask, dist, active, eos, inv = tables
    s = 0
    for t in toks[:k]:
        s = int(trans[s, inv[t]])
    legal = mask[s]
    budget = kw.get("max_new_tokens") or engine.config.engine.max_decode_len
    finish = legal & (eos | (dist[trans[s]] <= budget - k - 1))
    return active, finish if finish.any() else legal


def _grammar_tables(engine, kw: dict):
    if not kw.get("constrained", True):
        return None
    return (kw.get("grammar") or engine.grammar).device_tables(64)


def _top2_margin(vals, active, allowed) -> float:
    top = np.sort(np.where(allowed, vals[active], -np.inf))[-2:]
    return float(top[1] - top[0])


def _dense_logits(engine, ids: list, last_only: bool):
    from mcpx_torch.models.gemma.model import init_kv_cache, prefill

    dev = engine.device
    t = torch.tensor([list(ids)], device=dev)
    cache = init_kv_cache(engine.model_cfg, 1, t.shape[1], device=dev)
    with torch.inference_mode():
        logits, _ = prefill(engine._params, engine.model_cfg, t, torch.tensor([t.shape[1]], device=dev), cache,
                            last_only=last_only, layout=engine._layout)
    return logits[0].float().cpu().numpy()


def masked_margin(engine, prompt_ids: list, kw: dict, toks: list, k: int) -> float:
    """Top-2 margin of the next token's logits after ``prompt_ids +
    toks[:k]``, masked as the engine masks them (``_allowed``), by one dense
    prefill on the engine's device."""
    active, allowed = _allowed(engine, kw, toks, k, _grammar_tables(engine, kw))
    return _top2_margin(_dense_logits(engine, list(prompt_ids) + list(toks[:k]), True), active, allowed)


def stream_margin(engine, prompt_ids: list, kw: dict, toks: list) -> tuple[float, int]:
    """(least top-2 margin, its position) of the masked logits over every
    token of a greedy stream: one dense prefill of prompt and stream on the
    engine's device, each position masked as ``masked_margin`` masks it."""
    logits = _dense_logits(engine, list(prompt_ids) + list(toks), False)
    tables = _grammar_tables(engine, kw)
    margins = [
        _top2_margin(logits[len(prompt_ids) - 1 + k], *_allowed(engine, kw, toks, k, tables))
        for k in range(len(toks))
    ]
    k = int(np.argmin(margins)) if margins else 0
    return (margins[k] if margins else math.inf), k


async def serve_modes(
    cp, intents: list, size: str, card: str, trained: bool, profile: bool = False
) -> list[dict]:
    """The burst's intents once more in each of MODES, live flips on an
    idle slab of the same engine, with the prefix cache off for the phase:
    every mode then admits the same prompts by dense prefill and drafts from
    the whole prompt, as from a cold tree (warm from the burst, a repeated
    prompt's suffix is its last partial page, with little to draft from).
    Each mode runs twice:
      * through ``ControlPlane.plan``: plans/s, p50, the plans, origins and
        kernel launches;
      * a replay of the first mode's engine calls, submitted at once, so
        that they form one cohort whatever the planner's timing: the
        decode-loop counters (forwards dispatched and live, drafted and
        accepted tokens, tokens per live forward) and the token streams.
    With ``profile``, each mode's /plan pass runs once more under the
    profiler (device time by kernel, idle share). One unmeasured request
    with drafting off comes first, so that the fast-forward window is
    captured before any measured pass.
    Prints each mode's line; fails unless no mode captures a window, every
    plan is valid, drafting
    takes no more live forwards than the loop without it, and the plans and
    replayed streams agree with the first mode's: exactly at test; at 2b a
    differing stream passes only as a near-tie (its first differing token's
    masked top-2 margin under NEAR_TIE, printed with both texts). With
    ``trained`` weights, which copy service names from their prompt, it
    also fails unless drafting accepts tokens and takes fewer live forwards;
    random weights copy nothing, so the prompt lookup has no match to
    propose from (the counts are printed all the same)."""
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches

    engine = cp.planner.engine
    ecfg = engine.config.engine
    saved = (ecfg.draft_mode, ecfg.pipeline_depth, ecfg.prefix_cache)
    real_generate = engine.generate
    calls: dict = {}

    async def recording(prompt_ids, **kw):
        res = await real_generate(prompt_ids, **kw)
        calls.setdefault(tuple(prompt_ids), (kw, res.token_ids))
        return res

    runs = []
    replay_calls: list = []
    try:
        # One unmeasured request with drafting off first: its window key
        # (the fast-forward body) is captured here, so no mode's measured
        # pass pays a capture and every mode must capture nothing.
        await idle(engine)
        ecfg.draft_mode, ecfg.prefix_cache = "off", False
        q_warm = engine.queue_stats()
        await cp.plan(intents[0], use_cache=False)
        warm_captures = engine.queue_stats()["captures"] - q_warm["captures"]
        for draft, depth in MODES:
            await idle(engine)
            ecfg.draft_mode, ecfg.pipeline_depth, ecfg.prefix_cache = draft, depth, False
            calls = {}
            engine.generate = recording
            q_mode = engine.queue_stats()
            torch.cuda.synchronize()
            reset_kernel_launches()
            t0 = time.monotonic()
            results = await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
            wall = time.monotonic() - t0
            launches = kernel_launches()
            engine.generate = real_generate
            plans = [p for p, _ in results]
            lat = sorted(ms for _, ms in results)
            for p in plans:
                p.validate()
            replay_calls = replay_calls or sorted(calls.items())
            await idle(engine)
            q0 = engine.queue_stats()
            replayed = await asyncio.gather(*(
                real_generate(list(prompt), **kw) for prompt, (kw, _) in replay_calls
            ))
            stats = dict(
                model=size, draft_mode=draft, pipeline_depth=depth, prefix_cache=False,
                intents=len(intents), wall_s=wall, plans_per_s=len(intents) / wall,
                p50_ms=lat[len(lat) // 2],
                origins={o: sum(p.origin == o for p in plans) for o in {p.origin for p in plans}},
                launches=launches, replayed_calls=len(replay_calls),
                **loop_counts(engine, q0, engine.queue_stats(), len(replay_calls)),
                mode_captures=engine.queue_stats()["captures"] - q_mode["captures"],
                warm_captures=warm_captures,
                # The /plan pass's own counts: its launches are the line's.
                plan_pass=loop_counts(engine, q_mode, q0, len(intents)),
            )
            emit(f"serve_modes_{size}", card, **stats)
            no_new_captures(f"serve_modes_{size} {draft} {depth}", q_mode, engine.queue_stats())
            if profile:
                q_prof = engine.queue_stats()
                with _profiler() as prof:
                    t0 = time.monotonic()
                    await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
                    torch.cuda.synchronize()
                    wall = time.monotonic() - t0
                emit(
                    f"profile_modes_{size}", card, draft_mode=draft, pipeline_depth=depth,
                    **device_breakdown(prof, wall),
                    **loop_counts(engine, q_prof, engine.queue_stats(), len(intents)),
                )
                no_new_captures(f"profile_modes_{size}", q_prof, engine.queue_stats())
            streams = dict(calls)
            streams.update({("replay",) + p: (kw, r.token_ids) for (p, (kw, _)), r in zip(replay_calls, replayed)})
            runs.append((stats, plans, streams))
    finally:
        engine.generate = real_generate
        await idle(engine)
        ecfg.draft_mode, ecfg.pipeline_depth, ecfg.prefix_cache = saved

    off, off_plans, off_streams = runs[0]
    tok = engine.tokenizer
    for stats, plans, streams in runs[1:]:
        if trained and stats["accepted"] <= 0:
            raise SystemExit(f"serve_modes_{size}: drafting accepted no token: {stats}")
        if stats["live_forwards"] > off["live_forwards"]:
            raise SystemExit(f"serve_modes_{size}: drafting cost live forwards: {off} {stats}")
        differ = [i for i, (a, b) in enumerate(zip(off_plans, plans)) if a.to_json() != b.to_json()]
        ties = []
        for key, (kw, toks) in streams.items():
            ref_toks = off_streams.get(key, (None, toks))[1]
            if toks == ref_toks:
                continue
            k = next((j for j, (a, b) in enumerate(zip(toks, ref_toks)) if a != b), min(len(toks), len(ref_toks)))
            prompt = [t for t in key if t != "replay"]
            margin = masked_margin(engine, prompt, kw, toks, k)
            emit(
                f"near_tie_{size}", card, draft_mode=stats["draft_mode"],
                pipeline_depth=stats["pipeline_depth"], replay=key[0] == "replay", position=k,
                margin=margin, limit=NEAR_TIE, draft_off=tok.decode(ref_toks), this_mode=tok.decode(toks),
            )
            ties.append(margin)
        if size == "test" and (differ or ties):
            raise SystemExit(f"serve_modes_{size}: plans differ at {differ}, streams at {len(ties)}: {stats}")
        if ties and max(ties) >= NEAR_TIE or differ and not ties:
            raise SystemExit(f"serve_modes_{size}: plans differ at {differ}, not near-ties ({ties})")
    if trained and not runs[1][0]["live_forwards"] < off["live_forwards"]:
        raise SystemExit(f"serve_modes_{size}: drafting did not cut live forwards: {off} {runs[1][0]}")
    return [st for st, _, _ in runs]


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
        await idle(engine)
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
            launches=launches, **loop_counts(engine, q0, q1, n),
        )
        emit(f"serve_prefix_{size}", card, **stats)
        no_new_captures(f"serve_prefix_{size}", q0, q1)
        return stats, plans

    saved = ecfg.prefix_cache
    try:
        off, off_plans = await run(False)
        on, on_plans = await run(True)
    finally:
        await idle(engine)
        ecfg.prefix_cache = saved
    differ = [i for i, (a, b) in enumerate(zip(off_plans, on_plans)) if a.to_json() != b.to_json()]
    if differ:
        raise SystemExit(f"serve_prefix_{size}: plans differ between the modes at {differ}")
    if on["hits"] <= 0 or on["suffix_prefills"] <= 0 or on["suffix_prefill_launches"] <= 0:
        raise SystemExit(f"serve_prefix_{size}: no reuse through the kernel: {on}")
    if not on["prefill_tokens_per_request"] < off["prefill_tokens_per_request"]:
        raise SystemExit(f"serve_prefix_{size}: the cache did not cut prefill tokens: {off} {on}")
    return {"off": off, "on": on}


# ------------------------------------------------------------ telemetry
# Latency attribution phases: the reference bench's (span names whose
# durations add up to each phase of a request).
ATTR_PHASES = {
    "sched_queue": ("sched.acquire",),
    "engine_queue": ("engine.queue_wait",),
    "prefill": ("engine.prefill",),
    "decode": ("engine.decode",),
    "tools": ("attempt",),
}
TRACE_SPANS = ("plan", "engine.generate", "engine.queue_wait", "engine.prefill", "engine.decode")
METRIC_LINE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})? (\S+)$'
)


def quantile(vals: list, p: float) -> float:
    """The bench's quantile: the element at ``p`` of the sorted values."""
    vs = sorted(vals)
    return vs[min(len(vs) - 1, int(p * (len(vs) - 1)))]


def attribution(recs: list) -> dict:
    """p50/p99 per phase of the traced requests and each phase's share of
    the p50 request, as the reference bench attributes latency; plus the
    planner's time outside the engine (``plan`` minus its
    ``engine.generate`` spans) and, within it, the ``plan.context`` spans
    (registry version, retrieval shortlist)."""
    rows = []
    for rec in recs:
        phases = {k: 0.0 for k in ATTR_PHASES}
        for sp in rec.spans:
            for key, names in ATTR_PHASES.items():
                if sp.name in names:
                    phases[key] += sp.duration_ms
        plan_ms = sum(sp.duration_ms for sp in rec.spans if sp.name == "plan")
        gen_ms = sum(sp.duration_ms for sp in rec.spans if sp.name == "engine.generate")
        phases["planner_outside_engine"] = plan_ms - gen_ms
        phases["plan_context"] = sum(sp.duration_ms for sp in rec.spans if sp.name == "plan.context")
        phases["total"] = rec.total_ms
        rows.append(phases)
    keys = [*ATTR_PHASES, "planner_outside_engine", "plan_context", "total"]
    p50 = {k: quantile([r[k] for r in rows], 0.5) for k in keys}
    p99 = {k: quantile([r[k] for r in rows], 0.99) for k in keys}
    tot = max(1e-9, p50["total"])
    return {"traces": len(rows), "p50_ms": p50, "p99_ms": p99,
            "share_p50": {k: p50[k] / tot for k in keys[:-1]}}


def parse_exposition(text: str) -> dict:
    """The Prometheus text exposition as {(name, labels): value}; fails on
    a line that is neither a comment nor a sample, and on a sample whose
    family has no TYPE line."""
    out: dict = {}
    typed: set = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
            continue
        if line.startswith("#") or not line:
            continue
        m = METRIC_LINE.match(line)
        if m is None:
            raise SystemExit(f"metrics exposition: unparsable line {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        family = re.sub(r"_(bucket|count|sum)$", "", name)
        if name not in typed and family not in typed:
            raise SystemExit(f"metrics exposition: {name} has no TYPE line")
        out[(name, labels)] = float(value)
    return out


def metric(parsed: dict, name: str, labels: str = "") -> float:
    return parsed.get((name, labels), 0.0)


def profile_summary(profile: dict) -> dict:
    """A ``WorkerProfiler.snapshot()`` as one line: the worker's wall, the
    attributed fraction, and each phase's total, share and p50 lap."""
    from mcpx_torch.telemetry.flight import PROFILE_PHASES

    ph = profile["phases"]
    return {
        "wall_s": profile["wall_s"], "attributed_frac": profile["attributed_frac"],
        "iterations": profile["iterations"],
        "total_s": {p: ph[p]["total_s"] for p in PROFILE_PHASES},
        "share": {p: ph[p]["share"] for p in PROFILE_PHASES},
        "p50_us": {p: ph[p]["p50_us"] for p in PROFILE_PHASES},
    }


def first_sight(before: dict, after: dict) -> dict:
    """Executable keys seen for the first time between two ``/costs``
    snapshots, by executable."""
    out = {}
    for name, e in after.items():
        n = e["compiles"] - before.get(name, {}).get("compiles", 0)
        if n:
            out[name] = n
    return out


async def settle_profile() -> None:
    """After a profiler's detach, let the worker end the iteration it was
    in: every carve of an iteration is followed by a lap of the same
    iteration, so a snapshot taken then has no carve outside its wall."""
    await asyncio.sleep(0.2)


def sync() -> None:
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def one_cohort(engine, n: int, timeout_s: float = 10.0):
    """Hold the engine's next ``n`` generate requests and enqueue them at
    once, in prompt order, so that a burst forms one admission cohort
    whatever the planner's host timing: the rows that prefill densely or
    from the tree, and the companions each decode window runs with, are then
    the same in every pass of the burst, and so are its greedy plans (at 2b
    random weights leave near-ties that another cohort split flips). A
    request beyond the ``n`` (a planner retry) passes straight through;
    held requests are let through after ``timeout_s`` whatever their
    count. Each held request's ``enqueued_at`` restarts at its release: the
    hold is the harness's, not the engine queue's."""
    q = engine._queue
    real_put, held, lock = q.put, [], threading.Lock()
    state = {"taken": 0, "timer": None}

    def release() -> None:
        with lock:
            state["taken"] = n  # released once: later requests pass through
            items = sorted(held, key=lambda r: r.prompt_ids)
            held.clear()
            if state["timer"] is not None:
                state["timer"].cancel()
        now = time.monotonic()
        with q.not_full:  # all at once: the worker's drain sees every one
            for r in items:
                r.enqueued_at = now
                q._put(r)
                q.unfinished_tasks += 1
            q.not_empty.notify()

    def put(item, *args, **kwargs):
        with lock:
            take = hasattr(item, "prompt_ids") and state["taken"] < n
            if take:
                state["taken"] += 1
                held.append(item)
                if state["timer"] is None:
                    state["timer"] = threading.Timer(timeout_s, release)
                    state["timer"].start()
            full = take and state["taken"] == n
        if not take:
            return real_put(item, *args, **kwargs)
        if full:
            release()

    q.put = put
    try:
        yield
    finally:
        q.put = real_put
        release()


async def traced_burst(cp, intents: list, tracer) -> tuple[list, list]:
    """Each intent through ``ControlPlane.plan`` under a root span of
    ``tracer`` (as the reference bench's traced rounds: the card has no
    aiohttp); returns (plans, trace records) in intent order."""
    from mcpx_torch.telemetry import tracing

    async def one(intent: str):
        root = tracer.start_request("/plan", method="POST")
        err = False
        try:
            with tracing.activate(root):
                plan, _ = await cp.plan(intent, use_cache=False)
            return plan, root.record
        except Exception:
            err = True
            raise
        finally:
            tracer.finish(root, error=err)

    out = await asyncio.gather(*(one(i) for i in intents))
    return [p for p, _ in out], [r for _, r in out]


async def timed_burst(cp, intents: list, telemetry: bool) -> float:
    """p50 ms of one burst from an emptied tree, with a fresh tracer and
    profiler attached (``telemetry``) or both detached."""
    from mcpx_torch.telemetry.flight import WorkerProfiler
    from mcpx_torch.telemetry.tracing import Tracer

    engine = cp.planner.engine
    await idle(engine)
    await engine.drop_unpinned()
    prev = cp.tracer, engine._profiler
    try:
        if telemetry:
            cp.tracer, engine._profiler = Tracer(enabled=True, sample_rate=1.0), WorkerProfiler()
            _, recs = await traced_burst(cp, intents, cp.tracer)
            lat = [r.total_ms for r in recs]
        else:
            cp.tracer, engine._profiler = Tracer(enabled=False), None
            lat = [ms for _, ms in await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))]
    finally:
        cp.tracer, engine._profiler = prev
    return statistics.median(lat)


async def telemetry_phase(cp, intents: list, burst_plans: list, size: str, card: str) -> dict:
    """The burst's intents once more, from an emptied tree and as one
    cohort (``one_cohort``), as the burst ran, with a fresh
    ``Tracer`` (every trace kept) and a ``WorkerProfiler`` attached to the
    live control plane and engine. Fails unless every plan equals the
    burst's, every trace holds the engine's spans, nothing is captured, the
    decode-forward counter moves with ``live_forwards``, the profile's
    phases tile the worker's wall within 5%, the exposition parses, and the
    achieved FLOP/s of the ``/costs`` totals over the phase wall is at or
    below the card's datasheet peak. Prints the latency attribution, the
    planner's time outside the engine, the worker profile, the achieved
    rates, the HBM gauges, and the burst's p50 with telemetry on and off in
    three interleaved pairs (printed only: bursts spread about 60%)."""
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.telemetry.costs import device_peaks, rounded_roofline, update_hbm_gauges
    from mcpx_torch.telemetry.flight import WorkerProfiler
    from mcpx_torch.telemetry.tracing import Tracer

    engine = cp.planner.engine
    await idle(engine)
    await engine.drop_unpinned()
    prev = cp.tracer, engine._profiler
    tracer = Tracer(enabled=True, sample_rate=1.0, ring_size=max(256, len(intents)))
    prof = WorkerProfiler()
    m0 = parse_exposition(cp.metrics.render().decode())
    q0 = engine.queue_stats()
    c0 = engine.costs.snapshot()["totals"]
    sync()
    reset_kernel_launches()
    cp.tracer, engine._profiler = tracer, prof
    try:
        t0 = time.monotonic()
        with one_cohort(engine, len(intents)):
            plans, recs = await traced_burst(cp, intents, tracer)
        await idle(engine)
        sync()
        wall = time.monotonic() - t0
    finally:
        cp.tracer, engine._profiler = prev
    await settle_profile()
    profile = prof.snapshot()
    launches = kernel_launches()
    q1 = engine.queue_stats()
    c1 = engine.costs.snapshot()["totals"]
    update_hbm_gauges(cp.metrics)
    m1 = parse_exposition(cp.metrics.render().decode())
    families = sum(line.startswith("# TYPE ") for line in cp.metrics.render().decode().splitlines())
    peaks = device_peaks()
    flops = c1["flops_executed"] - c0["flops_executed"]
    nbytes = c1["bytes_executed"] - c0["bytes_executed"]
    rates = rounded_roofline(flops, nbytes, wall, peak_flops=peaks["flops_per_chip"],
                             peak_bytes_s=peaks["hbm_bytes_s_per_chip"])
    forwards_metric = (metric(m1, "mcpx_engine_decode_forwards_total")
                       - metric(m0, "mcpx_engine_decode_forwards_total"))
    hbm = {f"{n}{lb}": v for (n, lb), v in m1.items() if n.startswith("mcpx_hbm_bytes")}
    pairs = []
    for on in (True, False, False, True, True, False):
        pairs.append((on, await timed_burst(cp, intents, on)))
    q2 = engine.queue_stats()
    span_names = [sorted({sp.name for sp in r.spans}) for r in recs]
    segments = [sum(sp.name == "engine.segment" for sp in r.spans) for r in recs]
    stats = dict(
        model=size, intents=len(intents), wall_s=wall, plans_per_s=len(intents) / wall,
        launches=launches, **loop_counts(engine, q0, q1, len(intents)),
        decode_forwards_metric=forwards_metric, families=families,
        attribution=attribution(recs),
        worker_profile=profile_summary(profile),
        flops=flops, bytes=nbytes, peaks={k: peaks[k] for k in ("flops_per_chip", "hbm_bytes_s_per_chip")},
        roofline=rates, hbm=hbm, segment_spans=segments,
        p50_ms_on=[ms for on, ms in pairs if on], p50_ms_off=[ms for on, ms in pairs if not on],
        pair_captures=q2["captures"] - q1["captures"],
    )
    emit(f"telemetry_{size}", card, **stats)
    differ = [i for i, (a, b) in enumerate(zip(burst_plans, plans)) if a.to_json() != b.to_json()]
    if differ:
        raise SystemExit(f"telemetry_{size}: plans differ from the burst's at {differ}")
    missing = [i for i, names in enumerate(span_names) if not set(TRACE_SPANS) <= set(names)]
    if missing or min(segments) < 1:
        raise SystemExit(f"telemetry_{size}: incomplete traces at {missing}: {span_names}, segments {segments}")
    no_new_captures(f"telemetry_{size}", q0, q2)
    if forwards_metric != q1["live_forwards"] - q0["live_forwards"]:
        raise SystemExit(f"telemetry_{size}: decode-forward counter {forwards_metric} "
                         f"!= live forwards {q1['live_forwards'] - q0['live_forwards']}")
    if not 0.95 <= profile["attributed_frac"] <= 1.05:
        raise SystemExit(f"telemetry_{size}: the profile does not tile the worker wall: {profile}")
    if families != 71:
        raise SystemExit(f"telemetry_{size}: {families} metric families, expected the reference's 71")
    if peaks["flops_per_chip"] is not None and not rates.get("mfu", 0.0) <= 1.0:
        raise SystemExit(f"telemetry_{size}: achieved FLOP/s above the datasheet peak: {rates}")
    return stats


# ------------------------------------------------------------ observatory
OBS_TENANT = "observatory"
# The observatory's arms and the parts each attaches: ``ledger`` is the
# reference bench's ledger phase (the ledger and the SLO tracker), ``flight``
# its flight phase (the recorder; the worker profiler runs in every arm
# here), ``all`` every part at once.
OBS_ARMS = {
    "off": (),
    "ledger": ("ledger", "slo"),
    "flight": ("flight",),
    "all": ("ledger", "slo", "provenance", "flight"),
}
SLO_OBJECTIVES = ("latency_p99", "availability", "plan_quality")


def kernel_at_pages(engine, width: int, live: int, where: str) -> float:
    """The kernel against its plain version on seeded batches at an
    engine's geometry (its heads, layers, page size and pages a row, its
    window width, ``live`` rows live among the slab's): the largest
    absolute error; fails on a disagreement or a pad that is not an exact
    zero. None off the card (the plain version is the CPU's route)."""
    if engine.device.type != "cuda":
        return None
    from mcpx_torch.engine.kernels.paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_reference,
    )

    mc, ecfg = engine.model_cfg, engine.config.engine
    worst = 0.0
    for seed in range(3):
        q, kp, vp, table, starts, q_lens = mixed_batch(
            seed, ecfg.max_batch_size, width, mc.n_kv_heads, mc.n_heads // mc.n_kv_heads, mc.head_dim,
            mc.n_layers, ecfg.kv_page_size, ecfg.max_pages_per_seq, torch.bfloat16, live,
        )
        for layer in (0, mc.n_layers - 1):
            out = ragged_paged_attention(q, kp, vp, table, starts, q_lens, layer)
            torch.cuda.synchronize()
            ref = ragged_paged_attention_reference(q, kp, vp, table, starts, q_lens, layer)
            err = (out.float() - ref.float()).abs()
            worst = max(worst, float(err.max()))
            if bool((err > ATOL + RTOL * ref.float().abs()).any()):
                raise SystemExit(f"{where}: kernel disagrees with plain version at the phase's pages (max {worst})")
            for b, ql in enumerate(q_lens.tolist()):
                if bool((out[b, ql:] != 0).any()):
                    raise SystemExit(f"{where}: row {b} pads are not exact zeros")
    return worst


def kernel_at_shards(engine, width: int, live: int, where: str) -> dict:
    """``kernel_at_pages`` for a meshed engine: on seeded batches at its
    geometry and dtype (the slab's rows, its window width, its pages; the
    property-test mix and ``live`` live rows), each row block of its layout
    and each attention shard's query heads (``[Bd, S, K', G', hd]``) against
    that shard's ``pool_shards`` views, launched as ``decode_chunk_paged``
    launches them, against the plain version on the same views; and the
    same with ``n_kv_heads`` set to the model axis (GQA, so that a shard's
    pool view starts at an offset). Fails on a disagreement beyond
    ATOL/RTOL, a pad that is not an exact zero, or a pool view that is not
    its shard's leading-dim range. Returns the largest absolute error of
    each model and the views' (KV-head range, byte offset); None off the
    card."""
    if engine.device.type != "cuda":
        return None
    from mcpx_torch.engine.kernels.paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_reference,
    )
    from mcpx_torch.engine.kv_cache import pool_shards
    from mcpx_torch.models.gemma.model import torch_dtype
    from mcpx_torch.parallel.mesh import ServeLayout

    mc, ecfg = engine.model_cfg, engine.config.engine
    B, dtype = ecfg.max_batch_size, torch_dtype(mc.dtype)
    layouts = {"served": engine._layout,
               "gqa": ServeLayout(engine._mesh, dataclasses.replace(mc, n_kv_heads=engine._layout.model))}
    out = {"dtype": mc.dtype, "row_blocks": [list(r) for r in engine._layout.rows(B)]}
    for name, layout in layouts.items():
        K, H = layout.cfg.n_kv_heads, layout.cfg.n_heads
        worst, views = 0.0, []
        for seed, rows in ((0, None if width >= 3 else live), (1, live), (2, live)):
            q, kp, vp, table, starts, q_lens = mixed_batch(
                seed, B, width, K, H // K, mc.head_dim, mc.n_layers, ecfg.kv_page_size,
                ecfg.max_pages_per_seq, dtype, rows,
            )
            heads = q.reshape(B, width, H, mc.head_dim)
            pools = pool_shards({"k": kp, "v": vp}, layout)
            for a, (pk, pv) in zip(layout.attn, pools):
                (h0, h1), (k0, k1) = a.heads, a.kv
                offset = pk.data_ptr() - kp.data_ptr()
                if offset != k0 * kp[0].numel() * kp.element_size() or not pk.is_contiguous():
                    raise SystemExit(f"{where}: {name} shard {a} pool view at byte {offset} is not its heads'")
                if seed == 0:
                    views.append([[k0, k1], offset])
                qs = heads[:, :, h0:h1].reshape(B, width, k1 - k0, a.groups, mc.head_dim).contiguous()
                for r0, r1 in layout.rows(B):
                    args = (qs[r0:r1], pk, pv, table[r0:r1], starts[r0:r1], q_lens[r0:r1])
                    for layer in (0, mc.n_layers - 1):
                        got = ragged_paged_attention(*args, layer)
                        torch.cuda.synchronize()
                        ref = ragged_paged_attention_reference(*args, layer)
                        err = (got.float() - ref.float()).abs()
                        worst = max(worst, float(err.max()))
                        if bool((err > ATOL + RTOL * ref.float().abs()).any()):
                            raise SystemExit(f"{where}: {name} shard {a} rows {r0}:{r1} disagree with the plain "
                                             f"version (max {worst})")
                        for b, ql in enumerate(q_lens[r0:r1].tolist()):
                            if bool((got[b, ql:] != 0).any()):
                                raise SystemExit(f"{where}: {name} shard {a} row {r0 + b} pads are not exact zeros")
        out[name] = {"max_abs_err": worst, "attention_shards": len(layout.attn), "kv_heads": K,
                     "pool_views": views}
    return out


async def observatory_burst(cp, intents: list, tracer, gens: list, bills: list) -> tuple[list, list, list]:
    """Each intent through ``ControlPlane.plan`` under a root span, wrapped
    as the HTTP middleware wraps a request (the card has no aiohttp): a
    ``RequestBill`` activated while a ledger is attached (finalized onto the
    root span and into ``ledger.observe``, appended to ``bills`` in
    completion order), a provenance trail begun and ended, an SLO observe.
    Every engine result lands in ``gens``. Returns (plans, trace records,
    latencies in ms) in intent order."""
    from mcpx_torch.telemetry import ledger as ledger_mod
    from mcpx_torch.telemetry import provenance, tracing

    async def one(intent: str):
        t0 = time.monotonic()
        root = tracer.start_request("/plan", method="POST")
        led, slo = cp.ledger, cp.slo
        bill = token = None
        if led is not None:
            bill = ledger_mod.RequestBill(tenant=OBS_TENANT, endpoint="/plan", t0=t0)
            token = ledger_mod.activate(bill)
        trail = provenance.begin(cp.provenance) if root is not None else None
        err = False
        try:
            with tracing.activate(root):
                eng0 = bill.engine_wall_ms() if bill is not None else 0.0
                plan, latency_ms = await cp.plan(intent, use_cache=False, tenant=OBS_TENANT)
                if bill is not None:
                    bill.note_plan(latency_ms, bill.engine_wall_ms() - eng0)
                    bill.origin = plan.origin or ""
            return plan, root.record
        except Exception:
            err = True
            raise
        finally:
            provenance.end(trail)
            elapsed_ms = (time.monotonic() - t0) * 1e3
            if bill is not None:
                ledger_mod.deactivate(token)
                bill.finalize(status="error" if err else "ok", total_ms=elapsed_ms)
                root.set(bill=bill.to_dict())
                led.observe(bill)
                bills.append(bill)
            if slo is not None:
                slo.observe(tenant=OBS_TENANT, endpoint="/plan", latency_ms=elapsed_ms, error=err)
            tracer.finish(root, error=err)

    engine = cp.planner.engine
    real = engine.generate

    async def counted(*a, **kw):
        res = await real(*a, **kw)
        gens.append(res)
        return res

    engine.generate = counted
    try:
        out = await asyncio.gather(*(one(i) for i in intents))
    finally:
        del engine.generate
    return [p for p, _ in out], [r for _, r in out], [r.total_ms for _, r in out]


async def observatory_phase(cp, intents: list, burst_plans: list, name: str, card: str) -> dict:
    """Telemetry's default-off parts on a live serving control plane (the
    reference bench's ledger and flight phases): the burst's intents from an
    emptied tree and as one cohort, in three interleaved rounds of the
    ``OBS_ARMS``: ``off`` (every part detached), ``ledger`` (the cost ledger
    and the SLO tracker attached live), ``flight`` (a flight recorder
    sampling at 4 Hz into a temporary bundle directory) and ``all`` (those
    and a provenance recorder). Every run has a fresh tracer (every trace
    kept) and a ``WorkerProfiler`` attached, which counts the worker's
    blocking device waits (``sync``). Fails unless every run's plans equal
    the ``off`` runs' and the burst's and its ``sync`` count theirs, and
    unless, on every run with parts on, nothing is captured; with the
    ledger, the bills' FLOPs and bytes folded with ``+=`` in completion
    order equal the ``ledger_totals()`` delta and the ``/costs``
    executed-totals delta exactly, each engine bill's ``decode_tokens``
    equals its result's ``generated_tokens``, and the bills' accepted
    speculative tokens equal the engine's ``accepted`` delta on the
    speculative plane (0 on the homogeneous one, whose prompt drafts are no
    speculation); with provenance, every trace's explanation is valid and
    not empty; and unless the flight recorder sampled, a bundle captured
    from a synthetic trip is valid, ``/usage`` and ``/slo``
    (``ledger.snapshot()``, ``slo.status()``) name the tenant and the
    objectives, and the kernel launched and matches its plain version at
    the engine's pages. Prints ``ledger_overhead_frac`` and
    ``flight_overhead_frac`` (1 - plans/s of that arm over ``off``, as the
    reference bench reports them) and ``all_overhead_frac``, best of three
    each, and p50 by arm."""
    import shutil
    import tempfile

    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.telemetry.flight import WorkerProfiler, build_flight_recorder, validate_bundle
    from mcpx_torch.telemetry.ledger import UsageLedger
    from mcpx_torch.telemetry.provenance import ProvenanceRecorder, build_explanation, validate_explanation
    from mcpx_torch.telemetry.slo import SLOTracker
    from mcpx_torch.telemetry.tracing import Tracer

    engine = cp.planner.engine
    tcfg = cp.config.telemetry
    fcfg = tcfg.flight
    saved = (cp.tracer, cp.ledger, cp.slo, cp.flight, cp.provenance, engine._profiler, tcfg.ledger.enabled,
             fcfg.enabled, fcfg.interval_s, fcfg.bundle_dir)
    usage = UsageLedger(tcfg.ledger, metrics=cp.metrics)
    slo = SLOTracker(cp.config.slo)
    recorder = ProvenanceRecorder(tcfg.provenance, metrics=cp.metrics)
    bundle_dir = tempfile.mkdtemp(prefix="mcpx-torch-flight-")
    runs: dict = {arm: [] for arm in OBS_ARMS}
    flight = None
    await idle(engine)
    q_start = engine.queue_stats()
    sync()
    reset_kernel_launches()
    try:
        for arm in list(OBS_ARMS) * 3:
            await idle(engine)
            await engine.drop_unpinned()
            parts = OBS_ARMS[arm]
            cp.ledger = usage if "ledger" in parts else None
            cp.slo = slo if "slo" in parts else None
            cp.provenance = recorder if "provenance" in parts else None
            tcfg.ledger.enabled = "ledger" in parts
            task = None
            if "flight" in parts:
                fcfg.enabled, fcfg.interval_s, fcfg.bundle_dir = True, 0.25, bundle_dir
                flight = cp.flight = build_flight_recorder(cp)
                task = asyncio.create_task(flight.run())
            else:
                cp.flight = None
            cp.tracer = tracer = Tracer(enabled=True, sample_rate=1.0, ring_size=max(256, len(intents)))
            engine._profiler = prof = WorkerProfiler()
            gens, bills = [], []
            q0, c0, lt0 = engine.queue_stats(), engine.costs.snapshot()["totals"], engine.ledger_totals()
            t0 = time.monotonic()
            try:
                with one_cohort(engine, len(intents)):
                    plans, recs, lat = await observatory_burst(cp, intents, tracer, gens, bills)
                await idle(engine)
                sync()
                wall = time.monotonic() - t0
            finally:
                engine._profiler = None
                if task is not None:
                    task.cancel()
                    with contextlib.suppress(asyncio.CancelledError):
                        await task
            await settle_profile()
            q1, c1, lt1 = engine.queue_stats(), engine.costs.snapshot()["totals"], engine.ledger_totals()
            flops = nbytes = 0.0
            for b in bills:  # completion order
                flops += b.flops
                nbytes += b.hbm_bytes
            runs[arm].append(dict(
                plans=[p.to_json() for p in plans], wall_s=wall, plans_per_s=len(intents) / wall,
                p50_ms=statistics.median(lat), captures=q1["captures"] - q0["captures"],
                sync_waits=prof.snapshot()["phases"]["sync"]["count"],
                bills=(flops, nbytes), ledger_totals=(lt1["flops"] - lt0["flops"], lt1["bytes"] - lt0["bytes"]),
                costs=(c1["flops_executed"] - c0["flops_executed"], c1["bytes_executed"] - c0["bytes_executed"]),
                engine_bills=[(r.generated_tokens, r.bill) for r in gens],
                request_bills=len(bills), spec_accepted=sum(b.spec_accepted_tokens for b in bills),
                accepted=q1["accepted"] - q0["accepted"],
                explanations=[validate_explanation(build_explanation(r)) for r in recs],
                decisions=sum(len(build_explanation(r)["decisions"]) for r in recs),
            ))
        launches = kernel_launches()
        q_end = engine.queue_stats()
        samples = flight.samples if flight is not None else 0
        if flight is not None:
            await flight.tick()
            samples = flight.samples
            trip = {"detector": "synthetic", "signal": "request_p99_ms", "direction": "high",
                    "value": 1e9, "mean": 0.0, "band": 1.0}
            bundle = await flight.load_bundle(await flight.capture_bundle(trip))
            bundle_problems = validate_bundle(bundle)
        else:
            bundle_problems = ["no flight recorder"]
        usage_body, slo_body = usage.snapshot(), slo.status()
    finally:
        (cp.tracer, cp.ledger, cp.slo, cp.flight, cp.provenance, engine._profiler, tcfg.ledger.enabled,
         fcfg.enabled, fcfg.interval_s, fcfg.bundle_dir) = saved
        shutil.rmtree(bundle_dir, ignore_errors=True)
    width = engine._spec_k() + 1 if engine.config.engine.hetero_batch else engine._spec_chunk(True)
    max_abs_err = kernel_at_pages(engine, width, len(intents), f"observatory_{name}")
    best = {arm: max(r["plans_per_s"] for r in runs[arm]) for arm in OBS_ARMS}
    on_runs = [r for arm in OBS_ARMS if arm != "off" for r in runs[arm]]
    billed = [r for arm in OBS_ARMS if "ledger" in OBS_ARMS[arm] for r in runs[arm]]
    objectives = [o["name"] for o in slo_body["global"]["objectives"]]
    stats = dict(
        model=name, intents=len(intents), launches=launches,
        **loop_counts(engine, q_start, q_end, 3 * len(OBS_ARMS) * len(intents)),
        ledger_overhead_frac=1.0 - best["ledger"] / best["off"],
        flight_overhead_frac=1.0 - best["flight"] / best["off"],
        all_overhead_frac=1.0 - best["all"] / best["off"],
        plans_per_s={arm: [r["plans_per_s"] for r in runs[arm]] for arm in OBS_ARMS},
        p50_ms={arm: [r["p50_ms"] for r in runs[arm]] for arm in OBS_ARMS},
        sync_waits={arm: [r["sync_waits"] for r in runs[arm]] for arm in OBS_ARMS},
        captures_on=[r["captures"] for r in on_runs],
        conservation=[dict(bills=r["bills"], ledger_totals=r["ledger_totals"], costs=r["costs"]) for r in billed],
        spec_accepted=[(r["spec_accepted"], r["accepted"]) for r in billed],
        decisions=[r["decisions"] for r in runs["all"]], flight_samples=samples,
        usage_tenants=sorted(usage_body["tenants"]), usage_requests=usage_body["requests"],
        slo_objectives=objectives, slo_tenants=sorted(slo_body["tenants"]),
        max_abs_err=max_abs_err, atol=ATOL, rtol=RTOL,
    )
    emit(f"observatory_{name}", card, **stats)
    want = [p.to_json() for p in burst_plans]
    off_plans = runs["off"][0]["plans"]
    spec_plane = engine.config.engine.hetero_batch and engine._spec_k() > 0
    sync_off = runs["off"][0]["sync_waits"]
    for arm in OBS_ARMS:
        for k, r in enumerate(runs[arm]):
            where = f"observatory_{name} {arm} run {k}"
            if r["plans"] != off_plans or r["plans"] != want:
                raise SystemExit(f"{where}: plans differ from the parts-off run's or the burst's")
            if r["sync_waits"] != sync_off:
                raise SystemExit(f"{where}: {r['sync_waits']} sync waits, {sync_off} with the parts off")
            parts = OBS_ARMS[arm]
            if parts and r["captures"]:
                raise SystemExit(f"{where}: {r['captures']} windows captured with the parts on")
            if "provenance" in parts and (any(r["explanations"]) or r["decisions"] <= 0):
                raise SystemExit(f"{where}: explanations invalid or empty: {r['explanations']}")
            if "ledger" not in parts:
                continue
            if not (r["bills"] == r["ledger_totals"] == r["costs"]) or r["bills"][0] <= 0:
                raise SystemExit(f"{where}: bills {r['bills']} != ledger_totals delta {r['ledger_totals']} "
                                 f"!= /costs executed delta {r['costs']}")
            if r["request_bills"] != len(intents) or any(
                b is None or b["decode_tokens"] != n for n, b in r["engine_bills"]
            ):
                raise SystemExit(f"{where}: a bill's decode tokens differ from its result's: {r['engine_bills']}")
            # The speculative plane's accepted tokens are all on bills; the
            # homogeneous plane's prompt drafts are no speculative tokens
            # (the reference bills only its verify segments').
            if r["spec_accepted"] != (r["accepted"] if spec_plane else 0):
                raise SystemExit(f"{where}: bills accepted {r['spec_accepted']} speculative tokens, "
                                 f"the engine {r['accepted']} (speculative plane: {spec_plane})")
    if samples < 1 or bundle_problems:
        raise SystemExit(f"observatory_{name}: flight samples {samples}, bundle problems {bundle_problems}")
    if OBS_TENANT not in usage_body["tenants"] or OBS_TENANT not in slo_body["tenants"] or (
        tuple(objectives) != SLO_OBJECTIVES
    ):
        raise SystemExit(f"observatory_{name}: /usage or /slo misses the tenant or the objectives")
    if launches.get("ragged_paged_attention", 0) <= 0 and engine.device.type == "cuda":
        raise SystemExit(f"observatory_{name}: the ragged kernel was not launched")
    return stats


# ------------------------------------------------------------ execute path
# ------------------------------------------------------------ heterogeneous slab and speculation
HOT = 0.7  # the reference bench's sampled temperature


def stream_classes(tok, prefix: str, spec: bool) -> list:
    """The reference bench's five request classes (constrained, temperature,
    grammar), with its second grammar over three ``prefix`` services:
    ``_mixed_phase``'s order, or ``_spec_phase``'s with ``spec``."""
    from mcpx_torch.planner.grammar import build_plan_grammar

    alt = build_plan_grammar(tok, [f"{prefix}-rank-svc", f"{prefix}-sum-svc", f"{prefix}-etl-svc"])
    if spec:
        return [(True, 0.0, None), (True, 0.0, alt), (False, 0.0, None), (True, HOT, None), (False, HOT, None)]
    return [(True, 0.0, None), (False, HOT, None), (True, 0.0, alt), (True, HOT, None), (False, 0.0, None)]


async def serve_stream(engine, classes: list, prefix: str, ids, budget: int, concurrency: int) -> dict:
    """Direct ``engine.generate`` calls, request i of class ``i % 5`` with
    the prompt ``"<prefix> intent i: compose the services. JSON:"``, at most
    ``concurrency`` in flight; returns {i: (prompt, kwargs, result)}."""
    tok = engine.tokenizer
    sem = asyncio.Semaphore(concurrency)
    out: dict = {}

    async def one(i: int) -> None:
        constrained, temperature, grammar = classes[i % len(classes)]
        kw = dict(max_new_tokens=budget, constrained=constrained, temperature=temperature, grammar=grammar)
        prompt = tok.encode(f"{prefix} intent {i}: compose the services. JSON:")
        async with sem:
            out[i] = (prompt, kw, await engine.generate(prompt, **kw))

    await asyncio.gather(*(one(i) for i in ids))
    return out


def check_walks(where: str, engine, served: dict) -> None:
    """Every constrained output is a legal prefix of its grammar."""
    for i, (_, kw, res) in served.items():
        g = kw["grammar"] or engine.grammar
        if kw["constrained"] and g.walk(res.text) == g.dead_state:
            raise SystemExit(f"{where}: request {i} left its grammar: {res.text!r}")


def greedy_differences(where: str, size: str, card: str, engine, a: dict, b: dict) -> list:
    """The greedy requests whose token streams differ between two runs of a
    stream: at test a failure; at 2b each is printed with the top-2 margin
    of the masked logits at its first differing token (a ``near_tie``
    line). Returns the margins."""
    margins = []
    for i, (prompt, kw, res) in a.items():
        if kw["temperature"] > 0.0 or res.token_ids == b[i][2].token_ids:
            continue
        if size == "test":
            raise SystemExit(f"{where}: greedy request {i} differs: {res.text!r} against {b[i][2].text!r}")
        toks, other = res.token_ids, b[i][2].token_ids
        k = next((j for j, (x, y) in enumerate(zip(toks, other)) if x != y), min(len(toks), len(other)))
        margin = masked_margin(engine, prompt, kw, toks, k)
        emit(f"near_tie_{size}", card, phase_of=where, request=i, position=k, margin=margin,
             constrained=kw["constrained"], a=res.text, b=b[i][2].text)
        margins.append(margin)
    return margins


async def mixed_phase(cp, size: str, card: str, n: int = 96) -> dict:
    """The reference bench's ``_mixed_phase`` on the serving engine: the five
    classes round-robin by direct ``engine.generate`` calls, budget
    ``max(8, min(24, max_decode_len))``, ``n`` requests at concurrency
    ``min(2 B, 64)``, once with ``hetero_batch`` off (the homogeneous slab,
    which drains to switch configuration) and once on (live flips on an idle
    slab), each after an untimed warm round of the same classes. Prints each
    mode's plans/s, ``hol_wait`` p50/p99 (the admission waits the histogram
    observes), windows captured and kernel launches. Fails unless the timed
    run captures nothing, every constrained output walks its grammar and,
    at test, the greedy rows are the same token for token in both modes
    (at 2b each difference is printed with its top-2 margin)."""
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches

    engine = cp.planner.engine
    ecfg = engine.config.engine
    classes = stream_classes(engine.tokenizer, "mixed", spec=False)
    budget = max(8, min(24, ecfg.max_decode_len))
    concurrency = min(2 * ecfg.max_batch_size, 64)
    saved = ecfg.hetero_batch
    runs = {}
    try:
        for hetero in (False, True):
            await idle(engine)
            ecfg.hetero_batch = hetero
            await serve_stream(engine, classes, "mixed", range(max(len(classes), concurrency)), budget, concurrency)
            await idle(engine)
            q0 = engine.queue_stats()
            sync()
            reset_kernel_launches()
            t0 = time.monotonic()
            served = await serve_stream(engine, classes, "mixed", range(n), budget, concurrency)
            wall = time.monotonic() - t0
            launches = kernel_launches()
            q1 = engine.queue_stats()
            hol = [res.queue_ms for _, _, res in served.values()]
            stats = dict(
                model=size, hetero_batch=hetero, requests=n, concurrency=concurrency, budget=budget,
                wall_s=wall, plans_per_s=n / wall, hol_wait_p50_ms=quantile(hol, 0.5),
                hol_wait_p99_ms=quantile(hol, 0.99), launches=launches, **loop_counts(engine, q0, q1, n),
            )
            emit(f"mixed_{size}", card, **stats)
            no_new_captures(f"mixed_{size} hetero_batch={hetero}", q0, q1)
            check_walks(f"mixed_{size}", engine, served)
            runs[hetero] = (stats, served)
    finally:
        await idle(engine)
        ecfg.hetero_batch = saved
    margins = greedy_differences(f"mixed_{size}", size, card, engine, runs[True][1], runs[False][1])
    emit(f"mixed_{size}_parity", card, greedy_requests=sum(c[1] <= 0 for c in classes) * n // len(classes),
         differing=len(margins), margins=margins)
    return {"drain": runs[False][0], "hetero": runs[True][0], "differing": len(margins)}


def spec_counts(engine) -> dict:
    """The speculative counters of the engine's metrics, by row class."""
    m = engine.metrics
    return {
        f"{kind}_{cls}": getattr(m, f"spec_{kind}").labels(cls=cls).value
        for kind in ("drafted", "accepted") for cls in ("constrained", "free")
    }


async def spec_phase(
    size: str, checkpoint: str, card: str, n: int, rounds: int = 3, batch: int = 64, device=None
) -> dict:
    """The reference bench's ``_spec_phase`` on a dedicated engine
    (heterogeneous slab, batch 64, ``admit_min_free=1``,
    ``admit_max_wait_s=0``): *off* is ``speculative.enabled=false`` with
    ``speculate_k=1`` (one token a forward), *on* is k 4 with the recurrent
    drafter. The five classes of that phase, budget
    ``max(8, min(48, max_decode_len))``; ``n`` requests in ``rounds``
    interleaved rounds (off, on), each mode warmed by an untimed round of
    its own first. Prints each mode's tokens per live forward, decode
    tokens/s (its best round) and wall; for *on* the accept rate overall
    and by class (from the metrics series), the verify windows and the
    kernel launches. Fails unless the timed rounds capture nothing, the
    verify path ran, ``mcpx_engine_spec_drafted_total`` equals
    ``queue_stats()["drafted"]``, every constrained output walks its
    grammar and, at test, the greedy rows are the same in both modes (at
    2b each difference is printed with its top-2 margin). ``batch`` and
    ``device`` shrink it for a CPU rehearsal."""
    from mcpx_torch.engine.engine import InferenceEngine
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches

    cfg = config(size, checkpoint, batch)
    e = cfg.engine
    e.hetero_batch, e.warmup_compile, e.admit_min_free, e.admit_max_wait_s = True, False, 1, 0.0
    e.speculative.k, e.speculative.draft = 4, "recurrent"
    engine = InferenceEngine(cfg, device=device)  # device=None: the card
    await engine.start()
    try:
        classes = stream_classes(engine.tokenizer, "spec", spec=True)
        budget = max(8, min(48, e.max_decode_len))
        chunk_n = max(1, n // rounds)
        concurrency = min(2 * e.max_batch_size, 64, chunk_n)
        speculate_k = e.speculate_k
        acc = {m: {"rounds": [], "served": {}, "launches": 0, "wall_s": 0.0, "q": None, "spec0": None}
               for m in (False, True)}
        warmed = set()
        for r in range(rounds):
            for on in (False, True):
                await idle(engine)
                e.speculative.enabled, e.speculate_k = on, speculate_k if on else 1
                if on not in warmed:
                    await serve_stream(engine, classes, "spec", range(10**6, 10**6 + max(5, concurrency)),
                                       budget, concurrency)
                    await idle(engine)
                    warmed.add(on)
                a = acc[on]
                q0, s0 = engine.queue_stats(), spec_counts(engine)
                sync()
                reset_kernel_launches()
                t0 = time.monotonic()
                a["served"].update(await serve_stream(
                    engine, classes, "spec", range(r * chunk_n, (r + 1) * chunk_n), budget, concurrency
                ))
                wall = time.monotonic() - t0
                a["launches"] += kernel_launches()["ragged_paged_attention"]
                q1, s1 = engine.queue_stats(), spec_counts(engine)
                d = loop_counts(engine, q0, q1, chunk_n)
                d["spec_verify"] = q1["spec_verify"] - q0["spec_verify"]
                d.update({k: s1[k] - s0[k] for k in s1})
                d["wall_s"], d["decode_tok_s"] = wall, d["decode_tokens"] / wall
                a["rounds"].append(d)
                no_new_captures(f"spec_{size} round {r} on={on}", q0, q1)
        lines = {}
        for on in (False, True):
            a = acc[on]
            tot = {k: sum(rd[k] for rd in a["rounds"]) for k in (
                "decode_tokens", "live_forwards", "wall_s", "captures", "replays", "replay_launches",
                "spec_verify", "drafted_constrained", "drafted_free", "accepted_constrained", "accepted_free",
            )}
            stats = dict(
                model=size, speculative=on, k=4 if on else 0, speculate_k=speculate_k if on else 1,
                requests=chunk_n * rounds, rounds=rounds, concurrency=concurrency, budget=budget,
                tokens_per_live_forward=tot["decode_tokens"] / max(1, tot["live_forwards"]),
                decode_tok_s=max(rd["decode_tok_s"] for rd in a["rounds"]), wall_s=tot["wall_s"],
                live_forwards=tot["live_forwards"], decode_tokens=tot["decode_tokens"],
                captures=tot["captures"], replays=tot["replays"], replay_launches=tot["replay_launches"],
                spec_verify=tot["spec_verify"], launches={"ragged_paged_attention": a["launches"]},
            )
            if on:
                dr = {c: tot[f"drafted_{c}"] for c in ("constrained", "free")}
                ac = {c: tot[f"accepted_{c}"] for c in ("constrained", "free")}
                stats.update(
                    drafted=sum(dr.values()), accepted=sum(ac.values()),
                    accept_rate=sum(ac.values()) / max(1, sum(dr.values())),
                    accept_rate_constrained=ac["constrained"] / max(1, dr["constrained"]),
                    accept_rate_free=ac["free"] / max(1, dr["free"]),
                )
            emit(f"spec_{size}", card, **stats)
            check_walks(f"spec_{size}", engine, a["served"])
            lines[on] = stats
        q = engine.queue_stats()
        drafted_metric = sum(spec_counts(engine)[f"drafted_{c}"] for c in ("constrained", "free"))
        if lines[True]["spec_verify"] <= 0 or drafted_metric != q["drafted"]:
            raise SystemExit(f"spec_{size}: verify windows {lines[True]['spec_verify']}, "
                             f"drafted metric {drafted_metric} against queue_stats {q['drafted']}")
        margins = greedy_differences(f"spec_{size}", size, card, engine, acc[True]["served"], acc[False]["served"])
        emit(f"spec_{size}_parity", card, differing=len(margins), margins=margins,
             tokens_per_live_forward_ratio=lines[True]["tokens_per_live_forward"]
             / lines[False]["tokens_per_live_forward"])
        return {"off": lines[False], "on": lines[True], "differing": len(margins)}
    finally:
        await engine.aclose()


async def serve_hetero(
    size: str, checkpoint: str, n_intents: int, card: str, ref_plans: list, batch: int = 64, device=None,
    after=None,
) -> tuple[dict, object]:
    """One ``/plan`` burst through ``ControlPlane.plan`` on a control plane
    with ``hetero_batch`` and speculation (k 4) on: ``serve``'s intents, from
    an emptied tree and as one cohort, as ``serve`` sends them. Fails unless
    every plan is LLM-authored and equal to ``ref_plans`` and the verify
    path ran; then ``after(cp, intents, plans)`` on the same control plane
    when given. Returns (stats, what ``after`` returned). ``batch`` and
    ``device`` shrink it for a CPU rehearsal."""
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    cfg = config(size, checkpoint, batch)
    cfg.engine.hetero_batch = True
    cfg.engine.speculative.enabled, cfg.engine.speculative.k = True, 4
    cp = build_control_plane(cfg, device=device)  # device=None: the card
    records = synth_registry(1000, seed=0)
    for rec in records:
        await cp.registry.put(rec)
    try:
        await cp.startup()
        rng = random.Random(0)
        intents = [intent_for(records, rng) for _ in range(n_intents)]
        engine = cp.planner.engine
        await engine.drop_unpinned()
        q0 = engine.queue_stats()
        sync()
        reset_kernel_launches()
        t0 = time.monotonic()
        with one_cohort(engine, n_intents):
            results = await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
        wall = time.monotonic() - t0
        launches = kernel_launches()
        q1 = engine.queue_stats()
        plans = [p for p, _ in results]
        for p in plans:
            p.validate()
        differ = [i for i, (a, b) in enumerate(zip(plans, ref_plans)) if a.to_json() != b.to_json()]
        lat = sorted(ms for _, ms in results)
        stats = dict(
            model=size, intents=n_intents, wall_s=wall, plans_per_s=n_intents / wall, p50_ms=lat[len(lat) // 2],
            origins={o: sum(p.origin == o for p in plans) for o in {p.origin for p in plans}},
            differing_from_serve=differ, warmup_captures=q0["warmup_captures"],
            spec_verify=q1["spec_verify"] - q0["spec_verify"], launches=launches,
            accept_rate=q1["spec_accept_rate"], capture_counts=engine.capture_counts(),
            **loop_counts(engine, q0, q1, n_intents),
        )
        emit(f"serve_hetero_{size}", card, **stats)
        if differ or stats["origins"] != {"llm": n_intents} or stats["spec_verify"] <= 0:
            raise SystemExit(f"serve_hetero_{size}: plans differ at {differ}, origins {stats['origins']}, "
                             f"verify windows {stats['spec_verify']}")
        extra = await after(cp, intents, plans) if after is not None else None
        return stats, extra
    finally:
        await cp.aclose()


# ------------------------------------------------------------ int8 weights
async def int8_phase(
    size: str, checkpoint: str, n_intents: int, card: str, bf16: dict, batch: int = 64, device=None,
    after=None,
) -> dict:
    """``serve``'s first burst on a control plane with ``model.quantize=
    "int8"`` at the same settings and full width: from an emptied tree and
    as one cohort, then the burst once more, which must capture nothing,
    with ``graph_window`` on the card (eager against replay from one
    snapshot). ``bf16`` is ``serve``'s stats of the same configuration with
    its ``plans``. Prints the weights' bytes int8 against bf16 and
    ``quantized_param_bytes`` of the test, 2b and 7b presets; p50, plans/s,
    live forwards, llm share and how many plans equal the bf16 burst's; peak
    memory of both bursts; device ms a window and a forward by replay, int8
    against bf16 (each from its own engine's ``graph_window``). Then, on the
    same control plane, ``after(cp)`` when given. ``batch`` and ``device``
    shrink it for a CPU rehearsal."""
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.models.gemma.params import n_bytes
    from mcpx_torch.models.gemma.quant import is_quantized, quantized_param_bytes
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    t_phase = time.monotonic()
    cfg = config(size, checkpoint, batch)
    cfg.model.quantize = "int8"
    cuda = torch.cuda.is_available() and device is None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    cp = build_control_plane(cfg, device=device)  # device=None: the card
    records = synth_registry(1000, seed=0)
    for rec in records:
        await cp.registry.put(rec)
    try:
        t0 = time.monotonic()
        await cp.startup()
        startup_s = time.monotonic() - t0
        engine = cp.planner.engine
        if not is_quantized(engine._params):
            raise SystemExit(f"int8_{size}: the engine's weights are not int8")
        rng = random.Random(0)
        intents = [intent_for(records, rng) for _ in range(n_intents)]
        await engine.drop_unpinned()
        q0 = engine.queue_stats()
        resident = torch.cuda.memory_allocated() if cuda else None
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sync()
        reset_kernel_launches()
        t0 = time.monotonic()
        with one_cohort(engine, n_intents):
            results = await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
        sync()
        wall = time.monotonic() - t0
        launches = kernel_launches()
        q1 = engine.queue_stats()
        plans = [p for p, _ in results]
        for p in plans:
            p.validate()
        same = [a.to_json() == b.to_json() for a, b in zip(plans, bf16["plans"])]
        lat = sorted(ms for _, ms in results)
        vocab = engine.tokenizer.vocab_size
        stats = dict(
            model=size, quantize="int8", intents=n_intents, wall_s=wall, plans_per_s=n_intents / wall,
            p50_ms=lat[len(lat) // 2], startup_s=startup_s,
            origins={o: sum(p.origin == o for p in plans) for o in {p.origin for p in plans}},
            llm_share=sum(p.origin == "llm" for p in plans) / n_intents,
            same_plans_as_bf16=sum(same), differing_from_bf16=[i for i, ok in enumerate(same) if not ok],
            weight_bytes={"int8": n_bytes(engine._params), "bf16": bf16["weight_bytes"]},
            quantized_param_bytes={
                s: quantized_param_bytes(GemmaConfig.named(s, vocab_size=vocab)) for s in ("test", "2b", "7b")
            },
            max_memory_allocated={"int8": torch.cuda.max_memory_allocated() if cuda else None,
                                  "bf16": bf16["max_memory_allocated"]},
            allocated_at_burst_start=resident, warmup_captures=q0["warmup_captures"],
            startup_captures=q0["captures"], capture_counts=engine.capture_counts(), launches=launches,
            **loop_counts(engine, q0, q1, n_intents),
        )
        emit(f"int8_{size}", card, **stats)
        if cuda:
            routes = await repeat_with_graph_window(cp, intents, f"int8_{size}", card)
            bf = bf16["graph_window"]
            stats["window"] = dict(
                int8_device_ms_replay=routes["device_ms_replay"], bf16_device_ms_replay=bf["device_ms_replay"],
                int8_device_ms_a_forward=routes["device_ms_replay"] / routes["forwards"],
                bf16_device_ms_a_forward=bf["device_ms_replay"] / bf["forwards"],
                int8_over_bf16=routes["device_ms_replay"] / bf["device_ms_replay"],
                int8_key=routes["key"], bf16_key=bf["key"], int8_live_rows=routes["live_rows"],
                bf16_live_rows=bf["live_rows"],
            )
        else:
            q2 = engine.queue_stats()
            await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
            no_new_captures(f"int8_{size} repeat", q2, engine.queue_stats())
            stats["window"] = None
        stats["after"] = await after(cp) if after is not None else None
        stats["seconds"] = time.monotonic() - t_phase
        emit(f"int8_{size}_window", card, window=stats["window"], seconds=stats["seconds"])
        return stats
    finally:
        await cp.aclose()


# ------------------------------------------------------------ overload
async def overload_phase(cp, records, size: str, card: str, plans_per_s: float, n: int) -> dict:
    """The reference bench's overload scenario (``bench.py::_overload_phase``)
    on a live serving control plane: an admission ``Scheduler`` attached as
    ``cp.scheduler`` with the bench's ``SchedulerConfig`` (a 1000 ms SLO and
    deadline, the ladder engaging at a quarter of it), ``n`` unique intents
    offered open loop at four times ``plans_per_s`` (the width's own
    burst). Each request runs as the ``/plan`` handler runs it: acquire,
    ``plan(degraded=, deadline_at=, tenant=)``, release; a ``ShedError`` is
    a 429. Fails unless every request is admitted, degraded or shed with no
    error, the overload engaged (some shed or degraded), no degraded plan
    sits in the plan cache, and no pin or queued request is left."""
    from mcpx_torch.core.config import SchedulerConfig
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.scheduler import Scheduler, ShedError
    from mcpx_torch.utils.synth import intent_for

    t_phase = time.monotonic()
    slo_ms = 1000.0
    rate = max(1.0, plans_per_s * 4)
    scfg = SchedulerConfig(
        enabled=True, slo_ms=slo_ms, default_deadline_ms=slo_ms,
        max_parallel=max(4, cp.config.engine.max_batch_size // 8), max_queue_depth=max(64, int(rate)),
        degrade_threshold=0.25, recover_threshold=0.1, degrade_min_hold_s=0.5, ewma_alpha=0.5,
    )
    engine = cp.planner.engine
    sched = Scheduler(scfg, cp.metrics, engine_stats=engine.queue_stats)
    prev_scfg = cp.config.scheduler
    cp.scheduler, cp.config.scheduler = sched, scfg
    rng = random.Random(5)
    intents = [f"{intent_for(records, rng)} [ovl{i}]" for i in range(n)]
    outcomes = {"admitted": 0, "degraded": 0, "shed": 0, "error": 0}
    lat: dict = {"admitted": [], "degraded": []}
    degraded_intents: set = set()
    errors: list = []

    async def one(intent: str, delay: float) -> None:
        await asyncio.sleep(delay)
        t0 = time.monotonic()
        s = cp.scheduler
        try:
            try:
                slot = await s.acquire(s.context_from_headers({}))
            except ShedError:
                outcomes["shed"] += 1
                return
            try:
                plan, _ = await cp.plan(intent, degraded=slot.degraded, deadline_at=slot.ctx.deadline_at,
                                        tenant=slot.ctx.tenant)
            finally:
                s.release(slot)
            plan.validate()
        except Exception as e:  # counted and printed: the gate refuses any
            outcomes["error"] += 1
            errors.append(repr(e)[:200])
            return
        tier = "degraded" if slot.degraded else "admitted"
        outcomes[tier] += 1
        lat[tier].append((time.monotonic() - t0) * 1e3)
        if slot.degraded:
            degraded_intents.add(intent)

    q0 = engine.queue_stats()
    sync()
    reset_kernel_launches()
    try:
        await asyncio.gather(*(one(x, i / rate) for i, x in enumerate(intents)))
    finally:
        cp.scheduler, cp.config.scheduler = None, prev_scfg
    sync()
    launches = kernel_launches()
    await idle(engine)
    q1 = engine.queue_stats()
    served = sorted(lat["admitted"] + lat["degraded"])

    def p50(xs):
        return statistics.median(xs) if xs else None

    cached_degraded = sum(1 for intent, _ in cp._plan_cache if intent in degraded_intents)
    stats = dict(
        model=size, requests=n, offered_rate=rate, factor=4.0, slo_ms=slo_ms, **outcomes,
        shed_rate=outcomes["shed"] / n,
        degraded_share=outcomes["degraded"] / max(1, outcomes["admitted"] + outcomes["degraded"]),
        served_p50_ms=p50(served), served_p99_ms=served[int(0.99 * (len(served) - 1))] if served else None,
        primary_p50_ms=p50(lat["admitted"]), degraded_p50_ms=p50(lat["degraded"]),
        degraded_plans_cached=cached_degraded, pins_left=q1["prefix_pins"],
        scheduler_queue_left=sched._queue.depth(), scheduler_inflight_left=sched._inflight,
        launches=launches, errors_seen=errors[:3], seconds=time.monotonic() - t_phase,
        **loop_counts(engine, q0, q1, max(1, outcomes["admitted"])),
    )
    emit(f"overload_{size}", card, **stats)
    if outcomes["admitted"] + outcomes["degraded"] + outcomes["shed"] != n or outcomes["error"]:
        raise SystemExit(f"overload_{size}: requests unaccounted for or failed: {outcomes} {errors[:3]}")
    if outcomes["shed"] + outcomes["degraded"] <= 0:
        raise SystemExit(f"overload_{size}: the overload never engaged: {outcomes}")
    if cached_degraded or q1["prefix_pins"] or sched._queue.depth() or sched._inflight:
        raise SystemExit(f"overload_{size}: {cached_degraded} degraded plans cached, {q1['prefix_pins']} pins, "
                         f"{sched._queue.depth()} queued and {sched._inflight} in flight left")
    return stats


# ------------------------------------------------------------ chaos
CHAOS_PROFILE = {
    # The reference bench's chaos profile (``bench.py::_chaos_phase``): the
    # primaries badly degraded (one flapping hard-down on a cycle, both
    # erroring and timing out), the fallbacks nearly healthy.
    "seed": 1234,
    "endpoints": {
        "local://chaos-a": {"error_rate": 0.2, "timeout_rate": 0.55, "latency_ms": 5, "flap_period_s": 4.0,
                            "flap_down_s": 2.0},
        "local://chaos-b": {"error_rate": 0.2, "timeout_rate": 0.5, "latency_ms": 5},
        "local://chaos-*-fb": {"error_rate": 0.05, "latency_ms": 10},
    },
}
CHAOS_GRAPH = {
    "nodes": [
        {"name": "a", "service": "chaos-a", "endpoint": "local://chaos-a", "retries": 2, "timeout_s": 0.15,
         "fallbacks": ["local://chaos-a-fb"]},
        {"name": "b", "service": "chaos-b", "endpoint": "local://chaos-b", "retries": 2, "timeout_s": 0.15,
         "fallbacks": ["local://chaos-b-fb"], "inputs": {"x": "a"}},
    ],
    "edges": [{"src": "a", "dst": "b"}],
}


async def chaos_phase(cp, size: str, card: str, n: int = 160, deadline_ms: float = 400.0) -> dict:
    """The reference bench's chaos scenario (``bench.py::_chaos_phase``) on a
    live control plane: in-process tools behind a seeded ``ChaosTransport``
    (``CHAOS_PROFILE``), ``n`` executions of ``CHAOS_GRAPH``, 16 at a time,
    each with a ``deadline_ms`` deadline, first with resilience off, then on
    (the default ``ResilienceConfig``: breakers, budgets, hedges), each
    round on a fresh transport from the same seed. A request succeeds when
    it returns "ok" within its deadline. Prints per mode the successes, p50
    and p99, breaker transitions and hedge outcomes. Fails unless every
    request returns, and with resilience on a breaker opened and a hedge
    was launched."""
    from mcpx_torch.core.config import ResilienceConfig
    from mcpx_torch.core.dag import Plan
    from mcpx_torch.resilience import Resilience
    from mcpx_torch.resilience.chaos import ChaosProfile, ChaosTransport

    t_phase = time.monotonic()
    orch = cp.orchestrator
    prev_transport, prev_resilience = orch._transport, orch._resilience

    async def healthy(payload):
        return {"ok": True}

    for name in ("chaos-a", "chaos-a-fb", "chaos-b", "chaos-b-fb"):
        prev_transport.local.register(name, healthy)
    profile = ChaosProfile.from_dict(CHAOS_PROFILE)

    async def run_round(resilient: bool) -> dict:
        orch._transport = ChaosTransport(prev_transport, profile)
        orch._resilience = (
            Resilience(ResilienceConfig(enabled=True), telemetry=cp.telemetry, metrics=cp.metrics)
            if resilient else None
        )
        m0 = parse_exposition(cp.metrics.render().decode())
        counts = {"ok_within": 0, "ok_late": 0, "failed": 0, "error": 0, "overrun": 0}
        lat: list = []
        sem = asyncio.Semaphore(16)

        async def one() -> None:
            async with sem:
                t0 = time.monotonic()
                try:
                    # As the /execute handler: the deadline is read only
                    # while resilience is wired.
                    result = await cp.execute(
                        Plan.from_wire(CHAOS_GRAPH), {},
                        deadline_ms=deadline_ms if orch.resilience is not None else None,
                    )
                except Exception:  # counted: the gate refuses any
                    counts["error"] += 1
                    return
                ms = (time.monotonic() - t0) * 1e3
                lat.append(ms)
                counts["overrun"] += ms > deadline_ms
                if result.status == "ok":
                    counts["ok_within" if ms <= deadline_ms else "ok_late"] += 1
                else:
                    counts["failed"] += 1

        t0 = time.monotonic()
        await asyncio.gather(*(one() for _ in range(n)))
        wall = time.monotonic() - t0
        m1 = parse_exposition(cp.metrics.render().decode())

        def delta(name: str, label: str, value: str) -> float:
            key = f'{{{label}="{value}"}}'
            return metric(m1, name, key) - metric(m0, name, key)

        lat.sort()
        return dict(
            **counts, returned=len(lat), success_rate=counts["ok_within"] / n,
            overrun_share=counts["overrun"] / n, p50_ms=quantile(lat, 0.5) if lat else None,
            p99_ms=lat[int(0.99 * (len(lat) - 1))] if lat else None, wall_s=wall,
            breaker_transitions={s: delta("mcpx_breaker_transitions_total", "state", s) for s in ("open", "closed")},
            hedges={o: delta("mcpx_hedges_total", "outcome", o)
                    for o in ("launched", "denied", "win", "loss", "cancelled")},
        )

    try:
        # Resilience off first: its completions also warm the telemetry
        # EWMAs the hedge delays of the resilient round derive from.
        baseline = await run_round(False)
        resilient = await run_round(True)
    finally:
        orch._transport, orch._resilience = prev_transport, prev_resilience
    stats = dict(model=size, requests=n, deadline_ms=deadline_ms, seed=profile.seed, baseline=baseline,
                 resilient=resilient, seconds=time.monotonic() - t_phase)
    emit(f"chaos_{size}", card, **stats)
    for mode, r in (("off", baseline), ("on", resilient)):
        if r["returned"] != n or r["error"]:
            raise SystemExit(f"chaos_{size}: resilience {mode}: {r['returned']} of {n} requests returned, "
                             f"{r['error']} raised")
    if resilient["breaker_transitions"]["open"] < 1 or resilient["hedges"]["launched"] < 1:
        raise SystemExit(f"chaos_{size}: with resilience on no breaker opened or no hedge was launched: "
                         f"{resilient['breaker_transitions']} {resilient['hedges']}")
    return stats


# ------------------------------------------------------------ tiered KV cache
TIER_CHAOS = {"seed": 7, "host_alloc_fail_p": 0.3, "copy_delay_p": 0.3, "copy_delay_s": 0.02}
TIER_SPILL = ("spills", "readmits", "destructive_evictions", "host_evictions", "denied_readmits",
              "host_tokens", "host_bytes", "chaos_alloc_failures")


def tier_config(size: str, checkpoint: str, *, enabled: bool, chaos: str = "", snapshot: str = ""):
    """The reference bench's tier geometry (``bench.py::_tier_phase``) on
    the serving config: batch 4, 16 pages of 16 tokens a row, an 8-token
    decode budget, the homogeneous slab without warm-up or speculation,
    4096 tree nodes; the tier with 256 MB of host memory and 4096 copy
    tokens a cycle."""
    cfg = config(size, checkpoint, 4)
    e = cfg.engine
    e.max_pages_per_seq, e.kv_page_size, e.max_decode_len = 16, 16, 8
    e.prefix_cache, e.prefix_cache_entries = True, 4096
    e.warmup_compile, e.hetero_batch, e.speculative.enabled = False, False, False
    t = e.kv_tier
    t.enabled, t.host_mb, t.copy_tokens_per_cycle = enabled, 256.0, 4096
    t.snapshot_path, t.chaos_profile = snapshot, chaos
    return cfg


def tier_prompts(tok, n: int) -> list:
    """The reference bench's tier workload: ``n`` prompts of up to 128
    tokens that share no page with each other."""
    return [tok.encode(f"tier workload {i}: " + "compose rank fetch join " * 12)[:128] for i in range(n)]


async def tier_phase(size: str, checkpoint: str, card: str, n_prompts: int = 64, rounds: int = 3,
                     device=None) -> dict:
    """The reference bench's ``_tier_phase`` on dedicated engines at its
    geometry (``tier_config``): ``n_prompts`` prompts served one at a time
    (greedy, two new tokens), ``rounds`` times, in the reference's order:
      1. *single*: ``kv_tier`` off, eviction destroys what the resident cap
         (half the pool: 512 tokens) cannot hold;
      2. *tiered*: evicted runs spill to pinned host memory and readmit at
         their next match; its clean close writes a snapshot, and a
         successor engine serves its first request from it (*warm*);
      3. *thrash*: a tenant of unique prompts against a victim tenant
         repeating 4, 4 + 4 a burst, ``4 * rounds`` bursts, governed;
      4. *chaos*: the seeded profile ``TIER_CHAOS``, two rounds.
    Each mode's line: the token hit rate (matched over matched plus
    prefilled) and prefill tokens a request, the tier's counters, the
    victim's and thrash's hit rates, the ``spill_copy`` share of the worker
    profile, the kernel launches, captures a round and seconds; the summary
    line: the warm first request's prefill tokens against the cold
    page-aligned prompt's. Fails unless tiered and chaos outputs equal the
    single tier's (round 1, as the reference gates; a later round's
    difference is printed with its top-2 margin: a readmitted prefix and a
    suffix prefill through the kernel against a dense prefill), the warm
    first output equals round 1's, the tiered hit
    rate beats the single tier's, the clean tiered run destroys nothing,
    chaos faults are counted, the warm first request prefills less than the
    cold one, no round after the first captures, every engine's host tier
    is empty after ``aclose`` and, on the card, the warm request launched
    the kernel. ``device`` and fewer prompts make a CPU rehearsal."""
    import shutil
    import tempfile

    from mcpx_torch.engine.engine import InferenceEngine
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.telemetry.flight import WorkerProfiler

    t_phase = time.monotonic()
    snap_dir = tempfile.mkdtemp(prefix="mcpx-tier-")
    snap = os.path.join(snap_dir, "kv.snap")

    async def start(enabled: bool, chaos: str = "", snapshot: str = ""):
        cfg = tier_config(size, checkpoint, enabled=enabled, chaos=chaos, snapshot=snapshot)
        engine = InferenceEngine(cfg, device=device)  # device=None: the card
        await engine.start()
        return engine

    async def close(engine, mode: str) -> None:
        tier = engine._spill_tier
        await engine.aclose()
        if tier is not None and (tier.host_bytes_used or tier.host_tokens or tier.pending_copies()):
            raise SystemExit(f"tier_{size} {mode}: the host tier is not empty after aclose: {tier.stats()}")

    async def drive(engine, stream: list, tenants=None) -> list:
        outs = []
        for j, p in enumerate(stream):
            r = await engine.generate(p, max_new_tokens=2, constrained=False, temperature=0.0,
                                      tenant=tenants[j] if tenants else "default")
            outs.append(r.token_ids)
        await idle(engine)
        return outs

    async def run(mode: str, engine, streams: list, tenants=None) -> tuple[dict, list]:
        q0, c0 = engine.queue_stats(), engine.prefix_cache_stats()
        sync()
        reset_kernel_launches()
        engine._profiler = prof = WorkerProfiler()
        outs, captures = [], []
        t0 = time.monotonic()
        for stream in streams:
            before = engine.queue_stats()["captures"]
            outs.append(await drive(engine, stream, tenants))
            captures.append(engine.queue_stats()["captures"] - before)
        wall = time.monotonic() - t0
        engine._profiler = None
        sync()
        launches = kernel_launches()
        await settle_profile()
        q1, c1 = engine.queue_stats(), engine.prefix_cache_stats()
        n = sum(len(s) for s in streams)
        prefilled = q1["prefill_tokens"] - q0["prefill_tokens"]
        matched = c1["matched_tokens"] - c0["matched_tokens"]
        line = dict(
            model=size, mode=mode, requests=n, rounds=len(streams), seconds=wall, requests_per_s=n / wall,
            token_hit_rate=matched / max(1, matched + prefilled), prefill_tokens_per_request=prefilled / n,
            spill_copy_share=prof.snapshot()["phases"]["spill_copy"]["share"], captures_per_round=captures,
            launches=launches, **loop_counts(engine, q0, q1, n),
        )
        if c1["tier"] is not None:
            line.update({k: c1["tier"][k] for k in TIER_SPILL})
        else:
            line["evictions"] = c1["evictions"]
        if any(captures[1:]):
            raise SystemExit(f"tier_{size} {mode}: a repeated round captured windows: {captures}")
        return line, outs

    lines: dict = {}
    try:
        engine = await start(False)
        tok = engine.tokenizer
        prompts = tier_prompts(tok, n_prompts)
        cap_tokens = engine._prefix_cache.max_tokens
        lines["single"], single = await run("single", engine, [prompts] * rounds)
        await close(engine, "single")

        engine = await start(True, snapshot=snap)
        lines["tiered"], tiered = await run("tiered", engine, [prompts] * rounds)
        # Later rounds: a readmitted prefix and a suffix prefill through the
        # kernel against the single tier's dense prefill. Each difference is
        # printed with the top-2 margin at its first differing token.
        later = []
        for r in range(1, rounds):
            for i, (a, b) in enumerate(zip(tiered[r], single[r])):
                if a != b:
                    k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
                    margin = masked_margin(engine, prompts[i], {"constrained": False}, a, k) if device is None else None
                    later.append({"round": r + 1, "prompt": i, "position": k, "margin": margin})
        await close(engine, "tiered")  # a clean close: writes the snapshot
        engine = await start(True, snapshot=snap)
        restored = engine.prefix_cache_stats()["spilled_nodes"]
        q0 = engine.queue_stats()
        sync()
        reset_kernel_launches()
        t0 = time.monotonic()
        warm = (await drive(engine, [prompts[0]]))[0]
        warm_ms = (time.monotonic() - t0) * 1e3
        warm_launches = kernel_launches()["ragged_paged_attention"]
        warm_prefill = engine.queue_stats()["prefill_tokens"] - q0["prefill_tokens"]
        warm_readmits = engine.prefix_cache_stats()["tier"]["readmits"]
        await close(engine, "warm")

        engine = await start(True)
        victim = prompts[:4]
        thrash = [tok.encode(f"thrash {i}: " + "spam flood churn " * 14)[:128] for i in range(2 * n_prompts)]
        stream, tenants = [], []
        for burst in range(rounds * 4):
            stream += [thrash[(burst * 4 + j) % len(thrash)] for j in range(4)] + victim
            tenants += ["thrash"] * 4 + ["victim"] * 4
        lines["thrash"], _ = await run("thrash", engine, [stream], tenants)
        gov = engine.prefix_cache_stats()["governor"]
        lines["thrash"].update(victim_token_hit_rate=gov["victim"]["token_hit_rate"],
                               thrash_token_hit_rate=gov["thrash"]["token_hit_rate"])
        await close(engine, "thrash")

        engine = await start(True, chaos=json.dumps(TIER_CHAOS))
        lines["chaos"], chaos = await run("chaos", engine, [prompts, prompts])
        lines["chaos"]["profile"] = TIER_CHAOS
        await close(engine, "chaos")
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    for mode in ("single", "tiered", "thrash", "chaos"):
        emit(f"tier_{size}", card, **lines[mode])
    cold_first = (len(prompts[0]) // 16) * 16
    working_set = sum((len(p) // 16) * 16 for p in prompts)
    t, s = lines["tiered"], lines["single"]
    summary = dict(
        model=size, mode="summary", requests=n_prompts * rounds, working_set_tokens=working_set,
        resident_cap_tokens=cap_tokens, working_set_ratio=working_set / max(1, cap_tokens),
        tier_token_hit_rate=t["token_hit_rate"], single_token_hit_rate=s["token_hit_rate"],
        tier_hit_ratio=t["token_hit_rate"] / max(s["token_hit_rate"], 0.01),
        victim_token_hit_rate=lines["thrash"]["victim_token_hit_rate"],
        thrash_token_hit_rate=lines["thrash"]["thrash_token_hit_rate"],
        restored_runs=restored, warm_readmits=warm_readmits, warm_launches=warm_launches,
        cold_first_prefill_tokens=cold_first, warm_first_prefill_tokens=warm_prefill,
        warm_restart_prefill_ratio=cold_first / warm_prefill if warm_prefill else None,
        warm_first_ms=warm_ms, later_rounds_differing=len(later), later_rounds_margins=later,
        round1_equal={"tiered": tiered[0] == single[0], "chaos": chaos[0] == single[0], "warm": warm == tiered[0][0]},
        seconds=time.monotonic() - t_phase,
    )
    emit(f"tier_{size}", card, **summary)
    problems = [k for k, ok in summary["round1_equal"].items() if not ok]
    if t["token_hit_rate"] <= s["token_hit_rate"]:
        problems.append(f"tiered hit rate {t['token_hit_rate']} <= single {s['token_hit_rate']}")
    if t["destructive_evictions"]:
        problems.append(f"{t['destructive_evictions']} destructive evictions in the clean tiered run")
    if lines["chaos"]["chaos_alloc_failures"] <= 0:
        problems.append("no chaos fault counted")
    if warm_prefill >= cold_first:
        problems.append(f"warm first request prefilled {warm_prefill} >= cold {cold_first}")
    if device is None and warm_launches <= 0:
        problems.append("the warm request launched no kernel")
    if problems:
        raise SystemExit(f"tier_{size}: {problems}")
    return {**lines, "summary": summary}


def tier_batch(seed: int, kind: str, G: int, hd: int, L: int, psz: int, pmax: int):
    """The tier phases' attention shapes (B 4, 16-token pages, 16 a row):
    ``tier_prefill`` is a suffix prefill at the smallest prefill bucket (S
    64) over readmitted prefixes of 64, 80, 96 and 112 tokens, each row's
    suffix the rest of its 128-token prompt; ``tier_decode`` one token a row
    at positions 128-135. Random distinct pages."""
    rng = random.Random(seed)
    B = 4
    q, kp, vp, table, _s, _q = mixed_batch(seed, B, 64 if kind == "tier_prefill" else 1, 1, G, hd, L,
                                            psz, pmax, torch.bfloat16, live=B)
    if kind == "tier_prefill":
        starts = [64, 80, 96, 112]
        q_lens = [128 - s for s in starts]
    else:
        starts = [128 + rng.randint(0, 7) for _ in range(B)]
        q_lens = [1] * B
    as_i32 = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")  # noqa: E731
    return q, kp, vp, table, as_i32(starts), as_i32(q_lens)


def tier_roundtrip(size: str, card: str, run_pages=(4, 7, 8)) -> dict:
    """The tier's two copies held against the truth, bit for bit, at the
    tier geometry and ``size``'s full width, through the engine's own copy
    functions and a ``HostSpillTier`` bound to them (the engine is not
    started: its pools are filled from a seed here). For each run length in
    pages, once alone and once while a captured window replays on the same
    stream around every step: a long device sleep is queued first, so the
    copy is in flight; the run's pages are cloned (the truth), spilled, and
    overwritten at once as the next prefill would write them; ``poll()``
    must return while the copy is in flight (its longest call is printed)
    and is called until the run lands; the landed host run must equal the
    clone; the run is readmitted into other pages, which must then equal
    the clone, the pools' addresses unchanged; and ``ragged_paged_attention``
    over a table naming the readmitted pages (suffix prefill and decode
    rows) must give exactly what it gives over the clone."""
    from mcpx_torch.engine.engine import InferenceEngine
    from mcpx_torch.engine.kernels.paged_attention import ragged_paged_attention

    t0 = time.monotonic()
    engine = InferenceEngine(tier_config(size, "", enabled=True))
    mc, psz = engine.model_cfg, engine.config.engine.kv_page_size
    K, L, hd = mc.n_kv_heads, mc.n_layers, mc.head_dim
    n_pages = engine._allocator.n_pages
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    pools = {k: torch.randn((K, L, n_pages, psz, hd), generator=gen, device="cuda").to(torch.bfloat16)
             for k in ("k", "v")}
    engine._paged_kv = pools
    ptrs = {k: t.data_ptr() for k, t in pools.items()}
    tier = engine._spill_tier
    tier.bind(engine._spill_gather, engine._spill_readmit, 2 * K * L * hd * 2)
    G = mc.n_heads // K
    S = 16
    q = torch.randn((4, S, K, G, hd), generator=gen, device="cuda").to(torch.bfloat16)

    # A captured "window": the kernel over pages no run uses, and a K/V
    # write into two pages of its own, as a decode window reads and writes.
    w_table = torch.zeros((4, engine.config.engine.max_pages_per_seq), dtype=torch.int32, device="cuda")
    w_table[:, :2] = torch.tensor([n_pages - 4, n_pages - 3], dtype=torch.int32)
    w_starts = torch.full((4,), 20, dtype=torch.int32, device="cuda")
    w_lens = torch.ones((4,), dtype=torch.int32, device="cuda")
    scratch = torch.tensor([n_pages - 2, n_pages - 1], device="cuda")
    w_q = q[:, :1].clone()

    def window():
        ragged_paged_attention(w_q, pools["k"], pools["v"], w_table, w_starts, w_lens, 0)
        pools["k"].index_add_(2, scratch, pools["v"].index_select(2, scratch))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        window()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        window()

    class Node:
        def __init__(self, n_tokens: int):
            self.tokens, self.tenant, self.host = tuple(range(n_tokens)), "default", None

    def overwrite(pages_i):  # as the next prefill writes freed pages
        for k in ("k", "v"):
            pools[k].index_copy_(2, pages_i, torch.randn(
                (K, L, len(pages_i), psz, hd), generator=gen, device="cuda").to(torch.bfloat16))

    def settle():
        # No copy in flight, and the pinned sources of finished readmits
        # back in the caching host allocator for the next spill to reuse.
        torch.cuda.synchronize()
        engine._prune_readmit_holds()

    # Every step once per run length first, unchecked: a kernel's first
    # launch (lazy module loading) and a new pinned block (cudaHostAlloc)
    # wait for the device, so a first spill would land before its poll.
    for n in run_pages:
        node = Node(n * psz)
        tier.begin_cycle()
        tier.spill(node, list(range(1, n + 1)))
        overwrite(torch.arange(1, n + 1, device="cuda"))
        tier.drain()
        tier.readmit(node, list(range(1, n + 1)))
        settle()
    rng = random.Random(0)
    cases = []
    for n in run_pages:
        for replaying in (False, True):
            free = list(range(1, n_pages - 4))
            rng.shuffle(free)
            src, dst = free[:n], free[n : 2 * n]
            src_i, dst_i = torch.tensor(src, device="cuda"), torch.tensor(dst, device="cuda")
            settle()
            truth = [pools[k].index_select(2, src_i).clone() for k in ("k", "v")]
            node = Node(n * psz)
            tier.begin_cycle()
            torch.cuda._sleep(50_000_000)  # the gather waits behind this: in flight
            if not tier.spill(node, src):
                raise SystemExit(f"tier_roundtrip_{size}: spill refused")
            if replaying:
                graph.replay()
            overwrite(src_i)
            polls, worst_ms, in_flight = 0, 0.0, None
            while not tier.readmit_usable(node):
                t = time.perf_counter()
                tier.poll()
                worst_ms = max(worst_ms, (time.perf_counter() - t) * 1e3)
                if in_flight is None:
                    in_flight = tier.pending_copies() == 1
                polls += 1
                if replaying:
                    graph.replay()
                time.sleep(0.001)
            landed = all(torch.equal(h, t.cpu()) for h, t in zip((node.host.k, node.host.v), truth))
            pinned = node.host.k.is_pinned() and node.host.v.is_pinned()
            tier.begin_cycle()
            if not tier.readmit(node, dst):
                raise SystemExit(f"tier_roundtrip_{size}: readmit refused")
            if replaying:
                graph.replay()
            back = [pools[k].index_select(2, dst_i) for k in ("k", "v")]
            exact = all(torch.equal(a, b) for a, b in zip(back, truth))
            # The kernel over the readmitted pages against the clone laid out
            # in a pool of its own (page 0 null, the run at 1..n).
            clone = {k: torch.zeros((K, L, n + 1, psz, hd), dtype=torch.bfloat16, device="cuda") for k in ("k", "v")}
            for k, t in zip(("k", "v"), truth):
                clone[k][:, :, 1:] = t
            live_t = torch.zeros((4, engine.config.engine.max_pages_per_seq), dtype=torch.int32, device="cuda")
            clone_t = torch.zeros_like(live_t)
            live_t[:, :n] = dst_i.to(torch.int32)
            clone_t[:, :n] = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")
            end = n * psz
            starts = torch.tensor([end - 16, end - 1, end - 8, 0], dtype=torch.int32, device="cuda")
            q_lens = torch.tensor([16, 1, 8, 0], dtype=torch.int32, device="cuda")
            kernel_exact = all(
                torch.equal(
                    ragged_paged_attention(q, pools["k"], pools["v"], live_t, starts, q_lens, layer),
                    ragged_paged_attention(q, clone["k"], clone["v"], clone_t, starts, q_lens, layer),
                )
                for layer in (0, L - 1)
            )
            torch.cuda.synchronize()
            case = dict(pages=n, tokens=n * psz, replaying=replaying, in_flight_at_first_poll=in_flight,
                        polls=polls, max_poll_ms=worst_ms, landed_equal=landed, pinned=pinned,
                        readmitted_equal=exact, kernel_equal=kernel_exact,
                        pools_kept=all(pools[k].data_ptr() == p for k, p in ptrs.items()))
            cases.append(case)
            if not (in_flight and landed and pinned and exact and kernel_exact and case["pools_kept"]):
                raise SystemExit(f"tier_roundtrip_{size}: {case}")
    check_tickets(f"tier_roundtrip_{size}")
    out = dict(model=size, K=K, L=L, hd=hd, page_size=psz, cases=cases, bytes_per_token=2 * K * L * hd * 2,
               spills=tier.spills, readmits=tier.readmits, host_bytes_after=tier.host_bytes_used,
               max_poll_ms=max(c["max_poll_ms"] for c in cases), seconds=time.monotonic() - t0)
    emit(f"tier_roundtrip_{size}", card, **out)
    if tier.host_bytes_used or tier.pending_copies():
        raise SystemExit(f"tier_roundtrip_{size}: host tier not empty: {tier.stats()}")
    return out


def failing_transport(records, failing: set):
    """A zero-latency in-process handler for every ``local://`` endpoint and
    fallback of ``records``; every endpoint of a service in ``failing`` (read
    at each call, so the set may be filled later) raises. Returns the
    transport and the list of endpoints called."""
    from mcpx_torch.orchestrator.transport import LocalTransport, RouterTransport, TransportError

    local = LocalTransport()
    calls: list = []

    def handler(name: str, endpoint: str):
        async def call(payload):
            calls.append(endpoint)
            if name in failing:
                raise TransportError(f"{name} is down", status=503)
            return {"service": name, "inputs": sorted(payload)}

        return call

    for r in records:
        for ep in [r.endpoint, *r.fallbacks]:
            local.register(ep.removeprefix("local://"), handler(r.name, ep))
    return RouterTransport(local=local), calls


class Lockstep:
    """An orchestrator that runs the executions of concurrent
    ``plan_and_execute`` calls (started by ``run``) in rounds: once every
    call still running holds a plan to execute, and ``settle()`` has
    returned, that round's executions run one at a time in the order the
    calls were given, and each returns once the whole round has recorded
    its telemetry. Every replan's exclusions and telemetry snapshot then
    hold exactly the earlier rounds, recorded in a fixed order, whatever
    order the engine finishes plans in. It keeps every execution's
    (plan, result) by trace id."""

    def __init__(self, inner, settle) -> None:
        self.inner, self.settle = inner, settle
        self.slot: contextvars.ContextVar = contextvars.ContextVar("lockstep_slot")
        self.running = 0
        self.waiting: dict = {}  # slot -> future resolved with the round's end
        self.turns: list = []
        self.executions: dict = {}

    async def run(self, calls) -> list:
        calls = list(calls)
        self.running, self.executions = len(calls), {}

        async def each(i: int, call):
            self.slot.set(i)
            try:
                return await call
            finally:
                self.running -= 1
                self._start_round()

        return await asyncio.gather(*(each(i, c) for i, c in enumerate(calls)))

    def _start_round(self) -> None:
        if self.waiting and len(self.waiting) == self.running:
            turns = [self.waiting[i] for i in sorted(self.waiting)]
            self.waiting = {}
            asyncio.ensure_future(self._round(turns))

    async def _round(self, turns: list) -> None:
        await self.settle()
        self.end = asyncio.get_running_loop().create_future()
        self.turns = turns
        self._next_turn()

    def _next_turn(self) -> None:
        if self.turns:
            self.turns.pop(0).set_result(self.end)
        else:
            self.end.set_result(None)

    @property
    def resilience(self):
        return self.inner.resilience

    async def execute(self, plan, payload, trace=None, *, deadline_ms=None):
        turn = asyncio.get_running_loop().create_future()
        self.waiting[self.slot.get()] = turn
        self._start_round()
        end = await turn
        try:
            kw = {} if deadline_ms is None else {"deadline_ms": deadline_ms}
            result = await self.inner.execute(plan, payload, trace, **kw)
        finally:
            self._next_turn()
        self.executions.setdefault(result.trace.trace_id, []).append((plan, result))
        await end
        return result

    async def aclose(self) -> None:
        await self.inner.aclose()


def failed_services(plan, result) -> set:
    return {plan.node(n).service for n, e in result.errors.items() if not e.startswith("skipped:")}


def rendered_exclusion(plan) -> str:
    """The plan's first service that its prompt's services block renders,
    else the block's first service. Random 2b weights name services
    outside the block, and excluding one of those leaves the cold
    re-render equal to the original prompt, all of it cached."""
    rendered = list(plan.prompt_services or ())
    if not rendered:
        return plan.nodes[0].service
    return next((n.service for n in plan.nodes if n.service in rendered), rendered[0])


def latency_blind(tok, prompt_ids) -> str:
    """A prompt's text with every rendered tool latency (``p50=<ms>``)
    replaced by ``p50=_``: in-process tools answer in host noise."""
    return re.sub(r"p50=\d+", "p50=_", tok.decode(prompt_ids or []))


def latency_flip(tok, runs1: list, runs2: list, served1: dict, served2: dict, margin) -> dict | None:
    """Why one call of ``execute_phase`` differs between its passes, when
    the first of its executions whose prompt differs does so in the tools'
    latency alone (``latency_blind``), every execution before it is equal,
    and a plan differs from there on: that execution, the first whose plan
    differs, and pass 1's masked top-2 margin (``margin(prompt_ids, kw,
    toks, k)``) at the first token where the two plans' streams part. Else
    None (unexplained). ``runs*``: the call's executed plans as (JSON,
    prompt ids); ``served*``: prompt ids -> (generate's arguments, result)."""
    k = next((j for j, (a, b) in enumerate(zip(runs1, runs2)) if a[1] != b[1]), None)
    if k is None or runs1[:k] != runs2[:k]:
        return None
    if latency_blind(tok, runs1[k][1]) != latency_blind(tok, runs2[k][1]):
        return None
    j = next((j for j in range(k, min(len(runs1), len(runs2))) if runs1[j][0] != runs2[j][0]), None)
    if j is None:
        return None
    (kw, res1), (_, res2) = served1[tuple(runs1[j][1])], served2[tuple(runs2[j][1])]
    t1, t2 = res1.token_ids, res2.token_ids
    at = next((t for t, (x, y) in enumerate(zip(t1, t2)) if x != y), min(len(t1), len(t2)))
    return {"prompt_differs_at": k, "plan_differs_at": j, "token": at, "margin": margin(runs1[j][1], kw, t1, at)}


def common_prefix(a: list, b: list) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def extends_block(tok, original: list, replan: list) -> bool:
    """Whether the replan prompt byte-extends ``original`` through its
    services block, with the exclusions in an Avoid line after it."""
    text1, text2 = tok.decode(original), tok.decode(replan)
    end = text1.rindex("\nIntent:")
    return text2[:end] == text1[:end] and "\nAvoid: " in text2[end:]


def nearest_rank(sorted_ms: list, q: float) -> float:
    return sorted_ms[max(0, math.ceil(q * len(sorted_ms)) - 1)]


async def execute_phase(size: str, checkpoint: str, n_intents: int, card: str, batch: int, device=None) -> dict:
    """``ControlPlane.plan_and_execute`` on the burst's intents, on an engine
    of the serving phase's configuration with 16-token pages (the same
    256-token row capacity): at 64-token pages the services block of a
    /plan prompt (58-62 tokens at test) is shorter than one page, so no
    page of it could be shared by a replan. Every registry endpoint answers
    in process at zero latency, retries do not back off, the plan cache is
    off (every call plans), and the first service of every other intent's
    /plan fails at every endpoint. Then:
      * pass 1: every intent at once through ``plan_and_execute``
        (``telemetry.max_replans`` at its default), the executions in
        rounds (``Lockstep``);
      * the reference bench's replan probe over the same intents, one at a
        time on a quiet slab: plan, exclude a service, replan warm (with
        ``replan_prior``) and cold (without), the replan's prefill tokens
        and wall ms. Twice: excluding a service the prompt renders
        (``rendered_exclusion``, gated), and the plan's first service, as
        the bench does (reported). A first warm round of each, which builds
        each exclusion set's grammar, is reported apart;
      * pass 2: pass 1 again from the same starting state (the telemetry
        store reset, no unpinned run in the tree), which must capture no
        window.
    Prints one line; fails on no replan, a warm probe replan whose prompt
    does not byte-extend its original through the services block, a replan
    that names a service an earlier execution of its call saw fail, warm
    replans that prefill no fewer tokens than cold ones or run no suffix
    prefill, a pin or pinned tree node left after a pass, a capture in
    pass 2, and at test any difference between the two passes in graph,
    results, errors, status, replans or the plans executed and their
    prompts that ``latency_flip`` does not explain. The tools' measured
    latency (``p50=``) is host noise of about half a millisecond and renders
    as 0 or 1 by chance, so a replan's prompt may differ between the passes
    in it alone (``latency_blind``), and its plan, and what follows in that
    call, may then differ where pass 1's pick was a near-tie.
    A replan inside ``plan_and_execute`` renders the telemetry its
    services gained in the execution (``err=``, ``p50=``), as the
    reference's does, so its prompt parts from the original at the first
    such line: the line reports how many tokens each shares."""
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    cfg = config(size, checkpoint, batch)
    cfg.engine.kv_page_size, cfg.engine.max_pages_per_seq = 16, 16
    # Retries do not back off (the full-jitter sleep is an unseeded draw).
    cfg.orchestrator.retry_backoff_s = 0.0
    cfg.planner.plan_cache_size = 0
    records = synth_registry(1000, seed=0)
    rng = random.Random(0)
    intents = [intent_for(records, rng) for _ in range(n_intents)]
    failing: set = set()
    transport, calls = failing_transport(records, failing)
    cp = build_control_plane(cfg, transport=transport, device=device)
    for rec in records:
        await cp.registry.put(rec)
    cuda = cp.planner.engine.device.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()

    try:
        await cp.startup()
        engine = cp.planner.engine
        tok = engine.tokenizer

        async def settle() -> None:
            """Before a round of executions: the engine idle, its trailing
            segments harvested, and a full collection done, so that no tool
            call is timed across another thread's turn or the collector
            (the store records each call's measured latency)."""
            await idle(engine)
            await asyncio.sleep(0.02)
            gc.collect()

        served: dict = {}  # prompt ids -> (generate's arguments, result), this pass's
        real_generate = engine.generate

        async def recording(prompt_ids, **kw):
            res = await real_generate(prompt_ids, **kw)
            served[tuple(prompt_ids)] = ({"temperature": 0.0, **kw}, res)
            return res

        engine.generate = recording
        lockstep = cp.orchestrator = Lockstep(cp.orchestrator, settle)
        firsts = await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents[::2]))
        failing.update(p.nodes[0].service for p, _ in firsts)

        async def run_pass() -> tuple[dict, list, list]:
            """Every intent through plan_and_execute at once, from the same
            starting state each time: empty telemetry, no unpinned run in
            the tree (the captured windows and the grammar cache stay)."""
            await idle(engine)
            cp.telemetry.reset()
            await engine.drop_unpinned()
            served.clear()
            q0 = engine.queue_stats()
            sync()
            reset_kernel_launches()

            async def one(intent: str):
                t0 = time.monotonic()
                out = await cp.plan_and_execute(intent, {"query": "q", "text": "t"})
                return out, (time.monotonic() - t0) * 1e3

            t0 = time.monotonic()
            results = await lockstep.run(one(i) for i in intents)
            wall = time.monotonic() - t0
            sync()
            launches = kernel_launches()
            await idle(engine)  # the unpins ride the queue: drained here
            q1 = engine.queue_stats()
            pinned_nodes = await engine.drop_unpinned()
            outs = [o for o, _ in results]
            lat = sorted(ms for _, ms in results)
            # The plans each call executed, in order: its first plan, then
            # one a replan.
            executed = [lockstep.executions[o["trace"]["trace_id"]] for o in outs]
            bad_plans, shared, extends = [], [], 0
            for intent, runs in zip(intents, executed):
                seen_failing: set = set()
                for k, (plan, result) in enumerate(runs):
                    if k and {n.service for n in plan.nodes} & seen_failing:
                        bad_plans.append((intent, sorted(seen_failing), plan.to_json()))
                    seen_failing |= failed_services(plan, result)
                    orig = runs[0][0]
                    if k and orig.prompt_ids and plan.prompt_ids:
                        shared.append(common_prefix(orig.prompt_ids, plan.prompt_ids))
                        extends += extends_block(tok, orig.prompt_ids, plan.prompt_ids)
            p50s = sorted({
                m for runs in executed for plan, _ in runs[1:]
                for m in re.findall(r"p50=\d+", tok.decode(plan.prompt_ids or []))
            })
            stats = dict(
                model=size, intents=n_intents, failing=len(failing), wall_s=wall,
                p50_ms=nearest_rank(lat, 0.5), p99_ms=nearest_rank(lat, 0.99),
                status={s: sum(o["status"] == s for o in outs) for s in sorted({o["status"] for o in outs})},
                replans=sum(o["replans"] for o in outs),
                origins={o: sum(x["origin"] == o for x in outs) for o in sorted({x["origin"] for x in outs})},
                executions=sum(map(len, executed)),
                **{k: q1[k] - q0[k] for k in ("suffix_prefills", "suffix_prefill_launches", "prefill_tokens")},
                launches=launches, **loop_counts(engine, q0, q1, n_intents),
                pins_left=q1["prefix_pins"], pinned_nodes_left=pinned_nodes, bad_plans=len(bad_plans),
                replan_prompts=len(shared), replan_prompts_extending_block=extends,
                replan_shared_prompt_tokens=shared, replan_prompt_latency_features=p50s,
            )
            if bad_plans:
                raise SystemExit(f"execute_{size}: a replan named a service that failed before: {bad_plans[:2]}")
            plans = [[(p.to_json(), list(p.prompt_ids or [])) for p, _ in runs] for runs in executed]
            return stats, outs, plans, dict(served)

        async def replan_probe(warm: bool, exclusion) -> dict:
            """The reference bench's replan sample (bench.py ``timed_replan``,
            which builds the replan's context with ``_context`` as here)
            over every intent, one at a time: only the replan is timed, and
            nothing else runs, so the engine's prefill counter moves by the
            replan's own prefill. ``exclusion(plan)`` names the excluded
            service."""
            lats, d = [], {"prefill_tokens": 0, "suffix_prefills": 0, "suffix_prefill_launches": 0}
            own_first, broken = 0, []
            await idle(engine)
            await engine.drop_unpinned()  # no round matches an earlier round's replans
            for intent in intents:
                await idle(engine)
                plan, _ = await cp.plan(intent, use_cache=False)
                if not plan.nodes:
                    continue
                own_first += plan.nodes[0].service in (plan.prompt_services or ())
                prior = tuple(plan.prompt_services) if warm and plan.prompt_services else None
                ctx = await cp._context(intent, {exclusion(plan)}, replan_prior=prior)
                await idle(engine)
                q0 = engine.queue_stats()
                t0 = time.monotonic()
                replan = await cp.planner.plan(intent, ctx)
                lats.append((time.monotonic() - t0) * 1e3)
                q1 = engine.queue_stats()
                for k in d:
                    d[k] += q1[k] - q0[k]
                if prior and replan.prompt_ids and not extends_block(tok, plan.prompt_ids, replan.prompt_ids):
                    broken.append((tok.decode(plan.prompt_ids), tok.decode(replan.prompt_ids)))
            if broken:
                raise SystemExit(f"execute_{size}: warm replan prompts do not extend their block: {broken[:2]}")
            return dict(
                replans=len(lats), p50_ms=statistics.median(lats),
                prefill_tokens=d["prefill_tokens"] / len(lats),
                suffix_prefills=d["suffix_prefills"], suffix_prefill_launches=d["suffix_prefill_launches"],
                first_service_rendered=own_first,
            )

        async def probe_rounds(exclusion) -> dict:
            # The first round builds each exclusion set's grammar; the
            # timed rounds after it find them cached.
            out = {"first": await replan_probe(True, exclusion)}
            out.update(cold=await replan_probe(False, exclusion), warm=await replan_probe(True, exclusion))
            return out

        pass1, outs1, plans1, served1 = await run_pass()
        probe = await probe_rounds(rendered_exclusion)
        bench_probe = await probe_rounds(lambda plan: plan.nodes[0].service)
        pass2, outs2, plans2, served2 = await run_pass()
        keys = ("graph", "results", "errors", "status", "replans")

        def blind(runs: list) -> list:
            return [(j, latency_blind(tok, ids)) for j, ids in runs]

        differ = [
            i for i, (a, b) in enumerate(zip(outs1, outs2))
            if any(a[k] != b[k] for k in keys) or blind(plans1[i]) != blind(plans2[i])
        ]
        flips = {i: latency_flip(tok, plans1[i], plans2[i], served1, served2,
                                 lambda *a: masked_margin(engine, *a)) for i in differ}

        def first_difference(i: int) -> dict:
            """The first plan of call ``i`` that differs between the passes:
            its index, whether the plan or only its prompt differs, and the
            two prompts from 40 characters before they part."""
            b1, b2 = blind(plans1[i]), blind(plans2[i])
            k = next((k for k, (a, b) in enumerate(zip(b1, b2)) if a != b), None)
            if k is None:
                return {"executions": [len(b1), len(b2)]}
            (j1, t1), (j2, t2) = b1[k], b2[k]
            at = max(0, next((c for c, (x, y) in enumerate(zip(t1, t2)) if x != y), min(len(t1), len(t2))) - 40)
            return {"execution": k, "plan_differs": j1 != j2, "prompts": [t1[at:at + 120], t2[at:at + 120]]}

        stats = dict(
            model=size, kv_page_size=16, max_pages_per_seq=16, failing_services=sorted(failing),
            endpoints_called=len(calls), pass1=pass1, replan_probe=probe,
            replan_probe_first_service=bench_probe, pass2=pass2, pass_differ=differ,
            differing=[
                {**{k: [o[k] if k != "graph" else [n["service"] for n in o[k]["nodes"]] for o in (outs1[i], outs2[i])]
                    for k in keys}, "first_difference": first_difference(i), "latency_flip": flips[i]}
                for i in differ
            ],
            latency_flips=sum(f is not None for f in flips.values()), near_tie=NEAR_TIE,
        )
        emit(f"execute_{size}", card, **stats)
        if pass1["replans"] <= 0 or pass2["replans"] <= 0:
            raise SystemExit(f"execute_{size}: no replan happened")
        if not probe["warm"]["prefill_tokens"] < probe["cold"]["prefill_tokens"]:
            raise SystemExit(f"execute_{size}: warm replans prefilled no fewer tokens than cold: {probe}")
        if probe["warm"]["suffix_prefills"] <= 0:
            raise SystemExit(f"execute_{size}: no warm replan ran a suffix prefill: {probe}")
        if cuda and probe["warm"]["suffix_prefill_launches"] <= 0:
            raise SystemExit(f"execute_{size}: warm replans' suffix prefills launched no kernel: {probe}")
        for p in (pass1, pass2):
            if p["pins_left"] or p["pinned_nodes_left"]:
                raise SystemExit(f"execute_{size}: pins left after a pass: {p['pins_left']} {p['pinned_nodes_left']}")
        if pass2["captures"]:
            raise SystemExit(f"execute_{size}: the repeat captured {pass2['captures']} windows")
        unexplained = [i for i, f in flips.items() if f is None or f["margin"] >= NEAR_TIE]
        if size == "test" and unexplained:
            raise SystemExit(f"execute_{size}: the two passes differ at {unexplained}, not a near-tie after a "
                             f"replan prompt that differs in the tools' latency alone: {[flips[i] for i in unexplained]}")
        return stats
    finally:
        vars(cp.planner.engine).pop("generate", None)
        await cp.aclose()


# ------------------------------------------------------------ the config surface
# Phase 20: an operator's 100k-service deployment. The reference names 100k
# services as the scale where the table belongs in device memory, and its
# default ``device_threshold`` (65,536) puts that many rows on the device;
# seed 7 is the reference bench's registry seed.
REGISTRY_N, REGISTRY_SEED = 100_000, 7
SCORE_NEAR_TIE = 1e-5  # host and device fp32 products may order rows this close either way


def registry_config(size: str, checkpoint: str, batch: int, path: str):
    """Phases 5-6's settings over the file registry at ``path`` with
    shortlist-constrained names: the default ``"registry"`` tier builds one
    trie over every name, out of reach at 100k. (The retrieval index is
    built once and passed in, at ``compute="auto"``.)"""
    cfg = config(size, checkpoint, batch)
    cfg.registry.backend, cfg.registry.file_path = "file", path
    cfg.planner.constrain_names = "shortlist"
    cfg.validate()
    return cfg


async def registry_index(path: str, card: str, n: int = REGISTRY_N, device=None, threshold: int = 65536):
    """``gen-registry``'s file of ``n`` services, read by the file backend,
    and the retrieval index built from it once at ``compute="auto"`` (the
    table on ``device``, the card unless the caller asks for the CPU, at
    ``threshold`` rows or more: the default's 65,536 on the card, fewer in a
    small rehearsal). Prints the host seconds of each step and the table's
    bytes."""
    from mcpx_torch.cli.main import cmd_gen_registry
    from mcpx_torch.core.config import RetrievalConfig
    from mcpx_torch.registry import FileRegistry
    from mcpx_torch.retrieval.index import RetrievalIndex

    t0 = time.monotonic()
    cmd_gen_registry(argparse.Namespace(n=n, seed=REGISTRY_SEED, out=path))
    gen_s = time.monotonic() - t0
    registry = FileRegistry(path)
    t0 = time.monotonic()
    records = await registry.list_services()
    load_s = time.monotonic() - t0
    index = RetrievalIndex(RetrievalConfig(compute="auto", device_threshold=threshold), device=device)
    t0 = time.monotonic()
    await index.refresh(registry)
    build_s = time.monotonic() - t0
    table = index._table
    table_bytes = table.numel() * table.element_size() if table is not None else 0
    info = dict(services=len(records), gen_registry_s=gen_s, file_bytes=os.path.getsize(path),
                record_load_s=load_s, index_build_s=build_s, table_bytes=table_bytes,
                table_device=str(table.device) if table is not None else None, embed_dim=index.config.embed_dim)
    emit("registry_index", card, **info)
    if table is None or table.device.type != index.device.type or table.dtype != torch.float32:
        raise SystemExit(f"registry index: the table is not a float32 tensor on {index.device}: {info}")
    if table_bytes != len(records) * index.config.embed_dim * 4:
        raise SystemExit(f"registry index: table bytes {table_bytes} for {len(records)} services")
    return index, records


async def timed_plans(cp, intents: list) -> list:
    """(plan, ms) of each intent's ``/plan``, all sent at once."""

    async def one(intent: str):
        t = time.perf_counter()
        plan, _ = await cp.plan(intent, use_cache=False)
        return plan, (time.perf_counter() - t) * 1e3

    return await asyncio.gather(*(one(i) for i in intents))


def quantiles_ms(vals: list) -> dict:
    vals = sorted(vals)
    return dict(p50=nearest_rank(vals, 0.5), p99=nearest_rank(vals, 0.99), n=len(vals))


def rank_ms(index, q, k: int) -> tuple[float, float]:
    """Host ms of the shortlist's plain ranking of one query: the device
    table (``_device_topk``: product, top-k and read-back on the index's
    stream), then host numpy on the same table (``_host_order``)."""
    t = time.perf_counter()
    index._device_topk(q, k)
    t1 = time.perf_counter()
    index._host_order(q, k)
    return (t1 - t) * 1e3, (time.perf_counter() - t1) * 1e3


def rank_quantiles(pairs: list) -> dict:
    return dict(device=quantiles_ms([d for d, _ in pairs]), host=quantiles_ms([h for _, h in pairs]))


async def shortlists_while(index, queries: list, k: int, stop: asyncio.Event) -> dict:
    """``rank_ms`` in rounds over ``queries`` on the event loop until
    ``stop``, yielding after each query, so the burst's requests run
    meanwhile."""
    pairs = []
    while not stop.is_set():
        for q in queries:
            pairs.append(rank_ms(index, q, k))
            await asyncio.sleep(0)
            if stop.is_set():
                break
    return rank_quantiles(pairs)


def shortlist_agreement(index, intents: list, k: int) -> tuple[list, list]:
    """The device ranking against the host's on the same table, per intent:
    (near-ties, faults). Where the two orders part, the two rows' host
    scores must differ by less than ``SCORE_NEAR_TIE``."""
    near, bad = [], []
    for intent in intents:
        q = index.embedder.embed(intent)
        dev, host = index._device_topk(q, k)[1], index._host_order(q, k)
        if dev == host:
            continue
        scores = index._table_np @ q
        gaps = [float(abs(scores[a] - scores[b])) for a, b in zip(dev, host) if a != b]
        row = dict(intent=intent, device=dev, host=host, max_gap=max(gaps))
        (near if max(gaps) < SCORE_NEAR_TIE else bad).append(row)
    return near, bad


async def registry_phase(size: str, checkpoint: str, n_intents: int, card: str, index, path: str,
                         batch: int = 64, device=None) -> dict:
    """Phase 20 on one width: a control plane over the file registry at
    ``path``, sharing the built ``index`` (``retriever=``). A timed burst of
    ``n_intents`` concurrent ``/plan``s; a repeat, which must capture
    nothing, with the shortlist's device and host ranking timed on the event
    loop while it runs; then both timed on an idle card. Every plan valid
    and naming only registry services; the device ranking equal to the
    host's on every intent but near-ties (printed); the kernel launched in
    the burst and its tickets back at 0."""
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for

    cfg = registry_config(size, checkpoint, batch, path)
    cp = build_control_plane(cfg, retriever=index, device=device)  # device=None: the card
    cuda = cp.planner.engine.device.type == "cuda"
    try:
        t0 = time.monotonic()
        records = await cp.registry.list_services()
        load_s = time.monotonic() - t0
        t0 = time.monotonic()
        await cp.startup()
        startup_s = time.monotonic() - t0
        engine, planner = cp.planner.engine, cp.planner
        names = {r.name for r in records}
        k = cfg.planner.shortlist_top_k
        rng = random.Random(0)
        intents = [intent_for(records, rng) for _ in range(n_intents)]
        rng = random.Random(1)
        probe_intents = [intent_for(records, rng) for _ in range(64)]
        probes = [index.embedder.embed(i) for i in probe_intents]
        # Grammar builds (one a new shortlist) and admission scans that
        # deferred a request for its grammar (the homogeneous slab serves one
        # grammar at a time), counted around the planner and the slab.
        counts = {"grammar_builds": 0, "grammar_build_s": 0.0, "slot_deferrals": 0}
        build, compatible = planner._build_grammar, engine._slab.compatible

        def counted_build(*a, **kw):
            t = time.monotonic()
            try:
                return build(*a, **kw)
            finally:
                counts["grammar_builds"] += 1
                counts["grammar_build_s"] += time.monotonic() - t

        def counted_compatible(r) -> bool:
            ok = compatible(r)
            counts["slot_deferrals"] += not ok
            return ok

        planner._build_grammar, engine._slab.compatible = counted_build, counted_compatible

        try:
            q0 = engine.queue_stats()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            sync()
            reset_kernel_launches()
            t0 = time.monotonic()
            served = await timed_plans(cp, intents)
            wall = time.monotonic() - t0
            launches = kernel_launches()
            if cuda:
                check_tickets(f"registry_100k_{size}")
            q1 = engine.queue_stats()
            burst_counts = dict(counts)
            stop = asyncio.Event()
            during = asyncio.create_task(shortlists_while(index, probes, k, stop))
            try:
                await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
            finally:
                stop.set()
                busy = await during
            q2 = engine.queue_stats()
            await idle(engine)
            sync()
            quiet = rank_quantiles([rank_ms(index, q, k) for q in probes])
        finally:
            planner._build_grammar, engine._slab.compatible = build, compatible
        plans = [p for p, _ in served]
        lat = sorted(ms for _, ms in served)
        for p in plans:
            p.validate()
        foreign = sorted({n.service for p in plans for n in p.nodes} - names)
        near, bad = shortlist_agreement(index, intents + probe_intents, k)
        stats = dict(
            model=size, services=len(records), intents=n_intents, record_load_s=load_s, startup_s=startup_s,
            wall_s=wall, plans_per_s=n_intents / wall, p50_ms=nearest_rank(lat, 0.5), max_ms=lat[-1],
            origins={o: sum(p.origin == o for p in plans) for o in {p.origin for p in plans}},
            launches=launches, **loop_counts(engine, q0, q1, n_intents), **burst_counts,
            repeat_captures=q2["captures"] - q1["captures"],
            repeat_grammar_builds=counts["grammar_builds"] - burst_counts["grammar_builds"],
            shortlist_ms={"during_burst": busy, "idle": quiet, "k": k},
            table_bytes=index._table.numel() * index._table.element_size(),
            max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else None,
            near_ties=near, unknown_services=foreign,
        )
        emit(f"registry_100k_{size}", card, **stats)
        no_new_captures(f"registry_100k_{size}", q1, q2)
        if foreign:
            raise SystemExit(f"registry_100k_{size}: plans name services outside the registry: {foreign[:5]}")
        if bad:
            raise SystemExit(f"registry_100k_{size}: device and host shortlists differ beyond a near-tie: {bad[:3]}")
        if cuda and launches["ragged_paged_attention"] <= 0:
            raise SystemExit(f"registry_100k_{size}: the kernel was not launched in the burst")
        return stats
    finally:
        await cp.aclose()


async def snapshot_phase(index, intents: list, card: str, path: str, device=None) -> dict:
    """The built index saved, then loaded into a fresh one of the same
    config (``compute="auto"``): the table on the index's device again, ``version`` -1, and
    every intent's shortlist equal to the built index's."""
    from mcpx_torch.core.config import PlannerConfig, RetrievalConfig
    from mcpx_torch.retrieval.index import RetrievalIndex

    k = PlannerConfig().shortlist_top_k
    t0 = time.monotonic()
    index.save(path)
    save_s = time.monotonic() - t0
    fresh = RetrievalIndex(index.config, device=device)
    t0 = time.monotonic()
    fresh.load(path)
    load_s = time.monotonic() - t0
    differ = [i for i in intents if await fresh.shortlist(i, k) != await index.shortlist(i, k)]
    table = fresh._table
    stats = dict(file_bytes=os.path.getsize(path), save_s=save_s, load_s=load_s, version=fresh.version,
                 table_device=str(table.device) if table is not None else None, intents=len(intents),
                 differing=differ[:5])
    emit("registry_snapshot", card, **stats)
    if table is None or table.device.type != index.device.type or fresh.version != -1 or differ:
        raise SystemExit(f"registry snapshot: reload not on {index.device}, not provisional or different: {stats}")
    return stats


async def sharded_phase(index, intents: list, card: str, path: str, device=None, rounds: int = 4) -> dict:
    """``registry_sharded``: ``registry_snapshot``'s file loaded into a
    ``ShardedRetrievalIndex`` of two row shards on the index's device. Every
    intent's shortlist must equal the unsharded device index's, but where
    their plain rankings part on a near-tie (printed); both rankings timed
    on an idle card, p50 and p99 (the sharded one: a top-k a shard and the
    merge on the host)."""
    from mcpx_torch.cluster.sharding import ShardedRetrievalIndex
    from mcpx_torch.core.config import PlannerConfig

    k = PlannerConfig().shortlist_top_k
    sharded = ShardedRetrievalIndex(index.config, n_shards=2, device=device)
    t0 = time.monotonic()
    sharded.load(path)
    load_s = time.monotonic() - t0
    near, bad = [], []
    for intent in intents:
        if await sharded.shortlist(intent, k) == await index.shortlist(intent, k):
            continue
        q = index.embedder.embed(intent)
        a, b = sharded._base_order(q, k), index._device_topk(q, k)[1]
        scores = index._table_np @ q
        gap = max([float(abs(scores[x] - scores[y])) for x, y in zip(a, b) if x != y] or [0.0])
        (near if a != b and gap < SCORE_NEAR_TIE else bad).append(dict(intent=intent, sharded=a, unsharded=b,
                                                                        max_gap=gap))
    probes = [index.embedder.embed(i) for i in intents]
    timed = {"sharded": [], "unsharded": []}
    for _ in range(rounds):
        for q in probes:
            t = time.perf_counter()
            sharded._base_order(q, k)
            t1 = time.perf_counter()
            index._device_topk(q, k)
            timed["sharded"].append((t1 - t) * 1e3)
            timed["unsharded"].append((time.perf_counter() - t1) * 1e3)
    stats = dict(shards=sharded.shard_sizes, shard_devices=sorted({str(t.device) for t in sharded._shards}),
                 load_s=load_s, intents=len(intents), near_ties=near, differing=bad[:3],
                 rank_ms={name: quantiles_ms(v) for name, v in timed.items()})
    emit("registry_sharded", card, **stats)
    if bad or not sharded._shards or stats["shard_devices"] != [str(index._table.device)]:
        raise SystemExit(f"registry sharded: shortlists differ from the unsharded index's or shards misplaced: {stats}")
    return stats


def sp_backends(path: str, texts: list) -> dict:
    """Where the ``sentencepiece`` package is installed (``backend="auto"``
    takes it), the package against the in-tree codec on one model file:
    the texts whose ids are equal, whose decoded ids are equal, and whether
    the per-id surfaces (``token_bytes``) are the same list."""
    from mcpx_torch.models.tokenizer import SentencePieceTokenizer

    intree = SentencePieceTokenizer(path, backend="intree")
    try:
        pkg = SentencePieceTokenizer(path, backend="package")
    except ImportError:
        return {"package": None}
    ids = [(pkg.encode(t), intree.encode(t)) for t in texts]
    differ = [t for t, (a, b) in zip(texts, ids) if a != b]
    return dict(
        package=True, texts=len(texts), ids_equal=len(texts) - len(differ),
        decode_equal=sum(pkg.decode(b) == intree.decode(b) for _, b in ids),
        token_bytes_equal=pkg.token_bytes() == intree.token_bytes(), first_differing=differ[:2],
    )


async def sp_phase(size: str, checkpoint: str, n_intents: int, card: str, batch: int = 64, device=None,
                   n_services: int = 1000) -> dict:
    """Phase 21: ``model.vocab="sp:<path>"`` with ``tiny_model()``'s file,
    random weights (seed 0) over ``n_services`` services: a burst of
    ``n_intents`` concurrent ``/plan``s, then a repeat that captures nothing.
    Every plan LLM-authored and valid, its steps JSON parses, and the kernel
    launched."""
    import tempfile

    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.models.sp_model import tiny_model
    from mcpx_torch.models.tokenizer import SentencePieceTokenizer
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    with tempfile.TemporaryDirectory() as d:
        vocab = os.path.join(d, "tiny.model")
        tiny_model().save(vocab)
        cfg = config(size, checkpoint, batch)
        cfg.model.vocab = f"sp:{vocab}"
        cp = build_control_plane(cfg, device=device)  # device=None: the card
        cuda = cp.planner.engine.device.type == "cuda"
        records = synth_registry(n_services, seed=0)
        for rec in records:
            await cp.registry.put(rec)
        try:
            t0 = time.monotonic()
            await cp.startup()
            startup_s = time.monotonic() - t0
            engine = cp.planner.engine
            rng = random.Random(0)
            intents = [intent_for(records, rng) for _ in range(n_intents)]
            q0 = engine.queue_stats()
            sync()
            reset_kernel_launches()
            t0 = time.monotonic()
            served = await timed_plans(cp, intents)
            wall = time.monotonic() - t0
            launches = kernel_launches()
            plans = [p for p, _ in served]
            lat = sorted(ms for _, ms in served)
            q1 = engine.queue_stats()
            await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
            q2 = engine.queue_stats()
            steps_json = []
            for p in plans:
                p.validate()
                steps_json.append(json.loads(p.to_steps_json()))
            texts = intents + [p.to_steps_json() for p in plans] + [r.name for r in records[:32]]
            stats = dict(
                backend="package" if engine.tokenizer._sp is not None else "intree",
                backends=sp_backends(vocab, texts),
                model=size, vocab="sp:tiny_model", vocab_size=engine.tokenizer.vocab_size, services=n_services,
                intents=n_intents, startup_s=startup_s, wall_s=wall, plans_per_s=n_intents / wall,
                p50_ms=nearest_rank(lat, 0.5), max_ms=lat[-1],
                origins={o: sum(p.origin == o for p in plans) for o in {p.origin for p in plans}},
                launches=launches, **loop_counts(engine, q0, q1, n_intents),
                repeat_captures=q2["captures"] - q1["captures"], steps=[len(s["steps"]) for s in steps_json],
            )
            emit(f"sp_{size}", card, **stats)
            no_new_captures(f"sp_{size}", q1, q2)
            if not isinstance(engine.tokenizer, SentencePieceTokenizer):
                raise SystemExit(f"sp_{size}: the engine's tokenizer is {type(engine.tokenizer).__name__}")
            if stats["origins"] != {"llm": n_intents}:
                raise SystemExit(f"sp_{size}: not every plan is LLM-authored: {stats['origins']}")
            b = stats["backends"]
            if b["package"] and not (b["ids_equal"] == b["decode_equal"] == b["texts"] and b["token_bytes_equal"]):
                raise SystemExit(f"sp_{size}: the sentencepiece package and the in-tree codec disagree: {b}")
            if cuda and launches["ragged_paged_attention"] <= 0:
                raise SystemExit(f"sp_{size}: the kernel was not launched")
            return stats
        finally:
            await cp.aclose()


async def config_surface(card: str, sizes=(("test", CKPT, 16), ("2b", "", 8)), n: int = REGISTRY_N,
                         batch: int = 64, device=None, threshold: int = 65536, keep: "dict | None" = None) -> list:
    """Phase 20 (``registry_index``, then ``registry_100k_<size>`` for each
    width on the one index, then ``registry_snapshot`` and
    ``registry_sharded``) in a temporary directory the phase removes.
    ``keep``, when given, receives the built index and the intents of the
    snapshot checks (``index``, ``intents``) for phase 24."""
    import tempfile

    from mcpx_torch.utils.synth import intent_for

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "registry.json")
        index, records = await registry_index(path, card, n, device=device, threshold=threshold)
        runs = [await registry_phase(size, ckpt, m, card, index, path, batch=batch, device=device)
                for size, ckpt, m in sizes]
        rng = random.Random(0)
        intents = [intent_for(records, rng) for _ in range(32)]
        snap = os.path.join(d, "index.snap")
        await snapshot_phase(index, intents, card, snap, device=device)
        await sharded_phase(index, intents, card, snap, device=device)
        if keep is not None:
            keep.update(index=index, intents=intents)
        return runs


# ------------------------------------------------------------ cluster
CLUSTER_FAMILIES = (
    "mcpx_cluster_replicas_ready", "mcpx_cluster_replica_state", "mcpx_cluster_replica_depth",
    "mcpx_cluster_replica_eta_seconds", "mcpx_cluster_replica_skew", "mcpx_cluster_routed_requests_total",
    "mcpx_cluster_affinity_hits_total", "mcpx_cluster_resteers_total",
)


def cluster_config(size: str, checkpoint: str, batch: int, snapshot_dir: str):
    """Phases 5-6's settings served by a pool of two replicas: prefix
    affinity, burn-aware placement (with the SLO tracker and the ledger),
    the retrieval index sharded one shard a replica (host mode at 1k rows),
    the tiered KV cache with each replica's warm-restart snapshot in
    ``snapshot_dir``."""
    cfg = config(size, checkpoint, batch)
    cfg.cluster.enabled, cfg.cluster.replicas = True, 2
    cfg.cluster.affinity = cfg.cluster.burn_aware = cfg.cluster.shard_registry = True
    cfg.cluster.warm_snapshot_dir = snapshot_dir
    cfg.engine.kv_tier.enabled = True
    cfg.slo.enabled = True
    cfg.telemetry.ledger.enabled = True
    cfg.validate()
    return cfg


def settled_memory() -> int:
    """Bytes allocated on the card once its work is done and Python's
    garbage is collected, read while no engine's worker holds the device."""
    from mcpx_torch.engine.engine import DEVICE_LOCK

    with DEVICE_LOCK:
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()


async def steered_plan(cp, index: int, intent: str):
    """``intent``'s ``/plan`` served by replica ``index`` alone: the other
    replicas are taken out of routing (as a drain does) for the request."""
    others = [r for r in cp.cluster.replicas if r.index != index and r.state == "ready"]
    for r in others:
        r.state = "draining"
    try:
        plan, _ = await cp.plan(intent, use_cache=False)
    finally:
        for r in others:
            r.state = "ready"
    return plan


def per_replica(pool, key: str) -> list:
    return [r.engine.queue_stats()[key] for r in pool.replicas]


def routed_by_trace(pool) -> dict:
    """trace id -> replica of every routing decision in the pool's ring."""
    return {d["trace_id"]: d["replica"] for d in pool._pipeline.recent_decisions() if d["trace_id"]}


async def busiest_replica(pool, timeout_s: float = 20.0) -> int:
    """The replica with rows on its slab (the most pool-side in-flight
    requests among them), once one has."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        busy = [r for r in pool.replicas if r.routable and r.inflight and r.engine.queue_stats()["active_rows"]]
        if busy:
            return max(busy, key=lambda r: r.inflight).index
        await asyncio.sleep(0.001)
    raise SystemExit("cluster: no replica had rows in flight during the kill burst")


async def cluster_phase(size: str, checkpoint: str, n_intents: int, card: str, single: dict, single_plans: list,
                        batch: int = 64, device=None) -> dict:
    """Phase 22 at one width (``cluster_<size>``): ``build_control_plane``
    with ``cluster.enabled`` (two replicas on the card), its scoreboard
    refreshed by the pool's loop as the app runs it. Traffic: the width's
    intents (phase 5's or 6's) from emptied trees; their repeat, which
    captures nothing on either replica; a burst during which the replica
    with rows on its slab is killed (its requests resteer to the survivor);
    the rejoin, restoring its snapshot, and one intent it served before
    the kill, sent to it alone; a burst during which the other replica
    drains, and its rejoin. Every plan LLM-authored (at test) and valid,
    naming only registry services; at test the first burst's plans equal
    ``single_plans`` (phase 5's), at 2b a differing plan is printed. Gates:
    a resteer, 0 pins and 0 tickets after, generation 1 and restored runs
    on each rejoined replica, its warm request prefilling fewer tokens than
    its prompt, allocated bytes after each rejoin within 2% of before its
    replica went, the replicas' own launches adding up to the process's,
    the journal's kill, resteer, drain and rejoin, the ``mcpx_cluster_*``
    families in the exposition."""
    import tempfile

    from mcpx_torch.cluster.sharding import ShardedRetrievalIndex
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.telemetry.tracing import Tracer
    from mcpx_torch.utils.synth import intent_for, synth_registry

    t_phase = time.monotonic()
    with tempfile.TemporaryDirectory() as snap_dir:
        cp = build_control_plane(cluster_config(size, checkpoint, batch, snap_dir), device=device)
        pool = cp.cluster
        cuda = pool.device.type == "cuda"
        records = synth_registry(1000, seed=0)
        names = {r.name for r in records}
        for rec in records:
            await cp.registry.put(rec)
        scoreboard = None
        try:
            t0 = time.monotonic()
            await cp.startup()  # both replicas start together: their warm captures overlap
            startup_s = time.monotonic() - t0
            scoreboard = asyncio.create_task(pool.run_scoreboard())
            rng = random.Random(0)
            intents = [intent_for(records, rng) for _ in range(n_intents)]
            tracer = Tracer(enabled=True, sample_rate=1.0, ring_size=max(256, 8 * n_intents))
            checked: list = []

            def check(where: str, plans: list) -> None:
                for p in plans:
                    p.validate()
                foreign = sorted({n.service for p in plans for n in p.nodes} - names)
                origins = {o: sum(p.origin == o for p in plans) for o in {p.origin for p in plans}}
                checked.append((where, origins))
                if foreign:
                    raise SystemExit(f"cluster_{size} {where}: plans name services outside the registry: {foreign}")
                if size == "test" and origins != {"llm": len(plans)}:
                    raise SystemExit(f"cluster_{size} {where}: not every plan is LLM-authored: {origins}")

            await pool.drop_unpinned()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            sync()
            reset_kernel_launches()
            n0, own0 = kernel_launches(), pool.replica_launches()
            resteers0 = pool.resteers
            # 1. the width's intents, from emptied trees; the pool's engine
            # calls recorded, for the near-ties against one engine below
            calls: list = []
            real_generate = pool.generate

            async def recording(prompt_ids, **kw):
                res = await real_generate(prompt_ids, **kw)
                calls.append((tuple(prompt_ids), kw, res))
                return res

            pool.generate = recording
            try:
                t0 = time.monotonic()
                plans, recs = await traced_burst(cp, intents, tracer)
                wall = time.monotonic() - t0
            finally:
                del pool.generate
            check("burst", plans)
            lat = sorted(r.total_ms for r in recs)
            where = routed_by_trace(pool)
            served_by = [where.get(r.trace_id) for r in recs]
            differ = [i for i, (a, b) in enumerate(zip(plans, single_plans)) if a.to_json() != b.to_json()]
            if size == "test" and differ:
                raise SystemExit(f"cluster_test: plans {differ} differ from serve_test's")
            margins = await pool_near_ties(pool, calls, size, card)
            # 2. the repeat captures nothing on either replica
            c0 = per_replica(pool, "captures")
            repeat, _ = await traced_burst(cp, intents, tracer)
            check("repeat", repeat)
            repeat_captures = [b - a for a, b in zip(c0, per_replica(pool, "captures"))]
            # 3. kill the replica with rows on its slab, mid-burst
            mem_before_kill = settled_memory() if cuda else 0
            tasks = [asyncio.create_task(traced_burst(cp, [i], tracer)) for i in intents]
            victim = await busiest_replica(pool)
            inflight_at_kill = pool.replicas[victim].inflight
            await pool.kill(victim)
            killed = [(await t)[0][0] for t in tasks]
            check("kill_burst", killed)
            resteers = pool.resteers - resteers0
            # 4. rejoin from its snapshot; one intent it served, alone on it
            t0 = time.monotonic()
            await pool.rejoin(victim)
            rejoin_s = time.monotonic() - t0
            back = pool.replicas[victim]
            restored_pages = back.engine.queue_stats()["prefix_host_pages"]
            mine = [i for i, r in zip(intents, served_by) if r == victim] or intents[:1]
            other = pool.replicas[1 - victim]
            p0 = back.engine.queue_stats()["prefill_tokens"]
            warm_plan = await steered_plan(cp, victim, mine[0])
            warm_prefill = back.engine.queue_stats()["prefill_tokens"] - p0
            check("warm", [warm_plan])
            mem_after_rejoin = settled_memory() if cuda else 0
            # 5. drain the other replica under a burst, then rejoin it
            mem_before_drain = mem_after_rejoin
            tasks = [asyncio.create_task(traced_burst(cp, [i], tracer)) for i in intents]
            t0 = time.monotonic()
            while not other.inflight and time.monotonic() - t0 < 20.0:
                await asyncio.sleep(0.001)
            inflight_at_drain = other.inflight
            await pool.drain(other.index)
            drained = [(await t)[0][0] for t in tasks]
            check("drain_burst", drained)
            await pool.rejoin(other.index)
            await steered_plan(cp, other.index, intents[0])  # its grammar tables, as before it drained
            mem_after_drain_rejoin = settled_memory() if cuda else 0
            await idle(pool)
            sync()
            launches = kernel_launches()
            own = pool.replica_launches()
            own_delta = {i: own[i]["ragged_paged_attention"] - own0[i].get("ragged_paged_attention", 0) for i in own}
            global_delta = launches["ragged_paged_attention"] - n0["ragged_paged_attention"]
            if cuda:
                check_tickets(f"cluster_{size}")
            pins = per_replica(pool, "prefix_pins")
            snap = pool.scoreboard_snapshot()
            text = cp.metrics.render().decode()
            missing = [f for f in CLUSTER_FAMILIES if f not in text]
            rows = {r["replica"]: r for r in snap["replicas"]}
            stats = dict(
                model=size, replicas=len(pool.replicas), intents=n_intents, startup_s=startup_s,
                wall_s=wall, plans_per_s=n_intents / wall, p50_ms=lat[len(lat) // 2], max_ms=lat[-1],
                single_plans_per_s=single["plans_per_s"], single_p50_ms=single["p50_ms"],
                served_by=served_by, plans_differing_from_single=differ, near_tie_margins=margins,
                checked=checked,
                routed={i: rows[i]["routed"] for i in rows}, affinity_hits={i: rows[i]["affinity_hits"] for i in rows},
                skew=snap["skew"], journal_counts=snap["journal_counts"], repeat_captures=repeat_captures,
                capture_counts={i: len(c) for i, c in pool.capture_counts().items()},
                victim=victim, inflight_at_kill=inflight_at_kill, inflight_at_drain=inflight_at_drain,
                resteers=resteers, rejoin_s=rejoin_s,
                generations=[r.generation for r in pool.replicas], restored_host_pages=restored_pages,
                warm_prefill_tokens=warm_prefill, warm_prompt_tokens=len(warm_plan.prompt_ids),
                memory_before_kill=mem_before_kill, memory_after_rejoin=mem_after_rejoin,
                memory_before_drain=mem_before_drain, memory_after_drain_rejoin=mem_after_drain_rejoin,
                max_memory_allocated=torch.cuda.max_memory_allocated() if cuda else None,
                weight_bytes=[n_bytes_of(r.engine) for r in pool.replicas],
                launches=launches, launches_delta=global_delta, own_launches_delta=own_delta,
                ledger_totals={k: v for k, v in pool.ledger_totals().items() if k != "by_executable"},
                pins=pins, retriever=type(cp.retriever).__name__, shards=getattr(cp.retriever, "shard_sizes", None),
                seconds=time.monotonic() - t_phase,
            )
            emit(f"cluster_{size}", card, **stats)
            if size != "test" and differ:
                emit(f"cluster_{size}_differing", card, plans=[
                    dict(intent=i, pool=plans[i].to_json(), single=single_plans[i].to_json()) for i in differ])
            journal = {k for k in ("kill", "resteer", "drain", "rejoin") if snap["journal_counts"].get(k)}
            failures = [
                (any(repeat_captures), f"the repeat captured {repeat_captures}"),
                (resteers < 1, "no request resteered in the kill burst"),
                (any(pins), f"pins left {pins}"),
                (stats["generations"] != [1, 1], f"generations {stats['generations']}"),
                (restored_pages <= 0, "the rejoined replica restored no run"),
                (not 0 < warm_prefill < len(warm_plan.prompt_ids),
                 f"warm request prefilled {warm_prefill} of {len(warm_plan.prompt_ids)} tokens"),
                (cuda and abs(mem_after_rejoin - mem_before_kill) > 0.02 * mem_before_kill,
                 f"allocated {mem_after_rejoin} after the rejoin against {mem_before_kill} before the kill"),
                (cuda and abs(mem_after_drain_rejoin - mem_before_drain) > 0.02 * mem_before_drain,
                 f"allocated {mem_after_drain_rejoin} after the rejoin against {mem_before_drain} before the drain"),
                (sum(own_delta.values()) != global_delta, f"own launches {own_delta} against {global_delta}"),
                (cuda and global_delta <= 0, "the kernel was not launched"),
                (journal != {"kill", "resteer", "drain", "rejoin"}, f"journal holds {sorted(journal)}"),
                (bool(missing), f"exposition lacks {missing}"),
                (not isinstance(cp.retriever, ShardedRetrievalIndex), "the registry is not sharded"),
            ]
            bad = [why for failed, why in failures if failed]
            if bad:
                raise SystemExit(f"cluster_{size}: " + "; ".join(bad))
            return stats
        finally:
            if scoreboard is not None:
                scoreboard.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await scoreboard
            await cp.aclose()


async def pool_near_ties(pool, calls: list, size: str, card: str) -> list:
    """The pool's recorded engine calls served again by replica 0's engine
    alone, from an emptied tree and as one cohort (as the single engine
    served its burst): each greedy stream that differs is printed with the
    top-2 margin of its masked logits at the first differing token
    (``greedy_differences``; at test a difference fails). Returns the
    margins."""
    engine = pool.replicas[0].engine
    # The planner leaves the sampling settings at the engine's defaults.
    default = {"temperature": engine.config.engine.temperature, "constrained": True}
    a = {i: (p, {**default, **kw}, res) for i, (p, kw, res) in enumerate(sorted(calls, key=lambda c: c[0]))}
    await idle(pool)
    await engine.drop_unpinned()
    with one_cohort(engine, len(a)):
        alone = await asyncio.gather(*(engine.generate(list(p), **kw) for p, kw, _ in a.values()))
    b = {i: (p, kw, res) for (i, (p, kw, _)), res in zip(a.items(), alone)}
    return greedy_differences(f"cluster_{size}", size, card, engine, a, b)


# ------------------------------------------------------------ offline path
FP32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores (NVIDIA datasheet)
# The reference package's own plan-quality figures (README.md: its CPU
# ``eval-planner`` runs of the committed checkpoint), not the port's.
EVAL_REFERENCE = {
    "registry": {"constrain_names": "registry", "quantize": "none", "score": 0.86, "node_f1": 0.75},
    "shortlist": {"constrain_names": "shortlist", "quantize": "none", "score": 0.956, "node_f1": 0.861},
    "shortlist_int8": {"constrain_names": "shortlist", "quantize": "int8", "score": 0.949, "node_f1": 0.854},
}
EVAL_TOLERANCE = 0.05


def timed_train(size: str, corpus, tcfg, device, init=None, mesh=None) -> tuple:
    """``models.train.train`` at ``size`` (the BPE vocab), with the wall
    time at each logged step: ``log_fn`` runs after the step's loss is read
    back, so consecutive stamps bracket the steps between them. Returns
    (params, report, stamps, wall seconds)."""
    from mcpx_torch.models.bpe import BPETokenizer
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.models.train import train

    cfg = GemmaConfig.named(size, vocab_size=BPETokenizer().vocab_size)
    stamps: list = []
    t0 = time.monotonic()
    params, report = train(cfg, corpus, tcfg, device=device, init=init, mesh=mesh,
                           log_fn=lambda _m: stamps.append(time.monotonic()))
    return params, report, stamps, time.monotonic() - t0


def per_step_ms(stamps: list, steps_between: int) -> float:
    return (stamps[-1] - stamps[0]) * 1e3 / steps_between if len(stamps) > 1 else math.nan


@contextlib.contextmanager
def recording_margins(out: list):
    """While open, every plan generation of any engine appends (least top-2
    margin of its masked logits, its position, its text), computed when the
    call returns, on the engine's weights (``stream_margin``)."""
    from mcpx_torch.engine.engine import DEVICE_LOCK, InferenceEngine

    real = InferenceEngine.generate

    async def generate(self, prompt_ids, **kw):
        res = await real(self, prompt_ids, **kw)
        if kw.get("max_new_tokens") != 1:  # not the planner's one-token warm-up
            with DEVICE_LOCK:
                out.append((*stream_margin(self, prompt_ids, kw, res.token_ids), res.text))
        return res

    InferenceEngine.generate = generate
    try:
        yield
    finally:
        InferenceEngine.generate = real


def offline_phase(card: str, device="cuda", *, n_examples: int = 512, registry_size: int = 1000,
                  parity_steps: int = 20, test_steps: int = 200, big: str = "2b", big_steps: int = 6,
                  eval_intents: int = 48, eval_registry: int = 1000, serve_trained: bool = True) -> dict:
    """Phase 23, the offline path on ``device``: the planner corpus; the
    test preset trained from the committed checkpoint on the device and on
    the CPU, step for step (``train_parity_test``); trained from random
    init (``train_test``); ``big`` (the 2b preset) at full width from
    random float32 weights (``train_<big>``); the parity run's weights saved,
    loaded and served through the kernel (``train_serve_test``); and the
    committed checkpoint's plan quality at each tier (``eval_test``)."""
    import tempfile

    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.models.bpe import BPETokenizer
    from mcpx_torch.models.corpus import CorpusConfig, build_corpus_sync
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.models.gemma.params import load_npz
    from mcpx_torch.models.train import TrainConfig, flatten_params, save_npz
    from mcpx_torch.planner.evaluate import evaluate_planner

    cuda = torch.device(device).type == "cuda"
    if cuda and torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("offline: TF32 matmuls are on; the trainer runs in full float32")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out: dict = {}
    t0 = time.monotonic()
    corpus = build_corpus_sync(BPETokenizer(), CorpusConfig(n_examples=n_examples, registry_size=registry_size, seed=0),
                               device=device)
    L = corpus.tokens.shape[1]
    emit("corpus", card, rows=corpus.tokens.shape[0], seq_len=L, dropped=corpus.n_dropped,
         filtered=corpus.n_filtered, teacher_coverage=corpus.teacher_coverage, host_s=time.monotonic() - t0)

    # The committed checkpoint, cast to float32, trained on the device and on
    # the CPU over the same rows.
    tcfg = TrainConfig(steps=parity_steps, batch_size=24, lr=3e-3, warmup_steps=5, log_every=1)
    runs = {}
    for dev in (device, "cpu"):
        params, report, stamps, _ = timed_train("test", corpus, tcfg, dev, init=load_npz(CKPT, "cpu", torch.float32))
        runs[dev] = (params, report, per_step_ms(stamps, parity_steps - 1))
    (p_dev, r_dev, ms_dev), (p_cpu, r_cpu, ms_cpu) = runs[device], runs["cpu"]
    rel = [abs(a - b) / abs(b) for (_, a), (_, b) in zip(r_dev["loss_log"], r_cpu["loss_log"])]
    flat_dev, flat_cpu = flatten_params(p_dev), flatten_params(p_cpu)
    param_err = max(float((flat_dev[k].cpu() - flat_cpu[k]).abs().max()) for k in flat_cpu)
    emit("train_parity_test", card, steps=parity_steps, batch=24, lr=3e-3, warmup=5,
         losses=[x for _, x in r_dev["loss_log"]], cpu_losses=[x for _, x in r_cpu["loss_log"]],
         max_rel_loss_err=max(rel), rtol=1e-3, max_abs_param_err=param_err, step_ms=ms_dev, cpu_step_ms=ms_cpu,
         eval_token_accuracy=r_dev.get("eval_token_accuracy"), cpu_eval_token_accuracy=r_cpu.get("eval_token_accuracy"))
    if len(rel) != parity_steps or max(rel) > 1e-3:
        raise SystemExit(f"train_parity_test: the device's losses leave the CPU's by {max(rel)} (rtol 1e-3)")

    # The test preset from the port's random init: the reference's own gate.
    B = 24
    tcfg = TrainConfig(steps=test_steps, batch_size=B, warmup_steps=20, log_every=50)
    _, report, stamps, wall = timed_train("test", corpus, tcfg, device)
    host_ms = per_step_ms(stamps, test_steps - 1)
    prof_steps = 20
    with (_profiler() if cuda else contextlib.nullcontext()) as prof:
        t1 = time.monotonic()
        timed_train("test", corpus, TrainConfig(steps=prof_steps, batch_size=B, warmup_steps=5, log_every=0), device)
        sync()
        prof_wall = time.monotonic() - t1
    breakdown = device_breakdown(prof, prof_wall) if cuda else {}
    device_ms = breakdown["device_busy_ms"] / prof_steps if cuda else math.nan
    out["train_test"] = dict(
        steps=test_steps, batch=B, seq_len=L, warmup=20, first_loss=report["first_loss"],
        final_loss=report["final_loss"], eval_token_accuracy=report.get("eval_token_accuracy"),
        steps_per_s=1e3 / host_ms, tokens_per_s=B * L * 1e3 / host_ms, host_ms_per_step=host_ms,
        device_ms_per_step=device_ms, device_idle_share=1.0 - device_ms / host_ms if cuda else math.nan,
        wall_s=wall, profiled=dict(steps=prof_steps, top=breakdown.get("top", [])[:5]),
    )
    emit("train_test", card, **out["train_test"])
    if not report["final_loss"] < 0.7 * report["first_loss"]:
        raise SystemExit(f"train_test: final loss {report['final_loss']} not below 0.7 x first {report['first_loss']}")

    # The big preset at full width, random float32 weights.
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    allocated0 = torch.cuda.memory_allocated() if cuda else 0
    Bb = 8
    cfg = GemmaConfig.named(big, vocab_size=BPETokenizer().vocab_size)
    tcfg = TrainConfig(steps=big_steps, batch_size=Bb, lr=3e-4, warmup_steps=2, log_every=1)
    params, report, stamps, wall = timed_train(big, corpus, tcfg, device)
    del params
    losses = [x for _, x in report["loss_log"]]
    step_ms = per_step_ms(stamps, big_steps - 1)  # the steps after the first
    flops = 6 * cfg.n_params * Bb * L
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    card_bytes = torch.cuda.get_device_properties(0).total_memory if cuda else 0
    out["train_big"] = dict(
        layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff, head_dim=cfg.head_dim, vocab=cfg.vocab_size,
        n_params=cfg.n_params, batch=Bb, seq_len=L, steps=big_steps, warmup=2, lr=3e-4, losses=losses,
        step_ms=step_ms, flop_per_step=flops, achieved_flop_s=flops * 1e3 / step_ms,
        fp32_peak_flop_s=FP32_FLOPS, fp32_peak_share=flops * 1e3 / step_ms / FP32_FLOPS,
        max_memory_allocated=peak, memory_allocated_before=allocated0, card_memory=card_bytes,
        eval_token_accuracy=report.get("eval_token_accuracy"), wall_s=wall,
    )
    emit(f"train_{big}", card, **out["train_big"])
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0] or (cuda and peak >= card_bytes):
        raise SystemExit(f"train_{big}: losses {losses}, peak {peak} of {card_bytes} bytes")

    if serve_trained:
        # The parity run's weights, saved and loaded, served through the kernel.
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trained.npz")
            save_npz(path, p_dev)
            stats, _, _ = asyncio.run(serve("test", path, 16, card, batch=64, name="train_serve_test"))
        if stats["origins"] != {"llm": 16}:
            raise SystemExit(f"train_serve_test: not every plan is LLM-authored: {stats['origins']}")
        out["train_serve_test"] = stats

    evals = {}
    for tier, ref in EVAL_REFERENCE.items():
        margins: list = []
        reset_kernel_launches()
        t1 = time.monotonic()
        with recording_margins(margins):
            q = asyncio.run(evaluate_planner(
                checkpoint=CKPT, n_intents=eval_intents, registry_size=eval_registry, device=device,
                constrain_names=ref["constrain_names"], quantize=ref["quantize"]))
        launches = kernel_launches()
        near = [dict(plan=i, margin=m, position=k, text=t) for i, (m, k, t) in enumerate(margins) if m < NEAR_TIE]
        evals[tier] = dict(**q, launches=launches, seconds=time.monotonic() - t1, near_ties=near,
                           least_margin=min((m for m, _, _ in margins), default=math.nan))
        emit("eval_test", card, tier=tier, port=evals[tier],
             reference_cpu=dict(score=ref["score"], node_f1=ref["node_f1"]), tolerance=EVAL_TOLERANCE)
    out["eval_test"] = evals
    if cuda:
        bad = [t for t, ref in EVAL_REFERENCE.items()
               if abs(evals[t]["score"] - ref["score"]) > EVAL_TOLERANCE or evals[t]["quantize"] != ref["quantize"]
               or evals[t]["launches"].get("ragged_paged_attention", 0) <= 0]
        if bad:
            raise SystemExit(f"eval_test: tiers {bad} leave the reference's quality by more than {EVAL_TOLERANCE}: "
                             f"{ {t: evals[t]['score'] for t in bad} }")
    return out


# ------------------------------------------------------------ parallel (phase 24)
RING_MESHES = {"seq2": dict(seq=2), "seq4": dict(seq=4), "seq8": dict(seq=8), "data2xseq4": dict(data=2, seq=4)}
RING_TOL = 2e-5  # the reference test's float32 limit (tests/test_ring_attention.py)
RING_TOP_K = 64  # services a long /plan prompt lists
SHORT_PROMPT = "plan. JSON:"


def dense_attention(q, k, v, seq_lens):
    """The port's ``_attend`` under the causal and right-padding mask the ring
    derives from ``seq_lens`` (the reference test's ``dense_reference``)."""
    from mcpx_torch.models.gemma.model import _attend

    B, T = q.shape[:2]
    pos = torch.arange(T, device=q.device)
    mask = (pos[None, None, :] <= pos[None, :, None]) & (pos[None, None, :] < seq_lens.long()[:, None, None])
    return _attend(q, k, v, mask.expand(B, T, T))


def route_run(fn, dev: torch.device, iters: int = 3) -> tuple:
    """(output, ms a call, peak bytes above what was allocated before) of
    ``fn``: one call, then ``iters`` timed ones. On the card the time is
    between CUDA events and the peak ``max_memory_allocated``; on the CPU
    host ms and no peak."""
    out = fn()
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return out, (time.perf_counter() - t) * 1e3 / iters, None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b) / iters, torch.cuda.max_memory_allocated() - base


def excess(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """Largest ``|got - want| - (atol + rtol |want|)``: at or below 0 where
    ``allclose`` holds."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def ring_attention_check(card: str, dev: torch.device, T: int = 4096, B: int = 2, K: int = 1, G: int = 8,
                         hd: int = 256) -> dict:
    """``ring_attention_2b``: the ring on virtual seq meshes of the card
    (``RING_MESHES``) against the dense ``_attend`` at 2b's attention shape,
    float32 within ``RING_TOL`` on valid positions; bf16 ring and dense
    against that float32 dense, worst error printed. Times and peak bytes
    of each route."""
    from mcpx_torch.parallel.mesh import make_mesh
    from mcpx_torch.parallel.ring_attention import ring_attention

    torch.backends.cuda.matmul.allow_tf32 = False  # the float32 limit is the reference's, without TF32
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, T, K, G, hd), np.float32)).to(dev)
    k = torch.from_numpy(rng.standard_normal((B, T, K, hd), np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((B, T, K, hd), np.float32)).to(dev)
    lens_np = np.concatenate([[T, 3], rng.integers(1, T + 1, max(B - 2, 0))])[:B]
    lens = torch.from_numpy(lens_np).to(dev)
    valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
    bf = [t.bfloat16() for t in (q, k, v)]
    dense, dense_ms, dense_peak = route_run(lambda: dense_attention(q, k, v, lens), dev)
    dense16, dense16_ms, _ = route_run(lambda: dense_attention(*bf, lens), dev)
    routes = {"dense": dict(ms=dense_ms, peak_bytes=dense_peak, ms_bf16=dense16_ms,
                            bf16_max_abs_err=float((dense16.float() - dense)[valid].abs().max()))}
    bad = []
    for name, kw in RING_MESHES.items():
        mesh = make_mesh(**kw, devices=[dev] * math.prod(kw.values()))
        out, ms, peak = route_run(lambda: ring_attention(q, k, v, lens, mesh), dev)
        out16, ms16, _ = route_run(lambda: ring_attention(*bf, lens, mesh), dev)
        over = excess(out[valid], dense[valid], RING_TOL, RING_TOL)
        routes[name] = dict(ms=ms, peak_bytes=peak, max_abs_err=float((out - dense)[valid].abs().max()),
                            allclose_excess=over, ms_bf16=ms16,
                            bf16_max_abs_err=float((out16.float() - dense)[valid].abs().max()))
        if over > 0 or not bool(torch.isfinite(out).all()) or out.dtype != v.dtype:
            bad.append(name)
    stats = dict(B=B, T=T, K=K, G=G, head_dim=hd, seq_lens=lens_np.tolist(), rtol=RING_TOL, atol=RING_TOL,
                 dense_scores_bytes=B * T * K * G * T * 4, routes=routes)
    emit("ring_attention_2b", card, **stats)
    if bad:
        raise SystemExit(f"ring_attention: meshes {bad} leave the dense route beyond rtol = atol = {RING_TOL}")
    return stats


def ring_config(size: str, checkpoint: str, batch: int):
    """Phases 5-6's settings with room for /plan prompts over a
    ``RING_TOP_K``-service shortlist (about 450 tokens at the BPE vocab: the
    512 bucket and the decode budget in 12 pages of 64 tokens, where the
    serving phases' 4 pages would clamp the list), and the prefix cache
    off for the cohort passes, so that a repeat is a full prefill again
    (``ring_serve``'s radix pass turns it on). The seq view is armed here;
    the threshold is set to the long prompts' bucket once their length is
    known."""
    cfg = config(size, checkpoint, batch)
    cfg.engine.max_pages_per_seq = 12
    cfg.engine.prefix_cache = False
    cfg.engine.ring_prefill_min_tokens = 1
    cfg.retrieval.top_k = cfg.planner.shortlist_top_k = RING_TOP_K
    cfg.validate()
    return cfg


async def ring_serve(size: str, checkpoint: str, n_intents: int, card: str, *, float32: bool, batch: int = 64,
                     device=None, mesh_shape: dict = None, devices: list = None) -> tuple[dict, list, object]:
    """``ring_serve_<size>``: an engine on a virtual ``seq=4`` mesh of its
    own device (``mesh_shape``; ``ring_serve_data4_<size>`` on ``data=4``,
    whose data coordinates the engine views as a seq axis; with
    ``devices``, a mesh of those cards, ``cross_ring_serve_*``), behind a control
    plane over ``synth_registry(1000, seed=0)``. The burst's long /plan
    prompts served as one cohort on the dense route (the engine as
    ``ring_prefill_min_tokens=0`` builds it: no seq view), then with the
    seq view back and the threshold at their bucket, then that burst once
    more (which must capture nothing), then one short prompt alone, then,
    with the prefix cache on, the longest prompt alone declaring its pages
    as a shared head, whose cold radix build is a full prefill from 0.
    On ``seq=4`` the two routes differ only in the attention of a full
    prefill. On ``data=4`` the dense route's prefill also splits the
    cohort's rows over ``data`` while the ring keeps them whole (its data
    coordinates are the seq axis), so the burst runs once more on the dense
    route with each prefill's rows whole (``whole``: the layout's
    ``model_only()`` for the prefill, the decode windows as served): the
    ring is held against that pass, and the blocked dense pass against it
    too (``blocking_*``: what the row split alone changes).
    Fails unless the dense passes rang nowhere, the plans are valid and equal
    the dense pass's with the ring's row blocks (byte for byte at test in
    float32, the blocked pass's too; at 2b a differing stream must be a
    near-tie), the ring counter equals the full prefills
    at or over the threshold in the ring pass and in the radix build, the
    short prompt stays dense, the radix-built row's tokens equal its dense
    ones (or are a near-tie at 2b), the ragged kernel ran, and a mesh
    naming a device that holds no data is refused. Returns (stats, the long prompts'
    ids, the engine's seq mesh)."""
    from mcpx_torch.core.errors import EngineError
    from mcpx_torch.engine.engine import InferenceEngine
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.models.bpe import BPETokenizer
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.parallel import transfer
    from mcpx_torch.parallel.mesh import make_mesh
    from mcpx_torch.planner.llm import LLMPlanner
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    dev = torch.device("cuda" if device is None else device)
    mesh_shape = dict(seq=4) if mesh_shape is None else mesh_shape
    tag = "" if mesh_shape == {"seq": 4} else "".join(f"{k}{v}_" for k, v in mesh_shape.items())
    name = f"{'cross_' if devices else ''}ring_serve_{tag}{size}"
    cfg = ring_config(size, checkpoint, batch)
    model_cfg = GemmaConfig.named(size, vocab_size=BPETokenizer().vocab_size)
    if float32:
        model_cfg = dataclasses.replace(model_cfg, dtype="float32")
    # A device that can hold no data: a card past the visible ones, or meta.
    other = torch.device("cuda", torch.cuda.device_count()) if dev.type == "cuda" else torch.device("meta")
    try:
        InferenceEngine(cfg, model_cfg=model_cfg, device=dev, mesh=make_mesh(data=2, devices=[dev, other]))
        raise SystemExit(f"{name}: a mesh naming {other} was not refused")
    except EngineError as e:
        refusal = str(e)
    engine = InferenceEngine(cfg, model_cfg=model_cfg, device=dev,
                             mesh=make_mesh(**mesh_shape, devices=devices or [dev] * math.prod(mesh_shape.values())))
    cp = build_control_plane(cfg, planner=LLMPlanner(engine, cfg.planner), device=dev)
    records = synth_registry(1000, seed=0)
    for rec in records:
        await cp.registry.put(rec)
    ecfg = engine.config.engine
    prefills: list = []  # (width, ring) of every full prefill
    real_prefill, real_generate = engine._dense_prefill, engine.generate
    calls: dict = {}
    prefill_layout: list = []  # the layout a full prefill runs on in place of the engine's

    def counting(tokens_d, lens_d, table_d, ring=False):
        prefills.append((int(tokens_d.shape[1]), ring))
        if not prefill_layout:
            return real_prefill(tokens_d, lens_d, table_d, ring=ring)
        served, engine._layout = engine._layout, prefill_layout[0]
        try:
            return real_prefill(tokens_d, lens_d, table_d, ring=ring)
        finally:
            engine._layout = served

    async def recording(prompt_ids, **kw):
        res = await real_generate(prompt_ids, **kw)
        calls[tuple(prompt_ids)] = ({"temperature": 0.0, **kw}, res)
        return res

    async def burst(intents: list) -> tuple:
        calls.clear()
        with one_cohort(engine, len(intents)):
            results = await asyncio.gather(*(cp.plan(i, use_cache=False) for i in intents))
        for p, _ in results:
            p.validate()
        return [p for p, _ in results], dict(calls)

    def rings() -> int:
        return int(engine.metrics.ring_prefills._only().value)

    try:
        await cp.startup()
        engine._dense_prefill, engine.generate = counting, recording
        rng = random.Random(0)
        intents = [intent_for(records, rng) for _ in range(n_intents)]
        seq_mesh = engine._seq_mesh
        if seq_mesh is None:
            raise SystemExit(f"{name}: the engine armed no seq view on {engine._mesh}")
        await idle(engine)
        # The dense pass: the engine as ``ring_prefill_min_tokens=0`` leaves
        # it (no seq view), so no prefill can take the ring route.
        engine._seq_mesh, ecfg.ring_prefill_min_tokens = None, 0
        r_dense = rings()
        dense_plans, dense_calls = await burst(intents)
        dense_prefills, dense_rings = list(prefills), rings() - r_dense
        lengths = sorted(len(p) for p in dense_calls)
        long_T = max(w for w, _ in dense_prefills)
        await idle(engine)
        engine._seq_mesh, ecfg.ring_prefill_min_tokens = seq_mesh, long_T
        prefills.clear()
        q0, r0 = engine.queue_stats(), rings()
        sync()
        reset_kernel_launches()
        transfer.reset_counts()
        t0 = time.monotonic()
        ring_plans, ring_calls = await burst(intents)
        wall = time.monotonic() - t0
        sync()
        launches, ring_moves = kernel_launches(), transfer.counts()
        q1 = engine.queue_stats()
        repeat_plans, _ = await burst(intents)
        q2 = engine.queue_stats()
        served_prefills, ring_count = list(prefills), rings() - r0
        whole_plans, whole_calls, whole_prefills, whole_rings = None, dense_calls, [], 0
        if engine._layout is not None:
            # The dense route with each prefill's rows whole, as the ring's.
            await idle(engine)
            engine._seq_mesh, ecfg.ring_prefill_min_tokens = None, 0
            prefill_layout.append(engine._layout.model_only())
            prefills.clear()
            r_whole = rings()
            whole_plans, whole_calls = await burst(intents)
            whole_prefills, whole_rings = list(prefills), rings() - r_whole
            prefill_layout.clear()
            engine._seq_mesh, ecfg.ring_prefill_min_tokens = seq_mesh, long_T
        prefills.clear()
        await idle(engine)
        short = await real_generate(engine.tokenizer.encode(SHORT_PROMPT), max_new_tokens=24)
        short_prefills, short_rings = list(prefills), rings() - r0 - ring_count
        prompts = sorted(ring_calls)
        # The radix build: the longest prompt declares its pages (as many as
        # leave a bucket and the decode budget) as a shared head; the tree is
        # empty, so the head is a full prefill from 0 at the head's bucket,
        # and the rest of the row a suffix prefill through the ragged kernel.
        await idle(engine)
        psz, head = ecfg.kv_page_size, max(prompts, key=len)
        room = ecfg.max_pages_per_seq * psz - engine._prefill_buckets[0] - ecfg.max_decode_len
        head_len = min(len(head) - 1, room) // psz * psz
        radix_T = min(b for b in engine._prefill_buckets if b >= head_len)
        ecfg.prefix_cache, ecfg.ring_prefill_min_tokens = True, radix_T
        prefills.clear()
        r_radix = rings()
        head_kw = {**whole_calls[head][0], "shared_prefix_len": head_len}
        radix = await real_generate(list(head), **head_kw)
        radix_prefills, radix_rings = list(prefills), rings() - r_radix
        if prompts != sorted(dense_calls) or prompts != sorted(whole_calls):
            raise SystemExit(f"{name}: the passes rendered different prompts")

        def differing(a: list, b: list) -> list:
            return [i for i, (x, y) in enumerate(zip(a, b)) if x.to_json() != y.to_json()]

        def streams(calls_of: dict) -> dict:
            return {i: (list(p), *calls_of[p]) for i, p in enumerate(prompts)}

        differ = differing(dense_plans, ring_plans)
        if whole_plans is None:
            ties = greedy_differences(name, size, card, engine, streams(dense_calls), streams(ring_calls))
            blocking_differ, blocking_ties = [], []
        else:
            # Blocked against whole first: its near_tie lines are the row
            # split's alone; then the ring against the pass with its blocks.
            blocking_differ = differing(dense_plans, whole_plans)
            blocking_ties = greedy_differences(f"{name} blocking", size, card, engine, streams(dense_calls),
                                               streams(whole_calls))
            ties = greedy_differences(name, size, card, engine, streams(whole_calls), streams(ring_calls))
        radix_ties = greedy_differences(f"{name} radix", size, card, engine,
                                        {0: (list(head), *whole_calls[head])}, {0: (list(head), head_kw, radix)})
    finally:
        engine._dense_prefill, engine.generate = real_prefill, real_generate
        await cp.aclose()
    if dev.type == "cuda":
        check_tickets(name)
    expected = sum(1 for w, _ in served_prefills if w >= long_T)
    stats = dict(
        model=size, dtype=model_cfg.dtype, intents=n_intents, shortlist=RING_TOP_K, prompt_tokens=lengths,
        threshold=long_T, seq_mesh=dict(seq_mesh.shape), dense_full_prefills=dense_prefills,
        dense_ring_prefills=dense_rings, full_prefills=served_prefills,
        ring_prefills=ring_count, expected_ring_prefills=expected, short_prompt_tokens=len(
            engine.tokenizer.encode(SHORT_PROMPT)), short_prefills=short_prefills, short_rings=short_rings,
        short_tokens=len(short.token_ids), radix_head_tokens=head_len, radix_threshold=radix_T,
        radix_full_prefills=radix_prefills, radix_ring_prefills=radix_rings,
        radix_tokens_equal=radix.token_ids == whole_calls[head][1].token_ids, radix_near_ties=radix_ties,
        row_blocks=None if engine._layout is None else len(engine._layout.rows(n_intents)),
        whole_full_prefills=whole_prefills, whole_ring_prefills=whole_rings,
        plans_differing_from_blocked=differ,
        plans_differing=differ if whole_plans is None else differing(whole_plans, ring_plans), near_ties=ties,
        blocking_plans_differing=blocking_differ, blocking_near_ties=blocking_ties,
        repeat_equal=[p.to_json() for p in repeat_plans] == [p.to_json() for p in ring_plans],
        wall_s=wall, plans_per_s=n_intents / wall, launches=launches,
        **loop_counts(engine, q0, q1, n_intents), repeat_captures=q2["captures"] - q1["captures"],
        other_device_refused=refusal, cards=None if not devices else [str(d) for d in seq_mesh.distinct_devices()],
        ring_transfers=ring_moves,
    )
    emit(name, card, **stats)
    no_new_captures(f"{name} repeat", q1, q2)
    if dense_rings or any(r for _, r in dense_prefills) or not dense_prefills:
        raise SystemExit(f"{name}: the dense pass rang: {dense_rings} ring prefills, {dense_prefills}")
    if whole_plans is not None and (whole_rings or any(r for _, r in whole_prefills) or not whole_prefills):
        raise SystemExit(f"{name}: the whole-row dense pass rang: {whole_rings} ring prefills, {whole_prefills}")
    if radix_rings != 1 or radix_prefills != [(radix_T, True)]:
        raise SystemExit(f"{name}: the radix build did not ring once: {radix_rings}, {radix_prefills}")
    if radix_ties and max(radix_ties) >= NEAR_TIE:
        raise SystemExit(f"{name}: the radix-built row differs, not a near-tie ({radix_ties})")
    if ring_count != expected or expected <= 0 or any(r != (w >= long_T) for w, r in served_prefills):
        raise SystemExit(f"{name}: {ring_count} ring prefills for {served_prefills} at threshold {long_T}")
    if short_rings or any(r for _, r in short_prefills) or not short_prefills:
        raise SystemExit(f"{name}: the short prompt rang or never prefilled: {short_prefills}")
    if launches.get("ragged_paged_attention", 0) <= 0 and dev.type == "cuda":
        raise SystemExit(f"{name}: the ragged kernel never ran after the ring prefill")
    if size == "test" and (differ or blocking_differ or stats["plans_differing"] or not stats["repeat_equal"]):
        raise SystemExit(f"{name}: ring plans differ from the dense route's at {differ}, the blocked dense "
                         f"pass's from the whole one's at {blocking_differ}")
    if ties and max(ties) >= NEAR_TIE or stats["plans_differing"] and not ties:
        raise SystemExit(f"{name}: plans differ at {stats['plans_differing']}, not near-ties ({ties})")
    return stats, [list(p) for p in prompts], seq_mesh


def ring_probe(size: str, card: str, prompts: list, T: int, mesh, dev: torch.device, limit: float = 1e-3) -> dict:
    """``ring_probe_<size>``: the long prompts as one cohort of width ``T``
    at ``size``
    with random weights from seed 0 in float32, ring prefill over ``mesh``
    against dense prefill: last-token logits within ``limit`` (the forward
    check's), and so the ring through the sharded forward of a virtual
    ``data=4`` mesh's layout (``sharded_ring``: the batch whole, as
    ``ring_serve_data4_*``'s ring route runs it) and the dense prefill with
    the rows split in blocks over that layout (``blocked``, its dense
    route); then the four routes in bf16 (the same weights cast), each
    one's worst error against the float32 dense logits and the other three's
    against the bf16 dense logits."""
    from mcpx_torch.models.bpe import BPETokenizer
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.models.gemma.model import init_kv_cache, prefill
    from mcpx_torch.models.gemma.params import load_or_init
    from mcpx_torch.parallel.mesh import ServeLayout, make_mesh
    from mcpx_torch.parallel.ring_attention import ring_prefill

    tok = BPETokenizer()
    tokens = torch.full((len(prompts), T), tok.pad_id, dtype=torch.long)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts])
    tokens, lens = tokens.to(dev), lens.to(dev)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(GemmaConfig.named(size, vocab_size=tok.vocab_size), dtype=dtype)
        params, _ = load_or_init(dataclasses.replace(cfg, dtype="float32"), device=dev, seed=0)
        if dtype == "bfloat16":
            params = {k: {kk: vv.bfloat16() for kk, vv in v.items()} if isinstance(v, dict) else v.bfloat16()
                      for k, v in params.items()}
        with torch.inference_mode():
            dense, _ = prefill(params, cfg, tokens, lens, init_kv_cache(cfg, len(prompts), T, device=dev),
                               last_only=True)
            ring, _ = ring_prefill(params, cfg, tokens, lens, mesh, init_kv_cache(cfg, len(prompts), T, device=dev),
                                   last_only=True)
            layout = ServeLayout(make_mesh(data=4, devices=[dev] * 4), cfg)
            sharded_ring, _ = ring_prefill(params, cfg, tokens, lens, mesh,
                                           init_kv_cache(cfg, len(prompts), T, device=dev), last_only=True,
                                           layout=layout)
            blocked, _ = prefill(params, cfg, tokens, lens, init_kv_cache(cfg, len(prompts), T, device=dev),
                                 last_only=True, layout=layout)
        out[dtype] = {"dense": dense.float(), "ring": ring.float(), "sharded_ring": sharded_ring.float(),
                      "blocked": blocked.float()}
        del params
        gc.collect()
    f32, b16 = out["float32"], out["bfloat16"]

    def err(a, b) -> float:
        return float((a - b).abs().max())

    routes = ("ring", "sharded_ring", "blocked")
    stats = dict(model=size, rows=len(prompts), width=T, seq_mesh=dict(mesh.shape), layout_mesh={"data": 4},
                 **{f"float32_{r}_vs_dense": err(f32[r], f32["dense"]) for r in routes}, limit=limit,
                 **{f"bf16_{r}_vs_float32": err(b16[r], f32["dense"]) for r in ("dense", *routes)},
                 **{f"bf16_{r}_vs_dense": err(b16[r], b16["dense"]) for r in routes},
                 finite=all(bool(torch.isfinite(t).all()) for by in out.values() for t in by.values()))
    emit(f"ring_probe_{size}", card, **stats)
    if not stats["finite"] or max(stats[f"float32_{r}_vs_dense"] for r in routes) > limit:
        raise SystemExit(f"ring_probe_{size}: ring logits leave the dense route's: {stats}")
    return stats


async def retrieval_mesh(index, intents: list, card: str, device=None, rounds: int = 4, mesh=None,
                         name: str = "retrieval_mesh") -> dict:
    """``retrieval_mesh``: phase 20's table (``index``, unmeshed on its
    device) saved and loaded into an index on a virtual ``model=2`` mesh of
    that device (or on ``mesh``, its first coordinate that device): two row
    shards, each ranked on its coordinate's device, merged on the host.
    Every intent's shortlist must equal the unmeshed index's, and each shard
    must live on the mesh's device for it; both rankings timed on an idle
    card, p50 and p99."""
    import tempfile

    from mcpx_torch.core.config import PlannerConfig
    from mcpx_torch.parallel.mesh import make_mesh
    from mcpx_torch.retrieval.index import RetrievalIndex, RowShards

    dev = torch.device("cuda" if device is None else device)
    k = PlannerConfig().shortlist_top_k
    mesh = make_mesh(model=2, devices=[dev] * 2) if mesh is None else mesh
    meshed = RetrievalIndex(index.config, device=dev, mesh=mesh)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "index.snap")
        index.save(path)
        t0 = time.monotonic()
        meshed.load(path)
        load_s = time.monotonic() - t0
    differ = [i for i in intents if await meshed.shortlist(i, k) != await index.shortlist(i, k)]
    probes = [index.embedder.embed(i) for i in intents]
    timed = {"meshed": [], "unmeshed": []}
    for _ in range(rounds):
        for q in probes:
            t = time.perf_counter()
            meshed._device_topk(q, k)
            t1 = time.perf_counter()
            index._device_topk(q, k)
            timed["meshed"].append((t1 - t) * 1e3)
            timed["unmeshed"].append((time.perf_counter() - t1) * 1e3)
    table = meshed._table
    parts = table.parts if isinstance(table, RowShards) else []
    stats = dict(rows=index.size, mesh=dict(meshed._mesh.shape), shards=[int(p.shape[0]) for p in parts],
                 shard_devices=sorted({str(p.device) for p in parts}), load_s=load_s, intents=len(intents),
                 differing=differ[:3], rank_ms={name: quantiles_ms(v) for name, v in timed.items()})
    emit(name, card, **stats)
    if differ or len(parts) != 2 or [str(p.device) for p in parts] != [str(d) for d in mesh.devices.flat]:
        raise SystemExit(f"{name}: shortlists differ from the unmeshed index's or shards misplaced: {stats}")
    return stats


def train_dp(card: str, device=None, *, n_examples: int = 512, steps: int = 20, batch: int = 24,
             registry_size: int = 1000, meshes: dict = None, line: str = "train_dp_test") -> dict:
    """``train_dp_test``: phase 23's parity geometry (the test preset in
    float32 from the committed checkpoint, batch 24, lr 3e-3, warmup 5)
    with ``mesh=None``, on a virtual ``data=2`` mesh and on a hybrid
    (dcn_data 2, data 2) mesh of the device (or on ``meshes``, by name):
    every step's loss within 1e-5 relative of the unmeshed run's (the CPU
    parity test's limit), every meshed run's batch split."""
    from mcpx_torch.models.bpe import BPETokenizer
    from mcpx_torch.models.corpus import CorpusConfig, build_corpus_sync
    from mcpx_torch.models.gemma.params import load_npz
    from mcpx_torch.models.train import TrainConfig, _batch_shards, flatten_params
    from mcpx_torch.parallel.mesh import make_hybrid_mesh, make_mesh

    dev = torch.device("cuda" if device is None else device)
    corpus = build_corpus_sync(BPETokenizer(), CorpusConfig(n_examples=n_examples, registry_size=registry_size,
                                                            seed=0), device=dev)
    tcfg = TrainConfig(steps=steps, batch_size=batch, lr=3e-3, warmup_steps=5, log_every=1)
    meshes = {"none": None, **(meshes or {"data2": make_mesh(data=2, devices=[dev] * 2),
                                          "hybrid2x2x1": make_hybrid_mesh(2, 2, 1, devices=[dev] * 4)})}
    runs = {}
    for name, mesh in meshes.items():
        params, report, stamps, _ = timed_train("test", corpus, tcfg, dev, init=load_npz(CKPT, "cpu", torch.float32),
                                                mesh=mesh)
        runs[name] = dict(params=flatten_params(params), losses=[x for _, x in report["loss_log"]],
                          shards=len(_batch_shards(mesh, batch)), step_ms=per_step_ms(stamps, steps - 1),
                          eval_token_accuracy=report.get("eval_token_accuracy"))
    base = runs["none"]
    out = {}
    for name, r in runs.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], base["losses"]))
        err = max(float((r["params"][k] - base["params"][k]).abs().max()) for k in base["params"])
        out[name] = dict(shards=r["shards"], losses=r["losses"], max_rel_loss_err=rel, max_abs_param_err=err,
                         step_ms=r["step_ms"], eval_token_accuracy=r["eval_token_accuracy"])
    stats = dict(model="test", dtype="float32", batch=batch, steps=steps, rtol=1e-5, runs=out,
                 devices={n: None if m is None else [str(d) for d in m.distinct_devices()] for n, m in meshes.items()})
    emit(line, card, **stats)
    bad = [n for n, r in out.items() if len(r["losses"]) != steps or r["max_rel_loss_err"] > 1e-5]
    want = {n: math.prod(m.shape[a] for a in ("dcn_data", "data") if a in m.shape) for n, m in meshes.items() if m}
    if bad or any(out[n]["shards"] != k for n, k in want.items()):
        raise SystemExit(f"{line}: runs {bad} leave the unmeshed losses beyond 1e-5 relative: {stats}")
    return stats


def parallel_phase(card: str, index=None, intents: list = (), device=None, *, T: int = 4096, big: str = "2b",
                   n_test: int = 8, n_big: int = 8, batch: int = 64, n_examples: int = 512, registry_size: int = 1000,
                   train_steps: int = 20, train_batch: int = 24) -> dict:
    """Phase 24, the parallel package on ``device`` (the card unless the
    caller asks for the CPU): ``ring_attention_2b``; ``ring_serve_test``
    (float32, the committed checkpoint); ``ring_serve_<big>`` (random bf16
    weights); both again on ``data=4`` in float32 (``ring_serve_data4_*``);
    the float32 and bf16 ``ring_probe_<big>``; ``retrieval_mesh`` on
    phase 20's ``index`` and ``intents`` when given; ``train_dp_test``.
    Returns each line's stats and the phase's wall seconds."""
    dev = torch.device("cuda" if device is None else device)
    t0 = time.monotonic()
    out = {"ring_attention": ring_attention_check(card, dev, T=T)}
    out["ring_serve_test"], _, _ = asyncio.run(ring_serve("test", CKPT, n_test, card, float32=True, batch=batch,
                                                          device=dev))
    out[f"ring_serve_{big}"], prompts, seq_mesh = asyncio.run(
        ring_serve(big, "", n_big, card, float32=False, batch=batch, device=dev))
    for size, checkpoint, n in (("test", CKPT, n_test), (big, "", n_big)):
        out[f"ring_serve_data4_{size}"], _, _ = asyncio.run(ring_serve(
            size, checkpoint, n, card, float32=True, batch=batch, device=dev, mesh_shape=dict(data=4)))
    out["ring_probe"] = ring_probe(big, card, prompts, out[f"ring_serve_{big}"]["threshold"], seq_mesh, dev)
    if index is not None:
        out["retrieval_mesh"] = asyncio.run(retrieval_mesh(index, list(intents), card, device=dev))
    out["train_dp_test"] = train_dp(card, dev, n_examples=n_examples, steps=train_steps, batch=train_batch,
                                    registry_size=registry_size)
    out["wall_s"] = time.monotonic() - t0
    emit("parallel", card, wall_s=out["wall_s"])
    return out


TP_MESH = dict(data=2, model=2)
TP_MARGIN = 1e-4  # float32 sum reordering: a differing 2b stream's unmeshed margin must be under this


async def tp_serve(size: str, checkpoint: str, n_intents: int, card: str, *, batch: int = 64,
                   device=None, registry_size: int = 1000) -> dict:
    """``tp_serve_<size>``: the burst's /plan intents served by the unmeshed
    engine (``plain``) and by one on a virtual ``data=2, model=2`` mesh of
    its own device (``tp``: the weights laid out shard-major, every forward
    run for each row block over ``data`` in turn with each model shard's
    heads, ``d_ff`` columns and vocabulary, the kernel launched once a
    layer per attention shard and row block), both in float32 from the same
    weights, each behind a control plane over
    ``synth_registry(registry_size, seed=0)``. Each engine serves the burst as one cohort from an emptied
    tree, then once more. Prints both arms' plans/s, p50, kernel launches a
    decode forward, captures on the repeat and peak allocated bytes (from
    before startup to the repeat's end, less what the card held before).
    Fails unless every plan is valid, both arms render the same prompts, the
    plans are equal byte for byte at test and at 2b every differing token
    stream's unmeshed masked top-2 margin at its first differing token is
    under ``TP_MARGIN``, each arm launched the kernel ``launches_per_forward``
    times a decode forward (the meshed arm's layout splitting both axes),
    the repeats captured nothing, and on the card each shard's launch at
    its row blocks and pool views agrees with the plain version
    (``kernel_at_shards``). Returns both arms' stats."""
    from mcpx_torch.engine.engine import InferenceEngine
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, reset_kernel_launches
    from mcpx_torch.models.bpe import BPETokenizer
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.parallel.mesh import make_mesh
    from mcpx_torch.planner.llm import LLMPlanner
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    dev = torch.device("cuda" if device is None else device)
    model_cfg = dataclasses.replace(GemmaConfig.named(size, vocab_size=BPETokenizer().vocab_size), dtype="float32")
    records = synth_registry(registry_size, seed=0)
    rng = random.Random(0)
    intents = [intent_for(records, rng) for _ in range(n_intents)]
    name = f"tp_serve_{size}"
    out, calls, plans, engines, cps = {}, {}, {}, {}, []
    try:
        for arm in ("plain", "tp"):
            mesh = None if arm == "plain" else make_mesh(**TP_MESH, devices=[dev] * 4)
            cfg = config(size, checkpoint, batch)
            base = settled_memory() if dev.type == "cuda" else 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            engine = engines[arm] = InferenceEngine(cfg, model_cfg=model_cfg, device=dev, mesh=mesh)
            cp = build_control_plane(cfg, planner=LLMPlanner(engine, cfg.planner), device=dev)
            cps.append(cp)
            for rec in records:
                await cp.registry.put(rec)
            await cp.startup()
            seen, real_generate = calls.setdefault(arm, {}), engine.generate

            async def recording(prompt_ids, _real=real_generate, _seen=seen, **kw):
                res = await _real(prompt_ids, **kw)
                _seen[tuple(prompt_ids)] = ({"temperature": 0.0, **kw}, res)
                return res

            engine.generate = recording
            await idle(engine)
            await engine.drop_unpinned()
            q0 = engine.queue_stats()
            sync()
            reset_kernel_launches()
            t0 = time.monotonic()
            with one_cohort(engine, n_intents):
                timed = await timed_plans(cp, intents)
            wall = time.monotonic() - t0
            sync()
            launches = kernel_launches()
            q1 = engine.queue_stats()
            with one_cohort(engine, n_intents):
                await timed_plans(cp, intents)
            sync()
            q2 = engine.queue_stats()
            for p, _ in timed:
                p.validate()
            plans[arm] = [p.to_json() for p, _ in timed]
            lat = sorted(ms for _, ms in timed)
            decode_launches = launches["ragged_paged_attention"] - (q1["suffix_prefill_launches"]
                                                                    - q0["suffix_prefill_launches"])
            forwards = q1["decode_forwards"] - q0["decode_forwards"]
            layout = engine._layout
            out[arm] = dict(
                model=size, arm=arm, dtype=model_cfg.dtype, intents=n_intents,
                mesh=None if mesh is None else dict(mesh.shape),
                attention_shards=1 if layout is None else len(layout.attn),
                row_blocks=1 if layout is None else len(layout.rows(batch)),
                sharded_leaves=[] if layout is None else sorted(layout.sharded),
                wall_s=wall, plans_per_s=n_intents / wall, p50_ms=nearest_rank(lat, 0.5), max_ms=lat[-1],
                launches=launches,
                launches_per_forward=decode_launches / max(1, forwards),
                expected_launches_per_forward=launches_per_forward(engine, batch),
                suffix_prefill_launches=q1["suffix_prefill_launches"] - q0["suffix_prefill_launches"],
                **loop_counts(engine, q0, q1, n_intents), repeat_captures=q2["captures"] - q1["captures"],
                peak_allocated_bytes=(torch.cuda.max_memory_allocated() - base) if dev.type == "cuda" else 0,
                weight_bytes=n_bytes_of(engine), capture_keys=[repr(k) for k in engine.capture_counts()],
            )
            if layout is not None:
                width = engine._spec_k() + 1 if engine.config.engine.hetero_batch else engine._spec_chunk(True)
                out[arm]["shard_kernel"] = kernel_at_shards(engine, width, n_intents, name)
        prompts = sorted(calls["plain"])
        if prompts != sorted(calls["tp"]):
            raise SystemExit(f"{name}: the two arms rendered different prompts")
        differ = [i for i, (a, b) in enumerate(zip(plans["plain"], plans["tp"])) if a != b]
        margins = greedy_differences(name, size, card, engines["plain"],
                                     {i: (list(p), *calls["plain"][p]) for i, p in enumerate(prompts)},
                                     {i: (list(p), *calls["tp"][p]) for i, p in enumerate(prompts)})
    finally:
        for cp in cps:
            await cp.aclose()
    if dev.type == "cuda":
        check_tickets(name)
    tp, plain = out["tp"], out["plain"]
    emit(name, card, plain=plain, tp=tp, plans_differing=differ, margins=margins, margin_limit=TP_MARGIN,
         plans_per_s_ratio=tp["plans_per_s"] / plain["plans_per_s"],
         peak_bytes_ratio=tp["peak_allocated_bytes"] / max(1, plain["peak_allocated_bytes"]))
    for st in (plain, tp):
        no_new_captures(f"{name} {st['arm']} repeat", {"captures": 0}, {"captures": st["repeat_captures"]})
        if dev.type == "cuda" and st["launches_per_forward"] != st["expected_launches_per_forward"]:
            raise SystemExit(f"{name} {st['arm']}: {st['launches_per_forward']} launches a decode forward, "
                             f"expected {st['expected_launches_per_forward']}")
    if tp["attention_shards"] != TP_MESH["model"] or tp["row_blocks"] != TP_MESH["data"]:
        raise SystemExit(f"{name}: the mesh split {tp['attention_shards']} x {tp['row_blocks']}, not {TP_MESH}")
    if size == "test" and differ:
        raise SystemExit(f"{name}: plans {differ} differ from the unmeshed engine's")
    if any(m >= TP_MARGIN for m in margins):
        raise SystemExit(f"{name}: a differing stream is no float32 near-tie: margins {margins}")
    return {"plain": plain, "tp": tp}


def tp_phase(card: str, device=None, *, n_test: int = 16, n_big: int = 8, big: str = "2b", batch: int = 64) -> dict:
    """Phase 26: ``tp_serve_test`` on the committed checkpoint and
    ``tp_serve_<big>`` on random weights. Returns each line's arms and the
    phase's wall seconds."""
    t0 = time.monotonic()
    out = {"test": asyncio.run(tp_serve("test", CKPT, n_test, card, batch=batch, device=device)),
           big: asyncio.run(tp_serve(big, "", n_big, card, batch=batch, device=device))}
    out["wall_s"] = time.monotonic() - t0
    emit("tp", card, wall_s=out["wall_s"])
    return out


# ------------------------------------------------------------ cross-card
CROSS_MESHES = {"data2": dict(data=2), "model2": dict(model=2), "data2_model2": dict(data=2, model=2)}
CROSS_TOL = 1e-5  # a float32 gap between a mesh of cards and its virtual mesh, where not bit for bit


def card_lines() -> list[str]:
    """Each visible card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return [line.strip() for line in out]


def cards_of(shape: dict) -> list[torch.device]:
    """Cards 0..n-1 for a mesh of ``shape``'s n coordinates."""
    return [torch.device("cuda", i) for i in range(math.prod(shape.values()))]


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def kernel_on_cards(card: str, n: int) -> dict:
    """``cross_kernel``: on each of cards 0..n-1, the ragged kernel at the
    kernel phase's shapes (``CELLS``, seed 0, first and last layer) against
    its plain version on that card, launched from this thread, whose current
    device stays card 0 (the wrapper launches under the tensors' card).
    Fails on a disagreement beyond ATOL/RTOL, a pad that is not an exact
    zero, or a launch that is not counted on its card."""
    from mcpx_torch.engine.kernels.paged_attention import (
        launches_by_card,
        ragged_paged_attention,
        ragged_paged_attention_reference,
    )

    out = {}
    for i in range(n):
        dev = torch.device("cuda", i)
        before, worst = launches_by_card().get(i, 0), 0.0
        for cell, G, hd, L, live, psz, pmax in CELLS:
            batch = [t.to(dev) for t in cell_batch(0, G, hd, L, live, psz, pmax)]
            for layer in (0, L - 1):
                got = ragged_paged_attention(*batch, layer)
                torch.cuda.synchronize(dev)
                ref = ragged_paged_attention_reference(*batch, layer)
                err = (got.float() - ref.float()).abs()
                worst = max(worst, float(err.max()))
                if got.device != dev or bool((err > ATOL + RTOL * ref.float().abs()).any()):
                    raise SystemExit(f"cross_kernel: {cell} on {dev} disagrees with the plain version ({worst})")
                for b, ql in enumerate(batch[5].tolist()):
                    if bool((got[b, ql:] != 0).any()):
                        raise SystemExit(f"cross_kernel: {cell} on {dev} row {b} pads are not exact zeros")
        launched = launches_by_card().get(i, 0) - before
        if launched != 2 * len(CELLS) or torch.cuda.current_device() != 0:
            raise SystemExit(f"cross_kernel: {launched} launches counted on {dev}, expected {2 * len(CELLS)}")
        out[str(dev)] = dict(max_abs_err=worst, launches=launched)
    stats = dict(cells=[c[0] for c in CELLS], atol=ATOL, rtol=RTOL, by_card=out, cards=card_lines())
    emit("cross_kernel", card, **stats)
    return stats


def _whole(tree, layout, key: str, dim: int, ref: torch.Tensor) -> tuple[bool, float]:
    """(bit for bit, largest difference) of a pool or dense cache laid out
    on ``layout`` against ``ref``, the same tensor of the virtual mesh:
    every device's copy against its KV heads (dimension ``dim``) of
    ``ref``, the data replicas each."""
    from mcpx_torch.parallel.transfer import trees

    equal, worst = True, 0.0
    for dev, t in trees(tree, layout).items():
        k0, k1 = layout.kv_range(dev)
        want = ref.narrow(dim, k0, k1 - k0)
        got = t[key].to(ref.device)
        equal = equal and bool(torch.equal(got, want))
        worst = max(worst, float((got - want).abs().max()))
    return equal, worst


def cross_forward(size: str, shape: dict, card: str, *, n_layers: int = 0, seed: int = 0, B: int = 8,
                  S: int = 4, T: int = 16, name: str = "", quantize: str = "none") -> dict:
    """``cross_forward_<size>_<mesh>``: float32 random weights (``seed``)
    laid out on a mesh of ``shape`` over distinct cards and on the same mesh
    shape virtual on card 0, one ragged decode forward (decode, drafted and
    idle rows, one logit row each) over the same pools and one dense
    prefill of ``T`` tokens: the logits, every card's pools after the
    forward's writes (each data replica of its KV heads) and every card's
    dense cache, bit for bit (else within ``CROSS_TOL``); the kernel's
    launches of the decode forward on each card (``n_layers`` for each
    attention shard and row block it computes) and the forward's transfers
    and bytes (``parallel.transfer``: equal on both meshes). ``quantize``:
    int8 weights, each card's codes with the scales they dequantize with."""
    from mcpx_torch.engine.kernels.paged_attention import launches_by_card
    from mcpx_torch.engine.kv_cache import init_paged_kv
    from mcpx_torch.engine.paged_decode import decode_chunk_paged
    from mcpx_torch.models.bpe import BPETokenizer
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.models.gemma.model import init_kv_cache, prefill
    from mcpx_torch.models.gemma.params import load_or_init
    from mcpx_torch.parallel import transfer
    from mcpx_torch.parallel.mesh import ServeLayout, make_mesh

    cfg = GemmaConfig.named(size, vocab_size=BPETokenizer().vocab_size)
    cfg = dataclasses.replace(cfg, dtype="float32", n_layers=n_layers or cfg.n_layers)
    dev0, n = torch.device("cuda", 0), math.prod(shape.values())
    name = name or (f"cross_forward_{size}_{'_'.join(f'{k}{v}' for k, v in shape.items())}"
                    + ("_int8" if quantize == "int8" else ""))
    psz, p_max = 64, 4
    n_pages = B * p_max + 1
    gen = torch.Generator(device=dev0)
    gen.manual_seed(seed)
    pool_shape = (cfg.n_kv_heads, cfg.n_layers, n_pages, psz, cfg.head_dim)
    pools = {k: torch.randn(pool_shape, generator=gen, device=dev0) for k in ("k", "v")}
    rng = random.Random(seed)
    pages = list(range(1, n_pages))
    rng.shuffle(pages)
    table = torch.tensor(pages[: B * p_max], dtype=torch.int32, device=dev0).reshape(B, p_max)
    q_lens = torch.tensor(([S, 1, 2, 0] + [rng.randint(0, S) for _ in range(B)])[:B], dtype=torch.int32, device=dev0)
    starts = torch.tensor([rng.randint(0, p_max * psz - S - 1) for _ in range(B)], dtype=torch.int32, device=dev0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev0)
    prompt = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev0)
    lens = torch.tensor([T - (b % 5) for b in range(B)], dtype=torch.int32, device=dev0)
    res = {}
    for arm, devices in (("virtual", [dev0] * n), ("cards", cards_of(shape))):
        layout = ServeLayout(make_mesh(**shape, devices=devices), cfg)
        params, _ = load_or_init(cfg, seed=seed, device=dev0, mesh=layout.mesh, quantize=quantize)
        paged = init_paged_kv(cfg, n_pages, psz, dev0, layout=layout)
        for dev, t in transfer.trees(paged, layout).items():
            k0, k1 = layout.kv_range(dev)
            for k in ("k", "v"):
                t[k].copy_(pools[k][k0:k1])
        sync_all()
        transfer.reset_counts()
        before = launches_by_card()
        logits, paged = decode_chunk_paged(params, cfg, tokens, starts, table, paged,
                                           logits_at=(q_lens.long() - 1).clamp(min=0), q_lens=q_lens, layout=layout)
        sync_all()
        counts, after = transfer.counts(), launches_by_card()
        dense_logits, dense = prefill(params, cfg, prompt, lens, init_kv_cache(cfg, B, T, device=dev0, layout=layout),
                                      last_only=True, layout=layout)
        sync_all()
        res[arm] = dict(layout=layout, logits=logits, paged=paged, dense_logits=dense_logits, dense=dense,
                        counts=counts, by_card={i: after.get(i, 0) - before.get(i, 0) for i in after})
        del params
    v, c = res["virtual"], res["cards"]
    checks = {"logits": (bool(torch.equal(c["logits"], v["logits"])), float((c["logits"] - v["logits"]).abs().max())),
              "dense_logits": (bool(torch.equal(c["dense_logits"], v["dense_logits"])),
                               float((c["dense_logits"] - v["dense_logits"]).abs().max()))}
    for k in ("k", "v"):
        checks[f"pools_{k}"] = _whole(c["paged"], c["layout"], k, 0, v["paged"][k])
        checks[f"dense_{k}"] = _whole(c["dense"], c["layout"], k, 3, v["dense"][k])
    layout = c["layout"]
    want = {}
    for (d, m), dev in layout.coords().items():
        if m < len(layout.attn) and d < len(layout.rows(B)):
            want[dev.index] = want.get(dev.index, 0) + cfg.n_layers
    stats = dict(model=size, n_layers=cfg.n_layers, mesh=shape, dtype="float32", quantize=quantize, rows=B, width=S,
                 attention_shards=len(layout.attn), kv_split=layout.kv_split, row_blocks=len(layout.rows(B)),
                 bit_equal={k: eq for k, (eq, _) in checks.items()}, max_abs_diff={k: d for k, (_, d) in checks.items()},
                 launches_by_card=c["by_card"], expected_launches_by_card=want,
                 transfers_per_forward=c["counts"]["transfers"], bytes_per_forward=c["counts"]["bytes"],
                 virtual_transfers_per_forward=v["counts"]["transfers"], tol=CROSS_TOL)
    emit(name, card, **stats, cards=card_lines())
    if any(d > CROSS_TOL or d != d for _, d in checks.values()):
        raise SystemExit(f"{name}: the cards' forward leaves the virtual mesh's beyond {CROSS_TOL}: {stats}")
    if {i: n for i, n in c["by_card"].items() if n} != want:
        raise SystemExit(f"{name}: kernel launches by card {c['by_card']}, expected {want}")
    if c["counts"] != v["counts"] or c["counts"]["forwards"] != 1:
        raise SystemExit(f"{name}: transfers {c['counts']} on cards, {v['counts']} on the virtual mesh")
    return stats


async def cross_serve(size: str, checkpoint: str, n_intents: int, card: str, meshes: dict, *, batch: int = 64,
                      registry_size: int = 1000, axes: dict = None, quantize: str = "none") -> dict:
    """``cross_serve_<size>``: the burst's /plan intents (phase 26's, float32)
    served by the unmeshed engine on card 0 (``plain``) and by one engine on
    each mesh of ``meshes`` over distinct cards (its windows eager), and on
    each ``axes`` arm by one that builds its own mesh over the visible cards
    from explicit ``engine.data_axis`` and ``model_axis`` (``(data,
    model)``; the mesh it built must be cards ``0..data*model-1``), each
    behind a control plane, as one cohort from an emptied tree and then once
    more; ``quantize="int8"`` (``cross_serve_int8_<size>``) serves every arm
    int8. Prints each arm's plans/s, p50, kernel launches a decode forward
    and by card, the transfers and bytes a forward, the windows run eagerly,
    captures on the repeat and peak allocated bytes on each card. Fails
    unless every plan is valid, every arm renders the plain arm's prompts,
    the plans are equal byte for byte at test and at 2b every differing
    stream's unmeshed masked top-2 margin is under ``TP_MARGIN``, each meshed
    arm launched ``launches_per_forward`` a decode forward, ran its windows
    eagerly and captured nothing."""
    from mcpx_torch.engine.engine import InferenceEngine
    from mcpx_torch.engine.kernels.paged_attention import kernel_launches, launches_by_card, reset_kernel_launches
    from mcpx_torch.models.bpe import BPETokenizer
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.parallel import transfer
    from mcpx_torch.parallel.mesh import make_mesh
    from mcpx_torch.planner.llm import LLMPlanner
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.utils.synth import intent_for, synth_registry

    dev0, n_cards = torch.device("cuda", 0), torch.cuda.device_count()
    model_cfg = dataclasses.replace(GemmaConfig.named(size, vocab_size=BPETokenizer().vocab_size), dtype="float32")
    records = synth_registry(registry_size, seed=0)
    rng = random.Random(0)
    intents = [intent_for(records, rng) for _ in range(n_intents)]
    name = f"cross_serve_{'int8_' if quantize == 'int8' else ''}{size}"
    axes = axes or {}
    arms = {"plain": None, **{k: make_mesh(**shape, devices=cards_of(shape)) for k, shape in meshes.items()},
            **{k: None for k in axes}}
    meshes = {**meshes, **{k: dict(data=d, model=m) for k, (d, m) in axes.items()}}
    out, calls, plans, engines, cps = {}, {}, {}, {}, []
    try:
        for arm, mesh in arms.items():
            cfg = config(size, checkpoint, batch)
            cfg.model.quantize = quantize
            if arm in axes:
                cfg.engine.data_axis, cfg.engine.model_axis = axes[arm]
            sync_all()
            gc.collect()
            base = [torch.cuda.memory_allocated(i) for i in range(n_cards)]
            for i in range(n_cards):
                torch.cuda.reset_peak_memory_stats(i)
            engine = engines[arm] = InferenceEngine(cfg, model_cfg=model_cfg, device=dev0, mesh=mesh)
            cp = build_control_plane(cfg, planner=LLMPlanner(engine, cfg.planner), device=dev0)
            cps.append(cp)
            for rec in records:
                await cp.registry.put(rec)
            await cp.startup()
            if arm in axes and (engine._mesh.distinct_devices() != cards_of(meshes[arm]) or not engine._layout.cross):
                raise SystemExit(f"{name} {arm}: engine.data_axis/model_axis {axes[arm]} built {engine._mesh}")
            seen, real_generate = calls.setdefault(arm, {}), engine.generate

            async def recording(prompt_ids, _real=real_generate, _seen=seen, **kw):
                res = await _real(prompt_ids, **kw)
                _seen[tuple(prompt_ids)] = ({"temperature": 0.0, **kw}, res)
                return res

            engine.generate = recording
            await idle(engine)
            await engine.drop_unpinned()
            q0 = engine.queue_stats()
            sync_all()
            reset_kernel_launches()
            transfer.reset_counts()
            t0 = time.monotonic()
            with one_cohort(engine, n_intents):
                timed = await timed_plans(cp, intents)
            wall = time.monotonic() - t0
            sync_all()
            launches, by_card, moved = kernel_launches(), launches_by_card(), transfer.counts()
            q1 = engine.queue_stats()
            with one_cohort(engine, n_intents):
                await timed_plans(cp, intents)
            sync_all()
            q2 = engine.queue_stats()
            for p, _ in timed:
                p.validate()
            plans[arm] = [p.to_json() for p, _ in timed]
            lat = sorted(ms for _, ms in timed)
            decode_launches = launches["ragged_paged_attention"] - (q1["suffix_prefill_launches"]
                                                                    - q0["suffix_prefill_launches"])
            forwards = q1["decode_forwards"] - q0["decode_forwards"]
            layout = engine._layout
            mesh = engine._mesh if engine._layout is not None else None
            out[arm] = dict(
                model=size, arm=arm, dtype=model_cfg.dtype, quantize=quantize, intents=n_intents,
                mesh=None if mesh is None else dict(mesh.shape), built_from_axes=arm in axes,
                cards=None if mesh is None else [str(d) for d in mesh.distinct_devices()],
                attention_shards=1 if layout is None else len(layout.attn),
                row_blocks=1 if layout is None else len(layout.rows(batch)),
                wall_s=wall, plans_per_s=n_intents / wall, p50_ms=nearest_rank(lat, 0.5), max_ms=lat[-1],
                launches=launches, launches_by_card=by_card,
                launches_per_forward=decode_launches / max(1, forwards),
                expected_launches_per_forward=launches_per_forward(engine, batch),
                transfers_per_forward=moved["transfers"] / max(1, moved["forwards"]),
                bytes_per_forward=moved["bytes"] / max(1, moved["forwards"]), sharded_forwards=moved["forwards"],
                eager_windows=q1["eager_windows"] - q0["eager_windows"],
                **loop_counts(engine, q0, q1, n_intents), repeat_captures=q2["captures"] - q1["captures"],
                repeat_eager_windows=q2["eager_windows"] - q1["eager_windows"],
                peak_allocated_bytes_by_card={i: torch.cuda.max_memory_allocated(i) - base[i] for i in range(n_cards)},
            )
        prompts = sorted(calls["plain"])
        differ, margins = {}, {}
        for arm in meshes:
            if prompts != sorted(calls[arm]):
                raise SystemExit(f"{name}: {arm} rendered other prompts than the unmeshed engine")
            differ[arm] = [i for i, (a, b) in enumerate(zip(plans["plain"], plans[arm])) if a != b]
            margins[arm] = greedy_differences(f"{name} {arm}", size, card, engines["plain"],
                                              {i: (list(p), *calls["plain"][p]) for i, p in enumerate(prompts)},
                                              {i: (list(p), *calls[arm][p]) for i, p in enumerate(prompts)})
    finally:
        for cp in cps:
            await cp.aclose()
    check_tickets(name)
    emit(name, card, **out, plans_differing=differ, margins=margins, margin_limit=TP_MARGIN, cards=card_lines(),
         plans_per_s_ratio={arm: out[arm]["plans_per_s"] / out["plain"]["plans_per_s"] for arm in meshes})
    for arm in meshes:
        st = out[arm]
        if st["launches_per_forward"] != st["expected_launches_per_forward"]:
            raise SystemExit(f"{name} {arm}: {st['launches_per_forward']} launches a decode forward, expected "
                             f"{st['expected_launches_per_forward']}")
        if st["captures"] or st["repeat_captures"] or st["eager_windows"] <= 0 or st["replays"]:
            raise SystemExit(f"{name} {arm}: a mesh of cards captured or replayed a window, or ran none eagerly: {st}")
        if size == "test" and differ[arm]:
            raise SystemExit(f"{name} {arm}: plans {differ[arm]} differ from the unmeshed engine's")
        if any(m >= TP_MARGIN for m in margins[arm]):
            raise SystemExit(f"{name} {arm}: a differing stream is no float32 near-tie: {margins[arm]}")
    return out


def ring_on_cards(card: str, n: int, T: int = 4096, B: int = 2, K: int = 1, G: int = 8, hd: int = 256) -> dict:
    """``cross_ring``: ring attention at 2b's attention shape on a ``seq``
    mesh of ``n`` distinct cards (each hop a peer copy) against the dense
    ``_attend`` on card 0, float32 within ``RING_TOL`` on valid positions,
    with both routes' ms."""
    from mcpx_torch.parallel.mesh import make_mesh
    from mcpx_torch.parallel.ring_attention import ring_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, T, K, G, hd), np.float32)).to(dev)
    k = torch.from_numpy(rng.standard_normal((B, T, K, hd), np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((B, T, K, hd), np.float32)).to(dev)
    lens = torch.tensor([T, 3][:B], device=dev)
    valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
    mesh = make_mesh(seq=n, devices=cards_of({"seq": n}))
    dense, dense_ms, _ = route_run(lambda: dense_attention(q, k, v, lens), dev)
    ring, ring_ms, _ = route_run(lambda: ring_attention(q, k, v, lens, mesh), dev)
    sync_all()
    over = excess(ring[valid], dense[valid], RING_TOL, RING_TOL)
    stats = dict(B=B, T=T, K=K, G=G, head_dim=hd, seq=n, devices=[str(d) for d in mesh.distinct_devices()],
                 max_abs_err=float((ring - dense)[valid].abs().max()), allclose_excess=over, rtol=RING_TOL,
                 atol=RING_TOL, ring_ms=ring_ms, dense_ms=dense_ms, cards=card_lines())
    emit("cross_ring", card, **stats)
    if over > 0 or not bool(torch.isfinite(ring).all()):
        raise SystemExit(f"cross_ring: the ring over {n} cards leaves the dense route: {stats}")
    return stats


def cross_card_phase(card: str, need: int = 0, index=None, intents: list = (), *, n_test: int = 16,
                     n_big: int = 8, big: str = "2b", batch: int = 64) -> dict:
    """Phase 27, the cross-card half of the parallel package: with two or
    more visible cards, ``cross_kernel``, ``cross_forward_*`` (test at full
    depth, ``big`` at 4 layers, on every mesh of ``CROSS_MESHES`` the cards
    allow, and int8 on the widest of them; the 7b preset's widths at 2
    layers on ``model=4``, its KV heads split over the cards),
    ``cross_serve_test`` (with an engine that builds its ``data=2`` mesh
    from its explicit axes), ``cross_serve_<big>``, ``cross_serve_int8_test``
    on ``model=2``, ``cross_ring_serve_data2_test`` (the engine's ring
    prefill over its data cards viewed as a seq axis, held against its
    dense route), ``retrieval_mesh_cards`` on phase 20's table,
    ``cross_ring`` and ``train_dp_cards``. With fewer cards than ``need`` it fails; with one
    card it prints that it did not run and passes nothing. Returns each
    line's stats, the phase's launches and wall seconds."""
    n = torch.cuda.device_count()
    if n < need:
        raise SystemExit(f"cross_card: {n} card(s) visible, --cards asks for {need}")
    if n < 2:
        emit("cross_card", card, ran=False, cards_visible=n, reason="the cross-card checks need two or more cards")
        return {"ran": False, "launches": 0}
    t0 = time.monotonic()
    meshes = {k: v for k, v in CROSS_MESHES.items() if math.prod(v.values()) <= n}
    out = {"ran": True, "kernel": kernel_on_cards(card, n)}
    for size, layers in (("test", 0), (big, 4)):
        for mesh_name, shape in meshes.items():
            out[f"forward_{size}_{mesh_name}"] = cross_forward(size, shape, card, n_layers=layers)
    widest = list(meshes.values())[-1]
    out["forward_int8"] = cross_forward(big, widest, card, n_layers=4, quantize="int8")
    if n >= 4:
        out["forward_7b"] = cross_forward("7b", dict(model=4), card, n_layers=2, name="cross_forward_7b_model4")
    # The serving arms' launches: what the main path launched on the cards.
    launched = 0
    for size, checkpoint, k, kw in (("test", CKPT, n_test, dict(axes={"axes_data2": (2, 1)})),
                                    (big, "", n_big, {}),
                                    ("test", CKPT, n_test, dict(quantize="int8"))):
        st = asyncio.run(cross_serve(size, checkpoint, k, card, meshes if not kw.get("quantize") else
                                     {"model2": dict(model=2)}, batch=batch, **kw))
        out[f"serve_{'int8_' if kw.get('quantize') else ''}{size}"] = st
        launched += sum(st[arm]["launches"]["ragged_paged_attention"] for arm in st)
    st, _, _ = asyncio.run(ring_serve("test", CKPT, 8, card, float32=True, batch=batch, mesh_shape=dict(data=2),
                                      devices=cards_of({"data": 2})))
    out["ring_serve"] = st
    launched += st["launches"].get("ragged_paged_attention", 0)
    if index is not None:
        from mcpx_torch.parallel.mesh import make_mesh

        out["retrieval"] = asyncio.run(retrieval_mesh(index, list(intents), card, mesh=make_mesh(
            model=2, devices=cards_of({"model": 2})), name="retrieval_mesh_cards"))
    out["ring"] = ring_on_cards(card, 4 if n >= 4 else 2)
    from mcpx_torch.parallel.mesh import make_mesh

    out["train"] = train_dp(card, line="train_dp_cards",
                            meshes={"data2_cards": make_mesh(data=2, devices=cards_of({"data": 2}))})
    out["launches"] = launched
    out["wall_s"] = time.monotonic() - t0
    emit("cross_card", card, ran=True, cards_visible=n, meshes=list(meshes), wall_s=out["wall_s"],
         launches=launched, cards=card_lines())
    return out


def n_bytes_of(engine) -> int:
    from mcpx_torch.models.gemma.params import n_bytes

    return n_bytes(engine._params) if engine._params is not None else 0


def lint_phase(card: str, root: str = HERE) -> dict:
    """Phase 25: the port's mcpxlint over ``mcpx_torch/`` (host only),
    against the port's baseline; fails on a new finding or a stale entry."""
    from mcpx_torch.analysis import apply_baseline, load_baseline, scan_paths

    res = scan_paths([os.path.join(root, "mcpx_torch")], root=root)
    entries = load_baseline(os.path.join(root, "mcpx_torch", "analysis", "baseline.json"))
    new, baselined, stale = apply_baseline(res.findings, entries)
    slowest = sorted(res.rule_wall_s.items(), key=lambda kv: -kv[1])[:5]
    out = {
        "findings": len(res.findings), "new": len(new), "baselined": baselined, "stale": len(stale),
        "suppressed": res.suppressed, "files": res.files_scanned, "seconds": res.duration_s,
        "slowest_rules": dict(slowest), "python": sys.version.split()[0],
    }
    emit("lint", card, **out)
    if new or stale:
        raise SystemExit(
            "lint: " + "; ".join([f.render() for f in new] + [f"stale baseline entry {e}" for e in stale])
        )
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--profile", action="store_true",
        help="after each serving phase, serve its requests once more under "
        "torch.profiler and print device time by kernel and the idle share",
    )
    ap.add_argument(
        "--cards", type=int, default=0, metavar="N",
        help="fail unless at least N cards are visible (phase 27 runs on two or more)",
    )
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < args.cards:
        print(f"chip_smoke: {torch.cuda.device_count()} card(s) visible, --cards asks for {args.cards}",
              file=sys.stderr)
        return 2
    from mcpx_torch.engine.kernels import build

    card = card_line()
    emit("device", card, kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.monotonic()
    libs = build.build_all()
    emit("build", card, seconds=time.monotonic() - t0, libraries=sorted(libs),
         per_kernel_s={k: v["seconds"] for k, v in build.build_log.items()})

    seconds: dict = {"build": time.monotonic() - t0}

    def timed(name: str, fn, *a, **kw):
        """``fn(*a, **kw)``, its wall seconds added to ``seconds[name]``."""
        t = time.monotonic()
        try:
            return fn(*a, **kw)
        finally:
            seconds[name] = seconds.get(name, 0.0) + time.monotonic() - t

    rows = timed("kernel", kernel_phase, card)
    timed("forward_check", forward_check, card)
    timed("forward_check_int8", forward_check, card, quantize=True)

    async def on_the_engine(cp, recs, intents, plans, stats, size: str, n_unique: int, n_overload: int):
        modes = await serve_modes(cp, intents, size, card, trained=size == "test", profile=args.profile)
        pfx = await prefix_reuse(cp, recs, size, n_unique, 4, card)
        tel = await telemetry_phase(cp, intents, plans, size, card)
        obs = await observatory_phase(cp, intents, plans, size, card)
        mixed = await mixed_phase(cp, size, card)
        overload = await overload_phase(cp, recs, size, card, stats["plans_per_s"], n_overload)
        return modes, pfx, (tel, obs), mixed, overload

    trained, trained_plans, (trained_modes, trained_pfx, trained_tel, trained_mixed, trained_ovl) = timed(
        "serve_test..overload_test", asyncio.run,
        serve("test", CKPT, 16, card, batch=64, profile=args.profile,
              after=lambda cp, recs, intents, plans, st: on_the_engine(cp, recs, intents, plans, st, "test", 8, 256))
    )
    if trained["origins"] != {"llm": 16}:
        raise SystemExit(f"trained checkpoint: not every plan is LLM-authored: {trained['origins']}")
    for st in trained_modes:
        if st["origins"] != {"llm": 16}:
            raise SystemExit(f"serve_modes_test {st['draft_mode']}: not every plan is LLM-authored")
    for mode in ("off", "on"):
        if trained_pfx[mode]["origins"] != {"llm": 32}:
            raise SystemExit(f"serve_prefix_test {mode}: not every plan is LLM-authored")
    hetero, spec_obs = timed("serve_hetero_test, observatory_spec_test", asyncio.run, serve_hetero(
        "test", CKPT, 16, card, trained_plans,
        after=lambda cp, intents, plans: observatory_phase(cp, intents, plans, "spec_test", card),
    ))
    trained_tel, trained_obs = trained_tel
    int8_test = timed("int8_test, chaos_test", asyncio.run, int8_phase(
        "test", CKPT, 16, card, {**trained, "plans": trained_plans}, after=lambda cp: chaos_phase(cp, "test", card),
    ))
    full, full_plans, (full_modes, full_pfx, full_tel, full_mixed, full_ovl) = timed(
        "serve_2b..overload_2b", asyncio.run, serve(
            "2b", "", 8, card, batch=64, profile=args.profile,
            after=lambda cp, recs, intents, plans, st: on_the_engine(cp, recs, intents, plans, st, "2b", 4, 128),
        ))
    full_tel, full_obs = full_tel
    int8_2b = timed("int8_2b", asyncio.run, int8_phase("2b", "", 8, card, {**full, "plans": full_plans}))
    executed = [
        timed("execute_test", asyncio.run, execute_phase("test", CKPT, 16, card, batch=64)),
        timed("execute_2b", asyncio.run, execute_phase("2b", "", 8, card, batch=64)),
    ]
    specs = [timed("spec_test", asyncio.run, spec_phase("test", CKPT, card, 96)),
             timed("spec_2b", asyncio.run, spec_phase("2b", "", card, 48))]
    tiers = [timed("tier_test", asyncio.run, tier_phase("test", CKPT, card)),
             timed("tier_2b", asyncio.run, tier_phase("2b", "", card))]
    for size in ("test", "2b"):
        timed(f"tier_roundtrip_{size}", tier_roundtrip, size, card)
    table: dict = {}
    surface = timed("registry_100k", asyncio.run, config_surface(card, keep=table))
    sp = timed("sp_2b", asyncio.run, sp_phase("2b", "", 8, card))
    clusters = [
        timed("cluster_test", asyncio.run, cluster_phase("test", CKPT, 16, card, trained, trained_plans)),
        timed("cluster_2b", asyncio.run, cluster_phase("2b", "", 8, card, full, full_plans)),
    ]
    offline = timed("offline", offline_phase, card)
    parallel = timed("parallel", parallel_phase, card, table["index"], table["intents"])
    timed("lint", lint_phase, card)
    tp = timed("tp_serve", tp_phase, card)
    cross = timed("cross_card", cross_card_phase, card, args.cards, table["index"], table["intents"])
    emit("phase_seconds", card, **seconds, total=sum(seconds.values()))
    runs = [trained, full, *trained_modes, *full_modes, trained_tel, full_tel] + [
        r[m] for r in (trained_pfx, full_pfx) for m in ("off", "on")
    ] + [ex[p] for ex in executed for p in ("pass1", "pass2")] + [
        mx[m] for mx in (trained_mixed, full_mixed) for m in ("drain", "hetero")
    ] + [sp[m] for sp in specs for m in ("off", "on")] + [hetero] + [
        t[m] for t in tiers for m in ("single", "tiered", "thrash", "chaos")
    ] + [int8_test, int8_2b, trained_obs, full_obs, spec_obs, *surface, sp, offline["train_serve_test"],
         parallel["ring_serve_test"], parallel["ring_serve_2b"], parallel["ring_serve_data4_test"],
         parallel["ring_serve_data4_2b"]] + [
        tp[size][arm] for size in ("test", "2b") for arm in ("plain", "tp")
    ]
    for name in KERNELS:
        for st in runs:
            if st["launches"][name] <= 0:
                raise SystemExit(f"{name} was not launched while serving {st['model']}")
    for st in runs:
        # Every decode window of a run replays a graph (the first of a new
        # key is its capture's eager warm-up), and the launch count holds
        # the replays' launches.
        counts = st.get("plan_pass", st)
        if counts["replays"] <= 0 or st["launches"]["ragged_paged_attention"] < counts["replay_launches"]:
            raise SystemExit(f"serving {st['model']}: replays missing from the launch count: {st}")
    check_tickets("serving")

    headline = rows[0]
    kernels = [
        {
            "name": name, **meta,
            # The overload runs launch the kernel too (their primary tier),
            # but a run served mostly degraded may replay no window, so they
            # count here without the replay gate above; so do the cluster
            # runs, whose killed replicas' replays went with them (phase 22
            # gates its own launches).
            # So do phase 23's evaluations (one request at a time, windows
            # captured as they first run), gated in ``offline_phase``.
            # And phase 27's serving arms on the cards (eager windows).
            "launches": sum(st["launches"][name] for st in runs + [trained_ovl, full_ovl] + clusters
                            + list(offline["eval_test"].values())) + cross["launches"],
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
