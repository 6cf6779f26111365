"""The CUDA ragged paged-attention kernel against its plain PyTorch
version, on the card. These tests import neither JAX nor the reference
package, so they run where only PyTorch and the CUDA toolkit are:

    python -m pytest tests/test_torch_cuda_kernel.py -q --noconftest

Elsewhere they skip: the kernel has no CPU mode. The seeded mixed-batch
and prefill-cohort generators here are shared with the CPU parity tests.
The last tests hold the engine's decode window as a captured CUDA graph:
replay against eager from one snapshot (the heterogeneous and speculative
windows too), the ticket buffers after replays, the launch count of replays,
a sampled window's capture, a sampled speculative window's draws from the
registered generator, and the first-maximum tie-break on the card. Then
the retrieval index's device table: its ranking against host numpy, exact
ties, and its own stream beside a busy default stream. The last hold the
engines of a replica pool sharing the card: two engines started together
capture as one started alone, serving from two worker threads leaves the
ticket buffers at 0 and their own launches add up to the process's, a
closed engine leaves nothing allocated, and two 2b engines start and serve
from two worker threads with the device lock replaced by one that locks
nothing, token for token as each serves alone. The last shows which calls
of another thread break a thread's CUDA-graph capture."""

import asyncio
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mcpx_torch.engine.kernels import paged_attention as tk


def mixed_case(seed, B=6, S=5, K=2, G=2, hd=16, psz=4, p_max=12):
    """Rows with q_len = S, 1, 1 < q_len < S and 0, then random; distinct
    random pages and start offsets (the reference's mixed-batch generator,
    with numpy draws so both packages see the same numbers)."""
    rng = random.Random(seed)
    npr = np.random.default_rng(seed)
    n_pages = B * p_max + 2
    q = npr.standard_normal((B, S, K, G, hd), np.float32)
    kp = npr.standard_normal((K, 2, n_pages, psz, hd), np.float32)
    vp = npr.standard_normal((K, 2, n_pages, psz, hd), np.float32)
    pages = list(range(1, n_pages))
    rng.shuffle(pages)
    table = np.asarray(pages[: B * p_max], np.int32).reshape(B, p_max)
    mid = rng.randint(2, S - 1) if S > 2 else S
    q_lens = [S, 1, mid, 0, rng.randint(0, S), 1, rng.randint(0, S), S][:B]
    starts = [rng.randint(0, p_max * psz - max(1, q_lens[b]) - 1) for b in range(B)]
    return q, kp, vp, table, np.asarray(starts, np.int32), np.asarray(q_lens, np.int32)


def prefill_case(seed, B=16, S=128, K=1, G=4, hd=32, psz=64, p_max=4, starts=(0, 64, 128), idle=2):
    """A suffix-prefill cohort: q_len uniform in 1..S, each row's start
    drawn from `starts` (those that leave room for S queries in the table),
    and `idle` idle rows among them; numpy draws, as in `mixed_case`."""
    rng = random.Random(seed)
    npr = np.random.default_rng(seed)
    n_pages = B * p_max + 2
    q = npr.standard_normal((B, S, K, G, hd), np.float32)
    kp = npr.standard_normal((K, 2, n_pages, psz, hd), np.float32)
    vp = npr.standard_normal((K, 2, n_pages, psz, hd), np.float32)
    pages = list(range(1, n_pages))
    rng.shuffle(pages)
    table = np.asarray(pages[: B * p_max], np.int32).reshape(B, p_max)
    fits = [s for s in starts if s + S <= p_max * psz]
    idle_rows = set(rng.sample(range(B), idle))
    q_lens = [0 if b in idle_rows else rng.randint(1, S) for b in range(B)]
    st = [rng.choice(fits) for _ in range(B)]
    return q, kp, vp, table, np.asarray(st, np.int32), np.asarray(q_lens, np.int32)


def verify_case(seed, B=64, S=5, K=1, G=4, hd=32, psz=64, p_max=4, live=32):
    """The speculative verify window: ``live`` random rows at q_len S = K+1
    (the current token and K drafts), the rest idle, random distinct pages
    and start offsets that leave room for S queries; numpy draws."""
    rng = random.Random(seed)
    npr = np.random.default_rng(seed)
    n_pages = B * p_max + 2
    q = npr.standard_normal((B, S, K, G, hd), np.float32)
    kp = npr.standard_normal((K, 2, n_pages, psz, hd), np.float32)
    vp = npr.standard_normal((K, 2, n_pages, psz, hd), np.float32)
    pages = list(range(1, n_pages))
    rng.shuffle(pages)
    table = np.asarray(pages[: B * p_max], np.int32).reshape(B, p_max)
    rows = set(rng.sample(range(B), live))
    q_lens = [S if b in rows else 0 for b in range(B)]
    starts = [rng.randint(0, p_max * psz - S - 1) for _ in range(B)]
    return q, kp, vp, table, np.asarray(starts, np.int32), np.asarray(q_lens, np.int32)


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


DTYPES = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]


def _on_card(case, cuda, dtype):
    q, kp, vp, table, starts, q_lens = [t.to(cuda) for t in as_torch(*case)]
    return q.to(dtype), kp.to(dtype), vp.to(dtype), table, starts, q_lens


def _check_case(case, cuda, dtype, atol, layers=(0, 1)):
    """Kernel against plain on one case: within `atol`, one launch a call,
    pads and idle rows exactly 0, and the ticket counters left at 0."""
    args = _on_card(case, cuda, dtype)
    for layer in layers:
        n0 = tk.kernel_launches()["ragged_paged_attention"]
        out = tk.ragged_paged_attention(*args, layer)
        torch.cuda.synchronize()
        assert tk.kernel_launches()["ragged_paged_attention"] == n0 + 1
        ref = tk.ragged_paged_attention_reference(*args, layer)
        np.testing.assert_allclose(
            out.float().cpu().numpy(), ref.float().cpu().numpy(), rtol=atol, atol=atol
        )
        for b, ql in enumerate(case[5]):
            assert bool((out[b, ql:] == 0).all())
        assert all(int(t.abs().sum()) == 0 for t in tk.ticket_counters())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape", [(4, 32), (8, 256)])
def test_cuda_kernel_matches_plain(cuda, dtype, atol, shape):
    """The CUDA kernel against its plain version on the card: fp32 to
    summation order, bf16 to bf16 rounding of inputs and output."""
    G, hd = shape
    for seed in range(3):
        _check_case(mixed_case(seed, B=8, S=8, K=1, G=G, hd=hd, psz=64, p_max=4), cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("geometry", [{}, dict(S=8, G=8, hd=128, psz=4, p_max=40)])
def test_cuda_kernel_many_pages_per_split(cuda, dtype, atol, geometry):
    """Many pages in one block, more than one kv-head: the default mixed
    geometry (K 2, G 2, hd 16, Psz 4, Pmax 12), whose rows fit one split,
    and a wide one whose rows of two or more queries split into chunks of
    16 pages and merge."""
    for seed in range(3):
        _check_case(mixed_case(seed, **geometry), cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("hd", [24, 40])
def test_cuda_kernel_padded_head_dim(cuda, dtype, atol, hd):
    """hd % 16 == 8: the bf16 path zero-pads the last k-step in shared memory."""
    for seed in range(2):
        case = mixed_case(seed, B=6, S=8, K=1, G=4, hd=hd, psz=16, p_max=6)
        _check_case(case, cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_cuda_kernel_all_idle_batch_is_zero(cuda, dtype, atol):
    case = list(mixed_case(0, B=8, S=8, K=1, G=8, hd=256, psz=64, p_max=4))
    case[5] = np.zeros_like(case[5])
    args = _on_card(case, cuda, dtype)
    out = tk.ragged_paged_attention(*args, 1)
    torch.cuda.synchronize()
    assert bool((out == 0).all())
    assert all(int(t.abs().sum()) == 0 for t in tk.ticket_counters())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_cuda_kernel_repeats_bit_identical(cuda, dtype, atol):
    """Three launches back to back give the same bits: the counters reset
    and the merge visits splits in a fixed order."""
    args = _on_card(mixed_case(1, B=8, S=8, K=2, G=4, hd=64, psz=16, p_max=8), cuda, dtype)
    outs = [tk.ragged_paged_attention(*args, 1) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    ref = tk.ragged_paged_attention_reference(*args, 1)
    np.testing.assert_allclose(
        outs[0].float().cpu().numpy(), ref.float().cpu().numpy(), rtol=atol, atol=atol
    )


@pytest.mark.cuda
def test_cuda_kernel_two_streams_keep_their_own_counters(cuda):
    """Launches on two streams of one device may overlap; each stream has
    its own ticket counters, so every output equals that of a launch alone
    and every counter is back at 0."""
    cases = [
        _on_card(mixed_case(seed, B=8, S=8, K=1, G=8, hd=256, psz=64, p_max=4), cuda, torch.bfloat16)
        for seed in (0, 1)
    ]
    alone = [tk.ragged_paged_attention(*args, 1) for args in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, (s, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(s):
                outs[i].append(tk.ragged_paged_attention(*args, 1))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, alone[i]) for o in outs[i])
    assert all(int(t.abs().sum()) == 0 for t in tk.ticket_counters())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape", [(4, 32), (8, 256)])
@pytest.mark.parametrize("S", [64, 128])
def test_cuda_kernel_prefill_width(cuda, dtype, atol, shape, S):
    """Suffix-prefill windows (S*G of 256 to 1,024 rows, cut into query
    tiles) at both head-dim builds: starts at page offsets, idle rows
    beside prefill rows."""
    G, hd = shape
    for seed in range(2):
        _check_case(prefill_case(seed, S=S, G=G, hd=hd), cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape", [(4, 32), (8, 256)])
def test_cuda_kernel_prefill_off_page_starts(cuda, dtype, atol, shape):
    """Starts inside a page: a tile's visible end and the split boundaries
    fall mid-page."""
    G, hd = shape
    for seed in range(2):
        case = prefill_case(seed, S=128, G=G, hd=hd, starts=(5, 37, 70, 127))
        _check_case(case, cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("B", [2, 64])
def test_cuda_kernel_widest_window(cuda, dtype, atol, B):
    """S*G = 2,048 (S 256, G 8, hd 256) in one launch: a small batch keeps
    several splits a tile, a full one falls to one split."""
    _check_case(prefill_case(0, B=B, S=256, G=8, hd=256, starts=(0,), idle=1), cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape,live", [((4, 32), 32), ((8, 256), 16)])
def test_cuda_kernel_verify_shape(cuda, dtype, atol, shape, live):
    """The speculative verify window at the serving geometry: B 64, S 5
    (k 4), q_len 5 on the live rows and 0 on the rest, 64-token pages, at
    the test and the 2b widths."""
    G, hd = shape
    for seed in range(2):
        _check_case(verify_case(seed, G=G, hd=hd, live=live), cuda, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_cuda_kernel_prefill_repeats_bit_identical(cuda, dtype, atol):
    args = _on_card(prefill_case(3, S=128, G=8, hd=256), cuda, dtype)
    outs = [tk.ragged_paged_attention(*args, 0) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    assert all(int(t.abs().sum()) == 0 for t in tk.ticket_counters())


# ------------------------------------------------ the captured decode window
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.fixture
def window_engine(cuda, request):
    """An engine at the test preset (random weights, byte vocab) on the
    card with three requests admitted by hand, greedy unless the test is
    parametrised with a temperature (or with "hetero", "spec", "spec_hot"
    or "spec_grammar": the heterogeneous slab, speculation off or on, with
    rows at 0.8, or with the grammar draft mode; "int8" and "int8_spec":
    int8 weights, homogeneous or speculative); torn down through
    ``_shutdown``, which drops its graphs and releases the capturing
    stream's ticket buffer."""
    from collections import deque

    from mcpx_torch.core.config import MCPXConfig
    from mcpx_torch.engine.engine import InferenceEngine

    param = getattr(request, "param", 0.0)
    # "int8" and "int8_spec": int8 weights, the homogeneous slab or the
    # speculative one.
    quantize = "int8" if isinstance(param, str) and param.startswith("int8") else "none"
    if quantize == "int8":
        param = "spec" if param == "int8_spec" else 0.0
    slab = param if isinstance(param, str) else None  # the heterogeneous slab
    temperature = 0.8 if slab == "spec_hot" else 0.0 if slab else param
    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 256, "quantize": quantize},
        "engine": {
            "max_batch_size": 8, "max_decode_len": 48, "kv_page_size": 16,
            "max_pages_per_seq": 16, "temperature": temperature, "hetero_batch": slab is not None,
            "speculative": {
                "enabled": slab in ("spec", "spec_hot", "spec_grammar"),
                "draft": "grammar" if slab == "spec_grammar" else "recurrent",
            },
        },
    })
    eng = InferenceEngine(cfg, device=cuda)
    loop = asyncio.new_event_loop()
    with torch.inference_mode():
        eng._setup()
        tok = eng.tokenizer
        reqs = [
            _request(loop, tok.encode(f"intent {i}: compose the services. JSON:"), 40, temperature)
            for i in range(3)
        ]
        eng._admit(eng._slab, deque(reqs))
        yield eng
        eng._shutdown(eng._slab, deque())
    loop.close()


def _request(loop, prompt, budget, temperature):
    from mcpx_torch.engine.engine import GenerateRequest

    return GenerateRequest(
        prompt_ids=prompt, max_new_tokens=budget, constrained=True, temperature=temperature,
        future=loop.create_future(), loop=loop, enqueued_at=time.monotonic(),
    )


@pytest.mark.cuda
def test_captured_window_replays_what_eager_runs(window_engine):
    """From one snapshot: the window run eagerly, its capture's warm-up and
    its replay end in bitwise equal slab buffers and KV pools, and the
    rows advanced."""
    eng = window_engine
    slab = eng._slab
    key, dfa = eng._window_plan(slab)
    snap = chip_smoke.window_state(eng)
    ends = []
    for run in ("eager", "capture", "replay"):
        chip_smoke.set_window_state(eng, snap)
        if run == "eager":
            eng._window(slab, key, dfa)
        else:
            eng._run_window(slab, key, dfa)
        torch.cuda.synchronize()
        ends.append(chip_smoke.window_state(eng))
    assert eng._stats["captures"] == 1 and eng._stats["replays"] == 1 and key in eng._graphs
    for name in snap:
        assert torch.equal(ends[0][name], ends[1][name]), name
        assert torch.equal(ends[0][name], ends[2][name]), name
    assert bool((ends[2]["slab.emitted"] > snap["slab.emitted"]).any())


@pytest.mark.cuda
def test_ticket_buffers_are_zero_after_replays(window_engine):
    eng = window_engine
    slab = eng._slab
    key, dfa = eng._window_plan(slab)
    for _ in range(6):
        eng._run_window(slab, key, dfa)
    torch.cuda.synchronize()
    held = (eng.device, eng._capture_stream.cuda_stream)
    assert held in tk._TICKETS and tk._HELD.get(held, 0) >= 1
    assert all(int(t.abs().sum()) == 0 for t in tk.ticket_counters())


@pytest.mark.cuda
def test_launch_counts_include_replays(window_engine):
    """The capture records its launches without counting them; each replay
    adds one launch a layer a forward."""
    eng = window_engine
    slab = eng._slab
    key, dfa = eng._window_plan(slab)
    per_window = eng.model_cfg.n_layers * key[5]
    n0, c0 = tk.kernel_launches()["ragged_paged_attention"], tk.captured_launches()["ragged_paged_attention"]
    eng._run_window(slab, key, dfa)  # warm-up (counted: it launches) and capture (recorded)
    assert tk.captured_launches()["ragged_paged_attention"] == c0 + per_window
    assert tk.kernel_launches()["ragged_paged_attention"] == n0 + per_window
    for _ in range(3):
        eng._run_window(slab, key, dfa)
    torch.cuda.synchronize()
    assert tk.kernel_launches()["ragged_paged_attention"] == n0 + 4 * per_window


@pytest.mark.cuda
@pytest.mark.parametrize("window_engine", [0.8], indirect=True)
def test_sampled_window_captures_with_its_generator(window_engine):
    """A sampled window is captured with the engine's generator registered:
    replays draw anew and every emitted token is one the grammar allows."""
    eng = window_engine
    slab = eng._slab
    key, dfa = eng._window_plan(slab)
    assert key[1][0] == "sampled"
    for _ in range(3):
        eng._run_window(slab, key, dfa)
    torch.cuda.synchronize()
    assert eng._stats["captures"] == 1 and eng._stats["replays"] == 2
    active = set(eng.grammar.active_ids.tolist())
    d = slab.dev
    for b in range(3):
        toks = d["out_buf"][b, : int(d["emitted"][b])].tolist()
        assert toks and set(toks) <= active


@pytest.mark.cuda
@pytest.mark.parametrize("window_engine", ["hetero", "spec", "spec_grammar"], indirect=True)
def test_heterogeneous_windows_replay_what_eager_runs(window_engine):
    """The heterogeneous and the speculative window (per-row state, stacked
    grammar tables, the drafter's state, the verify window through the
    kernel): from one snapshot, eager, the capture's warm-up and the replay
    end bitwise equal (greedy rows), the rows advanced, and a speculative
    window verified drafts."""
    eng = window_engine
    slab = eng._slab
    key, dfa = eng._window_plan(slab)
    assert key[0] == ("spec" if slab.spec else "hetero") and key[1][0] == "rows"
    snap = chip_smoke.window_state(eng)
    ends = []
    for run in ("eager", "capture", "replay"):
        chip_smoke.set_window_state(eng, snap)
        if run == "eager":
            eng._window(slab, key, dfa)
        else:
            eng._run_window(slab, key, dfa)
        torch.cuda.synchronize()
        ends.append(chip_smoke.window_state(eng))
    assert eng._stats["captures"] == 1 and eng._stats["replays"] == 1
    for name in snap:
        assert torch.equal(ends[0][name], ends[1][name]), name
        assert torch.equal(ends[0][name], ends[2][name]), name
    assert bool((ends[2]["slab.emitted"] > snap["slab.emitted"]).any())
    if slab.spec:
        assert int(ends[2]["slab.counts"][1]) > int(snap["slab.counts"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("window_engine", ["spec_hot"], indirect=True)
def test_sampled_speculative_window_draws_from_the_registered_generator(window_engine):
    """Sampled rows in the speculative window: from one snapshot (the rows
    at their first sampled positions) and one ``manual_seed`` of the
    engine's generator, the window run eagerly, its capture's warm-up and
    two replays end bitwise equal (every draw comes from that generator,
    once a position, in the same order), a replay after another seed
    differs, and every emitted token is one the grammar allows."""
    eng = window_engine
    slab = eng._slab
    key, dfa = eng._window_plan(slab)
    snap = chip_smoke.window_state(eng)
    ends = []
    for run, seed in (("eager", 1234), ("capture", 1234), ("replay", 1234), ("replay", 1234), ("replay", 99)):
        chip_smoke.set_window_state(eng, snap)
        eng._generator.manual_seed(seed)
        if run == "eager":
            eng._window(slab, key, dfa)
        else:
            eng._run_window(slab, key, dfa)
        torch.cuda.synchronize()
        ends.append(chip_smoke.window_state(eng))
    assert eng._stats["captures"] == 1 and eng._stats["replays"] == 3
    for end in ends[1:4]:
        assert all(torch.equal(ends[0][k], end[k]) for k in snap)
    assert not torch.equal(ends[0]["slab.out_buf"], ends[4]["slab.out_buf"])
    active = set(eng.grammar.active_ids.tolist())
    d = slab.dev
    for b in range(3):
        toks = d["out_buf"][b, : int(d["emitted"][b])].tolist()
        assert toks and set(toks) <= active


@pytest.mark.cuda
def test_argmax_breaks_ties_at_the_first_maximum_on_the_card(cuda):
    """On the card too, vocabulary-space and compact-space greedy picks
    agree on a tie (the first maximum), over a [64, 5, 3072] window."""
    from mcpx_torch.engine import sampling

    B, W, V = 64, 5, 3072
    logits = torch.zeros((B, W, V), device=cuda)
    logits[..., [7, 11, 2900]] = 5.0
    active = torch.tensor([2, 7, 11, 20, 2900], device=cuda)
    mask = torch.zeros((V,), dtype=torch.bool, device=cuda)
    mask[active] = True
    temps = torch.zeros((B,), device=cuda)
    window = sampling.sample_window_rows(logits, temps, mask=mask, gumbel=torch.zeros_like(logits))
    vocab = sampling.sample_rows(logits[:, 0], None, temps, mask=mask)
    compact = active[sampling.sample_rows(logits[:, 0][:, active], None, temps)]
    assert bool((window == 7).all()) and bool((vocab == 7).all()) and bool((compact == 7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("window_engine", ["int8", "int8_spec"], indirect=True)
def test_int8_windows_replay_what_eager_runs(window_engine):
    """Int8 weights dequantized per layer inside a captured window (the
    temporaries from the graph's pool): from one snapshot, eager, the
    capture's warm-up and the replay end bitwise equal, the rows advanced,
    and the replay launched the ragged kernel once a layer a forward."""
    from mcpx_torch.models.gemma.quant import is_quantized

    eng = window_engine
    assert is_quantized(eng._params) and eng._params["layers"]["wq"]["int8"].dtype == torch.int8
    slab = eng._slab
    key, dfa = eng._window_plan(slab)
    snap = chip_smoke.window_state(eng)
    ends = []
    for run in ("eager", "capture", "replay"):
        chip_smoke.set_window_state(eng, snap)
        n0 = tk.kernel_launches()["ragged_paged_attention"]
        if run == "eager":
            eng._window(slab, key, dfa)
        else:
            eng._run_window(slab, key, dfa)
        torch.cuda.synchronize()
        if run == "replay":
            assert tk.kernel_launches()["ragged_paged_attention"] - n0 == eng.model_cfg.n_layers * key[5]
        ends.append(chip_smoke.window_state(eng))
    assert eng._stats["captures"] == 1 and eng._stats["replays"] == 1
    for name in snap:
        assert torch.equal(ends[0][name], ends[1][name]), name
        assert torch.equal(ends[0][name], ends[2][name]), name
    assert bool((ends[2]["slab.emitted"] > snap["slab.emitted"]).any())


@pytest.mark.cuda
def test_int8_quantize_on_the_card_is_bit_equal_to_the_cpu(cuda):
    """The committed checkpoint quantized on the card and on the CPU: equal
    int8 codes and f32 scales, bit for bit (a scale divided by a host
    scalar on CUDA is multiplied by its reciprocal, an ulp off, and flips
    codes)."""
    from mcpx_torch.models.gemma.params import load_npz
    from mcpx_torch.models.gemma.quant import quantize_params

    q = {d: quantize_params(load_npz(chip_smoke.CKPT, d, torch.float32)) for d in (cuda, "cpu")}
    for name in ("embed", "wq", "wo", "w_down"):
        a = q[cuda]["embed"] if name == "embed" else q[cuda]["layers"][name]
        b = q["cpu"]["embed"] if name == "embed" else q["cpu"]["layers"][name]
        assert torch.equal(a["int8"].cpu(), b["int8"]), name
        assert torch.equal(a["scale"].cpu().view(torch.int32), b["scale"].view(torch.int32)), name


@pytest.mark.cuda
def test_retrieval_table_on_the_card_ranks_as_the_host_and_keeps_its_stream(cuda):
    """``compute="device"`` on CUDA: the table is float32 on the card, the
    shortlist's ranking equals host numpy's on a seeded table (exact ties
    lowest index first, as ``lax.top_k``), its work runs on the index's own
    stream, and a snapshot reloads onto the card with the same rankings."""
    import tempfile

    from mcpx_torch.core.config import RetrievalConfig
    from mcpx_torch.retrieval.index import RetrievalIndex

    rng = np.random.default_rng(0)
    table = rng.normal(size=(4096, 256)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    table[[5, 9, 4000]] = table[7]  # one vector four times
    names = np.asarray([f"svc-{i}" for i in range(len(table))], dtype=object)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "index.snap")
        with open(path, "wb") as f:
            np.savez(f, table=table, names=names)
        index = RetrievalIndex(RetrievalConfig(compute="device"), device=cuda)
        index.load(path)
    assert index._table.is_cuda and index._table.dtype == torch.float32
    assert index._stream is not None and index._stream != torch.cuda.current_stream()
    queries = [rng.normal(size=256).astype(np.float32) for _ in range(32)] + [table[7]]
    for q in queries:
        vals, idx = index._device_topk(q, 8)
        host = index._host_order(q, 8)
        scores = table @ q
        assert all(abs(scores[a] - scores[b]) < 1e-5 for a, b in zip(idx, host)), (idx, host)
        np.testing.assert_allclose(vals, scores[idx], rtol=0, atol=1e-5)
    assert index._device_topk(table[7], 3)[1] == [5, 7, 9]
    # The default stream is untouched: a shortlist waits on its own stream only.
    torch.cuda._sleep(400_000_000)  # the default stream busy for about 0.2 s
    t = time.perf_counter()
    index._device_topk(queries[0], 8)
    assert (time.perf_counter() - t) < 0.1
    torch.cuda.synchronize()


def _pool_config(hetero: bool = False):
    from mcpx_torch.core.config import MCPXConfig

    return MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 256},
        "engine": {
            "max_batch_size": 8, "max_decode_len": 32, "kv_page_size": 16, "max_pages_per_seq": 16,
            "temperature": 0.0, "warmup_compile": True, "hetero_batch": hetero,
        },
    })


async def _serve_few(engine, n: int = 6):
    tok = engine.tokenizer
    return await asyncio.gather(*(
        engine.generate(tok.encode(f"intent {i}: compose the services. JSON:"), max_new_tokens=24,
                        constrained=i % 3 != 2)
        for i in range(n)
    ))


def _record(engine):
    # The capture counts and each graph's launch record, by key.
    return engine.capture_counts(), {repr(k): dict(v) for k, v in engine._graph_launches.items()}


@pytest.mark.cuda
def test_engines_started_together_capture_as_one_alone(cuda):
    """Two engines started at once (a pool's gather) capture their warm-up
    windows from two worker threads: each one's capture counts and launch
    records equal those of the same engine started alone."""
    from mcpx_torch.engine.engine import InferenceEngine

    async def go():
        alone = InferenceEngine(_pool_config(), device=cuda)
        await alone.start()
        await _serve_few(alone)
        want = _record(alone)
        await alone.aclose()
        pair = [InferenceEngine(_pool_config(), device=cuda) for _ in range(2)]
        await asyncio.gather(*(e.start() for e in pair))
        await asyncio.gather(*(_serve_few(e) for e in pair))
        got = [_record(e) for e in pair]
        await asyncio.gather(*(e.aclose() for e in pair))
        return want, got

    want, got = asyncio.run(go())
    assert want[0] and all(sum(r.values()) > 0 for r in want[1].values())
    assert got == [want, want]


@pytest.mark.cuda
def test_concurrent_serving_leaves_tickets_at_zero_and_counts_each_engine(cuda):
    """Two engines serve at once from their worker threads, both eager
    launches and replays on the legacy default stream: every ticket buffer
    is back at 0, and the engines' own launches add up to the process's."""
    from mcpx_torch.engine.engine import InferenceEngine

    async def go():
        pair = [InferenceEngine(_pool_config(hetero=h), device=cuda) for h in (False, True)]
        await asyncio.gather(*(e.start() for e in pair))
        n0 = tk.kernel_launches()["ragged_paged_attention"]
        own0 = [e.own_launches()["ragged_paged_attention"] for e in pair]
        for _ in range(3):
            await asyncio.gather(*(_serve_few(e, 8) for e in pair))
        torch.cuda.synchronize()
        delta = tk.kernel_launches()["ragged_paged_attention"] - n0
        own = [e.own_launches()["ragged_paged_attention"] - o for e, o in zip(pair, own0)]
        left = sum(int(t.abs().sum()) for t in tk.ticket_counters())
        await asyncio.gather(*(e.aclose() for e in pair))
        return delta, own, left

    delta, own, left = asyncio.run(go())
    assert left == 0 and all(n > 0 for n in own) and sum(own) == delta


@pytest.mark.cuda
def test_a_closed_engine_leaves_nothing_allocated(cuda):
    """With a reference to the closed engine kept (a pool's dead slot keeps
    its engine until the rejoin), a second engine serving the same requests
    allocates what the first did, and once it closes too the card holds
    what it held after the first closed, within 2% of an engine's
    footprint: nothing accumulates from one engine to the next. (The first
    close may leave process caches an engine's thread filled, such as
    cuBLAS's workspaces; the next engine reuses them.)"""
    import gc

    from mcpx_torch.engine.engine import InferenceEngine

    def allocated():
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    async def run():
        engine = InferenceEngine(_pool_config(hetero=True), device=cuda)
        await engine.start()
        await _serve_few(engine)
        used = allocated()
        await engine.aclose()
        return engine, used

    base = allocated()
    first, used1 = asyncio.run(run())
    after1 = allocated()
    second, used2 = asyncio.run(run())
    after2 = allocated()
    footprint = used1 - after1
    assert footprint > 0 and first.state == second.state == "closed"
    assert abs(used2 - used1) <= 0.02 * footprint, (used1, used2)
    assert abs(after2 - after1) <= 0.02 * footprint, (after1, after2, base)


@pytest.mark.cuda
def test_a_training_step_on_the_card_matches_the_cpu(cuda):
    """Three test-width training steps from the committed checkpoint in
    float32 (the first at lr 0, as optax's schedule), on the card and on the
    CPU over the same rows: the losses within 1e-4 relative, the weights
    within 1e-4, and the card's run leaves TF32 off."""
    from mcpx_torch.models.bpe import BPETokenizer
    from mcpx_torch.models.corpus import CorpusConfig, build_corpus_sync
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.models.gemma.params import load_npz
    from mcpx_torch.models.train import TrainConfig, flatten_params, train

    assert not torch.backends.cuda.matmul.allow_tf32
    tok = BPETokenizer()
    corpus = build_corpus_sync(tok, CorpusConfig(n_examples=48, registry_size=120, seed=3), device=cuda)
    cfg = GemmaConfig.named("test", vocab_size=tok.vocab_size)
    tcfg = TrainConfig(steps=3, batch_size=8, warmup_steps=1, log_every=1)
    runs = {d: train(cfg, corpus, tcfg, device=d, init=load_npz(chip_smoke.CKPT, "cpu", torch.float32))
            for d in (cuda, "cpu")}
    (p_card, r_card), (p_cpu, r_cpu) = runs[cuda], runs["cpu"]
    for (_, a), (_, b) in zip(r_card["loss_log"], r_cpu["loss_log"]):
        assert abs(a - b) <= 1e-4 * abs(b), (r_card["loss_log"], r_cpu["loss_log"])
    flat_card, flat_cpu = flatten_params(p_card), flatten_params(p_cpu)
    assert all(flat_card[k].device.type == "cuda" for k in flat_card)
    for k, v in flat_cpu.items():
        torch.testing.assert_close(flat_card[k].cpu(), v, rtol=0, atol=1e-4)


class _NoLock:
    """Stands in for ``engine.DEVICE_LOCK``: a re-entrant lock that locks
    nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def acquire(self, *args, **kwargs):
        return True

    def release(self):
        pass


# Counters of a burst's schedule: when streams differ, whether the engine
# took another path through the burst (admissions, suffix prefills, drafts).
_BURST_COUNTERS = (
    "admissions", "prefill_tokens", "suffix_prefills", "segments", "windows",
    "decode_forwards", "spec_verify", "captures", "replays",
)


@pytest.mark.cuda
def test_two_2b_engines_serve_at_once_without_the_device_lock(cuda, monkeypatch):
    """ROADMAP Queue C: two engines at the ``cluster_2b`` shapes (2b at full
    width, random weights, batch 64) start together and serve bursts from
    their two worker threads at once with ``engine.DEVICE_LOCK`` replaced by
    a lock that locks nothing. No CUDA error, and every burst's token
    streams equal, token for token, those of the same engine serving alone
    with the lock. Each burst is one admission cohort from an emptied tree;
    the locked runs are made twice and must agree, so that a difference
    belongs to the lock-free run. A failure names every differing stream
    with the locked stream's top-2 margin at the first differing token and
    both runs' schedule counters."""
    from mcpx_torch.engine import engine as eng

    real_lock = eng.DEVICE_LOCK
    n, rounds, budget = 16, 3, 64

    async def burst(engine, prompts):
        await chip_smoke.idle(engine)
        left = await engine.drop_unpinned()
        q0 = engine.queue_stats()
        with chip_smoke.one_cohort(engine, len(prompts)):
            res = await asyncio.gather(*(engine.generate(p, max_new_tokens=budget) for p in prompts))
        q1 = engine.queue_stats()
        counters = {k: q1[k] - q0[k] for k in _BURST_COUNTERS}
        return [r.token_ids for r in res], {"tree_nodes_left": left, **counters}

    def differences(pair, prompts, free, alone):
        """(round, engine, request, position, locked stream's margin there)
        of every stream that differs from the locked run's."""
        out = []
        for r, got in enumerate(free):
            for j, ((streams, _), (want, _)) in enumerate(zip(got, alone)):
                for i, (s, w) in enumerate(zip(streams, want)):
                    if s == w:
                        continue
                    k = next((x for x, (a, b) in enumerate(zip(s, w)) if a != b), min(len(s), len(w)))
                    margin = chip_smoke.masked_margin(pair[j], prompts[j][i], {"max_new_tokens": budget}, w, k)
                    out.append((r, j, i, k, margin))
        return out

    async def go():
        monkeypatch.setattr(eng, "DEVICE_LOCK", _NoLock())
        pair = [eng.InferenceEngine(chip_smoke.config("2b", "", 64), device=cuda) for _ in range(2)]
        tok = pair[0].tokenizer
        prompts = [
            [tok.encode(f"engine {j}, intent {i}: fetch the user record, then enrich it. JSON:") for i in range(n)]
            for j in range(2)
        ]
        try:
            await asyncio.gather(*(e.start() for e in pair))
            free = []
            for _ in range(rounds):
                free.append(await asyncio.gather(*(burst(e, p) for e, p in zip(pair, prompts))))
                torch.cuda.synchronize()
            monkeypatch.setattr(eng, "DEVICE_LOCK", real_lock)
            alone = [await burst(e, p) for e, p in zip(pair, prompts)]
            again = [await burst(e, p) for e, p in zip(pair, prompts)]
            torch.cuda.synchronize()
            diffs = differences(pair, prompts, free, alone)
        finally:
            monkeypatch.setattr(eng, "DEVICE_LOCK", real_lock)
            await asyncio.gather(*(e.aclose() for e in pair))
        return free, alone, again, diffs

    free, alone, again, diffs = asyncio.run(go())
    assert all(len(s) > 0 for streams, _ in alone for s in streams)
    assert [s for s, _ in again] == [s for s, _ in alone], (
        f"the locked runs differ from each other: {[c for _, c in alone]} {[c for _, c in again]}"
    )
    counters = {
        "locked": [c for _, c in alone],
        "lock_free": [[c for _, c in got] for got in free],
    }
    print(f"two engines lock-free: {len(diffs)} differing streams of {rounds * 2 * n}: {diffs} {counters}")
    assert not diffs, f"streams differ from the locked runs (round, engine, request, token, margin): {diffs} {counters}"


# One thread holds a CUDA-graph capture open on a stream of its own while
# another thread makes one call; prints whether each survived.
_CAPTURE_PROBE = r"""
import sys, threading
import torch

call = sys.argv[1]
dev = torch.device("cuda")
x = torch.zeros(1 << 20, device=dev)
torch.cuda.synchronize()
stream, graph = torch.cuda.Stream(dev), torch.cuda.CUDAGraph()
started, held, res = threading.Event(), threading.Event(), {}

def first_line(e):
    return str(e).splitlines()[0][:100]

def capture():
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        started.set()
        try:
            y = x
            for _ in range(200):
                y = y * 1.0001 + 1
            held.wait(5)
        finally:
            try:
                graph.capture_end()
                res["capture"] = "ok"
            except RuntimeError as e:
                res["capture"] = first_line(e)

def other():
    started.wait()
    try:
        if call == "synchronize":
            torch.cuda.synchronize()
        elif call == "graph_context":
            with torch.cuda.graph(torch.cuda.CUDAGraph(), capture_error_mode="thread_local"):
                torch.zeros(4, device=dev).add_(1)
        elif call == "empty_cache":
            torch.cuda.empty_cache()
        elif call == "capture_begin":
            s2, g2 = torch.cuda.Stream(dev), torch.cuda.CUDAGraph()
            with torch.cuda.stream(s2):
                g2.capture_begin(capture_error_mode="thread_local")
                torch.zeros(4, device=dev).add_(1)
                g2.capture_end()
        elif call == "malloc":
            torch.empty(1 << 30, dtype=torch.uint8, device=dev)
        elif call == "event_synchronize":
            e = torch.cuda.Event()
            e.record()
            e.synchronize()
        elif call == "eager_item":
            (torch.ones(1 << 20, device=dev) * 2).sum().item()
        res["call"] = "ok"
    except RuntimeError as e:
        res["call"] = first_line(e)
    finally:
        held.set()

threads = [threading.Thread(target=capture), threading.Thread(target=other)]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(f"capture={res.get('capture')}|call={res.get('call')}")
"""


@pytest.mark.cuda
def test_what_another_thread_may_do_while_a_graph_captures(cuda):
    """Why the engine captures with ``capture_begin``/``capture_end`` and
    never synchronizes the device on a serving path: while one thread's
    stream captures in thread-local mode, another thread's device-wide
    synchronize, and the entry of a ``torch.cuda.graph`` context (which
    synchronizes the device), raise and invalidate that capture; an
    allocator flush, a capture on another stream, a 1 GiB allocation, an
    event synchronize and an eager ``.item()`` leave it whole. Each call
    runs in a process of its own: a broken capture may poison the context."""
    breaks = ("synchronize", "graph_context")
    whole = ("empty_cache", "capture_begin", "malloc", "event_synchronize", "eager_item")
    seen = {}
    for call in breaks + whole:
        proc = subprocess.run(
            [sys.executable, "-c", _CAPTURE_PROBE, call], capture_output=True, text=True, timeout=120
        )
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("capture=")]
        seen[call] = lines[0] if lines else f"died rc={proc.returncode}: {proc.stderr[-300:]}"
    print(f"capture probe: {seen}")
    for call in breaks:
        assert "operation not permitted when stream is capturing" in seen[call], (call, seen[call])
        assert "capture=ok" not in seen[call], (call, seen[call])
    for call in whole:
        assert seen[call] == "capture=ok|call=ok", (call, seen[call])
