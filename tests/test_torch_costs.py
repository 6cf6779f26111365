"""The port's cost observatory and worker-loop profiler against the
reference's:

  - ``WorkerProfiler`` driven by a fake clock through the same laps and
    carves gives snapshots and ``delta_ms`` equal to the reference's;
  - ``roofline`` and ``rounded_roofline`` are equal to the reference's;
  - the analytic FLOPs of ``forward_cost`` equal ``FlopCounterMode``'s
    count of one eager test-width forward within 1%: a paged decode
    forward, whose ragged attention (a ctypes kernel on the card, invisible
    to the counter) is stubbed out and counted by hand, and a dense
    prefill, whose attention einsums the counter sees;
  - ``CostRegistry.snapshot`` has the reference's keys at every level, and
    on a CPU engine the capture sentinel counts each executable key once,
    ``mcpx_engine_compiles_total`` with it, and repeated traffic adds none;
  - without CUDA, ``device_peaks`` reports no peaks and ``hbm_stats`` no
    allocator.
"""

import asyncio

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mcpx.telemetry import costs as ref_costs
from mcpx.telemetry import flight as ref_flight
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine import paged_decode
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.engine.kv_cache import init_paged_kv
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import init_kv_cache, init_params, prefill
from mcpx_torch.telemetry import costs as port_costs
from mcpx_torch.telemetry import flight as port_flight
from mcpx_torch.telemetry.metrics import Metrics


class FakeClock:
    def __init__(self, steps):
        self.steps = list(steps)
        self.t = 100.0

    def __call__(self) -> float:
        self.t += self.steps.pop(0)
        return self.t


# Each entry: a profiler call and the clock advance its clock read sees.
SCRIPT = [
    ("tick", 0.0), ("mark", 0.01), ("carve", "idle", 0.040), ("lap", "drain", 0.002),
    ("lap", "host_bookkeeping", 0.0003), ("mark", 0.0001), ("carve", "locality_sort", 0.00002),
    ("mark", 0.0), ("carve", "prefix_match", 0.0004), ("lap", "admit", 0.03),
    ("mark", 0.001), ("carve", "sync", 0.005), ("lap", "dispatch_submit", 0.002),
    ("mark", 0.0), ("carve", "sync", 0.2), ("lap", "harvest", 0.0004),
    ("tick", 0.0), ("lap", "drain", 0.00001), ("lap", "host_bookkeeping", 3.5),
]


def _drive(module):
    steps = [step[-1] for step in SCRIPT if step[0] != "tick"]
    prof = module.WorkerProfiler(clock=FakeClock([0.0] + steps))
    snaps = []
    t0 = None
    for step in SCRIPT:
        if step[0] == "tick":
            prof.loop_tick()
        elif step[0] == "mark":
            t0 = prof.mark()
        elif step[0] == "carve":
            prof.carve(step[1], t0)
        else:
            prof.lap(step[1])
        snaps.append(prof.totals_copy())
    return prof.snapshot(), snaps, prof


def test_worker_profiler_matches_reference_under_a_fake_clock():
    assert port_flight.PROFILE_PHASES == ref_flight.PROFILE_PHASES
    assert port_flight._HIST_EDGES == ref_flight._HIST_EDGES
    ref_snap, ref_totals, _ = _drive(ref_flight)
    snap, totals, prof = _drive(port_flight)
    assert snap == ref_snap
    assert totals == ref_totals
    assert snap["attributed_frac"] == 1.0 and snap["iterations"] == 2
    for a, b in zip(totals, totals[3:]):
        assert port_flight.WorkerProfiler.delta_ms(a, b) == ref_flight.WorkerProfiler.delta_ms(a, b)


@pytest.mark.parametrize(
    "args",
    [
        (1e12, 1e9, 0.5, 989.4e12, 3.35e12),
        (1e12, 1e12, 2.0, 989.4e12, 3.35e12),
        (3.3e9, 7.1e7, 0.013, None, None),
        (None, 5e8, 0.2, 989.4e12, 3.35e12),
        (0.0, 0.0, 1.0, 989.4e12, 3.35e12),
        (1e12, 1e9, 0.0, 989.4e12, 3.35e12),
    ],
)
def test_roofline_matches_reference(args):
    flops, nbytes, wall, pf, pb = args
    for fn in ("roofline", "rounded_roofline"):
        got = getattr(port_costs, fn)(flops, nbytes, wall, peak_flops=pf, peak_bytes_s=pb)
        want = getattr(ref_costs, fn)(flops, nbytes, wall, peak_flops=pf, peak_bytes_s=pb)
        assert got == want, fn


CFG = GemmaConfig.named("test", vocab_size=3072)


def _params():
    return init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def test_analytic_flops_of_a_paged_forward_match_the_flop_counter(monkeypatch):
    B, S, psz, pmax = 8, 8, 16, 4
    params = _params()
    pools = init_paged_kv(CFG, B * pmax + 1, psz, "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 3000, (B, S), generator=g)
    positions = torch.randint(0, psz * pmax - S, (B,), generator=g)
    table = torch.arange(1, B * pmax + 1, dtype=torch.int32).reshape(B, pmax)
    q_lens = torch.full((B,), S, dtype=torch.int32)

    def kernel(q, k_pages, v_pages, page_table, start_pos, q_lens, layer=0):
        return torch.zeros_like(q)  # as invisible to the counter as the card's kernel

    monkeypatch.setattr(paged_decode, "ragged_paged_attention", kernel)
    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        paged_decode.decode_chunk_paged(
            params, CFG, tokens, positions, table, pools, logits_at=q_lens.long() - 1, q_lens=q_lens,
        )
    context = psz * pmax
    attention = 4 * B * S * CFG.n_heads * CFG.head_dim * context * CFG.n_layers
    flops, nbytes = port_costs.forward_cost(
        CFG, batch=B, width=S, context=context, unembed_rows=B, unembed_cols=CFG.vocab_size,
    )
    assert abs(flops - (counter.get_total_flops() + attention)) <= 0.01 * flops
    assert nbytes > 0


def test_analytic_flops_of_a_dense_prefill_match_the_flop_counter():
    A, T = 4, 64
    params = _params()
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, 3000, (A, T), generator=g)
    lens = torch.tensor([64, 17, 40, 5])
    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        prefill(params, CFG, tokens, lens, init_kv_cache(CFG, A, T, device="cpu"), last_only=True)
    flops, _ = port_costs.forward_cost(
        CFG, batch=A, width=T, context=T, unembed_rows=A, unembed_cols=CFG.vocab_size,
    )
    assert abs(flops - counter.get_total_flops()) <= 0.01 * flops


def _key_shape(obj):
    if isinstance(obj, dict):
        return {k: _key_shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_key_shape(obj[0])] if obj else []
    return None


def test_cost_snapshot_has_the_reference_keys():
    import jax
    import jax.numpy as jnp

    from mcpx.telemetry.metrics import Metrics as RefMetrics

    reg = ref_costs.CostRegistry(metrics=RefMetrics())
    f = reg.wrap("window", jax.jit(lambda x: x * 2.0))
    f(jnp.ones((4,)))
    port = port_costs.CostRegistry(metrics=Metrics())
    port.record("window", ("draft", 8), lambda: (10.0, 20.0))
    assert _key_shape(port.snapshot()) == _key_shape(reg.snapshot())
    assert port.snapshot()["totals"] == {"flops_executed": 10.0, "bytes_executed": 20.0, "unaccounted_calls": 0}
    assert port_costs.CostRegistry(enabled=False).record("window", (1,), lambda: (1.0, 1.0)) is None


def test_device_peaks_and_hbm_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pk = port_costs.device_peaks()
    assert pk["flops_per_chip"] is None and pk["hbm_bytes_s_per_chip"] is None and pk["basis"] is None
    assert set(pk) == {"device_kind", "n_devices", "flops_per_chip", "hbm_bytes_s_per_chip", "basis"}
    assert port_costs.hbm_stats() == [{"device": "cpu", "available": False}]
    m = Metrics()
    port_costs.update_hbm_gauges(m)
    assert "mcpx_hbm_bytes_in_use{" not in m.render().decode()


def test_capture_sentinel_counts_each_key_once_and_repeats_add_none():
    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "vocab": "bpe", "max_seq_len": 256},
        "engine": {"max_batch_size": 4, "max_decode_len": 16, "kv_page_size": 16, "max_pages_per_seq": 16},
    })

    async def go():
        eng = InferenceEngine(cfg, device="cpu")
        await eng.start()
        try:
            prompts = [eng.tokenizer.encode(f"Intent: thing {i}\nJSON:") for i in range(3)]
            snaps = []
            for _ in range(2):
                await asyncio.gather(*(eng.generate(p) for p in prompts))
                snaps.append((eng.costs.snapshot(), eng.queue_stats(), eng.metrics.render().decode()))
            return snaps
        finally:
            await eng.aclose()

    (s1, q1, m1), (s2, q2, m2) = asyncio.run(go())
    compiles = {name: e["compiles"] for name, e in s1["executables"].items()}
    assert set(compiles) == {"prefill", "admit", "window"}
    assert {name: e["compiles"] for name, e in s2["executables"].items()} == compiles
    for name, n in compiles.items():
        assert f'mcpx_engine_compiles_total{{executable="{name}"}} {float(n)}' in m2
    calls = {name: sum(s["calls"] for s in e["signatures"]) for name, e in s2["executables"].items()}
    assert calls["window"] == q2["windows"]
    assert calls["admit"] == q2["admissions"]
    flops = sum(s["flops"] * s["calls"] for e in s2["executables"].values() for s in e["signatures"])
    assert s2["totals"]["flops_executed"] == pytest.approx(flops)
    assert s2["totals"]["flops_executed"] > s1["totals"]["flops_executed"] > 0
    assert all(s["cost_basis"] == "analytic" for e in s2["executables"].values() for s in e["signatures"])
