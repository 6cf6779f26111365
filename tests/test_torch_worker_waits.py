"""The worker's blocking device waits, counted the same way every time.

The engine counts its waits by site (the early exit's all-done flag reads
and the harvest, each with and without an event to wait on), whether or not
a profiler is attached. A ``WorkerProfiler`` attached while the worker idles
sees the whole burst that wakes it: the iteration that admits the burst and
dispatches its first segment, whose third and fourth windows wait on the
flags of its first two, runs under it, however soon after the attach the
burst arrives. On the CPU a flag has no event, so the flag ring here holds
stand-ins that make the flag site wait (and the profiler carve ``sync``) as
the card's events do; the harvest site has none, as on the CPU."""

import asyncio
import time

import torch

from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine.engine import FLAG_SLOTS, InferenceEngine
from mcpx_torch.telemetry.flight import WorkerProfiler

SITES = ("flag_waits", "flag_reads_no_event", "harvest_waits", "harvests_no_event")


class _SpinEvent:
    """A CUDA event's stand-in: ``record`` does nothing and ``synchronize``
    returns once the profiler's clock has moved, so its carve has a
    length."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        t = time.perf_counter()
        while time.perf_counter() == t:
            pass


async def _settled(engine) -> None:
    while any(engine.queue_stats()[k] for k in ("active_rows", "queue_depth", "inflight_segments")):
        await asyncio.sleep(0.005)


def test_profiler_attached_while_idle_sees_every_wait_of_the_burst():
    cfg = MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 256},
        "engine": {"max_batch_size": 4, "max_decode_len": 48, "warmup_compile": False, "prefix_cache": False,
                   "decode_steps_per_tick": 4, "steps_per_dispatch": 4, "pipeline_depth": 2},
    })

    async def go() -> list:
        torch.manual_seed(0)
        engine = InferenceEngine(cfg, device="cpu")
        await engine.start()
        try:
            engine._flag_events = [_SpinEvent() for _ in range(FLAG_SLOTS)]
            ids = engine.tokenizer.encode("count every wait of this plan")
            out = []
            for _ in range(3):
                await _settled(engine)
                # Past one whole idle poll: the worker waits inside the next
                # one, having read the profiler (none) before it.
                await asyncio.sleep(0.08)
                q0 = engine.queue_stats()
                engine._profiler = prof = WorkerProfiler()
                res = await engine.generate(ids, max_new_tokens=40, constrained=False, temperature=0.0)
                await _settled(engine)
                engine._profiler = None
                await asyncio.sleep(0.05)  # the worker ends the iteration it was in
                q1 = engine.queue_stats()
                phases = prof.snapshot()["phases"]
                out.append(dict(
                    tokens=res.token_ids, sync=phases["sync"]["count"], admits=phases["admit"]["count"],
                    **{k: q1[k] - q0[k] for k in SITES},
                ))
            return out
        finally:
            await engine.aclose()

    runs = asyncio.run(go())
    first = runs[0]
    assert first["flag_waits"] >= 2 and first["harvest_waits"] == first["flag_reads_no_event"] == 0
    assert first["harvests_no_event"] >= 1 and len(first["tokens"]) == 40
    for r in runs:
        assert r["admits"] == 1, runs
        assert r["sync"] == r["flag_waits"], runs
        assert r == first, runs
