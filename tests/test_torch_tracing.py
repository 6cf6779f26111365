"""The request-tracing spine (``mcpx_torch/telemetry/tracing.py``) against
the reference's (``mcpx/telemetry/tracing.py``): the module cases of the
reference's ``tests/test_tracing.py``, each run against both packages'
modules. The HTTP cases (``traceparent`` through the app, ``/traces``,
exemplars) are in ``tests/test_torch_app.py``."""

import asyncio
import json
import logging
import threading

import pytest

from mcpx.telemetry import tracing as ref_tracing
from mcpx_torch.telemetry import tracing as port_tracing

PACKAGES = pytest.mark.parametrize("tracing", [ref_tracing, port_tracing], ids=["mcpx", "mcpx_torch"])


@PACKAGES
def test_span_tree_parent_links_and_attrs(tracing):
    tr = tracing.Tracer(enabled=True, sample_rate=1.0)
    root = tr.start_request("/plan", method="POST")
    with tracing.activate(root):
        with tracing.span("plan", path="primary") as sp:
            assert sp is not None
            with tracing.span("engine.generate") as esp:
                esp.set(tokens=7)
        assert tr.finish(root) is True
    rec = tr.get(root.record.trace_id)
    assert rec is not None
    by_name = {s.name: s for s in rec.spans}
    assert by_name["plan"].parent_id == root.span_id
    assert by_name["engine.generate"].parent_id == by_name["plan"].span_id
    assert by_name["engine.generate"].attrs["tokens"] == 7
    for s in rec.spans:
        assert s.t1 >= s.t0
        assert s.t0 >= root.t0 - 1e-9


@PACKAGES
def test_span_noop_without_active_trace(tracing):
    with tracing.span("orphan") as sp:
        assert sp is None
    assert tracing.current_span() is None
    assert tracing.current_trace_id() is None


@PACKAGES
def test_concurrent_requests_do_not_leak_spans_across_contextvars(tracing):
    tr = tracing.Tracer(enabled=True, sample_rate=1.0, ring_size=64)

    async def one(i: int) -> str:
        root = tr.start_request(f"/req{i}")
        with tracing.activate(root):
            for j in range(3):
                with tracing.span(f"step{i}.{j}"):
                    await asyncio.sleep(0)
            tr.finish(root)
        return root.record.trace_id

    async def go():
        return await asyncio.gather(*(asyncio.create_task(one(i)) for i in range(8)))

    tids = asyncio.run(go())
    assert len(set(tids)) == 8
    for i, tid in enumerate(tids):
        rec = tr.get(tid)
        assert {s.name for s in rec.spans} == {f"/req{i}"} | {f"step{i}.{j}" for j in range(3)}
        assert all(s.record is rec for s in rec.spans)


@PACKAGES
def test_worker_thread_child_spans_with_explicit_timestamps(tracing):
    tr = tracing.Tracer(enabled=True, sample_rate=1.0)
    root = tr.start_request("/plan")

    def worker():
        root.child("engine.segment", t0=root.t0, t1=root.t0 + 0.002, tokens=4)

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    tr.finish(root)
    seg = next(s for s in tr.get(root.trace_id).spans if s.name == "engine.segment")
    assert seg.attrs["tokens"] == 4
    assert abs(seg.duration_ms - 2.0) < 0.5


@PACKAGES
def test_ring_eviction_keeps_newest(tracing):
    tr = tracing.Tracer(enabled=True, sample_rate=1.0, ring_size=2)
    tids = []
    for i in range(4):
        root = tr.start_request(f"/r{i}")
        tr.finish(root)
        tids.append(root.record.trace_id)
    assert tr.get(tids[0]) is None and tr.get(tids[1]) is None
    assert tr.get(tids[2]) is not None and tr.get(tids[3]) is not None
    assert [r.trace_id for r in tr.traces()] == [tids[3], tids[2]]


@PACKAGES
def test_head_sampling_zero_drops_but_errors_are_always_kept(tracing):
    tr = tracing.Tracer(enabled=True, sample_rate=0.0, ring_size=8)
    dropped = tr.start_request("/ok")
    assert tr.finish(dropped) is False
    assert tr.get(dropped.record.trace_id) is None
    kept = tr.start_request("/boom")
    assert tr.finish(kept, error=True) is True
    rec = tr.get(kept.record.trace_id)
    assert rec.error and rec.root.status == "error"


@PACKAGES
def test_sealed_record_drops_late_worker_spans(tracing):
    tr = tracing.Tracer(enabled=True, sample_rate=1.0)
    root = tr.start_request("/plan")
    root.child("engine.queue_wait", t0=root.t0, t1=root.t0 + 0.001)
    tr.finish(root)
    n_before = len(root.record.spans)
    late = root.child("engine.segment", t0=root.t0, t1=root.t0 + 9.0, tokens=3)
    assert late.attrs["tokens"] == 3
    assert len(root.record.spans) == n_before
    assert tr.get(root.trace_id).to_chrome()


@PACKAGES
def test_slo_breach_tail_sampling(tracing):
    tr = tracing.Tracer(enabled=True, sample_rate=0.0, ring_size=8, slo_breach_ms=1.0)
    root = tr.start_request("/slow")
    root.end(root.t0 + 0.050)
    assert tr.finish(root) is True
    fast = tr.start_request("/fast")
    fast.end(fast.t0 + 0.0001)
    assert tr.finish(fast) is False


@PACKAGES
def test_disabled_tracer_is_noop(tracing):
    tr = tracing.Tracer(enabled=False)
    assert tr.start_request("/plan") is None
    assert tr.finish(None) is False
    assert tr.traces() == []


@PACKAGES
def test_tracer_reads_its_knobs_from_the_config_section(tracing):
    from mcpx_torch.core.config import MCPXConfig

    cfg = MCPXConfig.from_dict({"tracing": {"sample_rate": 0.25, "ring_size": 7, "slo_breach_ms": 9.0}})
    tr = tracing.Tracer(cfg.tracing)
    assert (tr.enabled, tr.sample_rate, tr.ring_size, tr.keep_errors, tr.slo_breach_ms) == (
        True, 0.25, 7, True, 9.0
    )


@PACKAGES
def test_chrome_export_schema_and_duration_sum(tracing):
    tr = tracing.Tracer(enabled=True, sample_rate=1.0)
    root = tr.start_request("/plan")
    t0 = root.t0
    root.child("sched.acquire", t0=t0, t1=t0 + 0.010)
    root.child("plan", t0=t0 + 0.010, t1=t0 + 0.090)
    root.child("node:a", t0=t0 + 0.020, t1=t0 + 0.060)
    root.child("node:b", t0=t0 + 0.020, t1=t0 + 0.080)
    root.end(t0 + 0.100)
    tr.finish(root)
    chrome = tr.get(root.trace_id).to_chrome()
    assert chrome["displayTimeUnit"] == "ms"
    xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 5
    for e in xs:
        for key in ("name", "ph", "ts", "dur", "pid", "tid", "args"):
            assert key in e, e
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert e["args"]["span_id"]
    root_ev = next(e for e in xs if e["name"] == "/plan")
    assert abs(root_ev["dur"] - 100e3) < 1e3
    for e in xs:
        assert e["ts"] + e["dur"] <= root_ev["ts"] + root_ev["dur"] + 1.0
    tid_a = next(e["tid"] for e in xs if e["name"] == "node:a")
    tid_b = next(e["tid"] for e in xs if e["name"] == "node:b")
    assert tid_a != tid_b
    json.loads(json.dumps(chrome))


@PACKAGES
def test_traceparent_parse_and_format(tracing):
    assert tracing.parse_traceparent(None) is None
    assert tracing.parse_traceparent("garbage") is None
    assert tracing.parse_traceparent("00-" + "0" * 32 + "-" + "1" * 16 + "-01") is None
    tid, pid = "ab" * 16, "cd" * 8
    assert tracing.parse_traceparent(f"00-{tid}-{pid}-01") == (tid, pid)
    tr = tracing.Tracer(enabled=True)
    root = tr.start_request("/plan", traceparent=f"00-{tid}-{pid}-01")
    assert root.record.trace_id == tid
    assert root.record.remote_parent == pid
    assert tracing.parse_traceparent(tracing.format_traceparent(root)) == (tid, root.span_id)


@PACKAGES
def test_json_log_lines_carry_trace_ids(tracing):
    tr = tracing.Tracer(enabled=True)
    root = tr.start_request("/plan")
    lines = []

    class Capture(logging.Handler):
        def emit(self, record):
            lines.append(tracing.JsonLogFormatter().format(record))

    logger = logging.getLogger(f"mcpx.test.tracelog.{tracing.__name__}")
    logger.setLevel(logging.INFO)
    cap = Capture()
    cap.addFilter(tracing.TraceLogFilter())
    logger.addHandler(cap)
    try:
        with tracing.activate(root):
            logger.info("inside request")
        logger.info("outside request")
    finally:
        logger.removeHandler(cap)
    inside, outside = json.loads(lines[0]), json.loads(lines[1])
    assert inside["trace_id"] == root.record.trace_id
    assert inside["span_id"] == root.span_id
    assert inside["msg"] == "inside request"
    assert "trace_id" not in outside


def test_export_of_one_span_tree_is_equal_in_both_packages():
    """The same tree, built with the same timestamps and ids, exports the
    same ``to_dict`` and ``to_chrome`` bodies."""
    out = []
    for tracing in (ref_tracing, port_tracing):
        rec = tracing.TraceRecord("f" * 32)
        rec.name = "/plan"
        rec.t0_wall = 1.0
        root = tracing.Span(rec, "/plan", None, t0=10.0)
        rec.spans.append(root)
        for k, (name, a, b) in enumerate((("plan", 10.001, 10.05), ("engine.decode", 10.01, 10.04))):
            sp = root.child(name, t0=a, t1=b, tokens=k)
            sp.span_id = f"{k:016x}"
        root.span_id = "e" * 16
        for sp in rec.spans[1:]:
            sp.parent_id = root.span_id
        root.end(10.1)
        out.append((rec.to_dict(), rec.to_chrome(), rec.summary()))
    assert out[0] == out[1]
