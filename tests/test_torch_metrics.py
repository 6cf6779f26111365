"""The port's metrics (``mcpx_torch/telemetry/metrics.py``, built on its own
small thread-safe families) against the reference's (built on
``prometheus_client``, which the tests alone import):

  - the same 71 families under the same names, types and label names, with
    the same bucket edges and rate-limited endpoints;
  - after the same sequence of operations both expositions, parsed by
    ``prometheus_client``'s parsers, hold the same samples (text format and
    OpenMetrics), apart from the ``_created`` samples the port does not
    write and the declared ``mcpx_build_info`` label (``torch`` for
    ``jax``);
  - an exemplar survives the OpenMetrics round trip;
  - eight threads incrementing one series lose no update.
"""

import sys
import threading

import pytest
from prometheus_client.openmetrics.parser import text_string_to_metric_families as parse_openmetrics
from prometheus_client.parser import text_string_to_metric_families as parse_text

from mcpx.telemetry import metrics as ref
from mcpx_torch.telemetry import metrics as port


def _ops(m, build_info) -> None:
    """One sequence of operations over every kind of family: labelled and
    plain counters, gauges set up and down, histograms with exemplars, an
    escaped label value."""
    build_info(m)
    m.requests.labels(endpoint="/plan", status="ok").inc()
    m.requests.labels(endpoint="/plan", status="ok").inc(2)
    m.requests.labels(endpoint="/execute", status="error").inc()
    m.request_latency.labels(endpoint="/plan").observe(0.003, exemplar={"trace_id": "ab" * 16})
    m.request_latency.labels(endpoint="/plan").observe(20.0)
    m.request_latency.labels(endpoint="/plan").observe(0.1)
    m.plans.labels(planner="LLMPlanner", origin="llm", status="ok").inc()
    m.node_attempts.labels(kind="retry", status="timeout").inc()
    m.decode_tokens.inc(5)
    m.decode_forwards.inc(3)
    m.hol_wait.observe(7.0)
    m.hol_wait.observe(10000.0)
    m.engine_decode_seconds.observe(0.2, exemplar={"trace_id": "cd" * 16})
    m.queue_depth_class.labels(cls="free").set(2)
    m.queue_depth_class.labels(cls="free").set(1)
    m.batch_occupancy.set(3)
    m.kv_page_utilization.set(0.125)
    m.engine_compiles.labels(executable="window").inc()
    m.grammar_fallbacks.labels(kind='odd "kind"\\with\nnewline').inc()
    m.hbm_bytes_in_use.labels(device="cuda:0").set(12345678901)


def _pair():
    r, p = ref.Metrics(), port.Metrics()
    _ops(r, lambda m: m.set_build_info(version="0.1.0", jax="9.9", backend="cpu"))
    _ops(p, lambda m: m.set_build_info(version="0.1.0", torch="9.9", backend="cpu"))
    return r, p


def _samples(text: str, parser) -> set:
    out = set()
    for fam in parser(text):
        for s in fam.samples:
            if s.name.endswith("_created") or s.name == "mcpx_process_uptime_seconds":
                continue
            labels = dict(s.labels)
            if s.name == "mcpx_build_info":
                labels["runtime"] = labels.pop("jax", None) or labels.pop("torch")
            out.add((s.name, tuple(sorted(labels.items())), s.value))
    return out


def test_families_names_types_labels_and_buckets_match_reference():
    def families(m):
        out = {}
        for fam in parse_text(m.render().decode()):
            if fam.name.endswith("_created"):
                continue
            out[fam.name] = (fam.type, fam.documentation)
        return out

    r, p = families(ref.Metrics()), families(port.Metrics())
    assert len(p) == 71
    assert sorted(r) == sorted(p)
    assert {k: v[0] for k, v in r.items()} == {k: v[0] for k, v in p.items()}
    # Help strings are the reference's, less its history note and the
    # build-info label's name.
    differ = sorted(k for k in r if r[k][1] != p[k][1])
    assert differ == ["mcpx_build_info", "mcpx_grammar_fallbacks"]
    assert port.LATENCY_BUCKETS == ref.LATENCY_BUCKETS
    assert port.LIMITED_ENDPOINTS == ref.LIMITED_ENDPOINTS
    rm, pm = ref.Metrics(), port.Metrics()
    for name, fam in vars(pm).items():
        if isinstance(fam, port._Family):
            want = tuple(getattr(rm, name)._labelnames)
            assert fam.labelnames == (("version", "torch", "backend") if name == "build_info" else want), name
    assert pm.hol_wait._bounds[:-1] == tuple(float(b) for b in rm.hol_wait._upper_bounds[:-1])


@pytest.mark.parametrize("openmetrics", [False, True], ids=["text", "openmetrics"])
def test_exposition_samples_match_reference(openmetrics):
    r, p = _pair()
    parser = parse_openmetrics if openmetrics else parse_text
    rs = _samples(r.render(openmetrics=openmetrics).decode(), parser)
    ps = _samples(p.render(openmetrics=openmetrics).decode(), parser)
    assert ps == rs
    assert len(ps) > 140


def test_openmetrics_exemplar_round_trips():
    _, p = _pair()
    text = p.render(openmetrics=True).decode()
    assert text.endswith("# EOF\n")
    found = {}
    for fam in parse_openmetrics(text):
        for s in fam.samples:
            if s.exemplar is not None:
                found[(s.name, s.labels.get("le"))] = s.exemplar
    assert set(found) == {
        ("mcpx_request_latency_seconds_bucket", "0.005"),
        ("mcpx_engine_decode_seconds_bucket", "0.25"),
    }
    ex = found[("mcpx_request_latency_seconds_bucket", "0.005")]
    assert ex.labels == {"trace_id": "ab" * 16} and ex.value == 0.003
    # The classic text format drops exemplars.
    assert "trace_id" not in p.render().decode()


def test_eight_threads_lose_no_update():
    m = port.Metrics()
    n, threads = 2000, 8
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k: int) -> None:
        for j in range(n):
            m.requests.labels(endpoint="/plan", status="ok").inc()
            m.requests.labels(endpoint=f"/t{k}", status="ok").inc()
            m.decode_forwards.inc()
            m.request_latency.labels(endpoint="/plan").observe(0.001 * (j % 7))

    try:
        ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(switch)
    got = {
        (s.name, tuple(sorted(s.labels.items()))): s.value
        for fam in parse_text(m.render().decode())
        for s in fam.samples
    }
    assert got[("mcpx_requests_total", (("endpoint", "/plan"), ("status", "ok")))] == n * threads
    assert all(got[("mcpx_requests_total", (("endpoint", f"/t{k}"), ("status", "ok")))] == n for k in range(threads))
    assert got[("mcpx_engine_decode_forwards_total", ())] == n * threads
    assert got[("mcpx_request_latency_seconds_count", (("endpoint", "/plan"),))] == n * threads
    assert got[("mcpx_request_latency_seconds_bucket", (("endpoint", "/plan"), ("le", "+Inf")))] == n * threads


def test_families_refuse_misuse_as_prometheus_client_does():
    m = port.Metrics()
    with pytest.raises(ValueError):
        m.decode_tokens.inc(-1)
    with pytest.raises(ValueError):
        m.requests.inc()  # a labelled family needs labels()
    with pytest.raises(ValueError):
        m.requests.labels(endpoint="/plan")  # a label is missing
    with pytest.raises(ValueError):
        m.decode_tokens.labels("x")  # no labels to give
