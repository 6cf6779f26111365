"""The port stands alone: nothing in ``mcpx_torch``, ``chip_smoke.py`` or
``kernel_ab.py`` imports JAX or the reference package, the package imports and builds a CPU
control plane with both blocked, and its entry points never drop to the CPU
on their own (a replica pool's engines neither). The GPU machine has no aiohttp, prometheus_client or redis:
only ``mcpx_torch.server.app`` imports aiohttp at module level (the HTTP
transport imports it inside its methods, the Redis plan cache imports redis
at its first use), nothing imports prometheus_client (the port's metrics are
its own), and the control plane serves ``/plan`` and ``/plan_and_execute``,
traced, renders its metrics, admits through the scheduler, executes through
the resilience facade over the chaos transport, and serves an int8 engine
with telemetry's default-off parts on (its mirror refusing to sync without
redis, by name), with all three blocked."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from mcpx_torch.cluster import EnginePool
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.core.errors import EngineError
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.parallel import make_mesh
from mcpx_torch.server.factory import build_control_plane

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources() -> list[str]:
    out = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "kernel_ab.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "mcpx_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "mcpx")


def test_walk_covers_every_module_of_the_port():
    """The walk sees every module, the int8, scheduler, resilience,
    default-off telemetry, config-surface, cluster, offline, parallel and
    static-analysis ones among them."""
    rel = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for module in (
        "models/gemma/quant.py", "scheduler/admission.py", "scheduler/fairness.py",
        "scheduler/degrade.py", "scheduler/scheduler.py", "resilience/__init__.py",
        "resilience/breaker.py", "resilience/budget.py", "resilience/hedge.py", "resilience/chaos.py",
        "telemetry/ledger.py", "telemetry/slo.py", "telemetry/provenance.py", "telemetry/flight.py",
        "telemetry/mirror.py", "utils/redis_client.py", "planner/mock.py", "registry/file.py",
        "registry/redis_backend.py", "models/sp_model.py", "ops/__init__.py", "cli/__init__.py",
        "cli/__main__.py", "cli/main.py", "cluster/__init__.py", "cluster/pool.py", "cluster/replica.py",
        "cluster/routing.py", "cluster/sharding.py", "planner/quality.py", "planner/evaluate.py",
        "models/corpus.py", "models/train.py", "models/gemma/convert.py", "cli/bench_report.py",
        "parallel/__init__.py", "parallel/mesh.py", "parallel/ring_attention.py",
        "analysis/__init__.py", "analysis/core.py", "analysis/callgraph.py", "analysis/dataflow.py",
        "analysis/project.py", "analysis/cli.py", "analysis/fix.py", "analysis/rules/torch_rules.py",
        "analysis/rules/graph_contract_rules.py", "analysis/rules/ownership_rules.py",
    ):
        assert f"mcpx_torch/{module}" in rel, module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_package_imports_and_serves_with_jax_and_reference_blocked():
    script = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["mcpx"] = None
sys.modules["prometheus_client"] = None
sys.path.insert(0, {ROOT!r})
import mcpx_torch
for m in pkgutil.walk_packages(mcpx_torch.__path__, "mcpx_torch."):
    importlib.import_module(m.name)
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.server.factory import build_control_plane
cfg = MCPXConfig.from_dict({{"planner": {{"kind": "llm"}}, "model": {{"vocab": "bpe"}}}})
cp = build_control_plane(cfg, device="cpu")
assert cp.planner.engine.device.type == "cpu"
cfg = MCPXConfig.from_dict({{"planner": {{"kind": "llm"}}, "model": {{"vocab": "bpe"}},
                            "cluster": {{"enabled": True, "shard_registry": True}}}})
cp = build_control_plane(cfg, device="cpu")
assert cp.cluster.device.type == "cpu" and cp.retriever.n_shards == 2
assert not any(
    k in ("jax", "prometheus_client") or k.startswith(("jax.", "mcpx.", "prometheus_client."))
    for k in sys.modules if sys.modules[k]
)
print("ok")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, cwd=ROOT, env=env, timeout=120
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MCPXConfig.from_dict({"planner": {"kind": "llm"}, "model": {"vocab": "bpe"}})
    with pytest.raises(EngineError, match="CUDA is not available"):
        build_control_plane(cfg)
    with pytest.raises(EngineError, match="CUDA is not available"):
        InferenceEngine(cfg)
    cfg.cluster.enabled = True
    with pytest.raises(EngineError, match="CUDA is not available"):
        build_control_plane(cfg)
    with pytest.raises(EngineError, match="CUDA is not available"):
        EnginePool(cfg)
    with pytest.raises(EngineError, match="CUDA is not available"):
        build_control_plane(MCPXConfig.from_dict({"planner": {"kind": "heuristic"}}))
    with pytest.raises(EngineError, match="CUDA is not available"):
        make_mesh()


OPTIONAL = ("aiohttp", "prometheus_client", "redis")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_optional_packages_are_imported_only_where_allowed(path):
    """aiohttp at module level only in the app; inside functions only in the
    HTTP transport; redis only inside functions; prometheus_client nowhere."""
    rel = os.path.relpath(path, ROOT)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    in_function = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_function.update(id(n) for n in ast.walk(fn))
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        for name in names:
            top = name.split(".")[0]
            if top not in OPTIONAL:
                continue
            lazy = id(node) in in_function
            allowed = (
                (top == "aiohttp" and rel == "mcpx_torch/server/app.py")
                or (top == "aiohttp" and lazy and rel == "mcpx_torch/orchestrator/transport.py")
                or (top == "redis" and lazy)
            )
            if not allowed:
                bad.append((name, "in a function" if lazy else "at module level"))
    assert not bad, f"{rel} imports {bad}"


def test_control_plane_serves_with_optional_packages_blocked():
    script = f"""
import asyncio, sys
for name in {OPTIONAL!r} + ("jax", "mcpx"):
    sys.modules[name] = None
sys.path.insert(0, {ROOT!r})
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.orchestrator.executor import Orchestrator
from mcpx_torch.orchestrator.transport import LocalTransport, RouterTransport
from mcpx_torch.registry import ServiceRecord
from mcpx_torch.server.control import ControlPlane
from mcpx_torch.server.factory import build_control_plane
from mcpx_torch.telemetry import tracing

async def go():
    local = LocalTransport()

    async def ok(payload):
        return {{"ok": True}}

    local.register("svc-a", ok)
    cfg = MCPXConfig.from_dict({{"planner": {{"kind": "heuristic"}}}})
    cp = build_control_plane(cfg, transport=RouterTransport(local=local), device="cpu")
    assert isinstance(cp, ControlPlane) and isinstance(cp.orchestrator, Orchestrator)
    await cp.registry.put(ServiceRecord(name="svc-a", endpoint="local://svc-a", description="do a"))
    plan, _ = await cp.plan("do a")
    root = cp.tracer.start_request("/plan_and_execute")
    with tracing.activate(root):
        out = await cp.plan_and_execute("do a", {{}})
    cp.tracer.finish(root)
    assert plan.nodes and out["status"] == "ok", out
    # The admission scheduler, the resilience facade and the chaos
    # transport, with the optional packages blocked.
    import json, os, tempfile
    with tempfile.TemporaryDirectory() as d:
        profile = os.path.join(d, "chaos.json")
        with open(profile, "w") as f:
            json.dump({{"seed": 1, "endpoints": {{"local://none": {{"error_rate": 1.0}}}}}}, f)
        cfg = MCPXConfig.from_dict({{
            "planner": {{"kind": "heuristic"}}, "scheduler": {{"enabled": True}},
            "resilience": {{"enabled": True, "chaos_profile": profile}},
        }})
        res = build_control_plane(cfg, transport=RouterTransport(local=local), device="cpu")
    await res.registry.put(ServiceRecord(name="svc-a", endpoint="local://svc-a", description="do a"))
    slot = await res.scheduler.acquire(res.scheduler.context_from_headers({{}}))
    try:
        plan, _ = await res.plan("do a", degraded=slot.degraded, deadline_at=slot.ctx.deadline_at)
    finally:
        res.scheduler.release(slot)
    result = await res.execute(plan, {{}}, deadline_ms=500.0)
    assert result.status == "ok" and res.orchestrator.resilience is not None
    assert {{"plan", "execute", "node:svc-a", "attempt"}} <= {{s.name for s in root.record.spans}}
    text = cp.metrics.render().decode() + cp.metrics.render(openmetrics=True).decode()
    assert 'mcpx_node_attempts_total{{kind="primary",status="ok"}} 1.0' in text
    small = {{
        "planner": {{"kind": "llm"}}, "model": {{"size": "test", "max_seq_len": 256, "quantize": "int8"}},
        "engine": {{"max_batch_size": 2, "max_decode_len": 16, "kv_page_size": 16, "max_pages_per_seq": 16}},
    }}
    # Telemetry's default-off parts, all on: a billed, explained plan on
    # the int8 engine, an SLO observe, a flight sample, and the mirror's
    # sync refused by name without redis.
    from mcpx_torch.telemetry import ledger, provenance
    with tempfile.TemporaryDirectory() as d:
        small["telemetry"] = {{
            "ledger": {{"enabled": True}}, "provenance": {{"enabled": True}}, "redis_url": "redis://unused",
            "flight": {{"enabled": True, "bundle_dir": d}},
        }}
        small["slo"] = {{"enabled": True}}
        llm = build_control_plane(MCPXConfig.from_dict(small), device="cpu")
        await llm.registry.put(ServiceRecord(name="svc-a", endpoint="local://svc-a"))
        await llm.startup()
        bill = ledger.RequestBill(endpoint="/plan")
        token, trail = ledger.activate(bill), provenance.begin(llm.provenance)
        root = llm.tracer.start_request("/plan")
        try:
            with tracing.activate(root):
                plan, _ = await llm.plan("do a")
        finally:
            provenance.end(trail)
            ledger.deactivate(token)
        llm.tracer.finish(root)
        plan.validate()
        bill.finalize(status="ok", total_ms=1.0)
        llm.ledger.observe(bill)
        llm.slo.observe(tenant="default", endpoint="/plan", latency_ms=1.0, error=False)
        assert bill.generates >= 1 and bill.decode_tokens > 0 and bill.flops > 0
        assert provenance.build_explanation(root.record)["decisions"]
        assert llm.flight.sample() == [] and llm.flight.samples == 1
        try:
            await llm.telemetry_mirror.sync()
            raise AssertionError("the mirror synced without redis")
        except RuntimeError as e:
            assert "telemetry.redis_url" in str(e)
        await llm.aclose()

asyncio.run(go())
loaded = [k for k in sys.modules if sys.modules[k] and k.split(".")[0] in {OPTIONAL!r}]
assert not loaded, loaded
print("ok")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, cwd=ROOT, env=env, timeout=300
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
