"""The port's CLI (``python -m mcpx_torch.cli``), held on the CPU: the
reference's four CLI tests (``tests/test_cli.py``) mirrored on the port,
with the control plane on ``device="cpu"``; ``gen-registry`` writes the
reference's file byte for byte; the offline commands (``train-planner``,
``eval-planner``, ``bench report``) are served with the reference's
arguments and output; and ``lint`` is served too: the port's mcpxlint
over the port's tree, clean against the port's baseline."""

import argparse
import asyncio
import json
import os
import subprocess
import sys

import pytest
from aiohttp import ClientSession
from aiohttp.test_utils import TestServer

from mcpx.cli.main import main as jmain
from mcpx_torch.cli.main import _load_config, main
from mcpx_torch.server.app import build_app
from mcpx_torch.server.factory import build_control_plane

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve_file(reg_path: str, provenance: bool = False):
    cfg = _load_config(argparse.Namespace(config=None, registry_file=reg_path, planner="heuristic"))
    assert cfg.registry.backend == "file" and cfg.registry.file_path == reg_path
    cfg.telemetry.provenance.enabled = provenance
    return TestServer(build_app(build_control_plane(cfg, device="cpu")))


def test_gen_registry_then_serve_smoke(tmp_path, capsys):
    reg_path = tmp_path / "registry.json"
    assert main(["gen-registry", "5", "--out", str(reg_path), "--seed", "3"]) == 0
    records = json.loads(reg_path.read_text())
    assert len(records) == 5
    assert all({"name", "endpoint"} <= set(r) for r in records)
    assert jmain(["gen-registry", "5", "--out", str(tmp_path / "ref.json"), "--seed", "3"]) == 0
    assert reg_path.read_bytes() == (tmp_path / "ref.json").read_bytes()

    # The file registry and the heuristic planner serve end to end over HTTP.
    async def go():
        server = _serve_file(str(reg_path))
        await server.start_server()
        try:
            async with ClientSession() as s:
                async with s.get(f"http://{server.host}:{server.port}/services") as r:
                    body = await r.json()
                assert r.status == 200 and len(body["services"]) == 5
                async with s.post(
                    f"http://{server.host}:{server.port}/plan", json={"intent": f"use {records[0]['name']}"}
                ) as r:
                    assert r.status == 200
                    plan = await r.json()
                assert plan["graph"]["nodes"]
        finally:
            await server.close()

    asyncio.run(go())


def test_validate_accepts_and_rejects(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"nodes": [{"name": "a"}, {"name": "b"}], "edges": [{"from": "a", "to": "b"}]}))
    assert main(["validate", str(good)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["valid"] and out["generations"] == [["a"], ["b"]]

    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"nodes": [{"name": "a"}], "edges": [{"from": "a", "to": "ghost"}]}))
    assert main(["validate", str(bad)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert not out["valid"] and out["problems"]
    assert jmain(["validate", str(bad)]) == 1
    assert json.loads(capsys.readouterr().out) == out


def test_config_file_plumbing(tmp_path):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"server": {"port": 9123}, "planner": {"kind": "mock"}}))
    cfg = _load_config(argparse.Namespace(config=str(cfg_path), registry_file=None, planner=None))
    assert cfg.server.port == 9123 and cfg.planner.kind == "mock"
    # The mock planner is served: a canned-plan planner, no engine.
    cp = build_control_plane(cfg, device="cpu")
    assert type(cp.planner).__name__ == "MockPlanner"


def test_explain_cli_defaults_to_newest_trace(tmp_path, capsys):
    """``explain`` with no trace id explains the newest retained trace."""
    reg_path = tmp_path / "registry.json"
    assert main(["gen-registry", "3", "--out", str(reg_path), "--seed", "7"]) == 0
    records = json.loads(reg_path.read_text())

    async def go():
        server = _serve_file(str(reg_path), provenance=True)
        await server.start_server()
        base = f"http://{server.host}:{server.port}"
        try:
            async with ClientSession() as s:
                async with s.post(f"{base}/plan", json={"intent": f"use {records[0]['name']}"}) as r:
                    assert r.status == 200
            out_path = str(tmp_path / "explained.json")
            rc = await asyncio.to_thread(main, ["explain", "--url", base, "--out", out_path])
            assert rc == 0
            explanation = json.loads((tmp_path / "explained.json").read_text())
            assert explanation["decisions"], "newest trace carries decisions"
            assert any(d["layer"] == "plan" for d in explanation["decisions"])
        finally:
            await server.close()

    asyncio.run(go())
    assert "planned via" in capsys.readouterr().out

    # No server behind the URL: a clean JSON error, not a traceback.
    assert main(["explain", "t-1", "--url", "http://127.0.0.1:1"]) == 1
    assert "error" in json.loads(capsys.readouterr().out.splitlines()[-1])


EVAL_KEYS = {"coverage", "relevance", "coherence", "score", "n", "n_with_edges", "llm_share", "node_f1",
             "node_f1_n", "quantize"}


@pytest.mark.parametrize(
    "argv",
    [
        ["train-planner", "--device", "cpu", "--steps", "3", "--examples", "32", "--registry", "60"],
        ["eval-planner", "--device", "cpu", "--intents", "2"],
        ["bench", "report", "BENCH_r01.json", "BENCH_r11.json", "BENCH_r12.json", "--format", "json"],
        ["lint", "mcpx_torch", "--format", "json"],
    ],
    ids=lambda a: " ".join(a[:2]) if a[0] == "bench" else a[0],
)
def test_unported_commands_are_refused_by_name(argv, capsys, tmp_path, monkeypatch):
    """The reference's commands the port once refused are all served now,
    with the reference's arguments (``--device`` for ``--platform``) and
    output. ``train-planner`` writes a checkpoint the reference's
    ``load_npz`` reads; ``eval-planner`` prints one JSON line with the
    reference's keys; ``bench report`` prints the reference's report;
    ``lint`` scans the port's tree and prints the reference's JSON report,
    exit 0 against the port's baseline (mcpx_torch/analysis/baseline.json)."""
    command = " ".join(argv[:2]) if argv[0] == "bench" else argv[0]
    monkeypatch.chdir(ROOT)
    if command == "lint":
        assert main(argv) == 0
        payload = json.loads(capsys.readouterr().out)
        assert payload["exit"] == 0 and payload["new"] == [] and payload["stale_baseline"] == []
        assert not payload["baseline_missing"] and payload["files_scanned"] > 100
        return
    if command == "train-planner":
        from mcpx.models.train import load_npz as jload_npz

        out = tmp_path / "planner.npz"
        assert main(argv + ["--out", str(out)]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].startswith("corpus: 32 rows (dropped 0, filtered 0, teacher coverage 1.000) in ")
        assert lines[1].startswith("step 0/3 loss ") and lines[-2].startswith("trained 3 steps in ")
        assert lines[-1] == f"wrote {out}"
        params = jload_npz(str(out))
        assert params["layers"]["wq"].shape == (2, 128, 4, 32) and str(params["embed"].dtype) == "bfloat16"
    elif command == "eval-planner":
        assert main(argv) == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
        assert len(lines) == 1
        out = json.loads(lines[0])
        assert set(out) == EVAL_KEYS and out["n"] == 2 and out["quantize"] == "none"
    else:
        assert main(argv) == 0
        port = capsys.readouterr().out
        assert jmain(argv) == 0
        assert port == capsys.readouterr().out and json.loads(port)["verdict"]


def test_train_planner_default_out_stays_out_of_the_reference_package(monkeypatch):
    """The reference's default ``--out`` is its committed checkpoint; the
    port's is a file in the working directory, and the device the card."""
    from mcpx_torch.cli import main as cli

    parsed = {}
    monkeypatch.setattr(cli, "cmd_train_planner", lambda args: parsed.update(vars(args)) or 0)
    assert cli.main(["train-planner"]) == 0
    assert parsed["out"] == "planner_test_bpe.npz" and parsed["device"] is None


def test_module_entry_point_runs_and_refuses():
    """``python -m mcpx_torch.cli``: the package's ``__main__`` runs the CLI
    (and importing it runs nothing); ``lint mcpx_torch``, once refused, is
    served and exits 0 against the port's baseline."""
    ok = subprocess.run([sys.executable, "-m", "mcpx_torch.cli", "validate", "-"], input='{"nodes": [{"name": "a"}]}',
                        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert ok.returncode == 0 and json.loads(ok.stdout)["valid"]
    served = subprocess.run([sys.executable, "-m", "mcpx_torch.cli", "lint", "mcpx_torch"], capture_output=True,
                            text=True, timeout=120, cwd=ROOT)
    assert served.returncode == 0, served.stdout + served.stderr
    assert "0 new finding(s)" in served.stdout and "0 stale baseline entries" in served.stdout
    import mcpx_torch.cli.__main__  # noqa: F401
