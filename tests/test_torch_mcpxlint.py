"""The port's mcpxlint (mcpx_torch/analysis/) against the reference's
(mcpx/analysis/), on the CPU.

  - **Parity.** Every generic rule over its fixtures in
    ``tests/fixtures/lint/`` (and the ``cgpkg``/``xmod*`` packages, and the
    suppression fixture) gives the reference's findings as (path, line,
    rule), in the same order; messages match once module paths are spelled
    the reference's way.
  - **The Torch/CUDA counterparts** of the reference's JAX rules, under the
    same ids, flag their positive case at the stated lines and stay silent
    on the negative one (sources written to ``tmp_path``);
    ``traced-control-flow`` is a usage error that names why it has no
    counterpart.
  - **Suppressions, baseline, CLI, SARIF, ``--changed``, ``--fix``**: the
    counterparts of the reference's tests, through the port's
    ``run_lint`` and ``python -m mcpx_torch.cli lint``.
  - **The gate.** One module-scoped scan of ``mcpx_torch/`` (beside a rogue
    module that breaks the marks) feeds the tree's gate against the port's
    baseline, its time budget, the baseline's size, and the checks that the
    marks are live: a rogue write of a worker-owned engine field, of
    loop-owned pool state and of the lock-guarded ticket registry is
    flagged.
"""

import contextlib
import io
import json
import pathlib
import subprocess
import textwrap

import pytest

from mcpx.analysis import scan_paths as jscan
from mcpx_torch.analysis import (
    all_rules,
    apply_baseline,
    load_baseline,
    save_baseline,
    scan_paths,
)
from mcpx_torch.analysis.cli import run_lint

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "lint"
BASELINE = REPO / "mcpx_torch" / "analysis" / "baseline.json"

# Generic rules: copied from the reference, held to its findings.
GENERIC = {
    "async-blocking": "async_blocking",
    "async-shared-mutation": "shared_mutation",
    "blank-lines": "blank_lines",
    "broad-except": "broad_except",
    "blocking-io-on-request-path": "blocking_io",
    "evict-without-refcount-consult": "evict_refcount",
    "loop-confinement": "loop_confinement",
    "metric-label-churn": "metric_label_churn",
    "span-across-await-blocking": "span_across_await",
    "thread-ownership": "ownership",
    "unbounded-cache-growth": "unbounded_cache_growth",
    "unbounded-retry-loop": "unbounded_retry",
    "wall-clock-duration": "wall_clock_duration",
}
# The Torch/CUDA counterparts of the reference's JAX rules, same ids.
TORCH_RULES = {
    "jit-host-sync",
    "per-token-host-loop",
    "jit-static-branch",
    "jit-contract",
    "blocking-transfer-on-loop",
    "hardcoded-kernel-fallback",
    "sharding-contract",
}


def _key(findings):
    return [(f.path, f.line, f.rule) for f in findings]


def _reference_spelling(message: str) -> str:
    return message.replace("mcpx_torch.", "mcpx.").replace("mcpx_torch/", "mcpx/")


def _same_as_reference(targets, rules=None):
    j = jscan(targets, root=REPO, rules=rules).findings
    t = scan_paths(targets, root=REPO, rules=rules).findings
    assert _key(t) == _key(j)
    assert [_reference_spelling(f.message) for f in t] == [f.message for f in j]
    return t


# ------------------------------------------------------------------ registry
def test_registry_has_the_reference_rules_but_traced_control_flow():
    from mcpx.analysis import all_rules as jall

    assert set(all_rules()) == set(jall()) - {"traced-control-flow"}
    assert set(GENERIC) | TORCH_RULES == set(all_rules())


def test_traced_control_flow_is_a_usage_error_that_says_why(tmp_path):
    with pytest.raises(ValueError, match="no counterpart in the port"):
        scan_paths([FIXTURES / "blank_lines_neg.py"], rules=["traced-control-flow"])
    out = io.StringIO()
    code = run_lint(
        [str(FIXTURES / "blank_lines_neg.py")], baseline=str(tmp_path / "b.json"),
        rules=["traced-control-flow"], root=str(REPO), out=out,
    )
    assert code == 2
    assert "traced-control-flow" in out.getvalue() and "jit-host-sync" in out.getvalue()


# -------------------------------------------------------------------- parity
@pytest.mark.parametrize(
    "rule,fixture",
    [(r, f"{stem}_{kind}.py") for r, stem in sorted(GENERIC.items()) for kind in ("pos", "neg")],
)
def test_generic_rule_matches_the_reference_on_its_fixture(rule, fixture):
    found = _same_as_reference([FIXTURES / fixture], rules=[rule])
    assert bool(found) == fixture.endswith("_pos.py")


@pytest.mark.parametrize("package", ["cgpkg", "xmodcache", "xmodretry", "xmodtransfer", "suppressed.py"])
def test_generic_rules_match_the_reference_on_packages(package):
    _same_as_reference([FIXTURES / package], rules=sorted(GENERIC))


def test_blocking_transfer_two_hops_across_modules_as_the_reference():
    # The device source is the engine's queue_stats(), the port's too.
    found = _same_as_reference([FIXTURES / "xmodtransfer"], rules=["blocking-transfer-on-loop"])
    assert [(f.path.rsplit("/", 1)[-1], f.line) for f in found] == [("web.py", 8)]


# --------------------------------------------------------- Torch/CUDA rules
TORCH_CASES = {
    "jit-host-sync": (
        '''
        import numpy as np
        import torch


        class Engine:
            def __init__(self):
                self.x = torch.zeros(4)
                self.graph = torch.cuda.CUDAGraph()

            def _body(self):
                n = self.x.sum().item()
                if self.x.any():
                    n += 1
                return float(self.x[0]) + n

            def capture(self):
                with torch.cuda.graph(self.graph):
                    self._body()
                    self.x.cpu()

            def serve(self, steps):
                for _ in range(steps):
                    out = self._body()
                    np.asarray(out)
                    torch.cuda.synchronize()
        ''',
        [11, 12, 14, 19, 24, 25],
        '''
        import torch


        class Engine:
            def __init__(self):
                self.x = torch.zeros(4)
                self.graph = torch.cuda.CUDAGraph()
                self.event = torch.cuda.Event()

            def _body(self):
                rows = int(self.x.shape[0])
                if rows > 2 and self.x.dtype == torch.float32:
                    rows -= 1
                return self.x * rows + len(self.x)

            def capture(self):
                with torch.cuda.graph(self.graph):
                    self._body()

            def serve(self, steps):
                for _ in range(steps):
                    self.graph.replay()
                    if self.event.query():
                        self.event.synchronize()
                return float(self.x.sum())

            def report(self, values):
                return [int(v) for v in values]
        ''',
    ),
    "per-token-host-loop": (
        '''
        import torch


        def decode(model, ids):
            tok = 0
            for _ in range(16):
                logits = model.forward(ids, tok)
                tok = int(logits.argmax())
            return tok


        def decode_rows(step_forward, state):
            while True:
                nxt = step_forward(state)
                state = nxt.tolist()
                if not state:
                    break
        ''',
        [8, 15],
        '''
        import torch


        def decode(model, ids, steps):
            tok = torch.zeros(1, dtype=torch.long)
            for _ in range(steps):
                logits = model.forward(ids, tok)
                tok = logits.argmax(-1)
            return int(tok)


        def decode_logged(model, ids, log):
            for _ in range(4):
                logits = model.forward(ids)
                log.append(float(logits.max()))
        ''',
    ),
    "jit-static-branch": (
        '''
        import torch


        class Req:  # mcpx: request-payload
            temperature: float
            n: int


        class Engine:
            def __init__(self):
                self._graphs = {}

            def _capture(self, key):
                graph = torch.cuda.CUDAGraph()
                self._graphs[key] = graph

            def serve(self, r: Req):
                key = ("window", r.temperature)
                if key not in self._graphs:
                    self._capture(key)
                return self._graphs[key]
        ''',
        [15, 19, 21],
        '''
        import torch


        def _bucket(n, buckets=(8, 64)):
            return next(b for b in buckets if n <= b)


        class Req:  # mcpx: request-payload
            temperature: float
            n: int


        class Engine:
            def __init__(self, width: int):
                self._graphs = {}
                self.width = width

            def _capture(self, key):
                graph = torch.cuda.CUDAGraph()
                self._graphs[key] = graph

            def serve(self, r: Req):
                key = ("window", _bucket(r.n), self.width)
                if key not in self._graphs:
                    self._capture(key)
                return self._graphs[key]
        ''',
    ),
    "jit-contract": (
        '''
        import torch


        class Engine:
            def __init__(self):
                self.buf = torch.zeros(8)
                self.dev = {"cur": torch.zeros(4)}
                self._graphs = {}

            def _window(self):
                self.buf.add_(1)
                self.dev["cur"].mul_(2)

            def _capture(self, key):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    self._window()
                self._graphs[key] = graph

            def admit(self, n):
                self.buf = torch.zeros(n)
                self.dev["cur"] = torch.ones(4)
                self.buf.resize_(16)
        ''',
        [21, 22, 23],
        '''
        import torch


        class Engine:
            def __init__(self):
                self.buf = torch.zeros(8)
                self.dev = {"cur": torch.zeros(4)}
                self.scale = 1.0
                self._graphs = {}

            def _window(self):
                self.buf.add_(self.scale)
                self.dev["cur"].mul_(2)

            def _capture(self, key):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    self._window()
                self._graphs[key] = graph

            def setup(self, n):
                self.buf = torch.zeros(n)
                self._capture("warm")

            def admit(self, rows, vals):
                self.buf.copy_(vals)
                self.buf[:2] = 0
                self.dev["cur"][rows] = 1
                self.scale = 2.0

            def close(self):
                self._graphs.clear()
                self.buf = torch.zeros(1)
                self.dev = None
        ''',
    ),
    "blocking-transfer-on-loop": (
        '''
        import torch


        async def stats_handler(request, engine):
            stats = engine.queue_stats()
            return float(stats["depth"])


        async def echo(request):
            t = torch.zeros(3).to("cuda")
            return t.cpu()


        async def drain(request):
            torch.cuda.synchronize()
            return None
        ''',
        [6, 11, 15],
        '''
        import asyncio

        import torch


        async def stats_handler(request, engine):
            def read():
                return float(engine.queue_stats()["depth"])

            return await asyncio.to_thread(read)


        def offline(engine):
            torch.cuda.synchronize()
            return float(engine.queue_stats()["depth"])


        async def host_math(request):
            return float(len(request.query))
        ''',
    ),
    "hardcoded-kernel-fallback": (
        '''
        import torch

        from mcpx_torch.engine.kernels.paged_attention import (
            paged_attention_chunk_reference,
            ragged_paged_attention_reference,
        )


        class Layer:
            def __init__(self, device):
                self.device = torch.device(device)

            def attend(self, q, k, v, table, starts, lens):
                return ragged_paged_attention_reference(q, k, v, table, starts, lens)

            def scratch(self):
                return torch.zeros(4, device="cpu")


        def run(q, k, v, table, starts, device):
            return paged_attention_chunk_reference(q, k, v, table, starts)
        ''',
        [14, 17, 21],
        '''
        import torch

        from mcpx_torch.engine.kernels.paged_attention import ragged_paged_attention, ragged_paged_attention_reference


        class Layer:
            def __init__(self, device):
                self.device = torch.device(device)

            def attend(self, q, k, v, table, starts, lens):
                return ragged_paged_attention(q, k, v, table, starts, lens)

            def scratch(self):
                return torch.zeros(4, device=self.device)


        def route(q, k, v, table, starts, lens):
            if q.device.type == "cpu":
                return ragged_paged_attention_reference(q, k, v, table, starts, lens)
            return ragged_paged_attention(q, k, v, table, starts, lens)


        def pools(n, device="cpu"):
            return torch.zeros(n, device=device)
        ''',
    ),
    "sharding-contract": (
        '''
        import torch

        from mcpx_torch.parallel.mesh import Mesh, place, shard_pytree

        DATA = "data"


        def spread(devices):
            mesh = Mesh(devices, (DATA, "model"))
            x = torch.zeros((8, 4))
            a = place(x, (DATA, None, None), mesh)
            b = place(x, ("dat", None), mesh)
            c = shard_pytree({"w": x}, {"w": ("seq", None)}, mesh)
            return a, b, c
        ''',
        [11, 12, 13],
        '''
        import torch

        from mcpx_torch.parallel.mesh import Mesh, indices_map, place, shard_pytree

        DATA = "data"
        MODEL = "model"


        def spread(devices, spec):
            mesh = Mesh(devices, (DATA, MODEL))
            x = torch.zeros((8, 4))
            a = place(x, (DATA, None), mesh)
            b = place(x, spec, mesh)
            c = shard_pytree({"w": x}, {"w": (None, (DATA, MODEL))}, mesh)
            d = indices_map((8, 4), (None, MODEL), mesh)
            return a, b, c, d
        ''',
    ),
}


def _source(text: str) -> str:
    return textwrap.dedent(text).lstrip("\n")


@pytest.mark.parametrize("kind", ["pos", "neg"])
@pytest.mark.parametrize("rule", sorted(TORCH_RULES))
def test_torch_rule_flags_its_positive_case_and_not_its_negative(rule, kind, tmp_path):
    pos, lines, neg = TORCH_CASES[rule]
    p = tmp_path / f"case_{kind}.py"
    p.write_text(_source(pos if kind == "pos" else neg))
    res = scan_paths([p], root=tmp_path, rules=[rule])
    assert [f.line for f in res.findings if f.rule == rule] == (lines if kind == "pos" else [])


# -------------------------------------------------------------- suppressions
def test_suppression_consumes_finding_and_dead_one_is_reported():
    res = scan_paths([FIXTURES / "suppressed.py"], root=REPO)
    assert res.suppressed == 1  # the justified time.sleep
    assert [f.rule for f in res.findings] == ["unused-suppression"]
    assert res.findings[0].line == 11


def test_suppression_only_judged_against_selected_rules():
    res = scan_paths([FIXTURES / "suppressed.py"], root=REPO, rules=["blank-lines"])
    assert res.findings == []


def test_multi_rule_suppression_reports_unfired_known_id(tmp_path):
    p = tmp_path / "t.py"
    p.write_text(
        "import time\n\n\nasync def f():\n"
        "    time.sleep(1)  # mcpx: ignore[async-blocking,jit-host-sync] - only one fires\n"
    )
    res = scan_paths([p], root=tmp_path)
    assert res.suppressed == 1
    assert [f.rule for f in res.findings] == ["unused-suppression"]
    assert "jit-host-sync" in res.findings[0].message


def test_unknown_suppression_id_always_reported(tmp_path):
    # traced-control-flow is no rule of the port: a suppression naming it
    # guards nothing, like a typo.
    p = tmp_path / "t.py"
    p.write_text(
        "import time\n\n\nasync def f():\n"
        "    time.sleep(1)  # mcpx: ignore[async-blocking,traced-control-flow] - not a port rule\n"
    )
    res = scan_paths([p], root=tmp_path)
    assert res.suppressed == 1
    assert [f.rule for f in res.findings] == ["unused-suppression"]
    assert "traced-control-flow" in res.findings[0].message
    res2 = scan_paths([p], root=tmp_path, rules=["blank-lines"])
    assert ["traced-control-flow" in f.message for f in res2.findings] == [True]


def test_suppression_groups_merge_and_duplicates_dedupe(tmp_path):
    p = tmp_path / "t.py"
    p.write_text(
        "import time\n\n\nasync def f():\n"
        "    time.sleep(1)  "
        "# mcpx: ignore[async-blocking] - x # mcpx: ignore[async-blocking,async-blocking] - dupe\n"
    )
    res = scan_paths([p], root=tmp_path)
    assert res.suppressed == 1
    assert res.findings == []


# ------------------------------------------------------------------ baseline
def test_baseline_roundtrip_match_and_stale(tmp_path):
    res = scan_paths([FIXTURES / "broad_except_pos.py"], root=REPO)
    findings = [f for f in res.findings if f.rule == "broad-except"]
    assert findings
    path = tmp_path / "base.json"
    save_baseline(path, findings)
    entries = load_baseline(path)
    new, baselined, stale = apply_baseline(findings, entries)
    assert (new, baselined, stale) == ([], len(findings), [])
    new, _, stale = apply_baseline(findings, entries[1:])
    assert len(new) == 1 and not stale
    assert new[0].key == (entries[0]["path"], entries[0]["rule"], entries[0]["line"])
    extra = dict(entries[0], line=9999)
    _, _, stale = apply_baseline(findings, entries + [extra])
    assert stale == [extra]


def test_missing_baseline_is_empty(tmp_path):
    assert load_baseline(tmp_path / "absent.json") == []


# ----------------------------------------------------------------------- cli
def test_cli_exit_codes_and_update(tmp_path):
    target = FIXTURES / "broad_except_pos.py"
    base = tmp_path / "b.json"
    out = io.StringIO()
    assert run_lint([str(target)], baseline=str(base), root=str(REPO), out=out) == 1
    line = out.getvalue().splitlines()[0]
    assert line.startswith("tests/fixtures/lint/broad_except_pos.py:7 broad-except ")
    assert run_lint(
        [str(target)], baseline=str(base), update_baseline=True, root=str(REPO), out=io.StringIO(),
    ) == 0
    assert run_lint([str(target)], baseline=str(base), root=str(REPO), out=io.StringIO()) == 0
    data = json.loads(base.read_text())
    data["entries"] = data["entries"][1:]
    base.write_text(json.dumps(data))
    assert run_lint([str(target)], baseline=str(base), root=str(REPO), out=io.StringIO()) == 1
    data = json.loads(base.read_text())
    data["entries"] = [dict(data["entries"][0], line=9999)] + data["entries"]
    base.write_text(json.dumps(data))
    assert run_lint([str(target)], baseline=str(base), root=str(REPO), out=io.StringIO()) == 1


def test_cli_json_format(tmp_path):
    out = io.StringIO()
    code = run_lint(
        [str(FIXTURES / "async_blocking_pos.py")], baseline=str(tmp_path / "none.json"),
        fmt="json", root=str(REPO), out=out,
    )
    payload = json.loads(out.getvalue())
    assert code == 1 and payload["exit"] == 1
    assert payload["counts_by_rule"]["async-blocking"] == 5
    assert payload["files_scanned"] == 1
    assert {f["rule"] for f in payload["new"]} == {"async-blocking"}
    assert all({"path", "line", "rule", "message"} <= set(f) for f in payload["new"])


def test_cli_unknown_rule_is_a_usage_error_not_a_crash(tmp_path):
    out = io.StringIO()
    code = run_lint(
        [str(FIXTURES / "blank_lines_neg.py")], baseline=str(tmp_path / "b.json"),
        rules=["no-such-rule"], root=str(REPO), out=out,
    )
    assert code == 2
    assert "unknown rule" in out.getvalue()


def test_cli_malformed_baseline_is_a_usage_error_not_a_crash(tmp_path):
    base = tmp_path / "b.json"
    for bad in ('{"entries": [{"path": "x"}]}', "{truncated"):
        base.write_text(bad)
        out = io.StringIO()
        code = run_lint([str(FIXTURES / "blank_lines_neg.py")], baseline=str(base), root=str(REPO), out=out)
        assert code == 2
        assert "cannot read baseline" in out.getvalue()


def test_cli_filtered_update_preserves_other_rules_entries(tmp_path):
    base = tmp_path / "b.json"
    save_baseline(base, scan_paths([FIXTURES / "broad_except_pos.py"], root=REPO).findings)
    before = load_baseline(base)
    assert {e["rule"] for e in before} == {"broad-except"}
    assert run_lint(
        [str(FIXTURES / "suppressed.py")], baseline=str(base), update_baseline=True,
        rules=["blank-lines"], root=str(REPO), out=io.StringIO(),
    ) == 0
    assert load_baseline(base) == before


def test_cli_subcommand_wiring():
    from mcpx_torch.cli.main import main

    assert main(["lint", str(FIXTURES / "blank_lines_neg.py"),
                 "--baseline", str(REPO / "does-not-exist.json")]) == 0
    assert main(["lint", str(FIXTURES / "blank_lines_pos.py"),
                 "--baseline", str(REPO / "does-not-exist.json")]) == 1


def test_cli_sarif_format_matches_golden(tmp_path):
    out = io.StringIO()
    code = run_lint(
        [str(FIXTURES / "broad_except_pos.py")], baseline=str(tmp_path / "none.json"),
        fmt="sarif", root=str(REPO), out=out,
    )
    assert code == 1
    doc = json.loads(out.getvalue())
    golden = json.loads((FIXTURES / "sarif_golden.json").read_text())
    # The reference's golden, read as is: the port's documentation is its own.
    driver = golden["runs"][0]["tool"]["driver"]
    assert driver["informationUri"] == "docs/static-analysis.md"
    driver["informationUri"] = "mcpx_torch/analysis/README.md"
    assert doc == golden
    assert all(
        r["locations"][0]["physicalLocation"]["region"]["startLine"] > 0 for r in doc["runs"][0]["results"]
    )


def _git(root, *args):
    subprocess.run(
        ["git", "-c", "user.email=t@t", "-c", "user.name=t", *args], cwd=root, check=True, capture_output=True,
    )


def test_cli_changed_scopes_report_to_diff(tmp_path):
    _git(tmp_path, "init", "-q")
    (tmp_path / "a.py").write_text("import time\n\n\nasync def f():\n    time.sleep(1)\n")
    (tmp_path / "b.py").write_text("def ok():\n    return 1\n")
    _git(tmp_path, "add", ".")
    _git(tmp_path, "commit", "-qm", "seed")
    (tmp_path / "b.py").write_text("import time\n\n\nasync def g():\n    time.sleep(2)\n")
    out = io.StringIO()
    code = run_lint(
        [str(tmp_path)], baseline=str(tmp_path / "none.json"), root=str(tmp_path), changed=True,
        fmt="json", out=out,
    )
    payload = json.loads(out.getvalue())
    assert code == 1
    assert payload["files_scanned"] == 1
    assert {f["path"] for f in payload["new"]} == {"b.py"}
    assert "async-blocking" in payload["rule_wall_s"]
    _git(tmp_path, "add", ".")
    _git(tmp_path, "commit", "-qm", "fixups")
    out2 = io.StringIO()
    assert run_lint(
        [str(tmp_path)], baseline=str(tmp_path / "none.json"), root=str(tmp_path), changed=True, out=out2,
    ) == 0
    assert "nothing to lint" in out2.getvalue()


def test_cli_changed_works_from_a_repo_subdirectory(tmp_path):
    sub = tmp_path / "pkg"
    sub.mkdir()
    _git(tmp_path, "init", "-q")
    (sub / "mod.py").write_text("def ok():\n    return 1\n")
    _git(tmp_path, "add", ".")
    _git(tmp_path, "commit", "-qm", "seed")
    (sub / "mod.py").write_text("import time\n\n\nasync def f():\n    time.sleep(1)\n")
    out = io.StringIO()
    code = run_lint(
        [str(sub)], baseline=str(tmp_path / "none.json"), root=str(sub), changed=True, fmt="json", out=out,
    )
    payload = json.loads(out.getvalue())
    assert code == 1
    assert {f["path"] for f in payload["new"]} == {"mod.py"}


def test_cli_changed_leaves_other_files_baseline_alone(tmp_path):
    _git(tmp_path, "init", "-q")
    viol = "import time\n\n\nasync def f():\n    time.sleep(1)\n"
    (tmp_path / "a.py").write_text(viol)
    (tmp_path / "b.py").write_text("def ok():\n    return 1\n")
    base = tmp_path / "base.json"
    save_baseline(base, scan_paths([tmp_path / "a.py"], root=tmp_path).findings)
    before = load_baseline(base)
    assert {e["path"] for e in before} == {"a.py"}
    _git(tmp_path, "add", ".")
    _git(tmp_path, "commit", "-qm", "seed")
    (tmp_path / "b.py").write_text(viol.replace("def f", "def g"))
    out = io.StringIO()
    code = run_lint(
        [str(tmp_path)], baseline=str(base), root=str(tmp_path), changed=True, fmt="json", out=out,
    )
    payload = json.loads(out.getvalue())
    assert payload["stale_baseline"] == []
    assert {f["path"] for f in payload["new"]} == {"b.py"}
    assert code == 1
    assert run_lint(
        [str(tmp_path)], baseline=str(base), root=str(tmp_path), changed=True, update_baseline=True,
        out=io.StringIO(),
    ) == 0
    after = load_baseline(base)
    assert [e for e in after if e["path"] == "a.py"] == before
    assert {e["path"] for e in after} == {"a.py", "b.py"}


def test_cli_changed_sarif_smoke(tmp_path, monkeypatch):
    from mcpx_torch.cli.main import main

    _git(tmp_path, "init", "-q")
    (tmp_path / "a.py").write_text("def ok():\n    return 1\n")
    _git(tmp_path, "add", ".")
    _git(tmp_path, "commit", "-qm", "seed")
    (tmp_path / "a.py").write_text("import time\n\n\nasync def f():\n    time.sleep(1)\n")
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(["lint", str(tmp_path), "--changed", "--format", "sarif", "--baseline",
                     str(tmp_path / "none.json")])
    assert code == 1
    run = json.loads(buf.getvalue())["runs"][0]
    assert run["tool"]["driver"]["name"] == "mcpxlint"
    assert {r["ruleId"] for r in run["results"]} == {"async-blocking"}
    assert all(
        r["locations"][0]["physicalLocation"]["artifactLocation"]["uri"] == "a.py" for r in run["results"]
    )


# ------------------------------------------------------------------- --fix
_FIXABLE = (
    "import time\n"
    "\n"
    "\n"
    "\n"
    "\n"
    "async def f():\n"
    "    time.sleep(1)  # mcpx: ignore[async-blocking,async-blocking] - dupe\n"
    "    x = 1  # mcpx: ignore[blank-lines] - never fires here\n"
    "    # mcpx: ignore[asnyc-blocking] - typo'd id, comment-only line\n"
    "    return x\n"
)

_FIXED = (
    "import time\n"
    "\n"
    "\n"
    "async def f():\n"
    "    time.sleep(1)  # mcpx: ignore[async-blocking] - dupe\n"
    "    x = 1\n"
    "    return x\n"
)


def test_fix_rewrites_mechanical_findings(tmp_path):
    p = tmp_path / "t.py"
    p.write_text(_FIXABLE)
    out = io.StringIO()
    assert run_lint([str(p)], baseline=str(tmp_path / "none.json"), root=str(tmp_path), fix=True, out=out) == 0
    assert p.read_text() == _FIXED
    assert "rewrote 1 file(s)" in out.getvalue()
    res = scan_paths([p], root=tmp_path)
    assert [f.rule for f in res.findings] == []
    assert res.suppressed == 1
    out2 = io.StringIO()
    assert run_lint([str(p)], baseline=str(tmp_path / "none.json"), root=str(tmp_path), fix=True, out=out2) == 0
    assert p.read_text() == _FIXED
    assert "rewrote 0 file(s)" in out2.getvalue()


def test_fix_dry_run_prints_diff_and_writes_nothing(tmp_path):
    p = tmp_path / "t.py"
    p.write_text(_FIXABLE)
    out = io.StringIO()
    code = run_lint(
        [str(p)], baseline=str(tmp_path / "none.json"), root=str(tmp_path), fix=True, fix_dry_run=True, out=out,
    )
    assert code == 0
    assert p.read_text() == _FIXABLE
    diff = out.getvalue()
    assert "--- a/t.py" in diff and "+++ b/t.py" in diff
    assert "-    x = 1  # mcpx: ignore[blank-lines] - never fires here" in diff
    assert "+    x = 1" in diff
    assert "would rewrite 1 file(s)" in diff


def test_fix_respects_rule_selection(tmp_path):
    p = tmp_path / "t.py"
    p.write_text(_FIXABLE)
    assert run_lint(
        [str(p)], baseline=str(tmp_path / "none.json"), root=str(tmp_path), rules=["async-blocking"], fix=True,
        out=io.StringIO(),
    ) == 0
    text = p.read_text()
    assert "ignore[blank-lines] - never fires here" in text
    assert "asnyc-blocking" not in text


def test_fix_cli_flags_wired(tmp_path):
    from mcpx_torch.cli.main import main

    p = tmp_path / "t.py"
    p.write_text(_FIXABLE)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(["lint", str(p), "--fix", "--dry-run", "--baseline", str(tmp_path / "none.json")])
    assert code == 0
    assert p.read_text() == _FIXABLE
    assert "would rewrite 1 file(s)" in buf.getvalue()


# ---------------------------------------------------------------- the gate
ROGUE = '''
from mcpx_torch.cluster.pool import EnginePool
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.engine.kernels import paged_attention


async def rogue(engine: InferenceEngine):
    engine._inflight.clear()


def rogue_pool(pool: EnginePool):
    pool.resteers += 1


def rogue_tickets():
    paged_attention._TICKETS.clear()


def rogue_pools(engine: InferenceEngine):
    engine._paged_kv = {"k": engine._paged_kv["k"].clone()}
'''


@pytest.fixture(scope="module")
def tree_scan(tmp_path_factory):
    """One scan of the port's tree, with a rogue module beside it that
    breaks three marks. The rogue mutates state directly (it calls no
    function of the tree), so it adds findings in its own file only."""
    rogue = tmp_path_factory.mktemp("rogue") / "rogue.py"
    rogue.write_text(ROGUE.lstrip("\n"))
    res = scan_paths([REPO / "mcpx_torch", rogue], root=REPO)
    tree = [f for f in res.findings if f.path.startswith("mcpx_torch/")]
    return res, tree, [f for f in res.findings if f not in tree]


def test_tree_is_clean_against_its_baseline(tree_scan):
    """THE gate: the port's tree reports nothing beyond
    mcpx_torch/analysis/baseline.json, and every entry still matches."""
    _, tree, _ = tree_scan
    new, _, stale = apply_baseline(tree, load_baseline(BASELINE))
    assert not new, "new findings:\n" + "\n".join(f.render() for f in new)
    assert not stale, f"stale baseline entries (delete them): {stale}"


def test_tree_scan_stays_under_budget(tree_scan):
    res, _, _ = tree_scan
    assert res.duration_s < 25.0, (
        f"tree lint took {res.duration_s:.1f}s; per-rule: "
        f"{sorted(res.rule_wall_s.items(), key=lambda kv: -kv[1])[:5]}"
    )
    assert {"thread-ownership", "jit-contract", "jit-static-branch"} <= set(res.rule_wall_s)


def test_baseline_stays_small():
    assert len(load_baseline(BASELINE)) <= 10


def test_marks_are_live_against_a_rogue_module(tree_scan):
    """The tree is clean because nothing breaks the marks, not because the
    passes are inert: a rogue write of the engine's worker-owned
    ``_inflight``, of the pool's loop-owned ``resteers`` and of the kernel
    wrapper's lock-guarded ticket registry are each flagged, and so is a
    rebinding of the KV pools that the engine's captured windows read."""
    _, _, rogue = tree_scan
    got = {(f.rule, f.line) for f in rogue}
    assert ("thread-ownership", 7) in got  # engine._inflight
    assert ("loop-confinement", 11) in got  # pool.resteers
    assert ("thread-ownership", 15) in got  # paged_attention._TICKETS
    assert ("jit-contract", 19) in got  # the KV pools the captured windows read
    assert any("_inflight" in f.message for f in rogue if f.line == 7)
    assert any("_LOCK" in f.message for f in rogue if f.line == 15)


def _project(paths):
    from mcpx_torch.analysis.core import FileContext, _relpath, iter_py_files
    from mcpx_torch.analysis.project import ProjectContext

    ctxs = [FileContext(p, _relpath(p, REPO), p.read_text()) for p in iter_py_files(paths)]
    return ProjectContext(ctxs, REPO)


def test_engine_ownership_annotations_are_live():
    """The port's engine files carry the declarations the pass runs on:
    the worker entry, owned fields (atomic where queue_stats reads them),
    decorated mutators, and the lock-guarded module state two engines'
    workers share."""
    from mcpx_torch.analysis.rules.ownership_rules import _Ownership

    proj = _project([REPO / "mcpx_torch" / "engine", REPO / "mcpx_torch" / "utils"])
    own = _Ownership(proj)
    eng = "mcpx_torch.engine.engine.InferenceEngine"
    assert (eng, "_inflight") in own.fields
    assert not own.fields[(eng, "_inflight")][1]  # owner-only, not atomic
    assert own.fields[(eng, "_ewma_service_s")][1]  # GIL-atomic, cross-read
    assert proj.index.functions[f"{eng}._worker"].entry_of == "engine-worker"
    pc = "mcpx_torch.engine.prefix_cache.RadixPrefixCache"
    assert proj.index.functions[f"{pc}.insert"].owner == "engine-worker"
    assert proj.index.classes["mcpx_torch.engine.engine._Slab"].owner == "engine-worker"
    assert proj.index.functions["mcpx_torch.engine.kv_cache.PageAllocator.free"].owner == "engine-worker"
    pa = "mcpx_torch.engine.kernels.paged_attention"
    assert {name for (mod, name) in own.guarded if mod == pa} == {"LAUNCHES", "CAPTURED", "BY_CARD", "_TICKETS", "_HELD"}
    assert own.guarded[("mcpx_torch.engine.engine", "_SPARE_STREAMS")][0] == "DEVICE_LOCK"


def test_cluster_loop_annotations_are_live():
    """The loop-confinement counterpart: the port's cluster and telemetry
    classes carry the event_loop declarations the pass runs on."""
    from mcpx_torch.analysis.rules.ownership_rules import LOOP_DOMAIN, _Ownership

    proj = _project([REPO / "mcpx_torch" / "cluster", REPO / "mcpx_torch" / "telemetry"])
    own = _Ownership(proj)
    pool = "mcpx_torch.cluster.pool.EnginePool"
    assert proj.index.classes[pool].owner == LOOP_DOMAIN
    assert own.fields[(pool, "_closed")][0] == LOOP_DOMAIN
    rep = "mcpx_torch.cluster.replica.ReplicaHandle"
    assert proj.index.classes[rep].owner == LOOP_DOMAIN
    assert proj.index.functions[f"{rep}.note_result"].owner == LOOP_DOMAIN
    rp = "mcpx_torch.cluster.routing.RoutingPipeline"
    assert proj.index.functions[f"{rp}.route"].owner == LOOP_DOMAIN
    for cls in ("telemetry.ledger.UsageLedger", "telemetry.slo.SLOTracker", "telemetry.flight.FlightRecorder"):
        assert proj.index.classes[f"mcpx_torch.{cls}"].owner == LOOP_DOMAIN

