"""The port's interprocedural analysis core (mcpx_torch/analysis/
{callgraph,dataflow,project}.py) against the reference's, on the CPU: the
call-graph golden over the fixture package gives the reference's edges,
backward reachability and type resolution agree, the taint engine reaches
the same fixpoint over the port's own tree, the capture model finds what
the port's engine runs inside CUDA-graph captures, and the taint property
tests of the reference run over the same depths with a capture key as the
sink (``jit-static-branch``, the port's counterpart of a static arg)."""

import pathlib
import textwrap

import pytest

from mcpx.analysis.core import FileContext as JFileContext
from mcpx.analysis.core import _relpath as j_relpath
from mcpx.analysis.core import iter_py_files as j_iter
from mcpx.analysis.dataflow import TaintEngine as JTaintEngine
from mcpx.analysis.project import ProjectContext as JProjectContext
from mcpx_torch.analysis import scan_paths
from mcpx_torch.analysis.core import FileContext, _relpath, iter_py_files
from mcpx_torch.analysis.dataflow import TaintEngine
from mcpx_torch.analysis.project import ProjectContext

REPO = pathlib.Path(__file__).resolve().parent.parent
CGPKG = REPO / "tests" / "fixtures" / "lint" / "cgpkg"
PREFIX = "tests.fixtures.lint.cgpkg."


def _project(paths, root=REPO):
    ctxs = [FileContext(p, _relpath(p, root), p.read_text()) for p in iter_py_files(paths)]
    return ProjectContext(ctxs, root)


def _jproject(paths, root=REPO):
    ctxs = [JFileContext(p, j_relpath(p, root), p.read_text()) for p in j_iter(paths)]
    return JProjectContext(ctxs, root)


# ------------------------------------------------------------- call graph
def test_callgraph_golden_snapshot_matches_the_reference():
    proj = _project([CGPKG])
    edges = [(c[len(PREFIX):], e[len(PREFIX):], k) for c, e, k in proj.callgraph().summary()]
    assert edges == [
        ("mainmod.Runner._loop", "mainmod.Runner.tick", "call"),
        ("mainmod.Runner.handle", "mainmod.Runner.tick", "call"),
        ("mainmod.Runner.serve", "mainmod.Runner.handle", "spawn"),
        ("mainmod.Runner.start", "mainmod.Runner._loop", "spawn"),
        ("mainmod.Runner.tick", "util.helper", "call"),
    ]
    assert proj.callgraph().summary() == _jproject([CGPKG]).callgraph().summary()


def test_callgraph_roots_exclude_spawn_edges():
    cg = _project([CGPKG]).callgraph()
    roots = {q[len(PREFIX):] for q in cg.roots_of(PREFIX + "mainmod.Runner.tick")}
    assert roots == {"mainmod.Runner._loop", "mainmod.Runner.handle"}
    assert cg.roots_of(PREFIX + "util.unused") == frozenset({PREFIX + "util.unused"})


def test_index_resolves_types_and_imports():
    index = _project([CGPKG]).index
    assert index.modules[PREFIX.rstrip(".") + ".mainmod"].imports["helper"] == PREFIX + "util.helper"
    assert PREFIX + "mainmod.Runner" in index.classes


def test_taint_fixpoint_over_the_port_tree_equals_the_reference_engine():
    """The port's taint engine re-analyzes only functions whose inputs grew
    (a worklist) where the reference re-runs every function each pass: the
    same fixpoint over the port's own engine package."""
    paths = [REPO / "mcpx_torch" / "engine"]
    port = TaintEngine(_project(paths).index)
    ref = JTaintEngine(_jproject(paths).index)
    assert port.heap == ref.heap and port.ret_taint == ref.ret_taint
    assert {k: v for k, v in port.param_taint.items() if v} == {k: v for k, v in ref.param_taint.items() if v}
    assert ("mcpx_torch.engine.engine._Slab", "temperature") in port.heap


# ------------------------------------------------------------ captures
def test_capture_model_of_the_port_engine():
    """What the engine's captures run: the window and its four bodies (a
    dict of bound methods picked at run time), the forward and the kernel
    wrapper they call, and the dict that holds the graphs."""
    model = _project([REPO / "mcpx_torch" / "engine", REPO / "mcpx_torch" / "models"]).captures()
    eng = "mcpx_torch.engine.engine.InferenceEngine"
    for fn in ("_window", "_draft_forward", "_fast_forward", "_hetero_forward", "_spec_forward"):
        assert f"{eng}.{fn}" in model.functions
    assert "mcpx_torch.engine.paged_decode.decode_chunk_paged" in model.functions
    assert "mcpx_torch.engine.kernels.paged_attention.ragged_paged_attention" in model.functions
    assert [info.qualname for info, _ in model.regions] == [f"{eng}._capture"]
    assert model.registries == {(eng, "_graphs")}


# ----------------------------------------------- dataflow reachability
def _chain_source(n: int, *, sanitize: bool) -> str:
    """A payload field flowing through ``n`` async helpers into the key of
    a dict of captured graphs; with ``sanitize`` the first hop buckets it."""
    lines = [
        "import torch",
        "",
        "",
        "def to_bucket(v):",
        "    return 8 if v <= 8 else 64",
        "",
        "",
        "class Req:  # mcpx: request-payload",
        "    n: int",
        "",
        "",
        "class Engine:",
        "    def __init__(self):",
        "        self._graphs = {}",
        "",
        "    def capture(self, k):",
        "        self._graphs[k] = torch.cuda.CUDAGraph()",
        "",
    ]
    entry = "to_bucket(req.n)" if sanitize else "req.n"
    lines += ["", "async def handle(req: Req, eng: Engine):", f"    await f0({entry}, eng)", ""]
    for i in range(n):
        lines += ["", f"async def f{i}(v, eng: Engine):"]
        lines.append(f"    await f{i + 1}(v, eng)" if i + 1 < n else "    eng.capture(('window', v))")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_taint_reaches_a_capture_key_through_n_hops(tmp_path, depth):
    p = tmp_path / "chain.py"
    p.write_text(_chain_source(depth, sanitize=False))
    res = scan_paths([p], root=tmp_path, rules=["jit-static-branch"])
    assert len(res.findings) == 1, [f.render() for f in res.findings]
    assert "Req.n" in res.findings[0].message and "'_graphs'" in res.findings[0].message


@pytest.mark.parametrize("depth", [1, 3])
def test_bucketing_sanitizes_at_any_depth(tmp_path, depth):
    p = tmp_path / "chain.py"
    p.write_text(_chain_source(depth, sanitize=True))
    assert scan_paths([p], root=tmp_path, rules=["jit-static-branch"]).findings == []


_HEAP = """
import torch


class Req:  # mcpx: request-payload
    n: int


class Slab:
    def __init__(self):
        self.width = 0


class Config:
    def __init__(self):
        self.width = 8


class Engine:
    def __init__(self):
        self.slab = Slab()
        self.cfg = Config()
        self._graphs = {}

    def admit(self, r: Req):
        self.slab.width = r.n

    def dispatch(self):
        graph = torch.cuda.CUDAGraph()
        self._graphs[("window", WIDTH)] = graph
"""


def test_taint_flows_through_heap_attributes(tmp_path):
    """The slab's latch shape: a payload field stored onto an attribute in
    one method, read back in another and made a capture key."""
    p = tmp_path / "latch.py"
    p.write_text(textwrap.dedent(_HEAP).replace("WIDTH", "self.slab.width"))
    res = scan_paths([p], root=tmp_path, rules=["jit-static-branch"])
    assert len(res.findings) == 1
    assert "Req.n" in res.findings[0].message


def test_unrelated_class_attr_does_not_borrow_taint(tmp_path):
    """Class-keyed heap cells: a tainted ``Slab.width`` does not taint
    ``Config.width`` reads (the warm-up captures' keys come from config)."""
    p = tmp_path / "split.py"
    p.write_text(textwrap.dedent(_HEAP).replace("WIDTH", "self.cfg.width"))
    assert scan_paths([p], root=tmp_path, rules=["jit-static-branch"]).findings == []
