"""The port's public surface held to the reference package's, name by name,
and the pieces of it that need no model held to the reference on the same
inputs.

The name walk is AST only: for every module under ``mcpx/``, each public
top-level function, each class and each public method of a public class
must have a same-named counterpart in the module at the same path under
``mcpx_torch/`` (a definition, an assignment or an import there). Every
name a reference ``__init__.py`` exports (its ``__all__`` and what it
imports from the package) must resolve on the port's counterpart. The only
exceptions are ``DECLARED`` below, one entry per name with its reason; an
entry the reference no longer has, or that the port now has, fails as
stale."""

import ast
import importlib
import os
import random

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "mcpx")
PORT = os.path.join(ROOT, "mcpx_torch")

_JIT = "the port has no jax.jit: its executables are CUDA graphs"

# (module path under mcpx/, name or None for the whole module): why the port
# has no counterpart of that name.
DECLARED = {
    ("utils/backend.py", None): "it only arms JAX's CPU platform; the port takes a torch device instead "
    "(mcpx_torch/device.py)",
    ("analysis/rules/jax_rules.py", None): "JAX rules; their Torch/CUDA counterparts are "
    "analysis/rules/torch_rules.py",
    ("analysis/rules/jit_contract_rules.py", None): "jit-contract over jax.jit bindings; the port's "
    "counterpart over CUDA-graph captures is analysis/rules/graph_contract_rules.py",
    ("analysis/rules/__init__.py", "jax_rules"): "the module is declared absent above (torch_rules)",
    ("analysis/rules/__init__.py", "jit_contract_rules"): "the module is declared absent above "
    "(graph_contract_rules)",
    ("analysis/project.py", "JitSpec"): f"one jax.jit binding; {_JIT} (analysis/project.py CaptureModel)",
    ("analysis/project.py", "JitSpec.positional_param"): "a method of JitSpec, declared absent above",
    ("analysis/project.py", "ProjectContext.jit_registry"): f"the project's jax.jit bindings; {_JIT} "
    "(ProjectContext.captures)",
    ("analysis/project.py", "spec_axis_names"): "flattens a JitSpec's parsed PartitionSpec axes; the port's "
    "sharding-contract reads mesh axes (ProjectContext.mesh_axes)",
    ("analysis/rules/common.py", "jit_scopes"): f"functions traced by jax.jit; {_JIT} (capture_scopes)",
    ("analysis/rules/common.py", "cached_jit_scopes"): "jit_scopes memoized; the port's is "
    "cached_capture_scopes",
    ("analysis/rules/common.py", "jitted_callable_names"): "names bound to jax.jit executables; the port's "
    "is dispatch_names",
    ("telemetry/costs.py", "TrackedExecutable"): "a shim over one jax.jit callable that detects retraces and "
    "lowers it for XLA's cost_analysis(); the port's costs are analytic (forward_cost) and it has no jit",
    ("telemetry/costs.py", "TrackedExecutable.compiles"): "a method of TrackedExecutable, declared absent above",
    ("telemetry/costs.py", "CostRegistry.wrap"): "wraps a jax.jit callable in a TrackedExecutable, declared "
    "absent above",
    ("telemetry/costs.py", "CostRegistry.release"): "drops the jit dispatch caches' device programs; the "
    "port's engine frees its captured graphs on close",
    ("telemetry/costs.py", "ExecCost.ensure"): "one AOT XLA compile for cost_analysis(); the port's costs are "
    "analytic, never pending",
    ("engine/engine.py", "InferenceEngine.pallas_paths"): "named for Pallas; the port's is "
    "InferenceEngine.kernel_paths, the same fields for the CUDA kernel",
    ("cluster/pool.py", "EnginePool.pallas_paths"): "the pool's aggregate of pallas_paths; the port's is "
    "EnginePool.kernel_paths",
    ("models/gemma/params.py", "save_checkpoint"): "an orbax checkpoint, which pulls in JAX (the GPU machine "
    "has no orbax); the port reads and writes .npz (models/train.py save_npz, params.load_npz)",
    ("models/gemma/params.py", "load_checkpoint"): "an orbax restore, as save_checkpoint; the port's "
    "load_or_init reads .npz",
    ("server/control.py", "_jax_version"): "the build identity's jax version; the port's names torch "
    "(mcpx_build_info)",
}


def _modules(base: str) -> list[str]:
    out = []
    for d, _, files in os.walk(base):
        out += [os.path.relpath(os.path.join(d, f), base) for f in files if f.endswith(".py")]
    return sorted(out)


def _tree(base: str, rel: str) -> ast.Module:
    with open(os.path.join(base, rel)) as f:
        return ast.parse(f.read(), rel)


def _defined(tree: ast.Module) -> set[str]:
    """Every top-level name a module binds (definitions, assignments,
    imports) and every method of its classes, as ``Class.method``."""
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out |= {
                f"{node.name}.{m.name}" for m in node.body if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _public(tree: ast.Module) -> set[str]:
    """The names the surface rule holds: public top-level functions, every
    class, and the public methods of public classes."""
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            if not node.name.startswith("_"):
                out |= {
                    f"{node.name}.{m.name}"
                    for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and not m.name.startswith("_")
                }
    return out


def _exports(tree: ast.Module) -> set[str]:
    """An ``__init__.py``'s ``__all__`` and the names it imports from the
    reference package at module level."""
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            out |= set(ast.literal_eval(node.value))
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and (node.module or "").split(".")[0] == "mcpx":
            out |= {a.asname or a.name for a in node.names}
    return out


def _dotted(rel: str) -> str:
    parts = rel[: -len(".py")].split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["mcpx_torch", *parts])


REF_MODULES = _modules(REF)
INITS = [m for m in REF_MODULES if os.path.basename(m) == "__init__.py"]


def test_the_walk_sees_the_reference_and_the_port():
    """Both trees are walked whole: the reference's modules, and the port's
    one-step decode beside its chunk forward, are in view."""
    assert "engine/paged_decode.py" in REF_MODULES and "utils/synth.py" in REF_MODULES
    assert len(REF_MODULES) > 100 and len(INITS) > 15
    port = _defined(_tree(PORT, "engine/paged_decode.py"))
    assert {"decode_chunk_paged", "decode_step_paged"} <= port


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    declared = {name for (mod, name) in DECLARED if mod == rel}
    if None in declared:
        assert not os.path.exists(os.path.join(PORT, rel)), f"mcpx_torch/{rel} exists: its entry is stale"
        return
    assert os.path.exists(os.path.join(PORT, rel)), f"mcpx/{rel} has no counterpart mcpx_torch/{rel}"
    missing = _public(_tree(REF, rel)) - _defined(_tree(PORT, rel)) - declared
    assert not missing, f"mcpx_torch/{rel} lacks {sorted(missing)}"


@pytest.mark.parametrize("rel", INITS)
def test_every_reference_export_resolves_in_the_port(rel):
    names = _exports(_tree(REF, rel)) - {name for (mod, name) in DECLARED if mod == rel}
    module = importlib.import_module(_dotted(rel))
    missing = sorted(n for n in names if not hasattr(module, n))
    assert not missing, f"{_dotted(rel)} does not export {missing}"


@pytest.mark.parametrize("entry", sorted(DECLARED, key=lambda e: (e[0], e[1] or "")), ids=lambda e: f"{e[0]}:{e[1]}")
def test_each_declared_name_is_missing_from_the_port_and_has_a_reason(entry):
    rel, name = entry
    assert len(DECLARED[entry]) > 20
    assert os.path.exists(os.path.join(REF, rel)), f"mcpx/{rel} is gone: the entry is stale"
    if name is None:
        assert not os.path.exists(os.path.join(PORT, rel)), f"mcpx_torch/{rel} exists now: the entry is stale"
        return
    assert name in _defined(_tree(REF, rel)), f"mcpx/{rel} no longer has {name}: the entry is stale"
    if os.path.exists(os.path.join(PORT, rel)):
        assert name not in _defined(_tree(PORT, rel)), f"mcpx_torch/{rel} has {name} now: the entry is stale"


def test_the_surface_rule_sees_a_missing_method_and_an_import():
    """The walk's own semantics on small sources: a public method missing
    from the port's class is reported; an import, an assignment or a
    private helper's absence is not."""
    ref = ast.parse("class A:\n    def f(self): ...\n    def _g(self): ...\ndef h(): ...\ndef _p(): ...\n")
    port = ast.parse("from x import h\nclass A:\n    pass\n")
    assert _public(ref) - _defined(port) == {"A.f"}
    assert _exports(ast.parse("from mcpx.a import B as C\nimport os\n__all__ = ['D']\n")) == {"C", "D"}


# ------------------------------------------------------------ core parity
def test_linear_plan_and_predecessors_match_the_reference():
    from mcpx.core.dag import linear_plan as jlinear
    from mcpx_torch.core.dag import linear_plan

    for names, intent in ((["a", "b", "c"], ""), (["x"], "do x"), ([f"s{i}" for i in range(7)], "chain")):
        ref, got = jlinear(names, intent), linear_plan(iter(names), intent)
        assert got.to_json() == ref.to_json()
        assert got.to_json(sort_keys=True, indent=1) == ref.to_json(sort_keys=True, indent=1)
        assert got.topological_generations() == ref.topological_generations()
        for n in names + ["absent"]:
            assert got.predecessors(n) == ref.predecessors(n)
    assert linear_plan(["a", "b", "c"]).predecessors("c") == ["b"]


def test_predecessors_match_on_a_fan_in_plan():
    from mcpx.core.dag import Plan as JPlan
    from mcpx_torch.core.dag import Plan

    wire = {
        "nodes": [{"name": n} for n in ("a", "b", "c", "d")],
        "edges": [{"from": "a", "to": "d"}, {"from": "c", "to": "d"}, {"from": "b", "to": "d"},
                  {"from": "a", "to": "c"}],
    }
    ref, got = JPlan.from_wire(wire), Plan.from_wire(wire)
    for n in "abcd":
        assert got.predecessors(n) == ref.predecessors(n)
    assert got.predecessors("d") == ["a", "c", "b"]


def test_linear_plan_refuses_what_the_reference_refuses():
    from mcpx.core.dag import PlanValidationError as JError
    from mcpx.core.dag import linear_plan as jlinear
    from mcpx_torch.core.dag import PlanValidationError, linear_plan

    with pytest.raises(JError) as ref:
        jlinear(["a", "a"])
    with pytest.raises(PlanValidationError) as got:
        linear_plan(["a", "a"])
    assert got.value.problems == ref.value.problems


def test_execution_error_keeps_its_fields_and_base():
    from mcpx.core.errors import ExecutionError as JExecutionError
    from mcpx_torch.core import ExecutionError, MCPXError
    from mcpx_torch.core.trace import ExecutionTrace

    trace = ExecutionTrace(trace_id="t1")
    err = ExecutionError("boom", results={"a": 1}, errors={"b": "down"}, trace=trace)
    assert isinstance(err, MCPXError) and str(err) == "boom"
    assert (err.results, err.errors, err.trace) == ({"a": 1}, {"b": "down"}, trace)
    bare, ref = ExecutionError("x"), JExecutionError("x")
    assert (bare.results, bare.errors, bare.trace) == (ref.results, ref.errors, ref.trace) == ({}, {}, None)


# ------------------------------------------------------------ synth parity
def _fields(r) -> tuple:
    return (r.name, r.endpoint, r.description, r.input_schema, r.output_schema, r.cost_profile, r.fallbacks,
            r.tags)


@pytest.mark.parametrize("n", [1, 8, 1000])
@pytest.mark.parametrize("seed", [0, 7])
def test_synth_registry_ood_matches_the_reference(n, seed):
    from mcpx.utils.synth import synth_registry_ood as jood
    from mcpx_torch.utils.synth import synth_registry_ood

    for local in (True, False):
        got, ref = synth_registry_ood(n, seed, local), jood(n, seed, local)
        assert [_fields(r) for r in got] == [_fields(r) for r in ref]
    assert synth_registry_ood(n, seed)[0].name == "GetInvoiceSvc0000"


@pytest.mark.parametrize("seed", [0, 7])
def test_synth_registry_on_the_shared_loop_is_unchanged(seed):
    """``synth_registry``, rebuilt on ``_build_registry``, gives the
    reference's records, and its intents draw the same."""
    from mcpx.utils.synth import intent_for as jintent
    from mcpx.utils.synth import synth_registry as jsynth
    from mcpx_torch.utils.synth import intent_for, synth_registry

    got, ref = synth_registry(1000, seed), jsynth(1000, seed)
    assert [_fields(r) for r in got] == [_fields(r) for r in ref]
    assert [intent_for(got, random.Random(i)) for i in range(20)] == [jintent(ref, random.Random(i)) for i in range(20)]


def test_the_two_registries_share_structure_not_names():
    from mcpx_torch.utils.synth import synth_registry, synth_registry_ood

    ind, ood = synth_registry(200, 3), synth_registry_ood(200, 3)
    assert not {w for r in ind for w in r.tags} & {w for r in ood for w in r.tags}
    for recs in (ind, ood):
        assert all(1 <= len(r.input_schema) <= 3 and 1 <= len(r.output_schema) <= 2 for r in recs)


# ------------------------------------------------------------- load_npz
def test_train_load_npz_is_the_params_reader_and_reads_the_reference_file():
    import numpy as np
    import torch

    from mcpx.models.train import load_npz as jload
    from mcpx_torch.models.gemma import params
    from mcpx_torch.models import train

    assert train.load_npz is params.load_npz
    path = os.path.join(ROOT, "mcpx", "models", "checkpoints", "planner_test_bpe.npz")
    ref, got = jload(path), train.load_npz(path, device="cpu")
    assert got["embed"].device.type == "cpu" and isinstance(got["embed"], torch.Tensor)
    for key in ("embed", "final_norm"):
        np.testing.assert_array_equal(got[key].float().numpy(), np.asarray(ref[key], np.float32))
    for key, leaf in ref["layers"].items():
        np.testing.assert_array_equal(got["layers"][key].float().numpy(), np.asarray(leaf, np.float32))
