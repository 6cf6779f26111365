"""sharding-contract: spec tuples that do not fit their tensor or their mesh.

The port's parallel package (mcpx_torch/parallel/mesh.py) places tensors
on a named mesh of devices by spec tuples: one entry per dimension, each
``None`` (replicated), an axis name, or a tuple of axis names. This pass
verifies, at every ``place(x, spec, mesh)``, ``shard_pytree(tree, specs,
mesh)`` and ``indices_map(shape, spec, mesh)`` call whose spec it can read
(a literal tuple, a dict of them for ``shard_pytree``, or a local name
bound once to one; axis names resolved through module constants such as
``DATA_AXIS = "data"``):

  - **Rank.** The spec has one entry per dimension of its tensor, when the
    tensor's rank is readable (a local name bound to a ``torch`` factory
    with a literal shape, or ``indices_map``'s literal shape). A spec
    longer than the tensor raises at placement; a shorter one replicates
    the dimensions it leaves out without saying so.
  - **Declared axes only.** Every axis the spec names exists on the mesh:
    the mesh built at the call site (a local ``Mesh(devices, names)`` with
    literal names), or else any mesh the project declares. A typo'd axis
    raises at placement on a real mesh, far from the spec that named it.

The reference's producer/consumer and donated-alias checks read jit
sharding bindings; the port has none (placement is explicit, and PyTorch
has no buffer donation), so they have no counterpart. Unknowns never
produce findings.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from mcpx_torch.analysis.astutil import walk
from mcpx_torch.analysis.core import Finding, rule
from mcpx_torch.analysis.rules.common import dotted_name

_UNKNOWN = object()
# Placement calls -> (position of the spec, position of the tensor or shape)
_PLACEMENTS = {"place": (1, 0), "shard_pytree": (1, 0), "indices_map": (1, 0)}
_FACTORIES = {"zeros", "ones", "empty", "randn", "rand", "full", "randint"}


def _axis_entry(a: ast.AST, resolve):
    if isinstance(a, ast.Constant):
        if a.value is None:
            return None
        return a.value if isinstance(a.value, str) else _UNKNOWN
    if isinstance(a, ast.Name):
        t = resolve(a.id)
        if isinstance(t, ast.Constant) and isinstance(t.value, str):
            return t.value
        return _UNKNOWN
    if isinstance(a, (ast.Tuple, ast.List)):
        parts = tuple(_axis_entry(e, resolve) for e in a.elts)
        return _UNKNOWN if any(p is _UNKNOWN for p in parts) else parts
    return _UNKNOWN


def _spec(expr: ast.AST, resolve) -> Optional[tuple]:
    """A literal spec tuple -> its entries; None when any entry is dynamic."""
    if not isinstance(expr, ast.Tuple):
        return None
    out = tuple(_axis_entry(e, resolve) for e in expr.elts)
    return None if any(e is _UNKNOWN for e in out) else out


def _axes(spec: tuple) -> set:
    out: set = set()
    for e in spec:
        if isinstance(e, str):
            out.add(e)
        elif isinstance(e, tuple):
            out.update(n for n in e if isinstance(n, str))
    return out


def _rank(expr: ast.AST) -> Optional[int]:
    """The rank of a factory call with a literal shape, or of a literal
    shape tuple."""
    if isinstance(expr, (ast.Tuple, ast.List)):
        return len(expr.elts)
    if not isinstance(expr, ast.Call):
        return None
    name = dotted_name(expr.func) or ""
    if not name.startswith("torch.") or name.rsplit(".", 1)[-1] not in _FACTORIES:
        return None
    if name.endswith(".randint"):
        shape = next((a for a in expr.args if isinstance(a, (ast.Tuple, ast.List))), None)
        return len(shape.elts) if shape is not None else None
    if expr.args and isinstance(expr.args[0], (ast.Tuple, ast.List)):
        return len(expr.args[0].elts)
    if name.endswith(".full") or any(isinstance(a, ast.Starred) for a in expr.args):
        return None
    if expr.args and all(isinstance(a, (ast.Constant, ast.Name, ast.Attribute, ast.BinOp)) for a in expr.args):
        return len(expr.args)
    return None


def _local_values(fn) -> dict:
    """Local names bound exactly once in ``fn`` -> their expression."""
    counts: dict[str, int] = {}
    values: dict[str, ast.AST] = {}
    for node in walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for sub in walk(t):
                    if isinstance(sub, ast.Name):
                        counts[sub.id] = counts.get(sub.id, 0) + 1
                if isinstance(t, ast.Name):
                    values[t.id] = node.value
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For)):
            for sub in walk(node.target):
                if isinstance(sub, ast.Name):
                    counts[sub.id] = 2  # rebound: not a single binding
    return {k: v for k, v in values.items() if counts.get(k) == 1}


def _mesh_names(expr: ast.AST, resolve) -> Optional[set]:
    """Axis names of a literal ``Mesh(devices, names)`` construction."""
    if not isinstance(expr, ast.Call) or (dotted_name(expr.func) or "").rsplit(".", 1)[-1] != "Mesh":
        return None
    arg = next((kw.value for kw in expr.keywords if kw.arg == "axis_names"), None)
    if arg is None and len(expr.args) >= 2:
        arg = expr.args[1]
    entry = _axis_entry(arg, resolve) if arg is not None else _UNKNOWN
    if not isinstance(entry, tuple):
        return None
    return {n for n in entry if isinstance(n, str)}


@rule(
    "sharding-contract",
    "spec tuple whose rank differs from its tensor's, or that names an "
    "axis its mesh lacks",
    scope="project",
)
def check_sharding_contract(project) -> Iterator[Finding]:
    index = project.index
    declared = project.mesh_axes()
    for info in index.functions.values():
        calls = [
            n for n in walk(info.node)
            if isinstance(n, ast.Call)
            and (dotted_name(n.func) or "").rsplit(".", 1)[-1] in _PLACEMENTS
        ]
        if not calls:
            continue
        resolve = project.module_resolver(info.module)
        local = _local_values(info.node)
        seen: set = set()

        def value(expr: ast.AST) -> ast.AST:
            if isinstance(expr, ast.Name) and expr.id in local:
                return local[expr.id]
            return expr

        for call in calls:
            fname = (dotted_name(call.func) or "").rsplit(".", 1)[-1]
            spec_pos, x_pos = _PLACEMENTS[fname]
            args = list(call.args)
            kw = {k.arg: k.value for k in call.keywords if k.arg}
            spec_expr = args[spec_pos] if spec_pos < len(args) else kw.get("spec", kw.get("specs"))
            x_expr = args[x_pos] if x_pos < len(args) else kw.get("x", kw.get("tree", kw.get("shape")))
            mesh_expr = args[2] if len(args) > 2 else kw.get("mesh")
            if spec_expr is None:
                continue
            axes = _mesh_names(value(mesh_expr), resolve) if mesh_expr is not None else None
            lacks = "its mesh lacks" if axes is not None else "no mesh in the project declares"
            axes = axes if axes is not None else (set(declared) or None)
            pairs: list[tuple[str, ast.AST, Optional[ast.AST]]] = []
            specs, xs = value(spec_expr), value(x_expr) if x_expr is not None else None
            if fname == "shard_pytree" and isinstance(specs, ast.Dict):
                xd = {}
                if isinstance(xs, ast.Dict):
                    xd = {k.value: value(v) for k, v in zip(xs.keys, xs.values) if isinstance(k, ast.Constant)}
                for k, v in zip(specs.keys, specs.values):
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        pairs.append((f"['{k.value}']", value(v), xd.get(k.value)))
            else:
                pairs.append(("", specs, xs))
            for label, sexpr, texpr in pairs:
                spec = _spec(sexpr, resolve)
                if spec is None:
                    continue
                rank = _rank(texpr) if texpr is not None else None
                if rank is not None and rank != len(spec) and (call.lineno, label, "rank") not in seen:
                    seen.add((call.lineno, label, "rank"))
                    yield project.finding(
                        info.path,
                        call.lineno,
                        "sharding-contract",
                        f"spec{label} of '{fname}' has {len(spec)} entries for a "
                        f"rank-{rank} tensor — one entry per dimension (None "
                        "for a replicated one)",
                    )
                for ax in sorted(_axes(spec) - (axes or _axes(spec))):
                    if (call.lineno, label, ax) in seen:
                        continue
                    seen.add((call.lineno, label, ax))
                    yield project.finding(
                        info.path,
                        call.lineno,
                        "sharding-contract",
                        f"spec{label} of '{fname}' names mesh axis '{ax}', which "
                        f"{lacks} (axes: {sorted(axes)}) — a typo'd axis "
                        "raises at placement, far from the spec",
                    )
