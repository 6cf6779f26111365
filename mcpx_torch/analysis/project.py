"""ProjectContext: the whole-program view handed to project-scope rules.

File-scope rules see one ``FileContext``; project-scope rules (the
thread-ownership and graph-contract passes, the migrated cache/retry rules)
see this object instead — every parsed file, plus lazily-built and shared
derived structure: the symbol index, the call graph, the capture model
(which functions run inside CUDA-graph captures, which dicts hold captured
graphs) and the taint engine. Building each is paid once per scan no
matter how many rules query it.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Optional

from mcpx_torch.analysis.astutil import GRAPH_CLASSES, dotted_name, walk
from mcpx_torch.analysis.callgraph import (
    CallGraph,
    FunctionInfo,
    ProjectIndex,
)


@dataclasses.dataclass
class CaptureModel:
    """The project's CUDA-graph captures. ``functions``: qualname ->
    FunctionInfo of every indexed function that runs inside a capture (each
    file's captured functions, then what they call or reference across
    modules, to a fixpoint). ``regions``: (FunctionInfo, statements) of the
    ``with torch.cuda.graph(...)`` bodies and ``capture_begin``/
    ``capture_end`` stretches. ``registries``: (class qualname, attr) of the
    dicts that hold captured graphs (``self._graphs[key] = graph`` where
    ``graph`` is a ``torch.cuda.CUDAGraph()``) — the capture keys' home."""

    functions: dict
    regions: list
    registries: set


class ProjectContext:
    def __init__(self, files: Iterable, root) -> None:
        self.files = [f for f in files if f.tree is not None]
        self.by_path = {f.relpath: f for f in self.files}
        self.root = root
        self._index: Optional[ProjectIndex] = None
        self._graph: Optional[CallGraph] = None
        self._taint = None
        self._captures: Optional[CaptureModel] = None
        self._mod_bindings: dict = {}
        self._mesh_axes: Optional[frozenset] = None

    @property
    def index(self) -> ProjectIndex:
        if self._index is None:
            self._index = ProjectIndex(self.files)
        return self._index

    def callgraph(self) -> CallGraph:
        if self._graph is None:
            self._graph = CallGraph(self.index)
        return self._graph

    def taint(self):
        if self._taint is None:
            from mcpx_torch.analysis.dataflow import TaintEngine

            self._taint = TaintEngine(self.index)
        return self._taint

    def finding(self, path: str, line: int, rule_id: str, message: str):
        from mcpx_torch.analysis.core import Finding

        return Finding(path=path, line=line, rule=rule_id, message=message)

    def function_for(self, ctx, node) -> FunctionInfo:
        """FunctionInfo for an AST function node — the indexed one when it
        is a module-level def or method, an ephemeral one (module-scoped,
        unique qualname) for nested defs so call/type resolution still
        works inside them."""
        info = self.index.fn_by_node.get(id(node))
        if info is not None:
            return info
        a = node.args
        params = tuple(p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs))
        mod = ctx.module or ctx.relpath
        return FunctionInfo(
            qualname=f"{mod}.<local>.{node.name}@{node.lineno}",
            module=mod,
            name=node.name,
            path=ctx.relpath,
            node=node,
            is_async=isinstance(node, ast.AsyncFunctionDef),
            params=params,
            has_self=bool(params) and params[0] in ("self", "cls"),
        )

    # ------------------------------------------------------------- meshes
    def module_resolver(self, modname: str):
        """Name -> module-level assigned expression, for resolving axis
        constants (``DATA_AXIS = "data"``) while reading mesh declarations
        and spec tuples."""
        consts = self._mod_bindings.get(modname)
        if consts is None:
            consts = {}
            mod = self.index.modules.get(modname)
            for stmt in (mod.tree.body if mod is not None else ()):
                if (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                ):
                    consts[stmt.targets[0].id] = stmt.value
                elif (
                    isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)
                    and stmt.value is not None
                ):
                    consts[stmt.target.id] = stmt.value
            self._mod_bindings[modname] = consts
        return consts.get

    def mesh_axes(self) -> frozenset:
        """Union of axis names declared by every ``Mesh(devices,
        axis_names)`` construction in the project (axis-name Names resolved
        through module constants). The sharding-contract pass checks a spec
        against these when its mesh is not known at the call site, and only
        when this is non-empty — a project with no mesh declares no
        contract."""
        if self._mesh_axes is not None:
            return self._mesh_axes
        axes: set = set()
        for mod in self.index.modules.values():
            resolve = self.module_resolver(mod.name)
            for node in walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                last = (dotted_name(node.func) or "").rsplit(".", 1)[-1]
                if last not in ("Mesh", "AbstractMesh", "make_mesh"):
                    continue
                name_arg = None
                for kw in node.keywords:
                    if kw.arg == "axis_names":
                        name_arg = kw.value
                if name_arg is None and len(node.args) >= 2:
                    name_arg = node.args[1]
                if name_arg is None:
                    continue
                for sub in walk(name_arg):
                    if isinstance(sub, ast.Constant) and isinstance(
                        sub.value, str
                    ):
                        axes.add(sub.value)
                    elif isinstance(sub, ast.Name):
                        t = resolve(sub.id)
                        if isinstance(t, ast.Constant) and isinstance(
                            t.value, str
                        ):
                            axes.add(t.value)
        self._mesh_axes = frozenset(axes)
        return self._mesh_axes

    # ------------------------------------------------------------ captures
    def captures(self) -> CaptureModel:
        if self._captures is not None:
            return self._captures
        from mcpx_torch.analysis.rules.common import cached_capture_scopes

        index = self.index
        functions: dict = {}
        regions: list = []
        for ctx in self.files:
            scopes = cached_capture_scopes(ctx)
            for fn in scopes.functions:
                info = index.fn_by_node.get(id(fn))
                if info is not None:
                    functions[info.qualname] = info
            for fn, body in scopes.regions:
                info = self.function_for(ctx, fn)
                regions.append((info, body))
                env = index.local_env(info)
                for stmt in body:
                    for sub in walk(stmt):
                        if isinstance(sub, ast.Call):
                            callee = index.resolve_call(sub, info, env)
                            if callee is not None:
                                functions.setdefault(callee.qualname, callee)
        # Across modules: what captured functions call or reference.
        work = list(functions.values())
        while work:
            info = work.pop()
            env = index.local_env(info)
            for sub in walk(info.node):
                ref = None
                if isinstance(sub, ast.Call):
                    ref = index.resolve_call(sub, info, env)
                elif isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Load):
                    ref = index.resolve_func_ref(sub, info, env)
                if ref is not None and ref.qualname not in functions:
                    functions[ref.qualname] = ref
                    work.append(ref)
        registries: set = set()
        for info in index.functions.values():
            graphs = set()
            env = None
            for node in walk(info.node):
                if (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and dotted_name(node.value.func) in GRAPH_CLASSES
                ):
                    graphs.update(t.id for t in node.targets if isinstance(t, ast.Name))
            for node in walk(info.node):
                if not isinstance(node, ast.Assign):
                    continue
                v = node.value
                if not (
                    (isinstance(v, ast.Name) and v.id in graphs)
                    or (isinstance(v, ast.Call) and dotted_name(v.func) in GRAPH_CLASSES)
                ):
                    continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Attribute):
                        env = env if env is not None else index.local_env(info)
                        bt = index.expr_type(tgt.value.value, info, env)
                        if bt is not None and not bt.container:
                            registries.add((bt.cls, tgt.value.attr))
        self._captures = CaptureModel(functions, regions, registries)
        return self._captures
