"""Project-wide symbol index and call graph for mcpxlint's
interprocedural passes.

The index parses every scanned file once (sharing the FileContext ASTs),
derives a dotted module name from the root-relative path, and resolves:

  - **imports** (absolute and relative, including function-local ones) to
    project symbols;
  - **classes** — methods, base classes, attribute types harvested from
    annotations (``self.x: T``, class-level ``x: T``) and constructor
    assignments (``self.x = ClassName(...)``), with ``Optional[...]`` /
    string annotations unwrapped and subscripted generics
    (``list[X]``, ``deque[X]``, ``queue.Queue[X]``) treated as containers
    of their element type;
  - **calls** — direct names, imported names, ``self.m()``,
    ``obj.m()``/``self.attr.m()`` through inferred receiver classes — into
    ``call`` edges, and **execution-boundary dispatches**
    (``threading.Thread(target=...)``, ``asyncio.create_task``/
    ``ensure_future``/``to_thread``, ``loop.call_soon*``,
    ``executor.submit``) into ``spawn`` edges, which change threads and are
    therefore *excluded* from ownership reachability walks.

Ownership annotations are picked up here so every pass shares one parse:
``@owned_by("X")`` / ``@thread_entry("X")`` decorators, the
``# mcpx: thread-entry[X]`` def-line comment, and the
``# mcpx: request-payload`` class marker (taint sources for the
jit-contract pass).

``CallGraph.roots_of(fn)`` answers the question the thread-ownership pass
is built on: walking plain ``call`` edges backwards, which *terminals*
(functions with no in-project callers, or functions carrying their own
owner/entry mark — they assert their domain and are checked at their own
call sites) can reach this function?
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Iterable, Optional, Union

from mcpx_torch.analysis.astutil import dotted_name, walk

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]
_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

_THREAD_ENTRY_RE = re.compile(r"#\s*mcpx:\s*thread-entry\[([A-Za-z0-9_\-]+)\]")
_REQUEST_PAYLOAD_RE = re.compile(r"#\s*mcpx:\s*request-payload\b")

# Annotation wrappers that pass their (single) argument through unchanged.
_UNWRAP_NAMES = {"Optional", "ClassVar", "Final", "Annotated"}
# Methods that pull one element out of a container-typed receiver.
_ELEMENT_GETTERS = {"get", "get_nowait", "pop", "popleft", "popitem"}
# Spawn-shaped module-level callables -> (how the target callable is
# named, which execution context the target lands in). ``via`` is the
# mechanism class: "thread" targets leave the event loop (threads,
# executors), "loop" targets are scheduled back onto it (tasks and loop
# callbacks — call_soon_threadsafe schedules ON the loop even though the
# *call site* may be off it).
_SPAWN_CALLS = {
    "threading.Thread": ("target", "thread"),
    "Thread": ("target", "thread"),
    "asyncio.create_task": (0, "loop"),
    "asyncio.ensure_future": (0, "loop"),
    "asyncio.to_thread": (0, "thread"),
}
# Spawn-shaped methods (any receiver) -> (positional index, via).
_SPAWN_METHODS = {
    "create_task": (0, "loop"),
    "call_soon_threadsafe": (0, "loop"),
    "call_soon": (0, "loop"),
    "call_later": (1, "loop"),
    "run_in_executor": (1, "thread"),
    "submit": (0, "thread"),
}


@dataclasses.dataclass
class TypeRef:
    """A resolved class reference; ``container`` marks list/deque/Queue-of."""

    cls: str  # class qualname
    container: bool = False


@dataclasses.dataclass
class FunctionInfo:
    qualname: str
    module: str
    name: str
    path: str
    node: FunctionNode
    cls: Optional[str] = None  # owning class qualname for methods
    is_async: bool = False
    owner: Optional[str] = None      # @owned_by("X")
    entry_of: Optional[str] = None   # @thread_entry("X") / # mcpx: thread-entry[X]
    params: tuple = ()               # declared parameter names, in order
    has_self: bool = False

    @property
    def marked(self) -> Optional[str]:
        return self.entry_of or self.owner


@dataclasses.dataclass
class ClassInfo:
    qualname: str
    module: str
    name: str
    path: str
    node: ast.ClassDef
    bases: tuple = ()                # raw dotted base names
    methods: dict = dataclasses.field(default_factory=dict)
    attr_types: dict = dataclasses.field(default_factory=dict)  # attr -> TypeRef
    owner: Optional[str] = None      # @owned_by("X") on the class
    request_payload: bool = False    # # mcpx: request-payload marker


@dataclasses.dataclass
class ModuleInfo:
    name: str
    path: str
    tree: ast.Module
    lines: list
    imports: dict = dataclasses.field(default_factory=dict)  # local -> dotted
    functions: dict = dataclasses.field(default_factory=dict)
    classes: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Edge:
    caller: str
    callee: str
    kind: str  # "call" | "spawn"
    path: str
    line: int
    via: str = ""  # spawn mechanism class: "thread" | "loop" ("" for calls)


def module_name_for(relpath: str) -> str:
    name = relpath[:-3] if relpath.endswith(".py") else relpath
    name = name.replace("/", ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


def _decorator_mark(dec: ast.AST) -> Optional[tuple]:
    """("owned_by"|"thread_entry", owner) for a recognised decorator."""
    if isinstance(dec, ast.Call):
        name = dotted_name(dec.func)
        last = name.rsplit(".", 1)[-1] if name else ""
        if last in ("owned_by", "thread_entry") and dec.args:
            a = dec.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                return last, a.value
    return None


class ProjectIndex:
    """Symbol tables + per-function type inference for one set of files."""

    def __init__(self, files: Iterable) -> None:
        self.modules: dict[str, ModuleInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.fn_by_node: dict[int, FunctionInfo] = {}
        self._env_cache: dict[str, dict] = {}
        for ctx in files:
            if ctx.tree is None:
                continue
            self._index_module(ctx)
        self._harvest_attr_types()

    # ------------------------------------------------------------- indexing
    def _index_module(self, ctx) -> None:
        mod = ModuleInfo(
            name=module_name_for(ctx.relpath),
            path=ctx.relpath,
            tree=ctx.tree,
            lines=ctx.lines,
        )
        self.modules[mod.name] = mod
        ctx.module = mod.name
        for node in walk(ctx.tree):  # function-local imports included
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    mod.imports[local] = alias.asname and alias.name or local
                    # `import a.b.c` binds `a`, but the dotted path is also
                    # resolvable verbatim.
                    mod.imports.setdefault(alias.name, alias.name)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = mod.name.split(".")
                    # a module's package is its parent; each extra level
                    # drops one more.
                    parts = parts[: len(parts) - node.level]
                    base = ".".join(parts + ([node.module] if node.module else []))
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    mod.imports[alias.asname or alias.name] = f"{base}.{alias.name}"
        for stmt in ctx.tree.body:
            if isinstance(stmt, _FUNC_NODES):
                self._index_function(mod, stmt, cls=None)
            elif isinstance(stmt, ast.ClassDef):
                self._index_class(mod, stmt)

    def _index_function(
        self, mod: ModuleInfo, node: FunctionNode, cls: Optional[ClassInfo]
    ) -> FunctionInfo:
        qual = (cls.qualname if cls else mod.name) + "." + node.name
        a = node.args
        params = tuple(
            p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)
        )
        info = FunctionInfo(
            qualname=qual,
            module=mod.name,
            name=node.name,
            path=mod.path,
            node=node,
            cls=cls.qualname if cls else None,
            is_async=isinstance(node, ast.AsyncFunctionDef),
            params=params,
            has_self=bool(params) and params[0] in ("self", "cls"),
        )
        for dec in node.decorator_list:
            mark = _decorator_mark(dec)
            if mark and mark[0] == "owned_by":
                info.owner = mark[1]
            elif mark:
                info.entry_of = mark[1]
        if 0 < node.lineno <= len(mod.lines):
            m = _THREAD_ENTRY_RE.search(mod.lines[node.lineno - 1])
            if m:
                info.entry_of = m.group(1)
        self.functions[qual] = info
        self.fn_by_node[id(node)] = info
        if cls is not None:
            cls.methods[node.name] = info
        else:
            mod.functions[node.name] = info
        return info

    def _index_class(self, mod: ModuleInfo, node: ast.ClassDef) -> None:
        qual = f"{mod.name}.{node.name}"
        ci = ClassInfo(
            qualname=qual,
            module=mod.name,
            name=node.name,
            path=mod.path,
            node=node,
            bases=tuple(n for n in (dotted_name(b) for b in node.bases) if n),
        )
        for dec in node.decorator_list:
            mark = _decorator_mark(dec)
            if mark and mark[0] == "owned_by":
                ci.owner = mark[1]
        if 0 < node.lineno <= len(mod.lines) and _REQUEST_PAYLOAD_RE.search(
            mod.lines[node.lineno - 1]
        ):
            ci.request_payload = True
        self.classes[qual] = ci
        mod.classes[node.name] = ci
        for stmt in node.body:
            if isinstance(stmt, _FUNC_NODES):
                self._index_function(mod, stmt, cls=ci)
            elif isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name
            ):
                t = self.ann_type(stmt.annotation, mod.name)
                if t is not None:
                    ci.attr_types[stmt.target.id] = t

    def _harvest_attr_types(self) -> None:
        """Attribute types from method bodies: ``self.x: T = ...`` anywhere,
        ``self.x = ClassName(...)`` constructor assignments (annotation
        wins over constructor when both exist)."""
        for ci in self.classes.values():
            ctor_types: dict[str, TypeRef] = {}
            for m in ci.methods.values():
                for node in walk(m.node):
                    if isinstance(node, ast.AnnAssign):
                        tgt = node.target
                        if (
                            isinstance(tgt, ast.Attribute)
                            and dotted_name(tgt.value) == "self"
                        ):
                            t = self.ann_type(node.annotation, ci.module)
                            if t is not None:
                                ci.attr_types.setdefault(tgt.attr, t)
                    elif isinstance(node, ast.Assign) and isinstance(
                        node.value, ast.Call
                    ):
                        cn = dotted_name(node.value.func)
                        sym = self.resolve(ci.module, cn) if cn else None
                        if isinstance(sym, ClassInfo):
                            for tgt in node.targets:
                                if (
                                    isinstance(tgt, ast.Attribute)
                                    and dotted_name(tgt.value) == "self"
                                ):
                                    ctor_types.setdefault(
                                        tgt.attr, TypeRef(sym.qualname)
                                    )
            for attr, t in ctor_types.items():
                ci.attr_types.setdefault(attr, t)

    # ----------------------------------------------------------- resolution
    def resolve(self, module: str, dotted: Optional[str]):
        """A dotted name used in ``module`` -> FunctionInfo | ClassInfo |
        ModuleInfo | None."""
        if not dotted:
            return None
        mod = self.modules.get(module)
        if mod is None:
            return None
        parts = dotted.split(".")
        if parts[0] in mod.functions and len(parts) == 1:
            return mod.functions[parts[0]]
        if parts[0] in mod.classes:
            ci = mod.classes[parts[0]]
            if len(parts) == 1:
                return ci
            if len(parts) == 2:
                return self.find_method(ci.qualname, parts[1])
        for i in range(len(parts), 0, -1):
            head = ".".join(parts[:i])
            if head in mod.imports:
                target = mod.imports[head]
                rest = parts[i:]
                return self._resolve_qualname(
                    target + ("." + ".".join(rest) if rest else "")
                )
        return self._resolve_qualname(dotted)

    def _resolve_qualname(self, qual: str):
        if qual in self.modules:
            return self.modules[qual]
        parts = qual.split(".")
        for i in range(len(parts) - 1, 0, -1):
            head = ".".join(parts[:i])
            mod = self.modules.get(head)
            if mod is None:
                continue
            rest = parts[i:]
            if rest[0] in mod.functions and len(rest) == 1:
                return mod.functions[rest[0]]
            if rest[0] in mod.classes:
                ci = mod.classes[rest[0]]
                if len(rest) == 1:
                    return ci
                if len(rest) == 2:
                    return self.find_method(ci.qualname, rest[1])
        if qual in self.functions:
            return self.functions[qual]
        if qual in self.classes:
            return self.classes[qual]
        return None

    def find_method(self, classq: str, name: str) -> Optional[FunctionInfo]:
        seen: set[str] = set()
        stack = [classq]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            ci = self.classes.get(q)
            if ci is None:
                continue
            if name in ci.methods:
                return ci.methods[name]
            for b in ci.bases:
                sym = self.resolve(ci.module, b)
                if isinstance(sym, ClassInfo):
                    stack.append(sym.qualname)
        return None

    def find_attr_type(self, classq: str, attr: str) -> Optional[TypeRef]:
        seen: set[str] = set()
        stack = [classq]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            ci = self.classes.get(q)
            if ci is None:
                continue
            if attr in ci.attr_types:
                return ci.attr_types[attr]
            for b in ci.bases:
                sym = self.resolve(ci.module, b)
                if isinstance(sym, ClassInfo):
                    stack.append(sym.qualname)
        return None

    # ----------------------------------------------------------------- types
    def ann_type(self, node: ast.AST, module: str) -> Optional[TypeRef]:
        """TypeRef for an annotation expression (strings parsed, Optional
        unwrapped, subscripted generics treated as containers)."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            try:
                node = ast.parse(node.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(node, (ast.Name, ast.Attribute)):
            sym = self.resolve(module, dotted_name(node))
            if isinstance(sym, ClassInfo):
                return TypeRef(sym.qualname)
            return None
        if isinstance(node, ast.Subscript):
            base = dotted_name(node.value) or ""
            last = base.rsplit(".", 1)[-1]
            inner: ast.AST = node.slice
            if isinstance(inner, ast.Tuple) and inner.elts:
                inner = inner.elts[-1]  # dict[k, v] / Callable[..., R]: value side
            t = self.ann_type(inner, module)
            if t is None:
                return None
            if last in _UNWRAP_NAMES:
                return t
            return TypeRef(t.cls, container=True)
        return None

    def local_env(self, info: FunctionInfo) -> dict:
        """name -> TypeRef for one function's locals (params from
        annotations, constructor assignments, container element binding
        through subscripts / ``for`` loops / get-style calls). Two passes
        so forward references settle; memoized per function."""
        env = self._env_cache.get(info.qualname)
        if env is not None:
            return env
        env = {}
        if info.has_self and info.cls:
            env["self"] = TypeRef(info.cls)
        a = info.node.args
        for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
            if p.annotation is not None:
                t = self.ann_type(p.annotation, info.module)
                if t is not None:
                    env[p.arg] = t
        for _ in range(2):
            for node in walk(info.node):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    tgt = node.targets[0]
                    if isinstance(tgt, ast.Name):
                        t = self.expr_type(node.value, info, env)
                        if t is not None:
                            env.setdefault(tgt.id, t)
                elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name
                ):
                    t = self.ann_type(node.annotation, info.module)
                    if t is not None:
                        env[node.target.id] = t
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    it = node.iter
                    tgt = node.target
                    if (
                        isinstance(it, ast.Call)
                        and dotted_name(it.func) == "enumerate"
                        and it.args
                    ):
                        it = it.args[0]
                        if isinstance(tgt, ast.Tuple) and len(tgt.elts) == 2:
                            tgt = tgt.elts[1]
                    t = self.expr_type(it, info, env)
                    if t is not None and t.container and isinstance(tgt, ast.Name):
                        env.setdefault(tgt.id, TypeRef(t.cls))
        self._env_cache[info.qualname] = env
        return env

    def expr_type(
        self, node: ast.AST, info: FunctionInfo, env: dict
    ) -> Optional[TypeRef]:
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, ast.Attribute):
            bt = self.expr_type(node.value, info, env)
            if bt is not None and not bt.container:
                return self.find_attr_type(bt.cls, node.attr)
            return None
        if isinstance(node, ast.Subscript):
            vt = self.expr_type(node.value, info, env)
            if vt is not None and vt.container:
                return TypeRef(vt.cls)
            return None
        if isinstance(node, ast.Call):
            cn = dotted_name(node.func)
            if cn is not None and "." not in cn:
                sym = self.resolve(info.module, cn)
                if isinstance(sym, ClassInfo):
                    return TypeRef(sym.qualname)
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _ELEMENT_GETTERS:
                    rt = self.expr_type(node.func.value, info, env)
                    if rt is not None and rt.container:
                        return TypeRef(rt.cls)
                elif node.func.attr == "copy":
                    return self.expr_type(node.func.value, info, env)
                else:
                    sym = self.resolve(info.module, cn) if cn else None
                    if isinstance(sym, ClassInfo):
                        return TypeRef(sym.qualname)
        return None

    # ------------------------------------------------------------ call refs
    def resolve_func_ref(
        self, expr: ast.AST, info: FunctionInfo, env: dict
    ) -> Optional[FunctionInfo]:
        """A *reference* to a callable (not a call): ``helper``,
        ``self._worker``, ``mod.fn``, ``self._thread.join``-style chains."""
        name = dotted_name(expr)
        if name is None:
            return None
        if isinstance(expr, ast.Attribute):
            bt = self.expr_type(expr.value, info, env)
            if bt is not None and not bt.container:
                m = self.find_method(bt.cls, expr.attr)
                if m is not None:
                    return m
        sym = self.resolve(info.module, name)
        if isinstance(sym, FunctionInfo):
            return sym
        if isinstance(sym, ClassInfo):
            return self.find_method(sym.qualname, "__init__")
        return None

    def resolve_call(
        self, call: ast.Call, info: FunctionInfo, env: dict
    ) -> Optional[FunctionInfo]:
        return self.resolve_func_ref(call.func, info, env)


class CallGraph:
    """Edges over the project index; ``roots_of`` walks plain call edges
    backwards to the terminals that can reach a function."""

    def __init__(self, index: ProjectIndex) -> None:
        self.index = index
        self.edges: list[Edge] = []
        self._callers: dict[str, set[str]] = {}
        self._roots: dict[str, frozenset] = {}
        self._spawned: dict[str, set[str]] = {}  # callee -> spawn vias
        for info in list(index.functions.values()):
            self._collect(info)

    def _add(
        self, caller: str, callee: str, kind: str, path: str, line: int,
        via: str = "",
    ) -> None:
        self.edges.append(Edge(caller, callee, kind, path, line, via))
        if kind == "call":
            self._callers.setdefault(callee, set()).add(caller)
        else:
            self._spawned.setdefault(callee, set()).add(via)

    def _spawn_target(self, call: ast.Call) -> Optional[tuple]:
        """(target expression, via) when ``call`` is a spawn dispatch."""
        cn = dotted_name(call.func)
        spec = _SPAWN_CALLS.get(cn or "")
        if not spec and isinstance(call.func, ast.Attribute):
            spec = _SPAWN_METHODS.get(call.func.attr)
        if not spec:
            return None
        pos, via = spec
        if pos == "target":
            for kw in call.keywords:
                if kw.arg == "target":
                    return kw.value, via
            return (call.args[0], via) if call.args else None
        if isinstance(pos, int) and pos < len(call.args):
            return call.args[pos], via
        return None

    def _collect(self, info: FunctionInfo) -> None:
        env = self.index.local_env(info)
        spawn_inner: set[int] = set()
        for node in walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            spawned = self._spawn_target(node)
            if spawned is not None:
                target, via = spawned
                # create_task(f(...)) spawns the coroutine f builds; the
                # inner f(...) call must not double as a plain call edge —
                # its body runs in the spawned context.
                if isinstance(target, ast.Call):
                    spawn_inner.add(id(target))
                    target = target.func
                callee = self.index.resolve_func_ref(target, info, env)
                if callee is not None:
                    self._add(
                        info.qualname, callee.qualname, "spawn",
                        info.path, node.lineno, via,
                    )
                continue
            if id(node) in spawn_inner:
                continue
            callee = self.index.resolve_call(node, info, env)
            if callee is not None:
                self._add(
                    info.qualname, callee.qualname, "call", info.path, node.lineno
                )

    def callers_of(self, qualname: str) -> set:
        return set(self._callers.get(qualname, ()))

    def spawned_via(self, qualname: str) -> frozenset:
        """Mechanism classes ("thread"/"loop") this function is spawned
        through anywhere in the project; empty if never a spawn target."""
        return frozenset(self._spawned.get(qualname, ()))

    def roots_of(self, qualname: str) -> frozenset:
        """Terminal functions reachable by walking ``call`` edges backwards
        from ``qualname``: functions with no in-project callers, plus
        functions carrying their own owner/entry mark (they assert a
        domain; their callers are checked at their own call sites).
        ``qualname`` itself is a terminal when unmarked and caller-less."""
        hit = self._roots.get(qualname)
        if hit is not None:
            return hit
        roots: set[str] = set()
        seen: set[str] = set()
        stack = [qualname]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            info = self.index.functions.get(q)
            if info is not None and info.marked and q != qualname:
                roots.add(q)
                continue
            callers = self._callers.get(q)
            if not callers:
                roots.add(q)
                continue
            stack.extend(callers)
        if info := self.index.functions.get(qualname):
            if info.marked:
                # A marked function is its own root regardless of callers.
                roots.add(qualname)
        out = frozenset(roots)
        self._roots[qualname] = out
        return out

    def summary(self) -> list[tuple]:
        """Stable (caller, callee, kind) triples for golden tests."""
        return sorted({(e.caller, e.callee, e.kind) for e in self.edges})
