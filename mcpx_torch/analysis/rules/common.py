"""Shared AST plumbing for mcpxlint rules: dotted-name resolution, scope
walks that respect function boundaries, and the discovery of captured
regions (the port's counterpart of the reference's jit scopes)."""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Union

from mcpx_torch.analysis.astutil import (  # noqa: F401 - re-exported rule API
    CAPTURE_CONTEXTS,
    GRAPHED_CALLABLES,
    call_name,
    dotted_name,
    walk,
)

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]
_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def walk_scope(fn: FunctionNode, *, include_nested_defs: bool = False) -> list:
    """Walk a function body. By default nested ``def``/``async def`` bodies
    are skipped — their statements run in a different execution regime (a
    sync helper offloaded to a thread is not event-loop code; each nested
    async def is its own scope). The node list is computed once per
    function and flag, and kept on the node (see ``astutil.walk``)."""
    attr = "_mcpx_scope_nested" if include_nested_defs else "_mcpx_scope"
    try:
        return getattr(fn, attr)
    except AttributeError:
        pass
    out: list = []
    stack: list[ast.AST] = []
    for stmt in fn.body:
        if not include_nested_defs and isinstance(stmt, _FUNC_NODES):
            continue
        stack.append(stmt)
    while stack:
        node = stack.pop()
        out.append(node)
        for child in ast.iter_child_nodes(node):
            if not include_nested_defs and isinstance(child, _FUNC_NODES):
                continue
            stack.append(child)
    setattr(fn, attr, out)
    return out


def async_functions(tree: ast.Module) -> Iterator[ast.AsyncFunctionDef]:
    for node in walk(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            yield node


class CaptureScopes:
    """What one file runs inside CUDA-graph captures.

    ``regions``: (enclosing function, statements) for every ``with
    torch.cuda.graph(...)`` body and every stretch between a graph's
    ``capture_begin()`` and ``capture_end()``. ``functions``: the defs those
    regions run, found by name within the file — those called there (a call
    of a parameter resolves through the enclosing function's call sites in
    the file: ``self._capture(key, lambda: self._window(...))`` captures
    ``_window``), those handed to ``make_graphed_callables``, and, to a
    fixpoint, the methods and module functions they call or reference
    (a dict of bound methods picked at run time is captured whole)."""

    def __init__(self, regions: list, functions: list) -> None:
        self.regions = regions
        self.functions = functions

    @property
    def names(self) -> set:
        return {fn.name for fn in self.functions}


def _params_sans_self(fn: FunctionNode) -> list:
    a = fn.args
    params = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    if params and params[0] in ("self", "cls"):
        params = params[1:]
    return params


def _local_target(expr: ast.AST) -> Optional[str]:
    """The def name a call or reference targets within the file: ``f`` or
    ``self.f``/``cls.f``; None for any other receiver."""
    name = dotted_name(expr)
    if name is None:
        return None
    parts = name.split(".")
    if len(parts) == 1:
        return parts[0]
    if len(parts) == 2 and parts[0] in ("self", "cls"):
        return parts[1]
    return None


def _is_graph_call(stmt: ast.AST, attr: str) -> bool:
    return (
        isinstance(stmt, ast.Expr)
        and isinstance(stmt.value, ast.Call)
        and isinstance(stmt.value.func, ast.Attribute)
        and stmt.value.func.attr == attr
    )


def _capture_stretches(stmts: list) -> Iterator[list]:
    """Statements between ``g.capture_begin()`` and ``g.capture_end()`` in
    one statement list — the end either a later statement of the list or
    the ``finally`` of a ``try`` that follows the begin (whose body is then
    captured) — for every nested list too."""
    begin = None
    for i, s in enumerate(stmts):
        if _is_graph_call(s, "capture_begin"):
            begin = i
        elif begin is not None and _is_graph_call(s, "capture_end"):
            yield stmts[begin + 1 : i]
            begin = None
        elif begin is not None and isinstance(s, ast.Try) and any(
            _is_graph_call(f, "capture_end") for f in s.finalbody
        ):
            yield stmts[begin + 1 : i] + s.body
            begin = None
        for field in ("body", "orelse", "finalbody"):
            inner = getattr(s, field, None)
            if isinstance(inner, list) and not isinstance(s, _FUNC_NODES):
                yield from _capture_stretches(inner)
        for h in getattr(s, "handlers", ()):
            yield from _capture_stretches(h.body)


def capture_scopes(tree: ast.Module) -> CaptureScopes:
    by_name: dict[str, list[FunctionNode]] = {}
    fns: list[FunctionNode] = []
    for node in walk(tree):
        if isinstance(node, _FUNC_NODES):
            by_name.setdefault(node.name, []).append(node)
            fns.append(node)
    marked: list[FunctionNode] = []
    seen: set[int] = set()

    def mark_name(name: Optional[str]) -> None:
        for fn in by_name.get(name or "", ()):
            if id(fn) not in seen:
                seen.add(id(fn))
                marked.append(fn)

    def mark_expr(expr: ast.AST) -> None:
        """Mark what a callable-valued argument runs."""
        if isinstance(expr, ast.Lambda):
            for sub in walk(expr.body):
                if isinstance(sub, ast.Call):
                    mark_name(_local_target(sub.func))
        elif isinstance(expr, ast.Call) and call_name(expr) in ("functools.partial", "partial") and expr.args:
            mark_name(_local_target(expr.args[0]))
        elif isinstance(expr, (ast.Tuple, ast.List)):
            for e in expr.elts:
                mark_expr(e)
        else:
            mark_name(_local_target(expr))

    def callers_args(fn: FunctionNode, param: str) -> Iterator[ast.AST]:
        """The arguments bound to ``param`` at ``fn``'s call sites in the file."""
        params = _params_sans_self(fn)
        pos = params.index(param) if param in params else None
        for node in walk(tree):
            if not isinstance(node, ast.Call) or _local_target(node.func) != fn.name:
                continue
            if pos is not None and pos < len(node.args) and not any(
                isinstance(a, ast.Starred) for a in node.args[: pos + 1]
            ):
                yield node.args[pos]
            for kw in node.keywords:
                if kw.arg == param:
                    yield kw.value

    regions: list = []
    for fn in fns:
        params = set(_params_sans_self(fn))
        bodies: list[list] = []
        for node in walk_scope(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call) and call_name(it.context_expr) in CAPTURE_CONTEXTS
                for it in node.items
            ):
                bodies.append(node.body)
        bodies.extend(_capture_stretches(fn.body))
        for body in bodies:
            regions.append((fn, body))
            for stmt in body:
                for sub in walk(stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    target = _local_target(sub.func)
                    if isinstance(sub.func, ast.Name) and target in params:
                        for arg in callers_args(fn, target):
                            mark_expr(arg)
                    else:
                        mark_name(target)
    for node in walk(tree):
        if isinstance(node, ast.Call) and call_name(node) in GRAPHED_CALLABLES and node.args:
            mark_expr(node.args[0])
    i = 0
    while i < len(marked):
        for sub in walk(marked[i]):
            if isinstance(sub, ast.Call):
                mark_name(_local_target(sub.func))
            elif isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Load):
                if isinstance(sub.value, ast.Name) and sub.value.id in ("self", "cls"):
                    mark_name(sub.attr)
        i += 1
    return CaptureScopes(regions, marked)


def cached_capture_scopes(ctx) -> CaptureScopes:
    """`capture_scopes(ctx.tree)` memoized on the FileContext: two rules
    need it and the discovery walks the tree several times."""
    if "capture_scopes" not in ctx.cache:
        ctx.cache["capture_scopes"] = capture_scopes(ctx.tree)
    return ctx.cache["capture_scopes"]


def dispatch_names(ctx) -> set:
    """Last name segments that dispatch device work when called: the
    captured functions of the file, a graph's ``replay``, and the model's
    forwards (``forward``, ``*_forward``)."""
    return cached_capture_scopes(ctx).names | {"replay", "forward"}


def is_dispatch(call: ast.Call, names: set) -> bool:
    name = call_name(call)
    if name is None:
        return False
    last = name.rsplit(".", 1)[-1]
    return last in names or last.endswith("_forward")
