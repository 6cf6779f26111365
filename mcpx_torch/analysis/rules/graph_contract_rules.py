"""jit-contract: no tensor that a captured CUDA graph reads may be rebound
or reallocated after the capture.

A CUDA graph bakes in the device addresses its kernels read and write when
it is captured. Replays then keep using those addresses whatever the Python
names now hold: ``self._x = torch.zeros(...)`` after the capture leaves the
graph reading the old storage (freed, or about to be reused by the caching
allocator) while the host writes into the new one, and ``x.resize_()`` or
``x.set_()`` moves the storage under it. The engine's convention ("no
tensor that a captured graph reads may be rebound": state is written back
with ``copy_``) made checkable. Three shapes are flagged, project-wide:

  - **Rebinding** ``recv.attr = ...`` (or ``del``) of a graph buffer: an
    attribute a captured function or region reads, whose class assigns it
    a tensor (a ``torch.*`` factory, ``.to()``/``.clone()``-style methods,
    a project function annotated to return tensors, or a dict of them).
  - **Entry replacement** ``recv.attr[k] = ...`` on a dict-valued graph
    buffer (``slab.dev["cur"] = ...``): the graph reads the tensor that was
    there. Writes one level deeper (``slab.dev["cur"][rows] = ...``) are
    in-place tensor writes and stay silent.
  - **Reallocation**: ``.resize_()``, ``.resize_as_()`` or ``.set_()`` on a
    graph buffer.

Exempt by construction: the declaring class's ``__init__`` (before any
capture), statements of a function that precede its first call into a
capturing function (the engine's ``_setup`` allocates, then warms its
windows), statements after the function drops its graphs (``.clear()`` of
a capture registry), and rebinding to ``None`` (a buffer released at
teardown is not a new tensor the graph misses).

The reference's second contract, use-after-donation, has no counterpart:
PyTorch has no buffer donation.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from mcpx_torch.analysis.astutil import walk
from mcpx_torch.analysis.core import Finding, rule
from mcpx_torch.analysis.rules.common import call_name

_CTOR_NAMES = {"__init__", "__post_init__", "__new__"}
_TENSOR_METHODS = {
    "to", "cuda", "clone", "contiguous", "pin_memory", "empty_like", "zeros_like",
    "ones_like", "new_zeros", "new_empty", "new_full", "view", "reshape",
}
_REALLOC_METHODS = {"resize_", "resize_as_", "set_"}


_TENSOR_RETURNS = ("Tensor", "Params", "KVCache")


def _tensor_valued(expr: ast.AST, callee) -> bool:
    """True when an assigned expression builds tensors: a ``torch.*`` call,
    a tensor-producing method, or a project function whose return
    annotation names tensors (``-> dict[str, torch.Tensor]``, ``Params``)
    anywhere in it (a dict or tuple of them included). ``callee`` resolves
    a call node to its FunctionInfo, or None."""
    for sub in walk(expr):
        if isinstance(sub, ast.Call):
            name = call_name(sub) or ""
            if name.startswith("torch."):
                return True
            if isinstance(sub.func, ast.Attribute) and sub.func.attr in _TENSOR_METHODS:
                return True
            fn = callee(sub)
            returns = getattr(fn.node, "returns", None) if fn is not None else None
            if returns is not None and any(t in ast.unparse(returns) for t in _TENSOR_RETURNS):
                return True
    return False


def _dict_valued(expr: ast.AST, callee) -> bool:
    """A dict literal or comprehension, or a call of a project function
    annotated to return a dict (``dict[...]``, ``Params``, ``KVCache``)."""
    if isinstance(expr, (ast.Dict, ast.DictComp)):
        return True
    if isinstance(expr, ast.Call):
        fn = callee(expr)
        returns = getattr(fn.node, "returns", None) if fn is not None else None
        if returns is not None:
            text = ast.unparse(returns)
            return text.startswith("dict") or text in ("Params", "KVCache")
    return False


def _short(qualname: str) -> str:
    parts = qualname.split(".")
    return ".".join(parts[-2:]) if len(parts) > 1 else qualname


class _Buffers:
    """The project's graph buffers: (class qualname, attr) read inside a
    capture whose class assigns them a tensor; which of them hold a dict."""

    def __init__(self, project) -> None:
        self.project = project
        index = project.index
        model = project.captures()
        self.registries = model.registries
        tensor_attrs: dict[tuple, bool] = {}  # (cls, attr) -> dict-valued
        for info in index.functions.values():
            if info.cls is None:
                continue
            env = index.local_env(info)
            for node in walk(info.node):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)) or node.value is None:
                    continue
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                attrs = [
                    t for tgt in targets
                    for t in (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt])
                    if isinstance(t, ast.Attribute)
                ]
                if not attrs or not _tensor_valued(
                    node.value, lambda c, info=info, env=env: index.resolve_call(c, info, env)
                ):
                    continue
                for tgt in attrs:
                    bt = index.expr_type(tgt.value, info, env)
                    if bt is None or bt.container:
                        continue
                    key = (bt.cls, tgt.attr)
                    tensor_attrs[key] = tensor_attrs.get(key, False) or _dict_valued(
                        node.value, lambda c, info=info, env=env: index.resolve_call(c, info, env)
                    )
        read: set = set()
        scopes = [(info, [info.node]) for info in model.functions.values()] + list(model.regions)
        for info, stmts in scopes:
            env = index.local_env(info)
            for stmt in stmts:
                for node in walk(stmt):
                    if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load):
                        bt = index.expr_type(node.value, info, env)
                        if bt is not None and not bt.container and (bt.cls, node.attr) in tensor_attrs:
                            read.add((bt.cls, node.attr))
        self.read = read
        self.dicts = {k for k in read if tensor_attrs[k]}
        # Functions whose call captures a graph: the region owners, and
        # (backwards over plain call edges) whatever calls them.
        graph = project.callgraph()
        capturing = {info.qualname for info, _ in model.regions}
        work = list(capturing)
        while work:
            for caller in graph.callers_of(work.pop()):
                if caller not in capturing:
                    capturing.add(caller)
                    work.append(caller)
        self.capturing = capturing


def _buffer_of(index, info, env, expr: ast.AST, buffers: _Buffers) -> Optional[tuple]:
    if not isinstance(expr, ast.Attribute):
        return None
    bt = index.expr_type(expr.value, info, env)
    if bt is None or bt.container:
        return None
    key = (bt.cls, expr.attr)
    return key if key in buffers.read else None


@rule(
    "jit-contract",
    "tensor read by a captured CUDA graph rebound or reallocated after the "
    "capture",
    scope="project",
)
def check_graph_contract(project) -> Iterator[Finding]:
    model = project.captures()
    if not model.functions and not model.regions:
        return
    buffers = _Buffers(project)
    if not buffers.read:
        return
    index = project.index
    for info in index.functions.values():
        env = index.local_env(info)
        # The first line that captures, and the first that drops the graphs.
        first_capture: Optional[int] = None
        dropped: Optional[int] = None
        for node in walk(info.node):
            if isinstance(node, ast.Call):
                callee = index.resolve_call(node, info, env)
                if callee is not None and callee.qualname in buffers.capturing:
                    first_capture = min(first_capture or node.lineno, node.lineno)
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "clear"
                    and isinstance(node.func.value, ast.Attribute)
                ):
                    bt = index.expr_type(node.func.value.value, info, env)
                    if bt is not None and (bt.cls, node.func.value.attr) in buffers.registries:
                        dropped = min(dropped or node.lineno, node.lineno)
        seen: set[tuple] = set()

        def exempt(key: tuple, line: int) -> bool:
            if info.name in _CTOR_NAMES and info.cls == key[0]:
                return True
            if info.qualname in buffers.capturing and (first_capture is None or line < first_capture):
                return True
            return dropped is not None and line > dropped

        def emit(line: int, key: tuple, what: str):
            if (line, key) in seen or exempt(key, line):
                return None
            seen.add((line, key))
            return project.finding(
                info.path,
                line,
                "jit-contract",
                f"{what} '{_short(key[0])}.{key[1]}', which a captured CUDA "
                f"graph reads, in '{_short(info.qualname)}' — replays keep "
                "the address baked in at capture; write into the buffer in "
                "place (copy_, slice writes) instead",
            )

        for node in walk(info.node):
            targets: list = []
            value: Optional[ast.AST] = None
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                value = node.value
            elif isinstance(node, ast.Delete):
                targets = node.targets
            if isinstance(value, ast.Constant) and value.value is None:
                continue
            for tgt in targets:
                for t in (tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]):
                    if isinstance(node, ast.AugAssign) and isinstance(t, ast.Attribute):
                        continue  # ``x += y`` on a tensor attribute is in place
                    if isinstance(t, ast.Attribute):
                        key = _buffer_of(index, info, env, t, buffers)
                        if key is not None:
                            f = emit(node.lineno, key, "rebinding of")
                            if f:
                                yield f
                    elif isinstance(t, ast.Subscript) and isinstance(t.value, ast.Attribute):
                        key = _buffer_of(index, info, env, t.value, buffers)
                        if key is not None and key in buffers.dicts:
                            f = emit(node.lineno, key, "replacement of an entry of")
                            if f:
                                yield f
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if node.func.attr in _REALLOC_METHODS:
                    recv = node.func.value
                    while isinstance(recv, ast.Subscript):
                        recv = recv.value
                    key = _buffer_of(index, info, env, recv, buffers)
                    if key is not None:
                        f = emit(node.lineno, key, f"'.{node.func.attr}()' reallocation of")
                        if f:
                            yield f

