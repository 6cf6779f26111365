"""Worklist taint/provenance dataflow over the project call graph.

The question the jit-contract pass asks — "can a per-request value reach
this expression?" — is answered here once for the whole project and then
queried per call site. The abstraction:

  - **Sources.** Attribute reads off instances of classes marked
    ``# mcpx: request-payload`` (the engine's ``GenerateRequest``: every
    field of a queue payload is per-request by construction), plus
    parameters literally named ``request``/``req`` of async functions
    (HTTP handlers). Labels carry their origin (``GenerateRequest.temperature``)
    into finding messages.
  - **Locals.** Flow-insensitive per function: a variable tainted anywhere
    in the body taints all its uses (iterated to a small fixpoint so
    chained assignments settle).
  - **Heap.** Attribute stores write a global ``(receiver class, attr)``
    cell; attribute loads read it. Receiver classes come from the project
    index's annotation/constructor inference; unresolved receivers pool
    under ``(None, attr)`` so an unknown object can never borrow taint
    from a resolved class's field.
  - **Calls.** Project-resolved calls bind argument taint to callee
    parameters and return the callee's return-taint summary; the worklist
    iterates functions until parameter/heap/return facts stop changing.
    Unresolved calls (builtins, stdlib) conservatively pass the union of
    their argument + receiver taint through — ``int(x)``, ``len(x)``,
    ``min(x, cap)`` keep request provenance, because a request-shaped
    length IS the retrace hazard.
  - **Sanitizers.** Calls whose last name segment contains ``bucket``
    launder taint: quantizing a request-derived length onto a fixed
    bucket grid is exactly the sanctioned idiom (``engine._bucket``) that
    makes a static arg finite.
"""

from __future__ import annotations

import ast
from typing import Optional

from mcpx_torch.analysis.astutil import dotted_name, walk
from mcpx_torch.analysis.callgraph import FunctionInfo, ProjectIndex

_HANDLER_PARAM_NAMES = {"request", "req"}
_TRANSFER_NODES = (
    ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Call, ast.Return, ast.For, ast.AsyncFor,
)
_MAX_PASSES = 12


def _is_sanitizer(name: Optional[str]) -> bool:
    return bool(name) and "bucket" in name.rsplit(".", 1)[-1].lower()


class TaintEngine:
    def __init__(self, index: ProjectIndex) -> None:
        self.index = index
        self.payload_classes = {
            q for q, ci in index.classes.items() if ci.request_payload
        }
        # (class qualname | None, attr) -> frozen set of origin labels
        self.heap: dict[tuple, set] = {}
        # function qualname -> param name -> labels flowing in from callers
        self.param_taint: dict[str, dict] = {}
        # function qualname -> labels of returned values
        self.ret_taint: dict[str, set] = {}
        # Memos, each paid once per scan: a function's transfer nodes in
        # ast.walk order, and each call node's resolution.
        self._nodes: dict[str, list] = {}
        self._callees: dict[int, Optional[FunctionInfo]] = {}
        self._run()

    # ------------------------------------------------------------- fixpoint
    def _run(self) -> None:
        """Passes over the functions, each re-analyzing only those whose
        inputs grew since their last analysis: their parameters' taint, a
        heap field they read (by attribute name), or the return taint of a
        function they call. The first pass analyzes every function."""
        funcs = list(self.index.functions.values())
        self._readers: dict[str, set] = {}
        for info in funcs:
            for n in walk(info.node):
                if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
                    self._readers.setdefault(n.attr, set()).add(info.qualname)
        self._callers: dict[str, set] = {}
        self._pending = {info.qualname for info in funcs}
        for _ in range(_MAX_PASSES):
            if not self._pending:
                break
            for info in funcs:
                if info.qualname in self._pending:
                    self._pending.discard(info.qualname)
                    self._analyze(info)

    def _seed_params(self, info: FunctionInfo) -> dict:
        seeded = dict(self.param_taint.get(info.qualname, ()))
        if info.is_async:
            for p in info.params:
                if p in _HANDLER_PARAM_NAMES:
                    label = f"handler param '{p}' of {info.name}"
                    cur = seeded.setdefault(p, set())
                    if label not in cur:
                        cur = set(cur) | {label}
                        seeded[p] = cur
        return seeded

    def _transfer_nodes(self, info: FunctionInfo) -> list:
        nodes = self._nodes.get(info.qualname)
        if nodes is None:
            nodes = [n for n in walk(info.node) if isinstance(n, _TRANSFER_NODES)]
            self._nodes[info.qualname] = nodes
        return nodes

    def _resolve(self, call: ast.Call, info: FunctionInfo, env_types: dict) -> Optional[FunctionInfo]:
        key = id(call)
        if key not in self._callees:
            callee = self.index.resolve_call(call, info, env_types)
            self._callees[key] = callee
            if callee is not None:
                self._callers.setdefault(callee.qualname, set()).add(info.qualname)
        return self._callees[key]

    def _analyze(self, info: FunctionInfo) -> None:
        env_types = self.index.local_env(info)
        var: dict[str, set] = {
            p: set(l) for p, l in self._seed_params(info).items() if l
        }
        # Two local passes: assignment chains (a = src; b = a) settle.
        nodes = self._transfer_nodes(info)
        for _ in range(2):
            for node in nodes:
                self._transfer(node, info, env_types, var)

    def _transfer(
        self, node: ast.AST, info: FunctionInfo, env_types: dict, var: dict
    ) -> None:
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            value = node.value
            if value is None:
                return
            taint = self.expr_taint(value, info, env_types, var)
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for tgt in targets:
                self._assign(tgt, taint, info, env_types, var)
        elif isinstance(node, ast.Call):
            self._bind_call(node, info, env_types, var)
        elif isinstance(node, ast.Return) and node.value is not None:
            taint = self.expr_taint(node.value, info, env_types, var)
            if taint:
                cur = self.ret_taint.setdefault(info.qualname, set())
                if not taint <= cur:
                    cur |= taint
                    self._pending |= self._callers.get(info.qualname, set())
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            it = node.iter
            if (
                isinstance(it, ast.Call)
                and dotted_name(it.func) == "enumerate"
                and it.args
            ):
                it = it.args[0]
            taint = self.expr_taint(it, info, env_types, var)
            if taint:
                self._assign(node.target, taint, info, env_types, var)

    def _assign(
        self, tgt: ast.AST, taint: set, info: FunctionInfo, env_types: dict, var: dict
    ) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._assign(e, taint, info, env_types, var)
            return
        if isinstance(tgt, ast.Starred):
            tgt = tgt.value
        if isinstance(tgt, ast.Name):
            if taint and not taint <= var.get(tgt.id, set()):
                var.setdefault(tgt.id, set()).update(taint)
            return
        base: Optional[ast.AST] = None
        attr: Optional[str] = None
        if isinstance(tgt, ast.Attribute):
            base, attr = tgt.value, tgt.attr
        elif isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Attribute):
            # slab.temp[i] = x writes into field `temp`
            base, attr = tgt.value.value, tgt.value.attr
        if base is None or attr is None or not taint:
            return
        bt = self.index.expr_type(base, info, env_types)
        key = (bt.cls if bt is not None else None, attr)
        cell = self.heap.setdefault(key, set())
        if not taint <= cell:
            cell |= taint
            self._pending |= self._readers.get(attr, set())

    def _bind_call(
        self, call: ast.Call, info: FunctionInfo, env_types: dict, var: dict
    ) -> None:
        callee = self._resolve(call, info, env_types)
        if callee is None:
            return
        params = list(callee.params)
        if callee.has_self and params:
            params = params[1:]
        slots = self.param_taint.setdefault(callee.qualname, {})

        def bind(name: str, expr: ast.AST) -> None:
            taint = self.expr_taint(expr, info, env_types, var)
            if not taint:
                return
            cur = slots.setdefault(name, set())
            if not taint <= cur:
                cur |= taint
                self._pending.add(callee.qualname)

        for i, a in enumerate(call.args):
            if isinstance(a, ast.Starred):
                continue
            if i < len(params):
                bind(params[i], a)
        for kw in call.keywords:
            if kw.arg is not None and kw.arg in params:
                bind(kw.arg, kw.value)

    # ---------------------------------------------------------------- taint
    def expr_taint(
        self, node: ast.AST, info: FunctionInfo, env_types: dict, var: dict
    ) -> set:
        if isinstance(node, ast.Constant):
            return set()
        if isinstance(node, ast.Name):
            return set(var.get(node.id, ()))
        if isinstance(node, ast.Attribute):
            out = self.expr_taint(node.value, info, env_types, var)
            bt = self.index.expr_type(node.value, info, env_types)
            cls = bt.cls if bt is not None and not bt.container else None
            if cls in self.payload_classes:
                short = cls.rsplit(".", 1)[-1]
                out = out | {f"{short}.{node.attr}"}
            out = out | self.heap.get((cls, node.attr), set())
            if cls is None:
                out = out | self.heap.get((None, node.attr), set())
            return out
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if _is_sanitizer(name):
                return set()
            callee = self._resolve(node, info, env_types)
            if callee is not None:
                # side effects (param binding) are applied in _transfer's
                # Call case; here we only need the summary result.
                return set(self.ret_taint.get(callee.qualname, ()))
            out: set = set()
            if isinstance(node.func, ast.Attribute):
                out |= self.expr_taint(node.func.value, info, env_types, var)
            for a in node.args:
                sub = a.value if isinstance(a, ast.Starred) else a
                out |= self.expr_taint(sub, info, env_types, var)
            for kw in node.keywords:
                out |= self.expr_taint(kw.value, info, env_types, var)
            return out
        if isinstance(node, ast.IfExp):
            return (
                self.expr_taint(node.body, info, env_types, var)
                | self.expr_taint(node.orelse, info, env_types, var)
            )
        out = set()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.keyword)):
                sub = child.value if isinstance(child, ast.keyword) else child
                out |= self.expr_taint(sub, info, env_types, var)
        return out

    def function_env(self, info: FunctionInfo) -> tuple[dict, dict]:
        """(env_types, var_taint) for querying one function's expressions
        after the fixpoint has settled."""
        env_types = self.index.local_env(info)
        var: dict[str, set] = {
            p: set(l) for p, l in self._seed_params(info).items() if l
        }
        for _ in range(2):
            for node in walk(info.node):
                if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    if node.value is None:
                        continue
                    taint = self.expr_taint(node.value, info, env_types, var)
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for tgt in targets:
                        if isinstance(tgt, ast.Name):
                            var.setdefault(tgt.id, set()).update(taint)
                        elif isinstance(tgt, (ast.Tuple, ast.List)):
                            for e in tgt.elts:
                                if isinstance(e, ast.Name):
                                    var.setdefault(e.id, set()).update(taint)
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    it = node.iter
                    if (
                        isinstance(it, ast.Call)
                        and dotted_name(it.func) == "enumerate"
                        and it.args
                    ):
                        it = it.args[0]
                    taint = self.expr_taint(it, info, env_types, var)
                    if taint and isinstance(node.target, ast.Name):
                        var.setdefault(node.target.id, set()).update(taint)
        return env_types, var
