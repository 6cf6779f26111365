"""thread-ownership: statically prove single-writer invariants.

The engine's correctness rests on state the worker thread alone may
mutate — the slab, the radix prefix tree, the page allocator. This pass
enforces that discipline. Four annotation forms declare ownership
(mcpx_torch/utils/ownership.py and mcpx_torch/analysis/README.md):

  - ``self._x = ...`` + a trailing ``mcpx: owner`` comment naming the
    thread — field-level: every
    write to the field, project-wide, must be reachable ONLY from the
    owner's thread entry points, and every cross-thread read must be
    sanctioned (the ``atomic`` variant for GIL-atomic fields
    swapped/stored whole, or a justified ``ignore``).
  - ``@owned_by("engine-worker")`` on a **class** — every instance
    attribute write outside the class's own ``__init__``/``__post_init__``
    must be owner-reachable-only (the slab).
  - ``@owned_by("engine-worker")`` on a **function/method** — every call
    site must sit on an owner-only call path (the prefix-cache and
    allocator mutators). Inside the pass the mark also asserts the
    function's own body runs in-domain, so checks terminate there.
  - ``NAME = ...`` at **module level** + a trailing owner comment naming a
    lock of the same module (``threading.Lock``/``RLock``) — state that
    every thread may reach (the kernel wrapper's launch counts and ticket
    registry, the engines' spare capturing streams): every use of the name
    inside a function must sit in a ``with <lock>:`` block of that
    function.

"Reachable only from the owner" is computed on the project call graph:
walk plain ``call`` edges backwards (``spawn`` edges — Thread targets,
``call_soon_threadsafe``, task spawns — change threads and are excluded)
to the terminals; every terminal must carry the owner's mark
(``# mcpx: thread-entry[X]`` / ``@thread_entry("X")`` / ``@owned_by("X")``).
A terminal nobody marks is an unknown entry and fails closed.

Construction is exempt by design: writes from the declaring class's
``__init__``/``__post_init__`` happen before the object is published to
the owning thread.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from mcpx_torch.analysis.astutil import walk
from mcpx_torch.analysis.callgraph import FunctionInfo
from mcpx_torch.analysis.core import Finding, rule
from mcpx_torch.analysis.rules.common import dotted_name

_OWNER_RE = re.compile(
    r"#\s*mcpx:\s*owner\[([A-Za-z0-9_\-]+)(\s*,\s*atomic)?\]"
)
_CTOR_NAMES = {"__init__", "__post_init__", "__new__"}
_LOCK_TYPES = {"Lock", "RLock"}

# The asyncio-loop ownership domain is checked by the `loop-confinement`
# pass (loop_rules.py) with loop-specific terminal semantics; this pass
# skips it so one annotation never double-reports.
LOOP_DOMAIN = "event_loop"


def _short(qualname: str) -> str:
    parts = qualname.split(".")
    return ".".join(parts[-2:]) if len(parts) > 1 else qualname


class _Ownership:
    """One scan's ownership model: declarations, safety memo, findings."""

    def __init__(self, project) -> None:
        self.project = project
        self.index = project.index
        self.graph = project.callgraph()
        # (class qualname, attr) -> (owner, atomic, path, line)
        self.fields: dict[tuple, tuple] = {}
        self._safe: dict[tuple, tuple] = {}
        self.orphans: list[tuple] = []  # (path, line) owner comments w/o field
        # (module, name) -> (lock name, path, line): module-level state
        # marked with the lock that guards it (``_TICKETS = {}  # mcpx:
        # owner[_LOCK]``); every thread may touch it, under that lock.
        self.guarded: dict[tuple, tuple] = {}
        self.unguarded_marks: list[tuple] = []  # (path, line, owner)
        self._collect_fields()

    def _collect_fields(self) -> None:
        for ctx in self.project.files:
            marks = {}
            for i, line in enumerate(ctx.lines, start=1):
                m = _OWNER_RE.search(line)
                if m:
                    marks[i] = (m.group(1), bool(m.group(2)))
            if not marks:
                continue
            mod = self.index.modules.get(ctx.module or "")
            consumed: set[int] = set()
            for ci in (mod.classes.values() if mod else ()):
                for meth in ci.methods.values():
                    for node in walk(meth.node):
                        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                            continue
                        if node.lineno not in marks:
                            continue
                        targets = (
                            node.targets
                            if isinstance(node, ast.Assign)
                            else [node.target]
                        )
                        for tgt in targets:
                            if (
                                isinstance(tgt, ast.Attribute)
                                and dotted_name(tgt.value) == "self"
                            ):
                                owner, atomic = marks[node.lineno]
                                self.fields.setdefault(
                                    (ci.qualname, tgt.attr),
                                    (owner, atomic, ctx.relpath, node.lineno),
                                )
                                consumed.add(node.lineno)
            if mod is not None:
                locks = {
                    t.id
                    for stmt in mod.tree.body
                    if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call)
                    and (dotted_name(stmt.value.func) or "").rsplit(".", 1)[-1] in _LOCK_TYPES
                    for t in stmt.targets
                    if isinstance(t, ast.Name)
                }
                for stmt in mod.tree.body:
                    if stmt.lineno not in marks or not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                        continue
                    targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                    names = [t.id for t in targets if isinstance(t, ast.Name)]
                    if not names:
                        continue
                    owner = marks[stmt.lineno][0]
                    consumed.add(stmt.lineno)
                    if owner not in locks:
                        self.unguarded_marks.append((ctx.relpath, stmt.lineno, owner))
                        continue
                    for name in names:
                        self.guarded[(mod.name, name)] = (owner, ctx.relpath, stmt.lineno)
            for line_no in sorted(set(marks) - consumed):
                self.orphans.append((ctx.relpath, line_no))

    # -------------------------------------------------------------- lookup
    def field_decl(self, classq: Optional[str], attr: str) -> Optional[tuple]:
        """Walk the receiver class's MRO for a field declaration."""
        if classq is None:
            return None
        seen: set[str] = set()
        stack = [classq]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            decl = self.fields.get((q, attr))
            if decl is not None:
                return decl
            ci = self.index.classes.get(q)
            if ci is None:
                continue
            for b in ci.bases:
                sym = self.index.resolve(ci.module, b)
                if sym is not None and hasattr(sym, "qualname"):
                    stack.append(sym.qualname)
        return None

    def class_owner(self, classq: Optional[str]) -> Optional[str]:
        if classq is None:
            return None
        seen: set[str] = set()
        stack = [classq]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            ci = self.index.classes.get(q)
            if ci is None:
                continue
            if ci.owner:
                return ci.owner
            for b in ci.bases:
                sym = self.index.resolve(ci.module, b)
                if sym is not None and hasattr(sym, "qualname"):
                    stack.append(sym.qualname)
        return None

    # -------------------------------------------------------------- safety
    def safe_for(self, info: FunctionInfo, owner: str) -> tuple[bool, str]:
        """(is_safe, offending_root). A function is owner-safe when every
        call-graph terminal that reaches it carries the owner's mark."""
        key = (info.qualname, owner)
        hit = self._safe.get(key)
        if hit is not None:
            return hit
        if info.marked == owner:
            out = (True, "")
        else:
            bad = ""
            for root in sorted(self.graph.roots_of(info.qualname)):
                r = self.index.functions.get(root)
                if r is None or r.marked != owner:
                    bad = root
                    break
            out = (not bad, bad)
        self._safe[key] = out
        return out


def ownership_model(project) -> "_Ownership":
    """The scan's shared ownership model (declarations + safety memo),
    built once per ProjectContext — thread-ownership and loop-confinement
    both read it."""
    model = getattr(project, "_ownership_model", None)
    if model is None:
        model = _Ownership(project)
        project._ownership_model = model
    return model


def _write_targets(node: ast.AST) -> Iterator[ast.AST]:
    """Flatten assignment/delete targets to the attribute/subscript nodes
    that name storage."""
    if isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _write_targets(e)
    elif isinstance(node, ast.Starred):
        yield from _write_targets(node.value)
    else:
        yield node


def _attr_of_target(tgt: ast.AST) -> Optional[ast.Attribute]:
    """The attribute a write lands on: ``self.x`` / ``self.x[i]`` /
    ``slab.temp[i]`` all store into the named field."""
    while isinstance(tgt, ast.Subscript):
        tgt = tgt.value
    return tgt if isinstance(tgt, ast.Attribute) else None


@rule(
    "thread-ownership",
    "write/read/call touching single-writer state from a call path not "
    "rooted at the owning thread's entry points",
    scope="project",
)
def check_thread_ownership(project) -> Iterator[Finding]:
    own = ownership_model(project)
    index = own.index
    if not own.fields and not own.guarded and not own.unguarded_marks and not any(
        ci.owner for ci in index.classes.values()
    ) and not any(f.owner for f in index.functions.values()):
        return
    for path, line in own.orphans:
        yield project.finding(
            path,
            line,
            "thread-ownership",
            "owner[...] annotation matches no `self.<attr> = ...` "
            "assignment on this line — move it onto the field's "
            "declaration site",
        )
    for path, line, owner in own.unguarded_marks:
        yield project.finding(
            path,
            line,
            "thread-ownership",
            f"owner[{owner}] on module-level state names no lock of this "
            "module — every thread may reach module state, so its mark "
            "names the lock (threading.Lock/RLock) that guards it",
        )
    yield from _check_guarded(project, own)
    for info in index.functions.values():
        env = index.local_env(info)
        seen: set[tuple] = set()
        write_attr_ids: set[int] = set()
        writes: list[tuple[ast.Attribute, int]] = []
        for node in walk(info.node):
            targets: list = []
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
            elif isinstance(node, ast.Delete):
                targets = node.targets
            for raw in targets:
                for tgt in _write_targets(raw):
                    attr = _attr_of_target(tgt)
                    if attr is not None:
                        write_attr_ids.add(id(attr))
                        writes.append((attr, node.lineno))

        def emit(line: int, key: tuple, msg: str):
            if key in seen:
                return None
            seen.add(key)
            return project.finding(info.path, line, "thread-ownership", msg)

        def receiver_class(attr: ast.Attribute) -> Optional[str]:
            bt = index.expr_type(attr.value, info, env)
            return bt.cls if bt is not None and not bt.container else None

        in_ctor_of = (
            info.cls if info.name in _CTOR_NAMES and info.cls else None
        )
        # --- writes: field-level and class-level ownership
        for attr, line in writes:
            cls = receiver_class(attr)
            decl = own.field_decl(cls, attr.attr)
            owner = decl[0] if decl else own.class_owner(cls)
            if owner is None or owner == LOOP_DOMAIN:
                continue
            if in_ctor_of is not None and in_ctor_of == cls:
                # construction-before-publication: the owning class's own
                # ctor writes before the object reaches the owner thread.
                continue
            ok, bad = own.safe_for(info, owner)
            if not ok:
                f = emit(
                    line,
                    ("w", line, attr.attr),
                    f"write to {owner}-owned '{_short(cls or '?')}."
                    f"{attr.attr}' in '{_short(info.qualname)}' is reachable "
                    f"from non-{owner} entry '{_short(bad)}' — single-writer "
                    "state; route the mutation through the owner thread "
                    "(queue op) or justify with an ignore",
                )
                if f:
                    yield f
        # --- reads: field-level, non-atomic only
        for node in walk(info.node):
            if (
                not isinstance(node, ast.Attribute)
                or not isinstance(node.ctx, ast.Load)
                or id(node) in write_attr_ids
            ):
                continue
            cls = receiver_class(node)
            decl = own.field_decl(cls, node.attr)
            # Undeclared, atomic, or loop-domain (loop-confinement treats
            # cross-boundary reads as the published GIL-atomic contract).
            if decl is None or decl[1] or decl[0] == LOOP_DOMAIN:
                continue
            owner = decl[0]
            if in_ctor_of is not None and cls == in_ctor_of:
                continue
            ok, bad = own.safe_for(info, owner)
            if not ok:
                f = emit(
                    node.lineno,
                    ("r", node.lineno, node.attr),
                    f"cross-thread read of {owner}-owned '{_short(cls or '?')}."
                    f"{node.attr}' in '{_short(info.qualname)}' (reachable "
                    f"from '{_short(bad)}') is not marked GIL-atomic — "
                    f"declare owner[{owner}, atomic] on the field if whole-"
                    "value reads are safe, or move the read to the owner",
                )
                if f:
                    yield f
        # --- calls into @owned_by functions
        for node in walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            callee = index.resolve_call(node, info, env)
            if callee is None or not callee.owner or callee.owner == LOOP_DOMAIN:
                continue
            owner = callee.owner
            ok, bad = own.safe_for(info, owner)
            if not ok:
                f = emit(
                    node.lineno,
                    ("c", node.lineno, callee.qualname),
                    f"call into {owner}-owned '{_short(callee.qualname)}' "
                    f"from '{_short(info.qualname)}' is reachable from "
                    f"non-{owner} entry '{_short(bad)}' — mutators of "
                    "single-writer state must only run on the owner thread",
                )
                if f:
                    yield f


def _check_guarded(project, own: "_Ownership") -> Iterator[Finding]:
    """Every use of lock-guarded module state inside a function sits in a
    ``with <lock>:`` block of that function: a read of the name, a store
    through ``global``, and the ``module.NAME`` / imported-name forms from
    other modules. Module-level code (the declaration itself) runs at
    import, before any thread."""
    if not own.guarded:
        return
    index = own.index
    by_name: dict[str, list] = {}
    for (modname, name), decl in own.guarded.items():
        by_name.setdefault(name, []).append((modname, decl))
    for info in index.functions.values():
        mod = index.modules.get(info.module)
        if mod is None:
            continue
        # name used in this function -> (declaring module, decl)
        uses: list[tuple] = []
        params = set(info.params)
        for node in walk(info.node):
            if isinstance(node, ast.Name) and node.id in by_name and node.id not in params:
                for modname, decl in by_name[node.id]:
                    if modname == info.module or mod.imports.get(node.id) == f"{modname}.{node.id}":
                        uses.append((node, node.id, decl))
            elif isinstance(node, ast.Attribute) and node.attr in by_name:
                target = index.resolve(info.module, dotted_name(node.value))
                for modname, decl in by_name[node.attr]:
                    if getattr(target, "name", None) == modname and hasattr(target, "tree"):
                        uses.append((node, node.attr, decl))
        if not uses:
            continue
        guarded: dict[str, set] = {}  # lock name -> ids of nodes under it
        for node in walk(info.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock = (dotted_name(item.context_expr) or "").rsplit(".", 1)[-1]
                    ids = guarded.setdefault(lock, set())
                    for stmt in node.body:
                        ids.update(id(n) for n in walk(stmt))
        seen: set[tuple] = set()
        for node, name, (lock, _path, _line) in uses:
            if id(node) in guarded.get(lock, ()) or (node.lineno, name) in seen:
                continue
            seen.add((node.lineno, name))
            yield project.finding(
                info.path,
                node.lineno,
                "thread-ownership",
                f"'{name}' is guarded by '{lock}' but '{_short(info.qualname)}' "
                f"touches it outside `with {lock}:` — every thread that "
                "reaches it (each engine's worker, the pool, callers) shares "
                "it; take the lock around the access",
            )
