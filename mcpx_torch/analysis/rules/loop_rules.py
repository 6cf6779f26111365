"""loop-confinement: single-writer ownership for the asyncio event loop.

The cluster layer states its concurrency contract in prose: "all pool
state is event-loop-confined, only GIL-atomic ``queue_stats`` crosses the
worker-thread boundary". This pass makes that machine-checked, the way
``thread-ownership`` (ownership_rules.py) does for the engine worker —
same annotations, a different terminal semantics:

  - ``@owned_by("event_loop")`` on a class: every instance-attribute
    write outside the class's own ctor must be loop-reachable-only.
  - ``@owned_by("event_loop")`` on a function/method: asserts its body
    runs on the loop; resolved call sites are checked, and ownership
    walks terminate there.
  - per-field marks (an ``mcpx: owner[event_loop]`` comment on the
    declaration line) work too — shared ``_Ownership`` model.

A call-graph terminal counts as *on the loop* when it is

  - explicitly marked for the ``event_loop`` domain, or
  - a coroutine (``async def`` bodies only ever run on the loop; handing
    a coroutine to another thread requires ``run_coroutine_threadsafe``,
    which is not a call edge), or
  - a sync callback spawned **only** through loop mechanisms
    (``call_soon``/``call_soon_threadsafe``/``call_later``/task spawns).

Everything else fails closed: a terminal marked for another domain, a
sync function handed to ``asyncio.to_thread``/``run_in_executor``/
``executor.submit``/``threading.Thread`` (even once), or a plain
unmarked sync entry nobody spawns — all are potential off-loop entries.

Asymmetry vs thread-ownership, by design: only **writes** (and calls
into loop-owned functions) are checked. Cross-boundary *reads* of
loop-owned state are the sanctioned contract — the worker thread reads
whole-value snapshots under the GIL (``queue_stats``, scoreboard
snapshots), which is exactly why the cluster needs no locks. Orphaned
``owner[...]`` comments are reported by thread-ownership (shared model,
reported once).
"""

from __future__ import annotations

import ast
from typing import Iterator

from mcpx_torch.analysis.astutil import walk
from mcpx_torch.analysis.core import Finding, rule
from mcpx_torch.analysis.rules.ownership_rules import (
    LOOP_DOMAIN,
    _attr_of_target,
    _short,
    _write_targets,
    ownership_model,
)

_CTOR_NAMES = {"__init__", "__post_init__", "__new__"}


@rule(
    "loop-confinement",
    "write/call touching event-loop-owned state from a call path that can "
    "originate off the loop (thread spawn, executor, or unmarked sync entry)",
    scope="project",
)
def check_loop_confinement(project) -> Iterator[Finding]:
    own = ownership_model(project)
    index = own.index
    graph = own.graph
    domain_used = (
        any(d[0] == LOOP_DOMAIN for d in own.fields.values())
        or any(ci.owner == LOOP_DOMAIN for ci in index.classes.values())
        or any(f.owner == LOOP_DOMAIN for f in index.functions.values())
    )
    if not domain_used:
        return

    root_memo: dict[str, bool] = {}

    def root_on_loop(q: str) -> bool:
        hit = root_memo.get(q)
        if hit is not None:
            return hit
        r = index.functions.get(q)
        if r is None:
            ok = False
        elif r.marked == LOOP_DOMAIN:
            ok = True
        elif r.marked:
            ok = False  # asserts another domain (e.g. engine-worker)
        else:
            vias = graph.spawned_via(q)
            if "thread" in vias:
                ok = False  # crosses into a thread somewhere: fail closed
            elif r.is_async:
                ok = True
            else:
                ok = bool(vias) and vias == frozenset(("loop",))
        root_memo[q] = ok
        return ok

    safe_memo: dict[str, tuple] = {}

    def loop_safe(info) -> tuple:
        """(is_safe, offending_root) — every terminal reaching ``info``
        must be on the loop."""
        hit = safe_memo.get(info.qualname)
        if hit is not None:
            return hit
        if info.marked == LOOP_DOMAIN:
            out = (True, "")
        else:
            bad = ""
            for root in sorted(graph.roots_of(info.qualname)):
                if not root_on_loop(root):
                    bad = root
                    break
            out = (not bad, bad)
        safe_memo[info.qualname] = out
        return out

    for info in index.functions.values():
        env = index.local_env(info)
        seen: set[tuple] = set()
        in_ctor_of = info.cls if info.name in _CTOR_NAMES and info.cls else None

        def emit(line: int, key: tuple, msg: str):
            if key in seen:
                return None
            seen.add(key)
            return project.finding(info.path, line, "loop-confinement", msg)

        # --- writes to loop-owned fields / attributes of loop-owned classes
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
                    if attr is None:
                        continue
                    bt = index.expr_type(attr.value, info, env)
                    cls = bt.cls if bt is not None and not bt.container else None
                    decl = own.field_decl(cls, attr.attr)
                    owner = decl[0] if decl else own.class_owner(cls)
                    if owner != LOOP_DOMAIN:
                        continue
                    if in_ctor_of is not None and in_ctor_of == cls:
                        continue  # construction-before-publication
                    ok, bad = loop_safe(info)
                    if not ok:
                        f = emit(
                            node.lineno,
                            ("w", node.lineno, attr.attr),
                            f"write to event-loop-owned '{_short(cls or '?')}."
                            f"{attr.attr}' in '{_short(info.qualname)}' is "
                            f"reachable from off-loop entry '{_short(bad)}' — "
                            "loop-confined state; schedule the mutation onto "
                            "the loop (call_soon_threadsafe / create_task) or "
                            "justify with an ignore",
                        )
                        if f:
                            yield f
        # --- calls into @owned_by("event_loop") functions
        for node in walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            callee = index.resolve_call(node, info, env)
            if callee is None or callee.owner != LOOP_DOMAIN:
                continue
            ok, bad = loop_safe(info)
            if not ok:
                f = emit(
                    node.lineno,
                    ("c", node.lineno, callee.qualname),
                    f"call into event-loop-owned '{_short(callee.qualname)}' "
                    f"from '{_short(info.qualname)}' is reachable from "
                    f"off-loop entry '{_short(bad)}' — loop-confined "
                    "mutators must only run on the event loop",
                )
                if f:
                    yield f
