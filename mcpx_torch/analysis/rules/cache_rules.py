"""Cache-hygiene rule: unbounded cache growth in the request path.

The bug class: a dict/list used as a cache ("cache"/"memo" in its name)
that a request-path async function INSERTS into without any eviction or
size-bound consult reachable from the same scope. Every request leaks an
entry; the process grows until the OOM killer finds it — silent in tests
(bounded request counts) and fatal in production. The radix prefix KV
cache is exactly this shape done right (engine/prefix_cache.py: every
insertion path consults ``evict()`` and a budget), and this rule keeps
the next cache honest.

Since the interprocedural rebuild this is a **project-scope** rule: the
bound consult no longer has to sit in the inserting function's own body.
A call to a helper — same module or imported — that evicts/pops/``len``s
the container (passed as an argument, or named identically on ``self``)
counts, transitively to a small depth. That kills the rule's known
false-positive class (bounded-insert helpers forced a suppression) while
the insertion sites themselves are still judged per async function.

What counts as an insertion (on a cache-named container):

  - ``X[key] = value`` (subscript assign, incl. augmented; a LITERAL key
    is exempt — ``stats_cache["hits"] += 1`` is a fixed slot, not growth)
  - ``X.append(v)`` / ``X.add(v)`` / ``X.setdefault(k, v)`` / ``X.insert(...)``

What counts as a bound consult (in scope, or in a resolvable callee up to
depth 2 — on the same container / the parameter it was passed as):

  - ``X.pop`` / ``X.popitem`` / ``X.clear`` / ``X.evict``
  - ``del X[...]``
  - ``len(X)`` anywhere (a size check implies a bound decision)
  - a call to anything whose name contains "evict" (``self._evict_…``)

Scope: async functions only — this codebase's request path is async end
to end; sync worker-thread code (the engine) manages its caches under
explicit budgets and single-writer discipline (now machine-checked by
``thread-ownership``). Containers without a cache-ish name stay silent:
flagging every dict write would bury the real leaks.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from mcpx_torch.analysis.astutil import walk
from mcpx_torch.analysis.core import Finding, rule
from mcpx_torch.analysis.rules.common import async_functions, call_name, dotted_name, walk_scope

_INSERT_METHODS = {"append", "add", "setdefault", "insert"}
_CONSULT_METHODS = {"pop", "popitem", "clear", "evict"}
_MAX_DEPTH = 2


def _cache_named(name: Optional[str]) -> bool:
    if not name:
        return False
    last = name.rsplit(".", 1)[-1].lower()
    return "cache" in last or "memo" in last


def _insertions(fn) -> Iterator[tuple[int, str]]:
    """(lineno, container dotted name) for every cache insertion in fn."""
    for node in walk_scope(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript):
                    if isinstance(t.slice, ast.Constant):
                        # A literal key ("hits", 0) is a fixed slot —
                        # counters and stat dicts cannot grow per request.
                        continue
                    name = dotted_name(t.value)
                    if _cache_named(name):
                        yield node.lineno, name
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _INSERT_METHODS:
                name = dotted_name(node.func.value)
                if _cache_named(name):
                    yield node.lineno, name


def _direct_consult(body_walk, container: str) -> bool:
    """A bound consult on ``container`` in one function's own statements:
    an eviction-ish method call, a ``del``, a ``len()`` size check, or any
    call whose name mentions eviction."""
    for node in body_walk:
        if isinstance(node, ast.Call):
            fname = call_name(node)
            if fname == "len" and node.args:
                if dotted_name(node.args[0]) == container:
                    return True
            if fname is not None and "evict" in fname.rsplit(".", 1)[-1].lower():
                return True
            if isinstance(node.func, ast.Attribute):
                if (
                    node.func.attr in _CONSULT_METHODS
                    and dotted_name(node.func.value) == container
                ):
                    return True
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and dotted_name(t.value) == container:
                    return True
    return False


def _consulted(
    fn, container: str, project, caller_info, depth: int = _MAX_DEPTH
) -> bool:
    """Bound consult on ``container`` in ``fn``'s scope OR inside a
    resolvable callee: either the callee receives the container as an
    argument and consults the matching parameter, or it is a method
    consulting the same ``self.<attr>`` name directly."""
    if _direct_consult(walk_scope(fn), container):
        return True
    if depth <= 0 or project is None:
        return False
    index = project.index
    env = index.local_env(caller_info)
    for node in walk_scope(fn):
        if not isinstance(node, ast.Call):
            continue
        callee = index.resolve_call(node, caller_info, env)
        if callee is None:
            continue
        # the container itself handed to the helper -> the helper's view
        # of it is the matching parameter
        params = list(callee.params)
        if callee.has_self and params:
            params = params[1:]
        bound_params: list[str] = []
        for i, a in enumerate(node.args):
            if not isinstance(a, ast.Starred) and dotted_name(a) == container:
                if i < len(params):
                    bound_params.append(params[i])
        for kw in node.keywords:
            if kw.arg is not None and dotted_name(kw.value) == container:
                bound_params.append(kw.arg)
        names = list(bound_params)
        # a same-class helper (`self._trim()`) may consult `self._cache`
        # under its own name
        if container.startswith("self.") and callee.cls == caller_info.cls:
            names.append(container)
        for name in names:
            if _consulted(callee.node, name, project, callee, depth - 1):
                return True
    return False


@rule(
    "unbounded-cache-growth",
    "Cache insertion in a request-path async function with no eviction "
    "or size-bound consult reachable in scope",
    scope="project",
)
def check_unbounded_cache_growth(project) -> Iterator[Finding]:
    for ctx in project.files:
        for fn in async_functions(ctx.tree):
            info = project.function_for(ctx, fn)
            flagged: set[tuple[int, str]] = set()
            for lineno, container in _insertions(fn):
                if (lineno, container) in flagged:
                    continue
                if _consulted(fn, container, project, info):
                    continue
                flagged.add((lineno, container))
                yield project.finding(
                    ctx.relpath,
                    lineno,
                    "unbounded-cache-growth",
                    f"'{container}' grows by one entry per call of async "
                    f"'{fn.name}' with no eviction/size-bound consult in "
                    "scope or in any resolvable helper — a per-request "
                    "memory leak; bound it (LRU popitem, len() cap, "
                    "evict()) or insert via a bounded helper",
                )


# --------------------------------------------------------------------------
# evict-without-refcount-consult: reclaim that ignores liveness pins.
#
# The bug class (tiered KV cache, engine/prefix_cache.py + spill.py): a
# cache whose entries carry a reference count — live readers pin an entry;
# eviction may reclaim only refcount-0 entries — grows an eviction/reclaim
# path that removes entries WITHOUT consulting the refcount. The race is
# silent in tests (small working sets rarely evict a pinned entry) and is
# memory corruption in production: a pinned KV run's pages return to the
# allocator while a resident slab row's page table still names them.
#
# Scope (file): a class is "refcount-aware" when anything in its body reads
# or writes a `.refs` / `.refcount` / `.pinned` attribute. In such classes,
# every method whose name mentions evict/reclaim that performs a REMOVAL —
# `del x[...]`, `.pop/.popitem/.remove/.clear/.free(...)`, or a call whose
# name mentions "drop" — must consult the refcount in its own scope or in a
# same-class helper it calls (one hop: the `_device_leaf`-style predicate
# pattern). Classes without refcounts stay silent: plain LRU caches are the
# unbounded-cache-growth rule's business, not this one's.

_REF_ATTRS = {"refs", "refcount", "pinned"}
_REMOVAL_METHODS = {"pop", "popitem", "remove", "clear", "free"}


def _reads_refcount(fn: ast.AST) -> bool:
    for node in walk(fn):
        if isinstance(node, ast.Attribute) and node.attr in _REF_ATTRS:
            return True
    return False


def _removals(fn) -> Iterator[int]:
    """Line numbers of entry-removal operations in ``fn``'s own scope."""
    for node in walk_scope(fn):
        if isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    yield node.lineno
                    break
        elif isinstance(node, ast.Call):
            name = call_name(node) or ""
            last = name.rsplit(".", 1)[-1].lower()
            if isinstance(node.func, ast.Attribute) and (
                node.func.attr in _REMOVAL_METHODS or "drop" in last
            ):
                yield node.lineno
            elif "drop" in last:
                yield node.lineno


def _class_refcount_aware(cls: ast.ClassDef) -> bool:
    return _reads_refcount(cls)


def _same_class_helpers(cls: ast.ClassDef) -> dict:
    return {
        n.name: n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _consults_refcount(fn, helpers: dict) -> bool:
    """Refcount consult in ``fn``'s own scope, or one hop into a same-class
    helper it calls (`self._helper(...)`)."""
    if _reads_refcount(fn):
        return True
    for node in walk_scope(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if dotted_name(node.func.value) == "self":
                callee = helpers.get(node.func.attr)
                if callee is not None and _reads_refcount(callee):
                    return True
    return False


@rule(
    "evict-without-refcount-consult",
    "Eviction/reclaim path in a refcounted cache removes entries without "
    "consulting the refcount (pinned entries could be reclaimed under a "
    "live reader)",
)
def check_evict_without_refcount(ctx) -> Iterator[Finding]:
    for cls in walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef) or not _class_refcount_aware(cls):
            continue
        helpers = _same_class_helpers(cls)
        for fn in helpers.values():
            lname = fn.name.lower()
            if "evict" not in lname and "reclaim" not in lname:
                continue
            lines = list(_removals(fn))
            if not lines or _consults_refcount(fn, helpers):
                continue
            yield ctx.finding(
                lines[0],
                "evict-without-refcount-consult",
                f"'{cls.name}.{fn.name}' removes cache entries without "
                "reading any refs/refcount/pinned attribute (directly or "
                "via a same-class helper) — a pinned entry could be "
                "reclaimed under a live reader; gate removal on "
                "refcount-0 like RadixPrefixCache.evict",
            )
