"""Retry-hygiene rule: unbounded retry loops around transport calls.

A ``while True`` (or ``for _ in range(...)``) loop that awaits a
transport/HTTP call, catches its exception, and keeps looping without ever
consulting a deadline or attempt bound is the retry-storm bug class the
resilience subsystem (mcpx_torch/resilience/) exists to eliminate: on a
persistent outage it hammers the dead endpoint forever — or, bounded only
by a count, burns the request's whole deadline on an answer the caller has
already given up on. The fix is a deadline/budget consult (or an explicit
give-up ``raise``/``break``) inside the loop — or using the executor's
attempt chain, which carries both.

Since the interprocedural rebuild this is a **project-scope** rule: a
bound consult counts when it lives in a helper the loop calls (resolved
through the project index, transitively to a small depth) — an
innocuously-named ``_check_time_left()`` that raises on an expired
deadline bounds the loop just as well as an inline ``if remaining <= 0``,
and no longer needs a suppression.

Matching is deliberately narrow: only awaits of HTTP-verb methods
(``.post``/``.get``/``.request``/…) on transport-shaped receivers
(``session``/``client``/``transport``/``http`` in the dotted base), so
``await queue.get()`` pollers never match. An except handler that
``raise``s, ``break``s or ``return``s is a give-up path, not a swallow; any
identifier smelling of a bound (deadline/budget/remaining/attempt/retries/
expire) consulted in a branch condition counts as bounded.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional, Union

from mcpx_torch.analysis.astutil import walk
from mcpx_torch.analysis.core import Finding, rule
from mcpx_torch.analysis.rules.common import (
    async_functions,
    call_name,
    dotted_name,
    walk_scope,
)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_HTTP_METHODS = {"post", "get", "put", "patch", "delete", "request", "fetch", "send"}
_TRANSPORT_BASE_RE = re.compile(r"transport|session|client|http", re.I)
_BOUND_NAME_RE = re.compile(
    r"deadline|budget|remaining|expire|attempt|retr|tries|bound|give_?up", re.I
)

_LoopNode = Union[ast.While, ast.For]


def _walk_no_defs(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a subtree, skipping nested function bodies (their statements
    run in a different call, often a different execution regime). Unlike
    ``common.walk_scope`` this takes ANY node and covers every child field
    (a While's test and orelse included), not just ``.body``."""
    stack = [node]
    while stack:
        n = stack.pop()
        if n is not node:
            yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, _FUNC_NODES):
                continue
            stack.append(child)


def _transport_call(call: ast.AST) -> bool:
    """``session.post(...)`` / ``self._transport.post(...)`` /
    ``client.request(...)`` — an HTTP-verb method on a transport-shaped
    receiver."""
    if not isinstance(call, ast.Call):
        return False
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr in _HTTP_METHODS):
        return False
    base = dotted_name(f.value) or ""
    return bool(_TRANSPORT_BASE_RE.search(base))


def _awaits_transport(node: ast.AST) -> bool:
    for n in _walk_no_defs(node):
        if isinstance(n, ast.Await) and _transport_call(n.value):
            return True
        # `async with session.post(...) as resp:` (the aiohttp idiom) is a
        # yield on the same call without a bare Await node.
        if isinstance(n, ast.AsyncWith) and any(
            _transport_call(item.context_expr) for item in n.items
        ):
            return True
    return False


def _handler_swallows(handler: ast.ExceptHandler) -> bool:
    """A handler that neither re-raises nor exits the loop keeps the retry
    loop spinning — the swallow this rule is about."""
    for n in [handler, *_walk_no_defs(handler)]:
        if isinstance(n, (ast.Raise, ast.Break, ast.Return)):
            return False
    return True


def _loop_kind(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.While):
        test = node.test
        if isinstance(test, ast.Constant) and bool(test.value) is True:
            return "while True"
        return None
    if isinstance(node, ast.For) and isinstance(node.iter, ast.Call):
        if call_name(node.iter) == "range":
            return "for … in range(…)"
    return None


def _mentions_bound(scope: ast.AST) -> bool:
    """A bound-shaped identifier in any branch condition, or a call to a
    bound-named helper, anywhere in ``scope``: ``if remaining <= 0``,
    ``budget.affords(…)``, ``while attempts < max_attempts`` …"""
    tests: list[ast.AST] = []
    for n in _walk_no_defs(scope):
        if isinstance(n, (ast.If, ast.While)):
            tests.append(n.test)
        elif isinstance(n, ast.Assert):
            tests.append(n.test)
        elif isinstance(n, ast.Call):
            name = call_name(n)
            if name and _BOUND_NAME_RE.search(name):
                return True
    for t in tests:
        for n in [t, *walk(t)]:
            if isinstance(n, ast.Name) and _BOUND_NAME_RE.search(n.id):
                return True
            if isinstance(n, ast.Attribute) and _BOUND_NAME_RE.search(n.attr):
                return True
    return False


def _consults_bound(loop: _LoopNode, project, caller_info, depth: int = 2) -> bool:
    """The loop consults a bound inline, or calls a helper (resolved
    through the project index, ``depth`` levels deep) that does — a
    deadline check living in ``_check_time_left()`` bounds the loop just
    as much as an inline test."""
    if _mentions_bound(loop):
        return True
    if depth <= 0 or project is None:
        return False
    index = project.index
    env = index.local_env(caller_info)
    for n in _walk_no_defs(loop):
        if not isinstance(n, ast.Call):
            continue
        callee = index.resolve_call(n, caller_info, env)
        if callee is None:
            continue
        if _mentions_bound(callee.node):
            return True
        if _consults_bound_body(callee.node, project, callee, depth - 1):
            return True
    return False


def _consults_bound_body(fn_node, project, info, depth: int) -> bool:
    if depth <= 0:
        return False
    index = project.index
    env = index.local_env(info)
    for n in _walk_no_defs(fn_node):
        if not isinstance(n, ast.Call):
            continue
        callee = index.resolve_call(n, info, env)
        if callee is None:
            continue
        if _mentions_bound(callee.node):
            return True
        if _consults_bound_body(callee.node, project, callee, depth - 1):
            return True
    return False


@rule(
    "unbounded-retry-loop",
    "retry loop around a transport call with no deadline or attempt bound — "
    "a persistent outage spins it forever (or through the caller's SLO)",
    scope="project",
)
def check_unbounded_retry(project) -> Iterator[Finding]:
    for ctx in project.files:
        for fn in async_functions(ctx.tree):
            info = project.function_for(ctx, fn)
            # walk_scope skips nested defs: a loop inside a nested async
            # def is reported once, under ITS function (async_functions
            # yields it too), never twice under every enclosing scope.
            for node in walk_scope(fn):
                kind = _loop_kind(node)
                if kind is None:
                    continue
                for n in _walk_no_defs(node):
                    if not isinstance(n, ast.Try):
                        continue
                    try_body = ast.Module(body=n.body, type_ignores=[])
                    if not _awaits_transport(try_body):
                        continue
                    if not any(_handler_swallows(h) for h in n.handlers):
                        continue
                    if _consults_bound(node, project, info):
                        continue
                    yield project.finding(
                        ctx.relpath,
                        node.lineno,
                        "unbounded-retry-loop",
                        f"{kind} loop in async '{fn.name}' awaits a transport "
                        "call and swallows its failure with no deadline or "
                        "attempt bound (inline or in any resolvable helper) — "
                        "consult a deadline/budget (or raise/break on a "
                        "bound) so a persistent outage cannot spin this "
                        "loop forever",
                    )
                    break
