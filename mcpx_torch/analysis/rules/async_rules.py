"""Async-safety rules: blocking calls inside coroutines, and shared-state
writes that straddle an await without a lock."""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from mcpx_torch.analysis.core import FileContext, Finding, rule
from mcpx_torch.analysis.rules.common import (
    async_functions,
    call_name,
    dotted_name,
    walk_scope,
)

# Dotted call names that block the event loop. Values are the suggested
# replacement shown in the message.
BLOCKING_CALLS = {
    "time.sleep": "await asyncio.sleep(...)",
    "subprocess.run": "asyncio.create_subprocess_exec",
    "subprocess.call": "asyncio.create_subprocess_exec",
    "subprocess.check_call": "asyncio.create_subprocess_exec",
    "subprocess.check_output": "asyncio.create_subprocess_exec",
    "subprocess.Popen": "asyncio.create_subprocess_exec",
    "os.system": "asyncio.create_subprocess_shell",
    "os.popen": "asyncio.create_subprocess_shell",
    "urllib.request.urlopen": "an async HTTP client (aiohttp)",
    "requests.get": "an async HTTP client (aiohttp)",
    "requests.post": "an async HTTP client (aiohttp)",
    "requests.put": "an async HTTP client (aiohttp)",
    "requests.patch": "an async HTTP client (aiohttp)",
    "requests.delete": "an async HTTP client (aiohttp)",
    "requests.head": "an async HTTP client (aiohttp)",
    "requests.request": "an async HTTP client (aiohttp)",
    "socket.create_connection": "asyncio.open_connection",
    "open": "asyncio.to_thread(...)",
}
# Blocking filesystem methods (pathlib and friends) by attribute name.
BLOCKING_METHODS = {"read_text", "write_text", "read_bytes", "write_bytes"}


@rule(
    "async-blocking",
    "blocking call (sleep, sync I/O, subprocess) inside an `async def` body",
)
def check_async_blocking(ctx: FileContext) -> Iterator[Finding]:
    for fn in async_functions(ctx.tree):
        for node in walk_scope(fn):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            hint = BLOCKING_CALLS.get(name or "")
            if hint is None and isinstance(node.func, ast.Attribute):
                if node.func.attr in BLOCKING_METHODS:
                    name = node.func.attr
                    hint = "asyncio.to_thread(...)"
            if hint is not None:
                yield ctx.finding(
                    node.lineno,
                    "async-blocking",
                    f"blocking call '{name}()' in async function "
                    f"'{fn.name}' blocks the event loop; use {hint}",
                )


def _target_key(node: ast.AST) -> Optional[tuple[str, str]]:
    """Shared-state keys this rule tracks: ``self.<attr>`` attribute writes
    and ``name[<const>]`` subscript writes (closure-dict counters)."""
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        if base == "self":
            return ("self", node.attr)
    elif isinstance(node, ast.Subscript):
        base = dotted_name(node.value)
        if base is not None and isinstance(node.slice, ast.Constant):
            return (base, repr(node.slice.value))
    return None


def _lock_guarded_spans(fn: ast.AsyncFunctionDef) -> list[tuple[int, int]]:
    spans: list[tuple[int, int]] = []
    for node in walk_scope(fn):
        if isinstance(node, ast.AsyncWith):
            for item in node.items:
                name = dotted_name(item.context_expr) or dotted_name(
                    getattr(item.context_expr, "func", ast.Pass())
                )
                if name is not None and "lock" in name.lower():
                    spans.append((node.lineno, node.end_lineno or node.lineno))
                    break
    return spans


@rule(
    "async-shared-mutation",
    "shared-state write straddling an await without an asyncio.Lock",
)
def check_async_shared_mutation(ctx: FileContext) -> Iterator[Finding]:
    """Check-then-act races: in one coroutine, state read before an await
    and written after it — the await is a yield point where another task
    can observe or update the same state (classic: `if self._loaded: ...;
    await load(); self._loaded = True`). Writes inside an `async with
    <...lock...>` block are exempt."""
    for fn in async_functions(ctx.tree):
        awaits = sorted(
            n.lineno for n in walk_scope(fn) if isinstance(n, ast.Await)
        )
        if not awaits:
            continue
        guarded = _lock_guarded_spans(fn)
        accesses: dict[tuple[str, str], list[int]] = {}
        writes: list[tuple[int, tuple[str, str], str]] = []
        for node in walk_scope(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                flat: list[ast.AST] = []
                for t in targets:
                    flat.extend(t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t])
                for t in flat:
                    key = _target_key(t)
                    if key is not None:
                        writes.append((node.lineno, key, ast.unparse(t)))
            key = _target_key(node)
            if key is not None:
                accesses.setdefault(key, []).append(node.lineno)
        for line, key, label in writes:
            if any(a <= line <= b for a, b in guarded):
                continue
            prior = [a for a in accesses.get(key, ()) if a < line]
            if prior and any(min(prior) < v <= line for v in awaits):
                yield ctx.finding(
                    line,
                    "async-shared-mutation",
                    f"write to shared state '{label}' after an await that "
                    f"follows an earlier access in '{fn.name}' — another "
                    "task can interleave; guard with an asyncio.Lock or "
                    "restructure",
                )
