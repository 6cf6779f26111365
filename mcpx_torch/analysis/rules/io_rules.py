"""Event-loop hygiene rule: blocking file IO reachable from the request path.

The bug class (the flight recorder's bundle writer, caught at design time):
a request-path async function — or a sync helper it calls — writes a file
on the event loop (``open(..., "w")``, ``json.dump``, ``np.save``,
``pickle.dump``, an atomic ``os.replace`` dance). Every request on the
server stalls for the write's duration; invisible in tests (tiny files,
local disk) and a p99 cliff in production the moment the disk hiccups.
The sanctioned shapes — both used throughout this repo — are:

  - a NESTED sync ``def`` handed to ``asyncio.to_thread`` /
    ``run_in_executor`` (FileRegistry's ``read``/``write`` closures);
  - a sync METHOD passed uncalled to ``asyncio.to_thread``
    (``FlightRecorder._write_bundle``).

Both are structurally invisible to this rule: a function REFERENCE is not
a call, nested defs are their own scope (``walk_scope``), and the call
graph models executor dispatch as a ``spawn`` edge — so only genuinely
on-loop writes are reachable.

**Project scope.** A write site is flagged when its enclosing function is
an async request-path function, or is reachable (backwards over plain
``call`` edges — never ``spawn`` — within ``_MAX_HOPS`` caller levels;
deeper chains are accepted false negatives, the bound keeps the walk
cheap and the findings explainable) from one. "Request-path" uses the
codebase's existing convention: an async function with a parameter named
``request`` (the aiohttp handler/middleware signature, the same anchor the
jit-contract pass taints from). Shutdown/startup async code (``aclose``,
``on_cleanup``) is NOT request-path and stays silent — a snapshot write at
teardown blocks no request.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from mcpx_torch.analysis.core import Finding, rule
from mcpx_torch.analysis.rules.common import call_name, dotted_name, walk_scope

# Dotted callables that block on file IO when invoked on the loop. dumps
# (string-building) is fine; dump (file-writing) is not.
_BLOCKING_CALLS = {
    "json.dump",
    "pickle.dump",
    "np.save", "np.savez", "np.savez_compressed",
    "numpy.save", "numpy.savez", "numpy.savez_compressed",
    "os.replace", "os.rename",
    "shutil.move", "shutil.copy", "shutil.copyfile", "shutil.copytree",
}
# Attribute calls that write files whatever the receiver (pathlib et al).
_BLOCKING_ATTRS = {"write_text", "write_bytes"}
_WRITE_MODES = set("wax+")
_MAX_HOPS = 3  # backward caller-walk bound (handler -> helper -> helper)


def _open_writes(call: ast.Call) -> bool:
    if call_name(call) != "open":
        return False
    mode: Optional[ast.AST] = call.args[1] if len(call.args) > 1 else None
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return False  # default "r": reads are a different (smaller) sin
    return (
        isinstance(mode, ast.Constant)
        and isinstance(mode.value, str)
        and any(ch in _WRITE_MODES for ch in mode.value)
    )


def _write_sites(fn) -> Iterator[int]:
    """Line numbers of blocking file-write calls in ``fn``'s OWN scope
    (nested defs excluded — they run wherever they are dispatched)."""
    for node in walk_scope(fn):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name in _BLOCKING_CALLS or _open_writes(node):
            yield node.lineno
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _BLOCKING_ATTRS
            and dotted_name(node.func.value) is not None
        ):
            yield node.lineno


def _is_request_path(info) -> bool:
    return info is not None and info.is_async and "request" in info.params


@rule(
    "blocking-io-on-request-path",
    "file write (open/json.dump/np.save/os.replace/…) on the event loop in "
    "code reachable from a request handler — hop through "
    "asyncio.to_thread / run_in_executor instead",
    scope="project",
)
def check_blocking_io_on_request_path(project) -> Iterator[Finding]:
    graph = project.callgraph()
    index = project.index
    request_path_cache: dict[str, bool] = {}

    def reaches_request_path(qualname: str) -> bool:
        """Backward BFS over plain call edges (spawn edges — to_thread,
        executors, threads, create_task — are not caller edges, so work
        dispatched off the loop never inherits request-path status)."""
        hit = request_path_cache.get(qualname)
        if hit is not None:
            return hit
        seen: set[str] = set()
        frontier = {qualname}
        found = False
        for _ in range(_MAX_HOPS + 1):
            nxt: set[str] = set()
            for q in frontier:
                if q in seen:
                    continue
                seen.add(q)
                if _is_request_path(index.functions.get(q)):
                    found = True
                    break
                nxt |= graph.callers_of(q)
            if found or not nxt:
                break
            frontier = nxt
        request_path_cache[qualname] = found
        return found

    for info in index.functions.values():
        lines = list(_write_sites(info.node))
        if not lines or not reaches_request_path(info.qualname):
            continue
        where = (
            "async request handler"
            if _is_request_path(info)
            else "function reachable from a request handler"
        )
        for lineno in lines:
            yield project.finding(
                info.path,
                lineno,
                "blocking-io-on-request-path",
                f"'{info.name}' ({where}) performs blocking file IO on the "
                "event loop — every in-flight request stalls for the "
                "write; move it into a sync helper dispatched via "
                "asyncio.to_thread / run_in_executor (the "
                "FileRegistry/FlightRecorder pattern)",
            )
