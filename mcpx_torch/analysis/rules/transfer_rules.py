"""blocking-transfer-on-loop: device readbacks inside loop-side code.

A request handler that reads a device value on the event loop stalls every
other request for a device round trip; the fix (move the read behind
``asyncio.to_thread``, or keep host copies) is structural, so the check is
too:

  - **Sources** produce (possibly) device-backed values: calls to the
    project's captured functions (ProjectContext.captures), tensors moved
    with ``.to(...)``/``.cuda()``, ``queue_stats()`` (the engine's
    device-adjacent stats surface), and any project function whose *return
    value* is itself device-tainted (a bounded two-round interprocedural
    closure, so a helper that forwards a device result taints its callers'
    locals across modules).
  - **Sinks** synchronize: ``float()``/``int()``/``bool()``/``np.asarray``/
    ``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` and ``.to(...)`` of a
    device-sourced value (shared with jit-host-sync,
    torch_rules._is_host_sync), and ``torch.cuda.synchronize()``, which
    waits for the whole device whatever it is handed.
  - **Scope**: only *loop-side* functions are checked — async
    request-path handlers (``async def`` with a ``request`` param), sync
    callbacks spawned through loop mechanisms (``call_soon*`` /
    ``create_task`` targets), and helpers within 3 call-graph hops of
    either. Code outside the loop is free to block.

Sanctioned off-loop shapes stay silent by construction: a nested ``def``
handed to ``asyncio.to_thread``/``run_in_executor`` is not an indexed
function (and ``walk_scope`` skips nested-def bodies); ``benchmarks/``
drives the loop from offline harnesses and is exempt.

Taint is per-function and flow-insensitive (names assigned from a
source-containing expression, ``for``/comprehension targets over tainted
iterables), which is deliberately coarse: a dict comprehension over
``engine.queue_stats().items()`` taints its element names, which is
exactly the healthz shape that needs a justification when the values are
known host scalars.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from mcpx_torch.analysis.astutil import walk
from mcpx_torch.analysis.core import Finding, rule
from mcpx_torch.analysis.rules.common import dotted_name, walk_scope
from mcpx_torch.analysis.rules.torch_rules import _is_host_sync

_MAX_HOPS = 3
_DEVICE_METHODS = {"queue_stats"}
_MOVES = {"to", "cuda"}
_DEVICE_WAITS = {"torch.cuda.synchronize", "cuda.synchronize"}
_RET_ROUNDS = 2


def _sink_subject(node: ast.Call, what: str) -> Optional[ast.AST]:
    """The expression a host-sync call synchronizes on."""
    if what.startswith("."):
        return node.func.value if isinstance(node.func, ast.Attribute) else None
    return node.args[0] if node.args else None


@rule(
    "blocking-transfer-on-loop",
    "synchronizing device readback or transfer (float()/.item()/.cpu()/"
    ".to()/torch.cuda.synchronize()/...) of a device-sourced value inside "
    "async request-path or loop-callback code",
    scope="project",
)
def check_blocking_transfer(project) -> Iterator[Finding]:
    index = project.index
    graph = project.callgraph()
    captured = {info.name for info in project.captures().functions.values()}
    ret_device: dict[str, str] = {}  # qualname -> source label

    def is_source(call: ast.Call, info, env) -> Optional[str]:
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _DEVICE_METHODS
        ):
            return f".{call.func.attr}()"
        if isinstance(call.func, ast.Attribute) and call.func.attr in _MOVES:
            return f"'.{call.func.attr}()'"
        name = dotted_name(call.func)
        last = name.rsplit(".", 1)[-1] if name else None
        if last and last in captured:
            return f"captured function '{last}'"
        callee = index.resolve_call(call, info, env)
        if callee is not None and callee.qualname in ret_device:
            return f"'{callee.name}()' (returns {ret_device[callee.qualname]})"
        return None

    def taint_of(info) -> dict[str, str]:
        """name -> source label for one function body (nested defs are
        separate execution contexts and excluded)."""
        env = index.local_env(info)
        tainted: dict[str, str] = {}

        def label(e: ast.AST) -> Optional[str]:
            for sub in walk(e):
                if isinstance(sub, ast.Call):
                    src = is_source(sub, info, env)
                    if src:
                        return src
                elif isinstance(sub, ast.Name) and sub.id in tainted:
                    return tainted[sub.id]
            return None

        def bind(tgt: ast.AST, src: str) -> None:
            for sub in walk(tgt):
                if isinstance(sub, ast.Name):
                    tainted.setdefault(sub.id, src)

        for _ in range(2):  # let chained assignments settle
            for node in walk_scope(info.node):
                if isinstance(node, ast.Assign):
                    src = label(node.value)
                    if src:
                        for t in node.targets:
                            bind(t, src)
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                    if node.value is not None:
                        src = label(node.value)
                        if src:
                            bind(node.target, src)
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    src = label(node.iter)
                    if src:
                        bind(node.target, src)
            # comprehension generators live in expression position
            for node in walk_scope(info.node):
                if isinstance(
                    node, (ast.ListComp, ast.SetComp, ast.DictComp,
                           ast.GeneratorExp)
                ):
                    for gen in node.generators:
                        src = label(gen.iter)
                        if src:
                            bind(gen.target, src)
        return tainted, env, label

    # --- interprocedural closure: functions returning device values
    for _ in range(_RET_ROUNDS):
        changed = False
        for info in index.functions.values():
            if info.qualname in ret_device:
                continue
            has_call = any(
                isinstance(n, ast.Call) for n in walk_scope(info.node)
            )
            if not has_call:
                continue
            tainted, env, label = taint_of(info)
            for node in walk_scope(info.node):
                if isinstance(node, ast.Return) and node.value is not None:
                    src = label(node.value)
                    if src:
                        ret_device[info.qualname] = src
                        changed = True
                        break
        if not changed:
            break

    # --- loop-side scope: request-path + loop-callback roots, helpers
    # within _MAX_HOPS backward call edges of either.
    def is_root(info) -> bool:
        if info.is_async and "request" in info.params:
            return True
        return "loop" in graph.spawned_via(info.qualname)

    def loop_side(info) -> bool:
        if "benchmarks" in info.path.split("/"):
            return False
        seen = {info.qualname}
        frontier = [info.qualname]
        for _ in range(_MAX_HOPS + 1):
            nxt = []
            for q in frontier:
                fi = index.functions.get(q)
                if fi is not None and is_root(fi):
                    return True
                for c in graph.callers_of(q):
                    if c not in seen:
                        seen.add(c)
                        nxt.append(c)
            frontier = nxt
            if not frontier:
                break
        return False

    for info in index.functions.values():
        if not loop_side(info):
            continue
        tainted, env, label = taint_of(info)
        emitted: set[tuple] = set()
        for node in walk_scope(info.node):
            if not isinstance(node, ast.Call):
                continue
            what = _is_host_sync(node)
            if what is None and isinstance(node.func, ast.Attribute) and node.func.attr in _MOVES:
                what = f".{node.func.attr}"
            if what is None or what == ".synchronize":
                continue
            if what in _DEVICE_WAITS:
                src = None
            else:
                subject = _sink_subject(node, what)
                if subject is None:
                    continue
                src = label(subject)
                if src is None:
                    continue
            key = (node.lineno, what)
            if key in emitted:
                continue
            emitted.add(key)
            short = info.qualname.split(".")
            short = ".".join(short[-2:]) if len(short) > 1 else info.qualname
            did = (
                "waits for the whole device" if src is None
                else f"synchronizes a device-sourced value (from {src})"
            )
            yield project.finding(
                info.path,
                node.lineno,
                "blocking-transfer-on-loop",
                f"'{what}' {did} inside loop-side '{short}' — the event loop "
                "stalls on the device round trip; move the readback off-"
                "loop (asyncio.to_thread / executor) or keep host copies",
            )
