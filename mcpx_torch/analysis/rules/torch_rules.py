"""PyTorch/CUDA hot-path hygiene rules: host-device syncs inside captured
regions and in dispatch loops, the per-token feedback loop, request values
reaching a capture key, and call sites that fork off the device route.

The counterparts of the reference's JAX rules, under the same ids. A
"captured region" is what runs while a CUDA graph records: a ``with
torch.cuda.graph(...)`` body, a ``capture_begin()``/``capture_end()``
stretch, a callable handed to ``make_graphed_callables``, and the functions
they call (rules/common.py, ``capture_scopes``). ``traced-control-flow``
has no counterpart: eager PyTorch has no tracer, and a Python branch on a
tensor inside a capture is a host sync, which ``jit-host-sync`` flags."""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from mcpx_torch.analysis.astutil import walk
from mcpx_torch.analysis.core import FileContext, Finding, rule
from mcpx_torch.analysis.rules.common import (
    cached_capture_scopes,
    call_name,
    dispatch_names,
    dotted_name,
    is_dispatch,
    walk_scope,
)

# Calls that wait for the device (a full pipeline stall inside a capture,
# where they also break the capture, or between dispatches of a hot loop).
HOST_SYNC_CALLS = {
    "np.asarray",
    "np.array",
    "numpy.asarray",
    "numpy.array",
    "torch.cuda.synchronize",
    "cuda.synchronize",
}
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_CONVERSIONS = {"float", "int", "bool"}
# Host metadata a conversion may read without touching device memory.
_METADATA_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
_METADATA_CALLS = {"len", "size", "numel", "dim", "stride", "element_size"}


def _host_metadata(expr: ast.AST) -> bool:
    """True when a conversion's argument reads shapes, lengths or sizes:
    ``int(x.shape[0])`` and ``int(len(rows))`` never wait for the device."""
    for sub in walk(expr):
        if isinstance(sub, ast.Attribute) and sub.attr in _METADATA_ATTRS:
            return True
        if isinstance(sub, ast.Call):
            name = call_name(sub) or ""
            if name.rsplit(".", 1)[-1] in _METADATA_CALLS:
                return True
    return False


def _is_host_sync(node: ast.Call) -> Optional[str]:
    name = call_name(node)
    if name in HOST_SYNC_CALLS:
        return name
    if isinstance(node.func, ast.Attribute) and node.func.attr in HOST_SYNC_METHODS:
        return f".{node.func.attr}"
    if (
        isinstance(node.func, ast.Name)
        and node.func.id in _CONVERSIONS
        and len(node.args) == 1
        and not isinstance(node.args[0], ast.Constant)
        and not _host_metadata(node.args[0])
    ):
        return node.func.id
    return None


_TENSOR_PREFIXES = ("torch.", "F.")
_REDUCER_METHODS = {"any", "all"}


def _branch_on_tensor(test: ast.AST) -> Optional[str]:
    """What makes a branch test a tensor: a ``torch.*`` call or an
    ``.any()``/``.all()`` reducer in it (Python then calls ``bool()`` on
    the result, a host sync)."""
    for node in walk(test):
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name is not None and name.startswith(_TENSOR_PREFIXES):
                return name
            if isinstance(node.func, ast.Attribute) and node.func.attr in _REDUCER_METHODS:
                return f".{node.func.attr}"
    return None


def _dispatchers(ctx: FileContext) -> set:
    """Names whose call dispatches device work: ``dispatch_names`` plus, to
    a fixpoint, the file's functions that call one (a helper that replays
    a graph, and the segment loop above it)."""
    if "dispatchers" in ctx.cache:
        return ctx.cache["dispatchers"]
    names = set(dispatch_names(ctx))
    fns = [n for n in walk(ctx.tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    changed = True
    while changed:
        changed = False
        for fn in fns:
            if fn.name in names:
                continue
            if any(isinstance(n, ast.Call) and is_dispatch(n, names) for n in walk_scope(fn)):
                names.add(fn.name)
                changed = True
    ctx.cache["dispatchers"] = names
    return names


def _device_names(loop: ast.AST, names: set) -> set:
    """Names a loop assigns from a dispatch call's result."""
    out: set[str] = set()
    for node in walk(loop):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) and is_dispatch(node.value, names):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    out.update(e.id for e in t.elts if isinstance(e, ast.Name))
    return out


def _dispatch_loops(ctx: FileContext) -> Iterator[tuple]:
    """(loop, its device names) for every ``for``/``while`` that dispatches."""
    names = _dispatchers(ctx)
    for loop in walk(ctx.tree):
        if isinstance(loop, (ast.For, ast.While)) and any(
            isinstance(n, ast.Call) and is_dispatch(n, names) for n in walk(loop)
        ):
            yield loop, _device_names(loop, names)


@rule(
    "jit-host-sync",
    "host-device sync inside a captured region or a dispatch loop",
)
def check_jit_host_sync(ctx: FileContext) -> Iterator[Finding]:
    scopes = cached_capture_scopes(ctx)
    seen: set[tuple[int, str]] = set()
    # --- inside captured regions: a sync there breaks the capture (or, in
    # the eager warm-up, stalls the pipeline).
    walks = [(fn.name, body) for fn, body in scopes.regions]
    walks += [(fn.name, [fn]) for fn in scopes.functions]
    for name, stmts in walks:
        for stmt in stmts:
            nodes = walk_scope(stmt, include_nested_defs=True) if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) else walk(stmt)
            for node in nodes:
                if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                    what = _branch_on_tensor(node.test)
                    if what is not None and (node.lineno, "branch") not in seen:
                        seen.add((node.lineno, "branch"))
                        yield ctx.finding(
                            node.lineno,
                            "jit-host-sync",
                            f"branch on a tensor ('{what}') inside captured region "
                            f"'{name}' — Python's bool() syncs with the device; use "
                            "torch.where or keep the decision on the device",
                        )
                    continue
                if not isinstance(node, ast.Call):
                    continue
                what = _is_host_sync(node)
                if what is not None and (node.lineno, what) not in seen:
                    seen.add((node.lineno, what))
                    yield ctx.finding(
                        node.lineno,
                        "jit-host-sync",
                        f"host sync '{what}' inside captured region '{name}' — "
                        "keep values on the device (torch ops on tensors) or "
                        "move the readback outside the captured function",
                    )
    # --- dispatch loops: a sync on a dispatch's result serializes every
    # iteration on the device round trip; a device-wide sync does so on
    # everything. The lagged harvest (a copy into pinned memory read after
    # its event's query() says it landed) waits for nothing and is not a
    # sync here; an event's synchronize() is, unless the loop polls it.
    for loop, device in _dispatch_loops(ctx):
        polled = {
            dotted_name(n.func.value)
            for n in walk(loop)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == "query"
        }
        for node in walk(loop):
            if not isinstance(node, ast.Call):
                continue
            arg: Optional[ast.AST] = None
            what = None
            name = call_name(node)
            if name in ("torch.cuda.synchronize", "cuda.synchronize"):
                what, label = name, name
            elif isinstance(node.func, ast.Name) and node.func.id in _CONVERSIONS and len(node.args) == 1:
                arg, what = node.args[0], node.func.id
            elif name in ("np.asarray", "numpy.asarray", "np.array", "numpy.array") and node.args:
                arg, what = node.args[0], name
            elif isinstance(node.func, ast.Attribute) and node.func.attr in HOST_SYNC_METHODS:
                if node.func.attr == "synchronize":
                    if dotted_name(node.func.value) in polled:
                        continue
                    what, label = ".synchronize", ".synchronize()"
                else:
                    arg, what = node.func.value, f".{node.func.attr}"
            if what is None:
                continue
            if arg is not None:
                if not (isinstance(arg, ast.Name) and arg.id in device):
                    continue
                label = f"{what}({arg.id})"
            key = (node.lineno, f"loop:{what}")
            if key in seen:
                continue
            seen.add(key)
            yield ctx.finding(
                node.lineno,
                "jit-host-sync",
                f"per-iteration host sync '{label}' inside a dispatch loop — "
                "defer or batch the transfer (one sync per loop, or a lagged "
                "copy read after its event's query())",
            )


@rule(
    "per-token-host-loop",
    "host loop stepping a forward or a captured graph with a per-iteration "
    "host sync fed back into the next dispatch",
)
def check_per_token_host_loop(ctx: FileContext) -> Iterator[Finding]:
    """A Python ``while``/``for`` that dispatches a forward (or replays a
    captured window), syncs its result to the host (``int()``/``.item()``/
    ``.tolist()``/``.cpu()``/``np.asarray``) and feeds the synced value
    into the NEXT dispatch: one full host-device round trip per token,
    serialized by construction. Keep the token loop on the device (the
    engine's captured decode windows) or widen the dispatch so one call
    covers many tokens (drafting, speculative decoding)."""
    names = _dispatchers(ctx)
    for loop, device in _dispatch_loops(ctx):
        if not device:
            continue
        synced: dict[str, tuple[int, str]] = {}
        for node in walk(loop):
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                continue
            what = _is_host_sync(node.value)
            if what is None:
                continue
            if not any(isinstance(sub, ast.Name) and sub.id in device for sub in walk(node.value)):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    synced[t.id] = (node.lineno, what)
        if not synced:
            continue
        seen: set[int] = set()
        for node in walk(loop):
            if not (isinstance(node, ast.Call) and is_dispatch(node, names)):
                continue
            consumed = {
                sub.id
                for a in (*node.args, *(kw.value for kw in node.keywords))
                for sub in walk(a)
                if isinstance(sub, ast.Name)
            }
            for name in sorted(consumed & set(synced)):
                line, what = synced[name]
                if line in seen:
                    continue
                seen.add(line)
                yield ctx.finding(
                    line,
                    "per-token-host-loop",
                    f"per-iteration host sync '{what}' -> '{name}' feeds the "
                    f"next '{call_name(node)}' dispatch — one device round "
                    "trip per token; keep the loop on the device (a captured "
                    "window) or widen the dispatch (drafting, speculation)",
                )


@rule(
    "jit-static-branch",
    "request-derived value reaching a CUDA-graph capture key without a "
    "bucketing sanitizer",
    scope="project",
)
def check_capture_key_taint(project) -> Iterator[Finding]:
    """A per-request value (a field of a ``# mcpx: request-payload`` class,
    or an async handler's ``request``) that reaches the key of a dict of
    captured graphs captures a NEW graph per distinct value: seconds of
    capture inside the serving path, and device memory that grows with the
    traffic. The project's taint engine (dataflow.py) follows it across
    helpers, attribute stores and container hops; ``*bucket*`` quantizers
    (``engine._bucket``) launder it, as a fixed grid makes the key finite."""
    model = project.captures()
    if not model.registries:
        return
    index = project.index
    taint = None
    for info in index.functions.values():
        env = index.local_env(info)
        uses: list[tuple[ast.AST, str, int]] = []  # (key expr, registry attr, line)

        def registry_of(expr: ast.AST) -> Optional[str]:
            if not isinstance(expr, ast.Attribute):
                return None
            bt = index.expr_type(expr.value, info, env)
            if bt is not None and not bt.container and (bt.cls, expr.attr) in model.registries:
                return expr.attr
            return None

        for node in walk(info.node):
            if isinstance(node, ast.Subscript):
                attr = registry_of(node.value)
                if attr is not None:
                    uses.append((node.slice, attr, node.lineno))
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                if node.func.attr in ("get", "setdefault", "pop") and node.args:
                    attr = registry_of(node.func.value)
                    if attr is not None:
                        uses.append((node.args[0], attr, node.lineno))
            elif isinstance(node, ast.Compare) and len(node.ops) == 1 and isinstance(node.ops[0], (ast.In, ast.NotIn)):
                attr = registry_of(node.comparators[0])
                if attr is not None:
                    uses.append((node.left, attr, node.lineno))
        if not uses:
            continue
        if taint is None:
            taint = project.taint()
        env_types, var = taint.function_env(info)
        seen: set[tuple] = set()
        for expr, attr, line in uses:
            labels = taint.expr_taint(expr, info, env_types, var)
            if not labels or (line, attr) in seen:
                continue
            seen.add((line, attr))
            origin = sorted(labels)[0]
            yield project.finding(
                info.path,
                line,
                "jit-static-branch",
                f"request-derived value ({origin}) reaches the capture key of "
                f"'{attr}' — every distinct value captures a new CUDA graph "
                "(a capture storm in the serving path); quantize it onto a "
                "fixed bucket grid first, or pass it as per-row device data",
            )


def _class_holds_device(cls: ast.ClassDef) -> bool:
    """True when a method of ``cls`` reads or writes ``self.device`` (or
    ``self._device``): the class resolves where its tensors live, and a call
    site that pins the plain route or the CPU overrides that resolution."""
    for node in walk(cls):
        if (
            isinstance(node, ast.Attribute)
            and node.attr in ("device", "_device")
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return True
    return False


def _fallback_calls(scope: ast.AST) -> Iterator[tuple[ast.Call, str]]:
    """(call, what) for calls of a plain version (``*_reference``) and for a
    literal ``device="cpu"`` keyword."""
    for node in walk(scope):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node) or ""
        if name.rsplit(".", 1)[-1].endswith("_reference"):
            yield node, name.rsplit(".", 1)[-1]
        for kw in node.keywords:
            if (
                kw.arg == "device"
                and isinstance(kw.value, ast.Constant)
                and isinstance(kw.value.value, str)
                and kw.value.value.split(":")[0] == "cpu"
            ):
                yield node, 'device="cpu"'


@rule(
    "hardcoded-kernel-fallback",
    "plain-version call or literal device=\"cpu\" at a call site with a "
    "resolved device in scope",
)
def check_hardcoded_kernel_fallback(ctx: FileContext) -> Iterator[Finding]:
    """The port's route is the tensor's device: a kernel wrapper launches
    the CUDA kernel on a CUDA tensor and runs its plain version on a CPU
    one. A call of a plain version (``ragged_paged_attention_reference``)
    or a literal ``device="cpu"`` inside a class that resolves its device
    (``self.device``), or inside a function that receives one as a
    ``device`` parameter, forks that one path off the kernel while every
    other path follows the resolved device. Plain versions called from
    code with no resolved device in scope (the wrappers themselves, tests,
    reference harnesses) and signature defaults stay silent."""
    tree = ctx.tree
    seen: set[tuple[int, str]] = set()
    for cls in walk(tree):
        if not isinstance(cls, ast.ClassDef) or not _class_holds_device(cls):
            continue
        for call, what in _fallback_calls(cls):
            if (call.lineno, what) not in seen:
                seen.add((call.lineno, what))
                yield ctx.finding(
                    call.lineno,
                    "hardcoded-kernel-fallback",
                    f"'{what}' at a call site inside '{cls.name}', which "
                    "resolves its device itself (self.device) — route by the "
                    "tensors' device so this path cannot silently fork off "
                    "the kernel",
                )
    for fn in walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        a = fn.args
        if "device" not in {p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)}:
            continue
        for call, what in _fallback_calls(fn):
            if (call.lineno, what) not in seen:
                seen.add((call.lineno, what))
                yield ctx.finding(
                    call.lineno,
                    "hardcoded-kernel-fallback",
                    f"'{what}' inside '{fn.name}', which already receives "
                    "the resolved device as a parameter — pass it through "
                    "instead of pinning one route",
                )
