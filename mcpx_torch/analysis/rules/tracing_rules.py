"""Tracing-hygiene rule: manual clock deltas that straddle an await in
request-path async code should be tracing spans (mcpx_torch/telemetry/tracing.py).

A ``t0 = time.monotonic()`` … ``await …`` … ``time.monotonic() - t0`` pair
measures a request-path interval — exactly what a span records, except the
manual delta is invisible to ``GET /traces``, carries no trace id, and
cannot be attributed against the rest of the request. Findings point the
author at ``tracing.span``; sites whose number must exist with tracing off
(client-facing latency fields, Prometheus observations) suppress with a
justification, same contract as every other rule.

Offline measurement harnesses are exempt by path (any ``benchmarks/``
segment): wall-clock deltas are their *product*, not a missed span.
"""

from __future__ import annotations

import ast
from typing import Iterator

from mcpx_torch.analysis.core import FileContext, Finding, rule
from mcpx_torch.analysis.rules.common import (
    async_functions,
    call_name,
    dotted_name,
    walk_scope,
)

# Direct clock reads. Event-loop clocks are matched structurally below
# (loop.time() / self._loop.time() / asyncio.get_event_loop().time()) —
# the executor's idiom.
_TIMING_NAMES = {"time.time", "time.monotonic", "time.perf_counter"}
_LOOP_FACTORIES = {"asyncio.get_event_loop", "asyncio.get_running_loop"}

# WALL clocks only (wall-clock-duration rule): reads that jump with NTP
# slews/steps and must never be differenced into a duration on the
# serving path — SLO windows and ledger bills are monotonic-clock
# contracts (time.monotonic / time.perf_counter).
_WALL_CLOCK_NAMES = {
    "time.time",
    "datetime.now",
    "datetime.utcnow",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
}


def _is_timing_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node)
    if name in _TIMING_NAMES:
        return True
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "time":
        base = dotted_name(f.value)
        if base is not None and "loop" in base.lower():
            return True
        if isinstance(f.value, ast.Call) and call_name(f.value) in _LOOP_FACTORIES:
            return True
    return False


def _is_wall_clock_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and call_name(node) in _WALL_CLOCK_NAMES


@rule(
    "wall-clock-duration",
    "wall-clock (time.time/datetime.now) delta used as a duration in "
    "request-path async code — durations must be monotonic-clock",
)
def check_wall_clock_duration(ctx: FileContext) -> Iterator[Finding]:
    """Flags a subtraction whose BOTH sides are wall-clock-derived (a
    direct ``time.time()``/``datetime.now()`` call, or a name assigned
    from one in the same function) inside async request-path code. A
    wall-clock pair differenced into an interval jumps with NTP
    slews/steps — an SLO window or a request bill built on it lies
    exactly when clocks misbehave. One wall-clock operand against a
    non-clock value stays silent: cross-host timestamp comparisons
    (telemetry mirror TTLs) have no monotonic alternative. Offline
    harnesses (any ``benchmarks/`` path segment) are exempt, like
    span-across-await-blocking."""
    parts = ctx.relpath.split("/")
    if "benchmarks" in parts:
        return
    for fn in async_functions(ctx.tree):
        assigns: set[str] = set()
        for node in walk_scope(fn):
            if isinstance(node, ast.Assign) and _is_wall_clock_call(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        assigns.add(t.id)

        def _wall_derived(side: ast.AST) -> bool:
            if _is_wall_clock_call(side):
                return True
            return isinstance(side, ast.Name) and side.id in assigns

        for node in walk_scope(fn):
            if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)):
                continue
            if _wall_derived(node.left) and _wall_derived(node.right):
                yield ctx.finding(
                    node.lineno,
                    "wall-clock-duration",
                    f"wall-clock delta used as a duration in async "
                    f"'{fn.name}' — time.time()/datetime.now() jump with "
                    "NTP; measure request-path intervals with "
                    "time.monotonic() (SLO windows and ledger bills are "
                    "monotonic-clock contracts)",
                )


@rule(
    "span-across-await-blocking",
    "manual clock delta spanning an await in request-path async code — "
    "record a tracing span instead",
)
def check_span_across_await(ctx: FileContext) -> Iterator[Finding]:
    """Flags a subtraction involving a variable assigned from a clock call
    when at least one yield point (``await`` / ``async for`` / ``async
    with``) sits between the assignment and the use — the measured interval
    is request-path latency that belongs in the trace tree."""
    parts = ctx.relpath.split("/")
    if "benchmarks" in parts:
        return
    for fn in async_functions(ctx.tree):
        yields = sorted(
            n.lineno
            for n in walk_scope(fn)
            if isinstance(n, (ast.Await, ast.AsyncFor, ast.AsyncWith))
        )
        if not yields:
            continue
        assigns: dict[str, list[int]] = {}
        for node in walk_scope(fn):
            if isinstance(node, ast.Assign) and _is_timing_call(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        assigns.setdefault(t.id, []).append(node.lineno)
        if not assigns:
            continue
        for node in walk_scope(fn):
            if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)):
                continue
            for side in (node.left, node.right):
                if not (isinstance(side, ast.Name) and side.id in assigns):
                    continue
                prior = [a for a in assigns[side.id] if a < node.lineno]
                if not prior:
                    continue
                # Judge against the LATEST assignment before the use: a
                # re-read of the clock after the await resets the interval.
                a0 = max(prior)
                if any(a0 < y <= node.lineno for y in yields):
                    yield ctx.finding(
                        node.lineno,
                        "span-across-await-blocking",
                        f"manual timing delta on '{side.id}' spans an await "
                        f"in async '{fn.name}' — record it as a tracing span "
                        "(mcpx_torch.telemetry.tracing.span) so it lands in the "
                        "request trace; suppress only where the number must "
                        "exist with tracing off",
                    )
                    break
