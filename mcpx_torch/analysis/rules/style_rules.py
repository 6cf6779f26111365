"""Hygiene rules: silent broad exception handlers, and the blank-line-run
check grown out of an earlier regex test."""

from __future__ import annotations

import ast
import re
from typing import Iterator

from mcpx_torch.analysis.astutil import walk
from mcpx_torch.analysis.core import FileContext, Finding, rule
from mcpx_torch.analysis.rules.common import call_name

_BLANK_RUN = re.compile(r"(?:^[ \t]*\n){3,}", re.MULTILINE)

_LOG_METHODS = {"exception", "error", "warning", "info", "debug", "critical"}
_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare `except:`
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        if isinstance(n, ast.Name) and n.id in _BROAD:
            return True
        if isinstance(n, ast.Attribute) and n.attr in _BROAD:
            return True
    return False


def _handles_visibly(handler: ast.ExceptHandler) -> bool:
    """True when the handler re-raises or leaves a trace (logging call or
    traceback.print_exc) — the failure isn't silently swallowed."""
    for stmt in handler.body:
        for node in walk(stmt):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                name = call_name(node) or ""
                if name == "traceback.print_exc":
                    return True
                if isinstance(node.func, ast.Attribute) and node.func.attr in _LOG_METHODS:
                    # log.exception / logging.error / self._logger.warning
                    root = name.split(".", 1)[0] if name else ""
                    if "log" in root.lower() or node.func.attr == "exception":
                        return True
                    # logging.getLogger(...).warning(...): the chain is
                    # rooted in a Call, so dotted-name resolution fails —
                    # accept when that inner call is itself a logging.* one.
                    inner = node.func.value
                    while isinstance(inner, ast.Attribute):
                        inner = inner.value
                    if isinstance(inner, ast.Call) and (
                        call_name(inner) or ""
                    ).startswith("logging."):
                        return True
    return False


@rule(
    "broad-except",
    "broad `except Exception`/bare except that swallows without re-raise or logging",
)
def check_broad_except(ctx: FileContext) -> Iterator[Finding]:
    for node in walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if _is_broad(node) and not _handles_visibly(node):
            caught = "bare except" if node.type is None else ast.unparse(node.type)
            yield ctx.finding(
                node.lineno,
                "broad-except",
                f"broad handler ({caught}) swallows the error — catch a "
                "specific exception, log before continuing, or justify with "
                "a suppression",
            )


@rule(
    "blank-lines",
    "run of >= 3 consecutive blank lines (block-deletion residue)",
    needs_ast=False,
)
def check_blank_lines(ctx: FileContext) -> Iterator[Finding]:
    for m in _BLANK_RUN.finditer(ctx.text):
        line = ctx.text[: m.start()].count("\n") + 1
        yield ctx.finding(
            line,
            "blank-lines",
            "run of >= 3 consecutive blank lines",
        )
