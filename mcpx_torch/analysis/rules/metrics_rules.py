"""Metrics-hygiene rule: Prometheus objects minted — or labeled with
unbounded request-derived values — inside request-path functions.

Two failure shapes, both silent in tests and fatal in production:

  - **Per-request metric construction**: a ``Counter``/``Gauge``/
    ``Histogram`` created inside a handler registers a NEW collector per
    request — the registry grows without bound (or raises on the duplicate
    name) and every scrape pays for it. Metrics belong in ``Metrics.
    __init__`` (mcpx_torch/telemetry/metrics.py), created once per registry.
  - **Label churn**: ``.labels(...)`` with a value synthesised from request
    data (an f-string over an intent, a concatenated URL, ``request.path``)
    mints a new time series per distinct value. Prometheus series are a
    resource: unbounded label cardinality is a memory leak on the server
    AND the scraper — the reason app.py labels by route TEMPLATE, not raw
    path. Bounded label sources (a plain name bound upstream, a literal, a
    conditional over literals) stay silent: the rule flags the *synthesis*
    of a label value in the request path, where unboundedness is
    structural.

Scope: async functions (this codebase's request path is async end to end);
sync helpers constructing metrics at init time are the sanctioned pattern.
The prometheus constructors are recognised by call shape (a string name
plus a ``registry=`` kwarg or a documentation string), so ``collections.
Counter()`` never matches.
"""

from __future__ import annotations

import ast
from typing import Iterator

from mcpx_torch.analysis.core import FileContext, Finding, rule
from mcpx_torch.analysis.rules.common import async_functions, call_name, dotted_name, walk_scope

_METRIC_CTORS = {"Counter", "Gauge", "Histogram", "Summary", "Info", "Enum"}


def _is_prom_ctor(call: ast.Call) -> bool:
    name = call_name(call)
    if name is None:
        return False
    if name.split(".")[-1] not in _METRIC_CTORS:
        return False
    # Disambiguate from collections.Counter / enum.Enum by call shape:
    # prometheus constructors take (name, documentation, ...) string
    # positionals and/or a registry= kwarg.
    if any(kw.arg == "registry" for kw in call.keywords):
        return True
    str_args = sum(
        1 for a in call.args if isinstance(a, ast.Constant) and isinstance(a.value, str)
    )
    return str_args >= 2


def _is_unbounded_label(expr: ast.AST) -> bool:
    """A label VALUE synthesised in the request path: f-strings with at
    least one interpolation, string concatenation / %-formatting,
    ``.format(...)`` calls, or data read off a ``request`` object. Plain
    names, literals and conditionals over them are presumed bounded
    upstream (flagging every Name would bury the real churn)."""
    if isinstance(expr, ast.JoinedStr):
        return any(isinstance(v, ast.FormattedValue) for v in expr.values)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, (ast.Add, ast.Mod)):
        return True
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Attribute) and f.attr == "format":
            return True
    name = dotted_name(expr)
    if name is not None:
        root = name.split(".")[0]
        if root in ("request", "req") and "." in name:
            return True
    return False


@rule(
    "metric-label-churn",
    "Prometheus metric created (or labeled with an unbounded "
    "request-derived value) inside a request-path function",
)
def check_metric_label_churn(ctx: FileContext) -> Iterator[Finding]:
    for fn in async_functions(ctx.tree):
        for node in walk_scope(fn):
            if not isinstance(node, ast.Call):
                continue
            if _is_prom_ctor(node):
                yield ctx.finding(
                    node.lineno,
                    "metric-label-churn",
                    f"prometheus metric constructed inside async "
                    f"'{fn.name}' — a new collector per request grows the "
                    "registry without bound; create it once in "
                    "Metrics.__init__ (mcpx_torch/telemetry/metrics.py)",
                )
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "labels":
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    if _is_unbounded_label(arg):
                        yield ctx.finding(
                            node.lineno,
                            "metric-label-churn",
                            f".labels() value synthesised from request data "
                            f"in async '{fn.name}' — one time series per "
                            "distinct value is unbounded cardinality; label "
                            "by a bounded class (route template, outcome "
                            "enum) instead",
                        )
                        break
