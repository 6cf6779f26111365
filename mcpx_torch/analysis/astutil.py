"""Dependency-free AST primitives shared by the analysis core (call graph,
dataflow, project index) and the rule modules. Lives outside the
``rules`` package so the interprocedural core can import it without
triggering ``rules/__init__``'s rule registration (which imports the core
right back)."""

from __future__ import annotations

import ast
from typing import Optional

# Spellings under which a CUDA-graph capture appears in the port: the
# ``with torch.cuda.graph(g, ...)`` context, the graph object itself (its
# ``capture_begin()``/``capture_end()`` pair) and the whole-callable form.
CAPTURE_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph", "cuda.graph"}
GRAPH_CLASSES = {"torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph"}
GRAPHED_CALLABLES = {
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
    "make_graphed_callables",
}


def walk(node: ast.AST) -> list:
    """``list(ast.walk(node))``, in the same order, computed once per node
    and kept on it: every rule walks the same function bodies, and a
    scan's passes walk them many times over."""
    try:
        return node._mcpx_walk  # type: ignore[attr-defined]
    except AttributeError:
        nodes = list(ast.walk(node))
        node._mcpx_walk = nodes  # type: ignore[attr-defined]
        return nodes


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains (``self.x`` -> "self.x"); None
    for anything rooted elsewhere (calls, subscripts, literals)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)
