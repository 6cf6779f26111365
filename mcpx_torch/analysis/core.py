"""mcpxlint core: findings, the rule registry, per-line suppressions and
the scan engine.

mcpxlint is a static analyzer for the two regimes where this codebase's
silent bugs live: the asyncio control plane (blocking calls in coroutines,
unlocked shared-state writes across awaits) and the CUDA engine
(host-device syncs inside CUDA-graph captures and dispatch loops, request
values reaching capture keys, tensors a captured graph reads rebound). Rules register themselves via :func:`rule`
at one of two scopes:

  - ``scope="file"`` (default): the engine parses each file once and hands
    the rule a :class:`FileContext` per file — single-function pattern
    rules live here.
  - ``scope="project"``: the rule runs ONCE per scan over a
    :class:`~mcpx_torch.analysis.project.ProjectContext` holding every parsed
    file plus the shared interprocedural structure (symbol index, call
    graph, taint engine) — the thread-ownership and jit-contract passes,
    and any rule whose evidence crosses function or module boundaries.

Findings from both scopes funnel through the same per-line
``# mcpx: ignore[<rule-id>]`` suppression machinery and the committed
baseline.

Suppression grammar (same line as the finding, trailing comment; the
placeholder below uses angle brackets precisely so it does NOT parse as a
suppression — matching is textual, docstrings included, and an id that
names no registered rule is itself reported)::

    risky_call()  # mcpx: ignore[<rule-id>] - one-line justification

Unused suppressions are themselves findings (``unused-suppression``) so the
tree can't accumulate dead annotations; a suppression naming an id that is
not a registered rule at all (a typo'd ``ignore[asnyc-blocking]`` would
otherwise silently stop guarding anything) is reported the same way
regardless of which rules were selected for the run.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
import time
from typing import Callable, Iterable, Optional

_SUPPRESS_RE = re.compile(r"#\s*mcpx:\s*ignore\[([a-z0-9_\-, ]+)\]")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit. ``path`` is root-relative posix."""

    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    @property
    def key(self) -> tuple[str, str, int]:
        return (self.path, self.rule, self.line)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FileContext:
    """Everything a rule may look at for one file: raw text, split lines and
    a lazily-parsed AST (one parse shared by every AST rule)."""

    def __init__(self, path: pathlib.Path, relpath: str, text: str) -> None:
        self.path = path
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self._tree: Optional[ast.Module] = None
        self.parse_error: Optional[str] = None
        self._parsed = False
        # Cross-rule memo (e.g. capture-scope discovery, shared by the torch
        # rules) — same lifetime as the parsed tree.
        self.cache: dict = {}
        # Dotted module name, filled in by the project index.
        self.module: Optional[str] = None

    @property
    def tree(self) -> Optional[ast.Module]:
        if not self._parsed:
            self._parsed = True
            try:
                self._tree = ast.parse(self.text)
            except SyntaxError as e:
                self.parse_error = f"{e.msg} (line {e.lineno})"
        return self._tree

    def finding(self, line: int, rule_id: str, message: str) -> Finding:
        return Finding(path=self.relpath, line=line, rule=rule_id, message=message)

    def suppressions(self) -> dict[int, set[str]]:
        """line -> rule ids suppressed on that line. Every ``ignore[...]``
        group on the line contributes (two comments on one line merge) and
        duplicate ids within a group dedupe to one."""
        out: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            ids: set[str] = set()
            for m in _SUPPRESS_RE.finditer(line):
                ids.update(r.strip() for r in m.group(1).split(",") if r.strip())
            if ids:
                out[i] = ids
        return out


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    check: Callable[..., Iterable[Finding]]
    needs_ast: bool = True
    scope: str = "file"  # "file" | "project"


_REGISTRY: dict[str, Rule] = {}


def rule(rule_id: str, summary: str, *, needs_ast: bool = True, scope: str = "file"):
    """Register an analyzer rule. File-scope checkers receive a
    :class:`FileContext` per file; project-scope checkers receive one
    :class:`~mcpx_torch.analysis.project.ProjectContext` per scan. Both yield
    :class:`Finding`s."""
    if scope not in ("file", "project"):
        raise ValueError(f"unknown rule scope {scope!r}")

    def deco(fn: Callable[..., Iterable[Finding]]):
        if rule_id in _REGISTRY:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        _REGISTRY[rule_id] = Rule(rule_id, summary, fn, needs_ast=needs_ast, scope=scope)
        return fn

    return deco


# Engine-internal rule ids (not callables, but documented and reportable).
PARSE_ERROR = "parse-error"
UNUSED_SUPPRESSION = "unused-suppression"

# Reference rule ids with no counterpart in the port, and why: asking for
# one is a usage error that says so.
NO_COUNTERPART = {
    "traced-control-flow": (
        "eager PyTorch has no tracer, and a Python branch on a tensor inside "
        "a CUDA-graph capture is a host sync, which 'jit-host-sync' flags"
    ),
}


def all_rules() -> dict[str, Rule]:
    _load_builtin_rules()
    return dict(_REGISTRY)


def _load_builtin_rules() -> None:
    # Deferred so `import mcpx_torch.analysis.core` never cycles with rule modules.
    from mcpx_torch.analysis import rules  # noqa: F401


@dataclasses.dataclass
class ScanResult:
    findings: list[Finding]          # after suppression, before baseline
    suppressed: int
    files_scanned: int
    duration_s: float
    counts_by_rule: dict[str, int] = dataclasses.field(default_factory=dict)
    # Per-rule wall time (seconds) — project-scope rules pay once per scan,
    # file-scope rules accumulate over files. The lint-time budget test
    # reads this so an interprocedural pass can't silently blow up tier-1.
    rule_wall_s: dict[str, float] = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        """Machine-readable run telemetry (mirrored into --format json)."""
        return {
            "files_scanned": self.files_scanned,
            "findings": len(self.findings),
            "suppressed": self.suppressed,
            "duration_s": round(self.duration_s, 3),
            "counts_by_rule": dict(sorted(self.counts_by_rule.items())),
            "rule_wall_s": {
                k: round(v, 4) for k, v in sorted(self.rule_wall_s.items())
            },
        }


def iter_py_files(paths: Iterable[pathlib.Path]) -> list[pathlib.Path]:
    out: set[pathlib.Path] = set()
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            out.update(p.rglob("*.py"))
        elif p.suffix == ".py":
            out.add(p)
    return sorted(out)


def _relpath(path: pathlib.Path, root: pathlib.Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def scan_paths(
    paths: Iterable[pathlib.Path],
    *,
    root: Optional[pathlib.Path] = None,
    rules: Optional[Iterable[str]] = None,
    project_paths: Optional[Iterable[pathlib.Path]] = None,
) -> ScanResult:
    """Run the selected rules (default: all registered) over every ``*.py``
    under ``paths``. Findings carry ``root``-relative paths.

    ``project_paths`` widens the *context* without widening the *report*:
    project-scope rules build their call graph / dataflow over the union
    of both path sets, but findings are only reported for files under
    ``paths`` — how ``lint --changed`` keeps whole-program precision
    while gating only the diff.
    """
    registry = all_rules()
    if rules is not None:
        rules = list(rules)  # may be a one-shot iterator; it's read twice
        unknown = sorted(set(rules) - set(registry))
        for rid in unknown:
            if rid in NO_COUNTERPART:
                raise ValueError(f"rule '{rid}' has no counterpart in the port: {NO_COUNTERPART[rid]}")
        if unknown:
            raise ValueError(f"unknown rule id(s): {', '.join(unknown)}")
        registry = {k: registry[k] for k in rules}
    root = pathlib.Path(root) if root is not None else pathlib.Path.cwd()
    t0 = time.monotonic()
    files = iter_py_files(paths)
    context_files = files
    if project_paths is not None:
        context_files = sorted(set(files) | set(iter_py_files(project_paths)))
    contexts = [
        FileContext(p, _relpath(p, root), p.read_text()) for p in context_files
    ]
    by_rel = {c.relpath: c for c in contexts}
    report = [by_rel[_relpath(p, root)] for p in files]
    report_set = {c.relpath for c in report}

    file_rules = [r for r in registry.values() if r.scope == "file"]
    project_rules = [r for r in registry.values() if r.scope == "project"]
    need_ast = any(r.needs_ast for r in registry.values())

    raw_by_path: dict[str, list[Finding]] = {c.relpath: [] for c in report}
    wall: dict[str, float] = {}
    for ctx in report:
        for r in file_rules:
            if r.needs_ast and ctx.tree is None:
                continue
            rt0 = time.monotonic()
            raw_by_path[ctx.relpath].extend(r.check(ctx))
            wall[r.id] = wall.get(r.id, 0.0) + (time.monotonic() - rt0)
        if ctx.parse_error is not None and need_ast:
            raw_by_path[ctx.relpath].append(
                ctx.finding(1, PARSE_ERROR, f"cannot parse: {ctx.parse_error}")
            )
    if project_rules:
        from mcpx_torch.analysis.project import ProjectContext

        project = ProjectContext(contexts, root)
        for r in project_rules:
            rt0 = time.monotonic()
            for f in r.check(project):
                if f.path in report_set:
                    raw_by_path[f.path].append(f)
            wall[r.id] = wall.get(r.id, 0.0) + (time.monotonic() - rt0)

    known_ids = set(all_rules()) | {PARSE_ERROR, UNUSED_SUPPRESSION}
    active: list[Finding] = []
    suppressed = 0
    counts: dict[str, int] = {}

    def emit(f: Finding) -> None:
        active.append(f)
        counts[f.rule] = counts.get(f.rule, 0) + 1

    for ctx in report:
        raw = raw_by_path[ctx.relpath]
        sup = ctx.suppressions()
        used: set[tuple[int, str]] = set()
        for f in sorted(set(raw), key=lambda f: (f.line, f.rule, f.message)):
            ids = sup.get(f.line, ())
            if f.rule in ids:
                suppressed += 1
                used.add((f.line, f.rule))
            else:
                emit(f)
        for line, ids in sorted(sup.items()):
            for rid in sorted(ids):
                if rid not in known_ids:
                    # A typo'd id guards nothing and must never pass
                    # silently — reported regardless of rule selection.
                    emit(
                        ctx.finding(
                            line,
                            UNUSED_SUPPRESSION,
                            f"suppression names unknown rule id '{rid}' "
                            "(typo?) — it can never match a finding",
                        )
                    )
                elif rid in registry and (line, rid) not in used:
                    # Known ids are judged only against rules that actually
                    # ran: a blank-lines-only pass must not report every
                    # broad-except annotation in the tree as unused.
                    emit(
                        ctx.finding(
                            line,
                            UNUSED_SUPPRESSION,
                            f"suppression for '{rid}' matches no finding on this line",
                        )
                    )
    active.sort(key=lambda f: (f.path, f.line, f.rule))
    return ScanResult(
        findings=active,
        suppressed=suppressed,
        files_scanned=len(report),
        duration_s=time.monotonic() - t0,
        counts_by_rule=counts,
        rule_wall_s=wall,
    )
