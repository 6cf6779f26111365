"""`mcpx_torch.cli lint` driver: scan, diff against the committed baseline, report.

Exit codes: 0 = clean (every finding suppressed or baselined, no stale
baseline entries); 1 = new findings and/or stale entries; 2 = usage error.
``--format json`` emits one machine-readable object (findings + run
telemetry, per-rule wall time included) for CI and dashboards;
``--format sarif`` emits SARIF 2.1.0 for code-scanning/editor tooling;
text mode prints one ``path:line rule-id message`` per finding.

``--changed`` scopes *reporting* to files touched in the working tree
(``git diff HEAD`` + untracked), while the interprocedural passes still
build their call graph over the full path set — diff-speed feedback,
whole-program precision.

``--fix`` rewrites the mechanical findings in place (unused/duplicate
suppression ids, blank-line runs — see mcpx_torch/analysis/fix.py);
``--fix --dry-run`` prints the unified diff instead. Both exit 0.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
from typing import Iterable, Optional

from mcpx_torch.analysis.baseline import (
    DEFAULT_BASELINE,
    apply_baseline,
    load_baseline,
    save_baseline,
)
from mcpx_torch.analysis.core import scan_paths


def changed_files(root: pathlib.Path) -> list[pathlib.Path]:
    """Working-tree ``*.py`` files that differ from HEAD (staged, unstaged
    or untracked). Raises RuntimeError when git is unavailable.

    Both listings print ``root``-relative paths: ``ls-files`` is
    cwd-relative by default and ``diff`` needs ``--relative`` (it prints
    repo-toplevel-relative otherwise, which joins to the wrong base
    whenever ``root`` is a subdirectory of the repository)."""
    out: set[pathlib.Path] = set()
    for args in (
        ["git", "diff", "--relative", "--name-only", "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                args, cwd=root, capture_output=True, text=True, check=True,
                timeout=30,
            )
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"cannot enumerate changed files: {e}") from e
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line.endswith(".py"):
                p = root / line
                if p.exists():
                    out.add(p)
    return sorted(out)


def run_lint(
    paths: Iterable[str],
    *,
    baseline: str = DEFAULT_BASELINE,
    update_baseline: bool = False,
    fmt: str = "text",
    rules: Optional[Iterable[str]] = None,
    root: Optional[str] = None,
    changed: bool = False,
    fix: bool = False,
    fix_dry_run: bool = False,
    out=None,
) -> int:
    out = out if out is not None else sys.stdout
    root_path = pathlib.Path(root) if root else pathlib.Path.cwd()
    if rules is not None:
        rules = list(rules)
    scan_targets = [pathlib.Path(p) for p in paths]
    project_paths = None
    changed_set: Optional[set] = None  # report-scope relpaths under --changed
    if changed:
        try:
            touched = changed_files(root_path)
        except RuntimeError as e:
            print(f"mcpxlint: error: {e}", file=out)
            return 2
        roots = [p.resolve() for p in scan_targets]
        selected = [
            t for t in touched
            if any(
                t.resolve() == r or r in t.resolve().parents for r in roots
            )
        ]
        if not selected:
            print(
                "mcpxlint: --changed: no modified .py files under the given "
                "paths; nothing to lint",
                file=out,
            )
            return 0
        project_paths = scan_targets  # full-tree context for the call graph
        scan_targets = selected
        from mcpx_torch.analysis.core import _relpath

        changed_set = {_relpath(p, root_path) for p in selected}
    if fix:
        from mcpx_torch.analysis.fix import apply_fixes

        try:
            return apply_fixes(
                scan_targets,
                root=root_path,
                rules=list(rules) if rules is not None else None,
                project_paths=project_paths,
                dry_run=fix_dry_run,
                out=out,
            )
        except ValueError as e:  # unknown --rule id, same contract as below
            print(f"mcpxlint: error: {e}", file=out)
            return 2
    try:
        result = scan_paths(
            scan_targets,
            root=root_path,
            rules=rules,
            project_paths=project_paths,
        )
    except ValueError as e:  # unknown --rule id: a usage error, not a crash
        print(f"mcpxlint: error: {e}", file=out)
        return 2
    baseline_path = pathlib.Path(baseline)
    if not baseline_path.is_absolute():
        baseline_path = root_path / baseline_path
    def _load_entries():
        # Malformed/truncated baseline JSON is a usage error, not a crash:
        # same exit-2 contract as an unknown --rule id.
        try:
            return load_baseline(baseline_path)
        except (ValueError, OSError) as e:
            print(f"mcpxlint: error: cannot read baseline: {e}", file=out)
            return None

    if update_baseline:
        keep: list = []
        if rules is not None or changed_set is not None:
            # A scoped pass only re-baselines what it actually scanned: a
            # --rule run preserves other rules' grandfathered entries, a
            # --changed run preserves entries for files outside the diff —
            # neither gets silently wiped.
            selected = set(rules) if rules is not None else None
            entries = _load_entries()
            if entries is None:
                return 2
            keep = [
                e
                for e in entries
                if (selected is not None and e["rule"] not in selected)
                or (changed_set is not None and e["path"] not in changed_set)
            ]
        n = len(result.findings) + len(keep)
        save_baseline(baseline_path, result.findings, keep=keep)
        print(
            f"mcpxlint: wrote {n} entr{'y' if n == 1 else 'ies'} to {baseline_path}",
            file=out,
        )
        return 0
    baseline_missing = not baseline_path.exists()
    entries = _load_entries()
    if entries is None:
        return 2
    if rules is not None:
        # Same guard the suppression engine applies: baseline entries are
        # judged only against rules that actually ran, or a --rule pass
        # would report every other rule's grandfathered entry as stale.
        selected = set(rules)
        entries = [e for e in entries if e["rule"] in selected]
    if changed_set is not None:
        # And only against files that were actually scanned: a --changed
        # run must not call an untouched file's entry stale.
        entries = [e for e in entries if e["path"] in changed_set]
    new, baselined, stale = apply_baseline(result.findings, entries)

    if fmt == "json":
        payload = {
            **result.summary(),
            "new": [f.to_dict() for f in new],
            "baselined": baselined,
            "stale_baseline": stale,
            "baseline_missing": baseline_missing,
            "exit": 1 if (new or stale) else 0,
        }
        print(json.dumps(payload, indent=2), file=out)
    elif fmt == "sarif":
        from mcpx_torch.analysis.sarif import to_sarif

        print(json.dumps(to_sarif(new), indent=2), file=out)
    else:
        for f in new:
            print(f.render(), file=out)
        for e in stale:
            print(
                f"{e['path']}:{e['line']} stale-baseline baseline entry for "
                f"'{e['rule']}' matches no current finding — delete it "
                f"from {baseline_path.name}",
                file=out,
            )
        if baseline_missing:
            # Loud, not fatal: a fresh project legitimately has no baseline,
            # but a wrong cwd or mistyped --baseline silently dropping every
            # grandfathered entry must be visible in the report.
            print(
                f"mcpxlint: note: baseline {baseline_path} not found; "
                "treating as empty (run from the repo root, or pass "
                "--baseline)",
                file=out,
            )
        counts = ", ".join(
            f"{k}={v}" for k, v in sorted(result.counts_by_rule.items())
        )
        print(
            f"mcpxlint: {len(new)} new finding(s), {baselined} baselined, "
            f"{result.suppressed} suppressed, {len(stale)} stale baseline "
            f"entr{'y' if len(stale) == 1 else 'ies'} across "
            f"{result.files_scanned} files in {result.duration_s:.2f}s"
            + (f" [{counts}]" if counts else ""),
            file=out,
        )
    return 1 if (new or stale) else 0
