"""Committed-baseline handling for mcpxlint.

The baseline grandfathers known findings so the analyzer can gate CI from
day one: ``mcpx_torch.cli lint`` fails only on findings *not* in the baseline, and on
baseline entries that no longer match anything (stale entries must be
deleted, not accumulated — the burn-down is monotone).

Entries match findings by (path, rule, line); the message is stored for
human readers of the JSON file but ignored when matching, so rewording a
rule's message never invalidates a baseline.
"""

from __future__ import annotations

import json
import pathlib
from collections import Counter
from typing import Iterable

from mcpx_torch.analysis.core import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = "mcpx_torch/analysis/baseline.json"


def load_baseline(path: pathlib.Path) -> list[dict]:
    """Entries from ``path``; a missing file is an empty baseline."""
    path = pathlib.Path(path)
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    if not isinstance(data, dict) or not isinstance(data.get("entries"), list):
        raise ValueError(f"malformed baseline file {path}: expected {{'entries': [...]}}")
    for e in data["entries"]:
        if not {"path", "rule", "line"} <= set(e):
            raise ValueError(f"malformed baseline entry in {path}: {e!r}")
    return data["entries"]


def save_baseline(
    path: pathlib.Path, findings: Iterable[Finding], *, keep: Iterable[dict] = ()
) -> None:
    """Write findings as entries; ``keep`` carries pre-existing entries to
    preserve verbatim (rules excluded from a filtered ``--update-baseline``)."""
    entries = [
        {"path": f.path, "line": f.line, "rule": f.rule, "message": f.message}
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    ] + list(keep)
    entries.sort(key=lambda e: (e["path"], int(e["line"]), e["rule"]))
    pathlib.Path(path).write_text(
        json.dumps({"version": BASELINE_VERSION, "entries": entries}, indent=2) + "\n"
    )


def apply_baseline(
    findings: list[Finding], entries: list[dict]
) -> tuple[list[Finding], int, list[dict]]:
    """Split findings against the baseline.

    Returns ``(new_findings, n_baselined, stale_entries)``: findings not
    covered by any entry, the count that were, and entries that matched no
    current finding. Duplicate keys (two findings of one rule on one line)
    are matched by multiplicity.
    """
    budget = Counter((e["path"], e["rule"], int(e["line"])) for e in entries)
    new: list[Finding] = []
    baselined = 0
    for f in findings:
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
            baselined += 1
        else:
            new.append(f)
    stale: list[dict] = []
    for e in entries:
        k = (e["path"], e["rule"], int(e["line"]))
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            stale.append(e)
    return new, baselined, stale
