"""`mcpx_torch.cli lint --fix`: mechanical rewrites for findings that are pure
text surgery.

Scope is deliberately narrow — only edits whose correctness is decidable
from the scan itself, with no judgement about the surrounding code:

  - **unused suppressions**: an ``ignore[...]`` id the scan reported as
    ``unused-suppression`` (unknown id, or known id matching no finding
    on its line) is removed from its group; when a group empties, the
    whole comment segment — justification included — goes with it, and a
    line left holding nothing but that comment is deleted.
  - **duplicate suppression ids**: within any group on an edited file,
    repeated ids collapse to the first occurrence (the scanner already
    treats them as one; the text should agree).
  - **blank-line runs**: runs of >= 3 blank lines (the ``blank-lines``
    rule) collapse to two, including runs created by deleting a
    comment-only suppression line.

The rewrite is idempotent: a second ``--fix`` pass over its own output
finds nothing to change. ``--fix --dry-run`` prints the unified diff and
writes nothing; both modes exit 0 (fixing is not a gate — the next plain
lint run is).
"""

from __future__ import annotations

import difflib
import pathlib
import re
import sys
from typing import Iterable, Optional

from mcpx_torch.analysis.core import UNUSED_SUPPRESSION, scan_paths

# One whole suppression-comment segment: the ignore[...] group plus its
# trailing justification, up to (not including) the next '#' or EOL.
_SEG_RE = re.compile(r"#\s*mcpx:\s*ignore\[([a-z0-9_\-, ]+)\]([^#\n]*)")
# Both unused-suppression message forms quote the offending id.
_QUOTED_ID_RE = re.compile(r"'([a-z0-9_\-]+)'")
# The blank-lines rule's pattern, reused as a rewrite.
_BLANK_RUN = re.compile(r"(?:^[ \t]*\n){3,}", re.MULTILINE)


def _rewrite_suppression_line(line: str, remove: set) -> str:
    """Drop ``remove`` ids (and duplicate ids) from every suppression
    group on ``line``; drop a group entirely when no id survives."""

    def _sub(m: "re.Match") -> str:
        kept, seen = [], set()
        for raw in m.group(1).split(","):
            rid = raw.strip()
            if not rid or rid in seen or rid in remove:
                continue
            seen.add(rid)
            kept.append(rid)
        if not kept:
            return ""
        return f"# mcpx: ignore[{','.join(kept)}]{m.group(2)}"

    out = _SEG_RE.sub(_sub, line)
    if not out.strip():
        return ""
    # Removing a trailing segment strands the spaces that preceded it.
    return out.rstrip() if out != line else out


def apply_fixes(
    paths: Iterable,
    *,
    root: pathlib.Path,
    rules: Optional[list] = None,
    project_paths: Optional[list] = None,
    dry_run: bool = False,
    out=None,
) -> int:
    out = out if out is not None else sys.stdout
    result = scan_paths(paths, root=root, rules=rules, project_paths=project_paths)

    # relpath -> {line -> ids to remove}; relpath set needing blank collapse
    dead: dict[str, dict[int, set]] = {}
    blanks: set = set()
    for f in result.findings:
        if f.rule == UNUSED_SUPPRESSION:
            m = _QUOTED_ID_RE.search(f.message)
            if m:
                dead.setdefault(f.path, {}).setdefault(f.line, set()).add(
                    m.group(1)
                )
        elif f.rule == "blank-lines":
            blanks.add(f.path)

    edits = sup_edits = runs = 0
    for rel in sorted(set(dead) | blanks):
        path = root / rel
        text = path.read_text()
        new_lines = []
        for i, line in enumerate(text.splitlines(keepends=True), start=1):
            remove = dead.get(rel, {}).get(i)
            if remove is None and rel not in dead:
                new_lines.append(line)
                continue
            # Files with any dead suppression also get duplicate-id
            # dedupe on every group (remove=set() edits dupes only).
            ends_nl = line.endswith("\n")
            body = _rewrite_suppression_line(
                line.rstrip("\n"), remove or set()
            )
            if body == "" and line.strip():
                if _SEG_RE.search(line):
                    sup_edits += 1
                    continue  # comment-only suppression line: delete it
                body = line.rstrip("\n")
            if body != line.rstrip("\n"):
                sup_edits += 1
            new_lines.append(body + ("\n" if ends_nl else ""))
        new_text = "".join(new_lines)
        if rel in blanks or new_text != text:
            collapsed = _BLANK_RUN.sub("\n\n", new_text)
            if collapsed != new_text:
                runs += 1
            new_text = collapsed
        if new_text == text:
            continue
        edits += 1
        if dry_run:
            diff = difflib.unified_diff(
                text.splitlines(keepends=True),
                new_text.splitlines(keepends=True),
                fromfile=f"a/{rel}",
                tofile=f"b/{rel}",
            )
            out.write("".join(diff))
        else:
            path.write_text(new_text)
    verb = "would rewrite" if dry_run else "rewrote"
    print(
        f"mcpxlint --fix: {verb} {edits} file(s) "
        f"({sup_edits} suppression edit(s), {runs} blank-run collapse(s))",
        file=out,
    )
    return 0
