"""SARIF 2.1.0 rendering of mcpxlint findings.

One static schema (the subset every SARIF consumer reads): a single run,
the registered rules as ``tool.driver.rules`` (ids + short descriptions),
each finding as a ``result`` with a file/line location. Root-relative
POSIX paths go out verbatim as artifact URIs, so GitHub code scanning /
editor SARIF viewers anchor findings without a path map. Deterministic by
construction — no timestamps, no absolute paths — which is what the
golden-file test locks in.
"""

from __future__ import annotations

from typing import Iterable

from mcpx_torch.analysis.core import (
    PARSE_ERROR,
    UNUSED_SUPPRESSION,
    Finding,
    all_rules,
)

SARIF_VERSION = "2.1.0"
_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)
# Engine-internal ids that can appear in findings without a Rule object.
_INTERNAL_SUMMARIES = {
    PARSE_ERROR: "file could not be parsed by the AST rules",
    UNUSED_SUPPRESSION: "suppression comment matches no finding",
}


def to_sarif(findings: Iterable[Finding]) -> dict:
    findings = list(findings)
    registry = all_rules()
    used_ids = sorted({f.rule for f in findings})
    rules_meta = []
    for rid in used_ids:
        summary = (
            registry[rid].summary
            if rid in registry
            else _INTERNAL_SUMMARIES.get(rid, rid)
        )
        rules_meta.append(
            {
                "id": rid,
                "shortDescription": {"text": summary},
                "defaultConfiguration": {"level": "warning"},
            }
        )
    rule_index = {rid: i for i, rid in enumerate(used_ids)}
    results = [
        {
            "ruleId": f.rule,
            "ruleIndex": rule_index[f.rule],
            "level": "warning",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path,
                            "uriBaseId": "SRCROOT",
                        },
                        "region": {"startLine": f.line},
                    }
                }
            ],
        }
        for f in findings
    ]
    return {
        "$schema": _SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "mcpxlint",
                        "informationUri": "mcpx_torch/analysis/README.md",
                        "rules": rules_meta,
                    }
                },
                "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
                "results": results,
            }
        ],
    }
