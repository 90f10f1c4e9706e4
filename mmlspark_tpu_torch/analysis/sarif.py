"""SARIF 2.1.0 serialization of graftlint findings.

The port's copy of ``mmlspark_tpu/analysis/sarif.py``: the tool is still
``graftlint``, and the catalog is the port's rule set.

The shape CI annotators consume (GitHub code scanning, sarif-tools):
one run, one tool (``graftlint``), a rule catalog restricted to the
rules that actually fired plus anything the caller passes, and one
result per violation with a physical location. Deliberately minimal —
no fixes, no code flows — so the document stays diffable in CI
artifacts.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from mmlspark_tpu_torch.analysis.base import Violation, all_rules

_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def to_sarif(
    violations: Iterable[Violation],
    tool_version: str = "2.0",
    extra_rules: Optional[Dict[str, str]] = None,
) -> dict:
    """SARIF document (as a plain dict) for one lint run."""
    violations = list(violations)
    catalog = {name: cls.description for name, cls in all_rules().items()}
    if extra_rules:
        catalog.update(extra_rules)
    fired = sorted({v.rule for v in violations})
    rules: List[dict] = [
        {
            "id": rule,
            "shortDescription": {
                "text": catalog.get(rule, rule).split(". ")[0]
            },
            "fullDescription": {"text": catalog.get(rule, rule)},
        }
        for rule in fired
    ]
    rule_index = {rule: i for i, rule in enumerate(fired)}
    results = [
        {
            "ruleId": v.rule,
            "ruleIndex": rule_index[v.rule],
            "level": "error",
            "message": {"text": v.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": v.path.replace("\\", "/"),
                        },
                        "region": {
                            "startLine": max(v.line, 1),
                            "startColumn": v.col + 1,
                        },
                    }
                }
            ],
        }
        for v in violations
    ]
    return {
        "$schema": _SCHEMA,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "graftlint",
                        "informationUri": "docs/static_analysis.md",
                        "version": tool_version,
                        "rules": rules,
                    }
                },
                "results": results,
            }
        ],
    }
