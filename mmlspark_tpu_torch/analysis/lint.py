"""graftlint's run and CLI: ``python -m mmlspark_tpu_torch.analysis.lint <paths>``.

The port's copy of ``mmlspark_tpu/analysis/lint.py``, with the same
options and exit codes; it lints the port's source with the port's rules.

Two-phase run: parse every file first (so the traced-function index and
the concurrency index see the whole project and cross-module
reachability works — see ``analysis/traced.py`` and
``analysis/lockgraph.py``), then run every rule over every file,
dropping findings the source suppresses per line
(``# graftlint: disable=<rule>``).

Beyond the plain run:

- ``--format sarif`` prints a SARIF 2.1.0 document instead of text, and
  ``--output FILE`` additionally writes SARIF to a file (CI artifact)
  whatever the stdout format;
- ``--check-suppressions`` audits every ``# graftlint: disable=``
  comment and fails on the stale ones (a suppression that no longer
  suppresses anything is a lie waiting to hide a real finding);
- ``--witness-check PATH`` loads runtime lock-witness reports
  (``analysis/witness.py``) and cross-checks observed acquisition
  orders against the static lock graph.

Exit status: 0 when clean, 1 on violations (``--fail-on-violation`` is
accepted for explicitness in CI, it is the default behavior), 2 on usage
or parse errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from mmlspark_tpu_torch.analysis.base import FileContext, Violation, all_rules
from mmlspark_tpu_torch.analysis.traced import TracedIndex

_SKIP_DIRS = {".git", "__pycache__", ".venv", "node_modules", "build"}


def discover_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            out.append(path)
        elif os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
                out.extend(
                    os.path.join(root, f)
                    for f in sorted(files)
                    if f.endswith(".py")
                )
        else:
            raise FileNotFoundError(path)
    return out


def _load_contexts(
    files: Iterable[str],
) -> Tuple[List[FileContext], List[str]]:
    contexts, errors = [], []
    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            contexts.append(FileContext(path, source))
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(f"{path}: {e}")
    return contexts, errors


def _run_rules(
    contexts: List[FileContext],
    select: Optional[Sequence[str]] = None,
    ignore: Sequence[str] = (),
) -> Tuple[List[Violation], List[Violation]]:
    """Run the rule set; returns (violations, suppressed_violations)."""
    rules = all_rules()
    unknown = [
        r for r in list(select or []) + list(ignore) if r not in rules
    ]
    if unknown:
        raise KeyError(f"unknown rule(s): {', '.join(unknown)}")
    active = [
        cls()
        for name, cls in sorted(rules.items())
        if (select is None or name in select) and name not in ignore
    ]
    index = TracedIndex(contexts)
    for ctx in contexts:
        ctx.traced_index = index
    violations: List[Violation] = []
    suppressed: List[Violation] = []
    for ctx in contexts:
        for rule in active:
            for v in rule.check(ctx):
                if ctx.suppressed(v.rule, v.line):
                    suppressed.append(v)
                else:
                    violations.append(v)
    violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return violations, suppressed


def lint_contexts(
    contexts: List[FileContext],
    select: Optional[Sequence[str]] = None,
    ignore: Sequence[str] = (),
) -> Tuple[List[Violation], int]:
    """Run the rule set; returns (violations, suppressed_count)."""
    violations, suppressed = _run_rules(contexts, select, ignore)
    return violations, len(suppressed)


def lint_paths(
    paths: Sequence[str],
    select: Optional[Sequence[str]] = None,
    ignore: Sequence[str] = (),
) -> Tuple[List[Violation], int, List[str]]:
    """Lint files/directories; returns (violations, suppressed, errors)."""
    contexts, errors = _load_contexts(discover_files(paths))
    violations, suppressed = lint_contexts(contexts, select, ignore)
    return violations, suppressed, errors


def lint_source(
    source: str,
    path: str = "<string>",
    select: Optional[Sequence[str]] = None,
) -> List[Violation]:
    """Lint one in-memory source string (tests / tooling)."""
    violations, _ = lint_contexts([FileContext(path, source)], select)
    return violations


def stale_suppressions(
    contexts: List[FileContext], suppressed: List[Violation]
) -> List[str]:
    """``path:line: ...`` report lines for every ``# graftlint:
    disable=`` entry that suppressed nothing in this run (run the full
    rule set: a suppression is only provably stale against every rule).
    """
    consumed: Dict[Tuple[str, int], Set[str]] = {}
    for v in suppressed:
        consumed.setdefault((v.path, v.line), set()).add(v.rule)
    known = set(all_rules())
    out: List[str] = []
    for ctx in contexts:
        for line, names in sorted(ctx.suppressions.items()):
            used = consumed.get((ctx.path, line), set())
            for name in sorted(names):
                if name == "*":
                    if not used:
                        out.append(
                            f"{ctx.path}:{line}: stale blanket suppression "
                            "(# graftlint: disable) — no rule fires here"
                        )
                elif name not in known:
                    out.append(
                        f"{ctx.path}:{line}: suppression names unknown "
                        f"rule '{name}'"
                    )
                elif name not in used:
                    out.append(
                        f"{ctx.path}:{line}: stale suppression '{name}' — "
                        "the rule no longer fires here"
                    )
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mmlspark_tpu_torch.analysis.lint",
        description="graftlint: framework-aware static analysis "
        "(docs/static_analysis.md)",
    )
    parser.add_argument("paths", nargs="*", help="files or directories")
    parser.add_argument(
        "--fail-on-violation",
        action="store_true",
        help="exit 1 on violations (the default; accepted for explicit CI "
        "wiring)",
    )
    parser.add_argument(
        "--select", action="append", default=None, metavar="RULE",
        help="run only the named rule (repeatable)",
    )
    parser.add_argument(
        "--ignore", action="append", default=[], metavar="RULE",
        help="skip the named rule (repeatable)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    parser.add_argument(
        "--format", choices=("text", "sarif"), default="text",
        help="stdout format: human text (default) or a SARIF 2.1.0 "
        "document",
    )
    parser.add_argument(
        "--output", metavar="FILE", default=None,
        help="additionally write SARIF to FILE (CI artifact), whatever "
        "the stdout format",
    )
    parser.add_argument(
        "--check-suppressions", action="store_true",
        help="audit # graftlint: disable= comments; exit 1 when any no "
        "longer suppresses a finding (requires the full rule set)",
    )
    parser.add_argument(
        "--witness-check", action="append", default=[], metavar="PATH",
        help="lock-witness report file/directory (MMLSPARK_TPU_LOCKCHECK "
        "dumps); cross-checks observed lock orders against the static "
        "lock graph (repeatable)",
    )
    parser.add_argument(
        "-q", "--quiet", action="store_true",
        help="print only the summary line",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for name, cls in sorted(all_rules().items()):
            print(f"{name}: {cls.description}")
        return 0
    if not args.paths:
        parser.print_usage(sys.stderr)
        return 2
    if args.check_suppressions and (args.select or args.ignore):
        print(
            "graftlint: --check-suppressions needs the full rule set; "
            "drop --select/--ignore",
            file=sys.stderr,
        )
        return 2

    try:
        contexts, errors = _load_contexts(discover_files(args.paths))
        violations, suppressed = _run_rules(
            contexts, select=args.select, ignore=args.ignore
        )
    except (FileNotFoundError, KeyError) as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2

    extra_rules = None
    if args.witness_check:
        from mmlspark_tpu_torch.analysis.witness import (
            WITNESS_RULE,
            WITNESS_RULE_DESCRIPTION,
            check_witness,
            load_reports,
        )

        try:
            reports = load_reports(args.witness_check)
        except (OSError, ValueError) as e:
            print(f"graftlint: witness report: {e}", file=sys.stderr)
            return 2
        witness_violations = check_witness(reports, contexts)
        violations.extend(witness_violations)
        violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
        extra_rules = {WITNESS_RULE: WITNESS_RULE_DESCRIPTION}
        print(
            f"graftlint: witness: {len(reports)} report(s), "
            f"{len(witness_violations)} inconsistenc"
            + ("y" if len(witness_violations) == 1 else "ies"),
            file=sys.stderr,
        )

    stale: List[str] = []
    if args.check_suppressions:
        stale = stale_suppressions(contexts, suppressed)

    for err in errors:
        print(f"graftlint: parse error: {err}", file=sys.stderr)

    if args.output or args.format == "sarif":
        from mmlspark_tpu_torch.analysis.sarif import to_sarif

        doc = to_sarif(violations, extra_rules=extra_rules)
        if args.output:
            with open(args.output, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, indent=2, sort_keys=True)
                fh.write("\n")
        if args.format == "sarif":
            json.dump(doc, sys.stdout, indent=2, sort_keys=True)
            sys.stdout.write("\n")

    if args.format == "text" and not args.quiet:
        for v in violations:
            print(v.render())
    for line in stale:
        print(line)
    note = f", {len(suppressed)} suppressed" if suppressed else ""
    stale_note = f", {len(stale)} stale suppression(s)" if stale else ""
    summary = (
        f"graftlint: {len(violations)} violation(s){note}{stale_note}"
        + (f", {len(errors)} parse error(s)" if errors else "")
    )
    print(summary, file=sys.stderr if args.format == "sarif" else sys.stdout)
    if errors:
        return 2
    return 1 if (violations or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
