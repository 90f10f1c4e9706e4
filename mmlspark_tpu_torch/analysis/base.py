"""graftlint rule plumbing: violations, per-file context, rule registry.

The port's copy of ``mmlspark_tpu/analysis/base.py``, with the same logic.

A rule is a class with a ``name``, a ``description``, and a
``check(ctx) -> Iterator[Violation]``. Rules self-register via
:func:`register_rule` (the same registry-by-declaration idiom as the stage
registry in ``core/params.py``), so adding a rule is: subclass
:class:`Rule` in ``rules.py``, decorate, done — the CLI and the tests pick
it up automatically.

Suppression is per line: ``# graftlint: disable=<rule>[,<rule>]`` on the
offending line (or the line a multi-line statement starts on) silences the
named rules; a bare ``# graftlint: disable`` silences all of them. Each
rule may additionally honor domain noqa codes (the bare-except rule
accepts ``# noqa: BLE001``).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from typing import Dict, Iterator, List, Optional, Set, Type

_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*disable(?:=([\w\-, ]+))?")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: rule id, location, and a human-actionable message."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class FileContext:
    """Parsed view of one source file shared by every rule."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.suppressions = self._parse_suppressions(source)

    @staticmethod
    def _parse_suppressions(source: str) -> Dict[int, Set[str]]:
        # Tokenize so only genuine comments count: docstrings or string
        # literals that merely *mention* the disable syntax must neither
        # silence findings on their line nor show up as stale suppressions.
        out: Dict[int, Set[str]] = {}
        try:
            tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
        except (tokenize.TokenError, IndentationError):
            return out
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            names = m.group(1)
            i = tok.start[0]
            if names is None:
                out[i] = {"*"}
            else:
                out[i] = {n.strip() for n in names.split(",") if n.strip()}
        return out

    def suppressed(self, rule: str, line: int) -> bool:
        names = self.suppressions.get(line)
        return bool(names) and ("*" in names or rule in names)

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


class Rule:
    """Base of all graftlint rules."""

    name: str = ""
    description: str = ""

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        raise NotImplementedError

    def violation(
        self, ctx: FileContext, node: ast.AST, message: str
    ) -> Violation:
        return Violation(
            rule=self.name,
            path=ctx.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


_RULE_REGISTRY: Dict[str, Type[Rule]] = {}


def register_rule(cls: Type[Rule]) -> Type[Rule]:
    if not cls.name:
        raise ValueError(f"rule {cls.__name__} must declare a name")
    _RULE_REGISTRY[cls.name] = cls
    return cls


def all_rules() -> Dict[str, Type[Rule]]:
    # Imports trigger registration of the builtin rule set.
    from mmlspark_tpu_torch.analysis import concurrency as _concurrency  # noqa: F401
    from mmlspark_tpu_torch.analysis import rules as _rules  # noqa: F401

    return dict(_RULE_REGISTRY)


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.nn.functional.relu`` for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def module_int_constants(tree: ast.Module) -> Dict[str, int]:
    """Module-level ``NAME = <int literal>`` bindings (tile-size constants
    like ``_LANE = 128``), including simple aliases of earlier constants."""
    consts: Dict[str, int] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        value = _resolve_int(node.value, consts)
        if value is not None:
            consts[target.id] = value
    return consts


def _resolve_int(node: ast.AST, env: Dict[str, int]) -> Optional[int]:
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.Mult, ast.Add, ast.Sub, ast.FloorDiv)
    ):
        lhs = _resolve_int(node.left, env)
        rhs = _resolve_int(node.right, env)
        if lhs is None or rhs is None:
            return None
        if isinstance(node.op, ast.Mult):
            return lhs * rhs
        if isinstance(node.op, ast.Add):
            return lhs + rhs
        if isinstance(node.op, ast.Sub):
            return lhs - rhs
        return lhs // rhs if rhs else None
    return None


def local_int_constants(
    func: ast.AST, module_consts: Dict[str, int]
) -> Dict[str, int]:
    """Function-local single-assignment int bindings layered over the
    module constants (resolves ``tn = _N_ALIGN`` inside a kernel builder)."""
    env = dict(module_consts)
    assigned_twice: Set[str] = set()
    for node in ast.walk(func):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        if target.id in assigned_twice:
            env.pop(target.id, None)
            continue
        value = _resolve_int(node.value, env)
        if target.id in env and env.get(target.id) != value:
            assigned_twice.add(target.id)
            env.pop(target.id, None)
            continue
        if value is not None:
            env[target.id] = value
        assigned_twice.add(target.id)
    return env


def resolve_int(node: ast.AST, env: Dict[str, int]) -> Optional[int]:
    return _resolve_int(node, env)
