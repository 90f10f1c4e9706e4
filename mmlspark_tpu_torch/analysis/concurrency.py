"""graftlint v2: concurrency & distributed-protocol rules.

The port's copy of ``mmlspark_tpu/analysis/concurrency.py``: the eight
rules are unchanged, and their path parts (``runtime/``, ``serving/``,
``streaming/``, ``dataguard/`` and the rest) are directory names the port
shares.

Four families on top of the whole-program model in ``lockgraph.py``
(catalog and semantics in docs/static_analysis.md):

- lock order: ``lock-order`` (ABBA cycles in the acquisition graph),
  ``lock-blocking`` (a call made while a lock is held transitively
  reaches sleep/join/socket/HTTP/queue waits — the interprocedural
  extension of ``lock-discipline``);
- collective consistency: ``collective-deadline`` (gang waits must be
  deadline-bounded), ``collective-rank-branch`` (a collective under a
  rank/member-dependent conditional is a static gang deadlock);
- protocol ordering: ``wal-before-commit``, ``journal-before-store``,
  ``tmp-rename-atomicity``, ``onset-recovery-pairing``.

All findings honor the per-line ``# graftlint: disable=<rule>``
suppressions; whole-program findings (cycles) anchor at their smallest
edge site so a suppression has one well-defined home.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from mmlspark_tpu_torch.analysis.base import (
    FileContext,
    Rule,
    Violation,
    dotted_name,
    register_rule,
)
from mmlspark_tpu_torch.analysis.lockgraph import concurrency_index


def _path_parts(ctx: FileContext) -> List[str]:
    return ctx.path.replace("\\", "/").split("/")


def _in_parts(ctx: FileContext, parts: Tuple[str, ...]) -> bool:
    have = _path_parts(ctx)
    return any(p in have for p in parts)


_CONCURRENT_PARTS = (
    "runtime", "serving", "streaming", "observability", "resilience",
    "sweep", "lightgbm", "dataguard",
)


# ---------------------------------------------------------------------------
# Family 1: lock order
# ---------------------------------------------------------------------------


@register_rule
class LockOrderRule(Rule):
    name = "lock-order"
    description = (
        "The whole-program lock acquisition graph (locks identified by "
        "class-qualified self._lock attribute paths) must be acyclic: a "
        "cycle means two threads can acquire the same locks in opposite "
        "orders and deadlock (ABBA). Each cycle is reported once, at its "
        "smallest edge site."
    )

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        index = concurrency_index(ctx)
        for cycle in index.cycles():
            if cycle.path != ctx.path:
                continue
            yield Violation(
                rule=self.name, path=ctx.path, line=cycle.line,
                col=cycle.col,
                message=(
                    "lock-order cycle (potential ABBA deadlock): "
                    + cycle.describe()
                ),
            )


@register_rule
class LockBlockingRule(Rule):
    name = "lock-blocking"
    description = (
        "A call made while holding a lock must not transitively reach a "
        "blocking wait (sleep, unbounded join/wait, queue get/put, socket "
        "or HTTP I/O) in any callee, across modules. Direct blocking in "
        "the with-body is lock-discipline's finding; this rule follows "
        "the call graph."
    )

    _PATH_PARTS = _CONCURRENT_PARTS

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not _in_parts(ctx, self._PATH_PARTS):
            return
        index = concurrency_index(ctx)
        for f in index.blocking_findings():
            if f.path != ctx.path:
                continue
            yield Violation(
                rule=self.name, path=ctx.path, line=f.line, col=f.col,
                message=(
                    f"call while holding {f.lock_id} reaches {f.reason} "
                    f"via {' -> '.join(f.chain)}: every thread contending "
                    "for the lock stalls behind that wait"
                ),
            )


# ---------------------------------------------------------------------------
# Family 2: collective consistency
# ---------------------------------------------------------------------------


@register_rule
class CollectiveDeadlineRule(Rule):
    name = "collective-deadline"
    description = (
        "Gang and process waits must be deadline-bounded: "
        "AllreduceGroup(...) requires an explicit timeout=, and bare "
        ".wait()/.join() without a timeout block forever when a member "
        "dies or the network partitions."
    )

    _PATH_PARTS = _CONCURRENT_PARTS

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not _in_parts(ctx, self._PATH_PARTS):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            short = name.split(".")[-1]
            if short == "AllreduceGroup":
                kwargs = {kw.arg for kw in node.keywords}
                if "timeout" not in kwargs and len(node.args) < 4:
                    yield self.violation(
                        ctx, node,
                        "AllreduceGroup(...) without an explicit timeout=: "
                        "formation blocks forever when a member never "
                        "arrives — pass the gang deadline",
                    )
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            kwargs = {kw.arg for kw in node.keywords}
            if (
                attr in ("wait", "join")
                and not node.args
                and "timeout" not in kwargs
            ):
                yield self.violation(
                    ctx, node,
                    f"unbounded .{attr}(): a dead peer or partitioned "
                    "network hangs this thread forever — pass timeout= "
                    "and handle the expiry",
                )


_RANK_MARKERS = {
    "rank", "member_id", "process_id", "process_index", "local_rank",
    "worker_id",
}
_COLLECTIVE_SUFFIXES = {
    "allreduce", "barrier", "psum", "pmean", "pmax", "pmin", "all_gather",
    "all_to_all", "ppermute", "hist_reduce",
}


def _rank_dependent(test: ast.AST) -> Optional[str]:
    """The rank-ish reference a condition reads, else None. ``world``/
    ``process_count`` comparisons are uniform across members and allowed."""
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and node.id in _RANK_MARKERS:
            return node.id
        if isinstance(node, ast.Attribute) and node.attr in _RANK_MARKERS:
            return dotted_name(node) or node.attr
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name.split(".")[-1] in ("process_index", "process_id"):
                return name
    return None


@register_rule
class CollectiveRankBranchRule(Rule):
    name = "collective-rank-branch"
    description = (
        "A collective (allreduce/barrier/psum/...) reachable only under a "
        "rank- or member-dependent conditional is a static gang deadlock: "
        "the members that skip the branch never enter the collective and "
        "the rest block until the gang deadline. World-size conditions "
        "(uniform across members) are allowed."
    )

    _PATH_PARTS = ("runtime", "lightgbm", "sweep", "ops", "parallel")

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not _in_parts(ctx, self._PATH_PARTS):
            return
        for stmt in ctx.tree.body:
            yield from self._visit(ctx, stmt, None)

    def _visit(
        self, ctx: FileContext, node: ast.AST,
        guard: Optional[Tuple[str, int]],
    ) -> Iterator[Violation]:
        """Recursive visit tracking the innermost rank-dependent guard.
        Function boundaries reset the guard (the callee runs wherever it
        is called from); the condition expression itself is visited with
        the OUTER guard, only the branch bodies get the new one."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for stmt in node.body:
                yield from self._visit(ctx, stmt, None)
            return
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.Call) and self._is_collective(node):
            if guard is not None:
                yield self._make(ctx, node, guard)
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            marker = _rank_dependent(node.test)
            inner = (marker, node.lineno) if marker is not None else guard
            yield from self._visit(ctx, node.test, guard)
            if isinstance(node, ast.IfExp):
                yield from self._visit(ctx, node.body, inner)
                yield from self._visit(ctx, node.orelse, inner)
            else:
                for stmt in node.body:
                    yield from self._visit(ctx, stmt, inner)
                for stmt in node.orelse:
                    yield from self._visit(ctx, stmt, inner)
            return
        for child in ast.iter_child_nodes(node):
            yield from self._visit(ctx, child, guard)

    @staticmethod
    def _is_collective(node: ast.Call) -> bool:
        name = dotted_name(node.func) or ""
        return name.split(".")[-1] in _COLLECTIVE_SUFFIXES

    def _make(
        self, ctx: FileContext, node: ast.Call, guard: Tuple[str, int]
    ) -> Violation:
        name = dotted_name(node.func) or "<collective>"
        return self.violation(
            ctx, node,
            f"collective {name}() guarded by member-dependent condition "
            f"on {guard[0]!r} (line {guard[1]}): members that skip the "
            "branch never join and the rest deadlock until the gang "
            "deadline",
        )


# ---------------------------------------------------------------------------
# Family 3: protocol ordering
# ---------------------------------------------------------------------------


def _own_nodes(func: ast.AST) -> Iterator[ast.AST]:
    """Nodes of ``func``'s own body, not descending into nested defs."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _calls_with_suffix(func: ast.AST, suffix: str) -> List[ast.Call]:
    out = []
    for node in _own_nodes(func):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func) or ""
        if name.split(".")[-1] == suffix:
            out.append(node)
    return out


@register_rule
class WalBeforeCommitRule(Rule):
    name = "wal-before-commit"
    description = (
        "Exactly-once streaming writes the offset WAL before the commit "
        "log: a function in streaming/ that writes the commit record must "
        "write the WAL first — commit-before-WAL (or commit with no WAL) "
        "re-executes or skips a batch after a crash."
    )

    _PATH_PARTS = ("streaming",)

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not _in_parts(ctx, self._PATH_PARTS):
            return
        for func in ast.walk(ctx.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if func.name == "_write_commit":
                continue
            commits = _calls_with_suffix(func, "_write_commit")
            if not commits:
                continue
            wals = _calls_with_suffix(func, "_write_wal")
            first_commit = min(commits, key=lambda c: c.lineno)
            if not wals:
                yield self.violation(
                    ctx, first_commit,
                    f"'{func.name}' writes the commit log without writing "
                    "the offset WAL: a crash between planning and commit "
                    "loses the batch boundary",
                )
            elif first_commit.lineno < min(w.lineno for w in wals):
                yield self.violation(
                    ctx, first_commit,
                    f"'{func.name}' writes the commit log before the "
                    "offset WAL: a crash in between re-executes the batch "
                    "with a different plan — write the WAL first",
                )


def _attr_call_on(node: ast.Call, attr: str, base_hint: str) -> bool:
    if not isinstance(node.func, ast.Attribute) or node.func.attr != attr:
        return False
    base = dotted_name(node.func.value) or ""
    return base_hint in base.lower()


@register_rule
class JournalBeforeStoreRule(Rule):
    name = "journal-before-store"
    description = (
        "A streaming sink that commits model text to the ModelStore must "
        "record the epoch in the fit journal first (the journal is the "
        "durability point replay dedupes on) — either in the same "
        "function, or in a same-class caller of it."
    )

    _PATH_PARTS = ("streaming",)

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not _in_parts(ctx, self._PATH_PARTS):
            return
        index = concurrency_index(ctx)
        fm = index.file_model(ctx.path)
        if fm is None:
            return
        for fn in fm.functions.values():
            commits = [
                node for node in _own_nodes(fn.node)
                if isinstance(node, ast.Call)
                and _attr_call_on(node, "commit", "store")
            ]
            if not commits:
                continue
            records = [
                node for node in _own_nodes(fn.node)
                if isinstance(node, ast.Call)
                and _attr_call_on(node, "record", "journal")
            ]
            if records:
                if min(r.lineno for r in records) < max(
                    c.lineno for c in commits
                ):
                    continue
            elif self._caller_records(fm, fn):
                continue
            yield self.violation(
                ctx, min(commits, key=lambda c: c.lineno),
                f"'{fn.key[1]}' commits to the ModelStore without a "
                "journal record: a crash after the store write but before "
                "journaling replays the epoch and double-commits — record "
                "the epoch first",
            )

    @staticmethod
    def _caller_records(fm, fn) -> bool:
        if fn.class_name is None:
            return False
        bare = fn.key[1].split(".")[-1]
        for other in fm.functions.values():
            if other.class_name != fn.class_name or other is fn:
                continue
            calls_fn = any(
                site.name in (f"self.{bare}", f"cls.{bare}")
                for site in other.calls
            )
            if not calls_fn:
                continue
            if any(
                isinstance(node, ast.Call)
                and _attr_call_on(node, "record", "journal")
                for node in _own_nodes(other.node)
            ):
                return True
        return False


_WRITE_MODES = {"w", "wb", "wt", "w+", "w+b", "wb+"}
_RENAME_ATTRS = {"replace", "rename", "renames"}


@register_rule
class TmpRenameAtomicityRule(Rule):
    name = "tmp-rename-atomicity"
    description = (
        "Checkpoint/WAL state in streaming/, dataguard/ and "
        "runtime/journal.py must be written tmp+rename (_atomic_write): a "
        "bare open(path, 'w') or write_text leaves a torn file when the "
        "process dies mid-write, and recovery then reads garbage. "
        "Functions that os.replace/rename are exempt (they ARE the atomic "
        "writer)."
    )

    def _applies(self, ctx: FileContext) -> bool:
        parts = _path_parts(ctx)
        return (
            "streaming" in parts
            or "dataguard" in parts
            or parts[-1] == "journal.py"
        )

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not self._applies(ctx):
            return
        for func in ast.walk(ctx.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if "atomic" in func.name or self._renames(func):
                continue
            for node in _own_nodes(func):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func) or ""
                short = name.split(".")[-1]
                if short == "open" and len(node.args) >= 2:
                    mode = node.args[1]
                    if (
                        isinstance(mode, ast.Constant)
                        and isinstance(mode.value, str)
                        and mode.value in _WRITE_MODES
                    ):
                        yield self.violation(
                            ctx, node,
                            f"bare open(..., {mode.value!r}) on a "
                            "checkpoint/WAL path: a crash mid-write tears "
                            "the file — write tmp then os.replace "
                            "(_atomic_write)",
                        )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("write_text", "write_bytes")
                ):
                    yield self.violation(
                        ctx, node,
                        f".{node.func.attr}() on a checkpoint/WAL path is "
                        "not atomic: a crash mid-write tears the file — "
                        "write tmp then os.replace (_atomic_write)",
                    )

    @staticmethod
    def _renames(func: ast.AST) -> bool:
        for node in _own_nodes(func):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _RENAME_ATTRS
            ):
                return True
        return False


#: onset event class -> recovery classes, any one of which must be
#: constructed in the same file (the publisher owns both edges of its
#: outage latch, so tools/check_eventlog.py can pair them at runtime)
_EVENT_PAIRS: Dict[str, Set[str]] = {
    "WorkerQuarantined": {"WorkerParoled", "GroupReformed"},
    "ProcessLost": {"GroupReformed", "ProcessStarted"},
    "NetworkPartitioned": {"GroupReformed"},
    "RegistryUnavailable": {"RegistryRecovered"},
    "DriftDetected": {"DriftCleared"},
    "AlertFired": {"AlertResolved"},
}
#: level-carrying events: a literal warn/critical onset needs a literal
#: "ok" publish, a variable level (covers both), or a degradation event
_LEVEL_EVENTS = {"MemoryPressure", "DiskPressure"}
_DEGRADATION_EVENTS = {"HistogramDegraded", "RequestShed"}


@register_rule
class OnsetRecoveryPairingRule(Rule):
    name = "onset-recovery-pairing"
    description = (
        "A module that publishes an outage-onset event (ProcessLost, "
        "NetworkPartitioned, RegistryUnavailable, WorkerQuarantined, a "
        "warn/critical pressure level) must also publish the paired "
        "recovery event: an event log with onsets and no recoveries "
        "cannot be audited for outage duration and check_eventlog's "
        "pairing contract fails."
    )

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        ctors: Dict[str, List[ast.Call]] = {}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = (dotted_name(node.func) or "").split(".")[-1]
            if name in _EVENT_PAIRS or name in _LEVEL_EVENTS or (
                name in _DEGRADATION_EVENTS
                or any(name in v for v in _EVENT_PAIRS.values())
            ):
                ctors.setdefault(name, []).append(node)
        present = set(ctors)
        for onset, recoveries in _EVENT_PAIRS.items():
            if onset in present and not (recoveries & present):
                for call in ctors[onset]:
                    yield self.violation(
                        ctx, call,
                        f"{onset} published with no paired recovery event "
                        f"({' or '.join(sorted(recoveries))}) in this "
                        "module: the outage has an onset record but no "
                        "end, so duration auditing and event-log pairing "
                        "checks fail",
                    )
        for name in _LEVEL_EVENTS & present:
            yield from self._check_levels(ctx, name, ctors, present)

    def _check_levels(
        self, ctx: FileContext, name: str,
        ctors: Dict[str, List[ast.Call]], present: Set[str],
    ) -> Iterator[Violation]:
        onsets, has_ok, has_dynamic = [], False, False
        for call in ctors[name]:
            level = None
            for kw in call.keywords:
                if kw.arg == "level":
                    level = kw.value
            if level is None or not isinstance(level, ast.Constant):
                has_dynamic = True
            elif level.value == "ok":
                has_ok = True
            elif level.value in ("warn", "critical"):
                onsets.append(call)
        if onsets and not (
            has_ok or has_dynamic or (_DEGRADATION_EVENTS & present)
        ):
            for call in onsets:
                yield self.violation(
                    ctx, call,
                    f"{name} published at a literal warn/critical level "
                    "with no 'ok' recovery publish (or degradation event) "
                    "in this module: the pressure onset never pairs, so "
                    "check_eventlog --pressure fails",
                )
