"""Whole-program lock & call model for the concurrency rule family.

The port's copy of ``mmlspark_tpu/analysis/lockgraph.py``, with the same
logic; lock ids and sites are keyed on ``mmlspark_tpu_torch``.

graftlint's original ``lock-discipline`` rule sees one ``with`` body at a
time, so it catches ``time.sleep`` under a lock but not ``self._flush()``
under a lock where ``_flush`` sleeps three calls deeper — and it cannot
see lock *ordering* at all. This module builds the project-wide model the
interprocedural rules (``analysis/concurrency.py``) query:

- **lock identities**: ``self._lock``-style attributes qualified by the
  defining class (``mmlspark_tpu_torch.serving.server._BatchLoop._lock``) and
  module-level locks. One id covers every *instance* of the class — the
  same granularity the runtime witness (``analysis/witness.py``) records,
  so the two sides cross-check.
- **per-function facts**: lock acquisitions with the locks lexically held
  at that point, every call site with its held-lock set, and direct
  blocking calls (sleep, unbounded join/wait, queue get/put, socket and
  HTTP waits).
- **a resolved call graph**: ``self.m()`` to same-class methods,
  ``self._attr.m()`` through ``self._attr = ClassName(...)`` attribute
  types, bare and module-qualified calls through the same import maps
  ``analysis/traced.py`` uses, and constructor calls into ``__init__``.
- **transitive summaries** (fixpoint over the call graph): the locks a
  function may acquire and the blocking calls it may reach, each with a
  witness chain for the diagnostic message.
- **the lock-order graph**: an edge ``A -> B`` whenever ``B`` is acquired
  (directly or through calls) while ``A`` is held; cycles are potential
  ABBA deadlocks.

Everything is an over/under-approximation in the usual linter sense:
unresolvable calls (``obj.method()`` on unknown types) are dropped, and
attribute locks are merged per class. Both choices keep findings cheap to
verify by hand; docs/static_analysis.md spells out the semantics.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from mmlspark_tpu_torch.analysis.base import FileContext, dotted_name
from mmlspark_tpu_torch.analysis.traced import PACKAGE, _module_name

FnKey = Tuple[str, str]  # (path, qualified function name)

_LOCK_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "Lock": "lock",
    "RLock": "rlock",
}
_LOCKISH = ("lock", "mutex")


def _is_lockish(name: str) -> bool:
    low = name.lower()
    return any(part in low for part in _LOCKISH)


# ---------------------------------------------------------------------------
# Blocking-call catalog (superset of lock-discipline's: adds unbounded
# ``.wait()`` — Event.wait()/Popen.wait() without a timeout)
# ---------------------------------------------------------------------------

_NETWORK_PREFIXES = (
    "urllib.request.urlopen", "urlopen", "requests.", "socket.",
    "http.client.",
)
_NETWORK_METHODS = {"recv", "recv_into", "accept", "connect", "urlopen"}


def blocking_reason(call: ast.Call) -> Optional[str]:
    """Why this call can block indefinitely (or long), else None."""
    name = dotted_name(call.func)
    if name is not None:
        if name.startswith("time.") and name.endswith("sleep"):
            return f"{name}()"
        for prefix in _NETWORK_PREFIXES:
            if name == prefix or name.startswith(prefix):
                return f"network call {name}()"
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    has_positional = bool(call.args)
    kwargs = {kw.arg for kw in call.keywords}
    if attr == "sleep":
        return "sleep()"
    if attr == "join" and not has_positional and "timeout" not in kwargs:
        # str.join always takes one positional iterable; thread/process
        # join takes none (a deadline arrives as timeout=)
        return "unbounded .join()"
    if attr == "wait" and not has_positional and "timeout" not in kwargs:
        # Event.wait()/Popen.wait()/Condition.wait() with no deadline
        return "unbounded .wait()"
    if attr in ("get", "put") and (
        (not has_positional and not kwargs) or kwargs & {"timeout", "block"}
    ):
        return f"queue .{attr}()"
    if attr in _NETWORK_METHODS:
        return f"network call .{attr}()"
    return None


# ---------------------------------------------------------------------------
# Per-file model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LockDef:
    """One lock identity: where it is allocated and what primitive."""

    lock_id: str
    path: str
    line: int
    kind: str  # "lock" | "rlock" | "heuristic"


@dataclasses.dataclass(frozen=True)
class Acq:
    lock_id: str
    line: int
    col: int
    held: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class CallSite:
    name: str  # dotted callee text as written
    line: int
    col: int
    held: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Blocking:
    reason: str
    line: int
    col: int
    held: Tuple[str, ...]


class _ClassModel:
    def __init__(self, name: str):
        self.name = name
        self.methods: Dict[str, ast.AST] = {}
        self.attr_locks: Dict[str, str] = {}  # attr -> kind
        self.attr_lock_lines: Dict[str, int] = {}
        self.attr_types: Dict[str, str] = {}  # attr -> callee dotted text


class _FnModel:
    def __init__(self, key: FnKey, node: ast.AST, class_name: Optional[str]):
        self.key = key
        self.node = node
        self.class_name = class_name
        self.acquisitions: List[Acq] = []
        self.calls: List[CallSite] = []
        self.blocking: List[Blocking] = []


class _FileModel:
    """One file's classes, functions, locks, and import maps."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.path = ctx.path
        self.module = _module_name(ctx.path)
        self.qual = self.module if self.module is not None else ctx.path
        self.classes: Dict[str, _ClassModel] = {}
        self.functions: Dict[str, _FnModel] = {}  # qualname -> model
        self.module_functions: Dict[str, str] = {}  # bare -> qualname
        self.module_locks: Dict[str, Tuple[str, int]] = {}  # name->(kind,ln)
        self.imports: Dict[str, Tuple[str, str]] = {}
        self.module_imports: Dict[str, str] = {}
        self._collect()

    def _collect(self) -> None:
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (
                        node.module, alias.name
                    )
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    self.module_imports[
                        alias.asname or alias.name.split(".")[0]
                    ] = alias.name
        for stmt in self.ctx.tree.body:
            if isinstance(stmt, ast.ClassDef):
                self._collect_class(stmt)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[stmt.name] = _FnModel(
                    (self.path, stmt.name), stmt, None
                )
                self.module_functions[stmt.name] = stmt.name
            elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target = stmt.targets[0]
                if isinstance(target, ast.Name) and isinstance(
                    stmt.value, ast.Call
                ):
                    ctor = dotted_name(stmt.value.func)
                    if ctor in _LOCK_CTORS:
                        self.module_locks[target.id] = (
                            _LOCK_CTORS[ctor], stmt.lineno
                        )

    def _collect_class(self, cls: ast.ClassDef) -> None:
        model = _ClassModel(cls.name)
        self.classes[cls.name] = model
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            model.methods[stmt.name] = stmt
            qualname = f"{cls.name}.{stmt.name}"
            self.functions[qualname] = _FnModel(
                (self.path, qualname), stmt, cls.name
            )
            # self.<attr> = threading.Lock() / C(...) anywhere in the class
            for node in ast.walk(stmt):
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and isinstance(node.targets[0].value, ast.Name)
                    and node.targets[0].value.id == "self"
                    and isinstance(node.value, ast.Call)
                ):
                    continue
                attr = node.targets[0].attr
                ctor = dotted_name(node.value.func)
                if ctor in _LOCK_CTORS:
                    model.attr_locks[attr] = _LOCK_CTORS[ctor]
                    model.attr_lock_lines.setdefault(attr, node.lineno)
                elif ctor is not None:
                    model.attr_types.setdefault(attr, ctor)


# ---------------------------------------------------------------------------
# Project model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Edge:
    """Lock-order edge: ``dst`` acquired while ``src`` is held."""

    src: str
    dst: str
    path: str
    line: int
    col: int
    via: Tuple[str, ...]  # human-readable call chain, () for direct


@dataclasses.dataclass(frozen=True)
class BlockingFinding:
    """A call site that reaches a blocking call while a lock is held."""

    lock_id: str
    reason: str
    path: str
    line: int
    col: int
    chain: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Cycle:
    """A lock-order cycle, anchored at its smallest edge site."""

    locks: Tuple[str, ...]
    edges: Tuple[Edge, ...]
    path: str
    line: int
    col: int

    def describe(self) -> str:
        ring = " -> ".join(self.locks + (self.locks[0],))
        sites = "; ".join(
            f"{e.src} -> {e.dst} at {e.path}:{e.line}"
            + (f" (via {' -> '.join(e.via)})" if e.via else "")
            for e in self.edges
        )
        return f"{ring} [{sites}]"


class ConcurrencyIndex:
    """Project-wide lock graph + blocking reachability, built once per
    lint run and cached on the run's TracedIndex."""

    def __init__(self, contexts: Iterable[FileContext]):
        self._files: Dict[str, _FileModel] = {}
        self._by_module: Dict[str, _FileModel] = {}
        for ctx in contexts:
            fm = _FileModel(ctx)
            self._files[ctx.path] = fm
            if fm.module is not None:
                self._by_module[fm.module] = fm
        self.lock_defs: Dict[str, LockDef] = {}
        self._register_lock_defs()
        self._scan_functions()
        self._resolved: Dict[FnKey, List[Tuple[CallSite, FnKey]]] = {}
        self._resolve_calls()
        self._locks_of: Dict[FnKey, Dict[str, Tuple[str, ...]]] = {}
        self._block_of: Dict[FnKey, Dict[str, Tuple[str, ...]]] = {}
        self._fixpoint()
        self.edges: Dict[Tuple[str, str], Edge] = {}
        self._build_edges()
        self._cycles: Optional[List[Cycle]] = None
        self._blocking: Optional[List[BlockingFinding]] = None

    # -- lock identities -------------------------------------------------

    def _register_lock_defs(self) -> None:
        # attr name -> unique (qual, class) owner, for unifying opaque
        # `other._reorder_lock`-style references with their definition;
        # an attr defined as a lock in several classes stays ambiguous
        self._attr_owner: Dict[str, Optional[Tuple[str, str]]] = {}
        for fm in self._files.values():
            for cls in fm.classes.values():
                for attr, kind in cls.attr_locks.items():
                    lid = f"{fm.qual}.{cls.name}.{attr}"
                    self.lock_defs.setdefault(lid, LockDef(
                        lid, fm.path, cls.attr_lock_lines[attr], kind
                    ))
                    if attr in self._attr_owner:
                        self._attr_owner[attr] = None
                    else:
                        self._attr_owner[attr] = (fm.qual, cls.name)
            for name, (kind, line) in fm.module_locks.items():
                lid = f"{fm.qual}.{name}"
                self.lock_defs.setdefault(
                    lid, LockDef(lid, fm.path, line, kind)
                )

    def _lock_id_of(
        self, expr: ast.AST, fm: _FileModel, fn: _FnModel
    ) -> Optional[str]:
        if isinstance(expr, ast.Call):
            expr = expr.func
        name = dotted_name(expr)
        if name is None:
            return None
        parts = name.split(".")
        if parts[0] in ("self", "cls") and len(parts) == 2 and fn.class_name:
            attr = parts[1]
            cls = fm.classes.get(fn.class_name)
            if cls is not None and (
                attr in cls.attr_locks or _is_lockish(attr)
            ):
                return f"{fm.qual}.{fn.class_name}.{attr}"
            return None
        if len(parts) == 1:
            if parts[0] in fm.module_locks or _is_lockish(parts[0]):
                return f"{fm.qual}.{parts[0]}"
            return None
        if parts[0] == "self" and len(parts) == 3 and fn.class_name:
            # self.<attr>.<lock> through self.<attr> = ClassName(...)
            cls = fm.classes.get(fn.class_name)
            type_name = cls.attr_types.get(parts[1]) if cls else None
            if type_name is not None:
                resolved = self._resolve_class(fm, type_name)
                if resolved is not None:
                    other, cname = resolved
                    cm = other.classes[cname]
                    if parts[2] in cm.attr_locks or _is_lockish(parts[2]):
                        return f"{other.qual}.{cname}.{parts[2]}"
        if _is_lockish(parts[-1]):
            owner = self._attr_owner.get(parts[-1])
            if owner is not None:
                # the attr is defined as a lock in exactly one class:
                # unify the reference with that definition
                return f"{owner[0]}.{owner[1]}.{parts[-1]}"
            # opaque attribute path (other object's lock): identity by text
            return f"{fm.qual}:{name}"
        return None

    def lock_kind(self, lock_id: str) -> str:
        d = self.lock_defs.get(lock_id)
        return d.kind if d is not None else "heuristic"

    def lock_sites(self) -> Dict[Tuple[str, int], str]:
        """(package-relative path, line) of each lock allocation ->
        lock id; the runtime witness keys its records the same way."""
        out: Dict[Tuple[str, int], str] = {}
        for d in self.lock_defs.values():
            out[(package_relative(d.path), d.line)] = d.lock_id
        return out

    # -- per-function scan -------------------------------------------------

    def _scan_functions(self) -> None:
        for fm in self._files.values():
            for fn in fm.functions.values():
                body = getattr(fn.node, "body", [])
                for stmt in body:
                    self._visit(stmt, (), fm, fn)

    def _visit(
        self,
        node: ast.AST,
        held: Tuple[str, ...],
        fm: _FileModel,
        fn: _FnModel,
    ) -> None:
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                   ast.Lambda)
        ):
            return  # separate scope: does not run under the current locks
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                self._visit(item.context_expr, inner, fm, fn)
                lid = self._lock_id_of(item.context_expr, fm, fn)
                if lid is not None:
                    fn.acquisitions.append(Acq(
                        lid, node.lineno, node.col_offset, inner
                    ))
                    inner = inner + (lid,)
            for stmt in node.body:
                self._visit(stmt, inner, fm, fn)
            return
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name is not None:
                # `lock.acquire()` outside a with: record the acquisition
                # event (edges from held) without extending the region
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"
                ):
                    lid = self._lock_id_of(node.func.value, fm, fn)
                    if lid is not None:
                        fn.acquisitions.append(Acq(
                            lid, node.lineno, node.col_offset, held
                        ))
                fn.calls.append(CallSite(
                    name, node.lineno, node.col_offset, held
                ))
            reason = blocking_reason(node)
            if reason is not None:
                fn.blocking.append(Blocking(
                    reason, node.lineno, node.col_offset, held
                ))
        for child in ast.iter_child_nodes(node):
            self._visit(child, held, fm, fn)

    # -- call resolution -----------------------------------------------------

    def _resolve_class(
        self, fm: _FileModel, name: str
    ) -> Optional[Tuple[_FileModel, str]]:
        parts = name.split(".")
        if len(parts) == 1:
            if parts[0] in fm.classes:
                return fm, parts[0]
            if parts[0] in fm.imports:
                mod, item = fm.imports[parts[0]]
                other = self._by_module.get(mod)
                if other is not None and item in other.classes:
                    return other, item
            return None
        if len(parts) == 2 and parts[0] in fm.module_imports:
            other = self._by_module.get(fm.module_imports[parts[0]])
            if other is not None and parts[1] in other.classes:
                return other, parts[1]
        return None

    def _resolve_call(
        self, fm: _FileModel, fn: _FnModel, name: str
    ) -> List[FnKey]:
        parts = name.split(".")
        if parts[0] in ("self", "cls") and fn.class_name:
            cls = fm.classes.get(fn.class_name)
            if cls is None:
                return []
            if len(parts) == 2:
                if parts[1] in cls.methods:
                    return [(fm.path, f"{fn.class_name}.{parts[1]}")]
                return []
            if len(parts) == 3:
                # self._attr.m() through self._attr = ClassName(...)
                type_name = cls.attr_types.get(parts[1])
                if type_name is None:
                    return []
                resolved = self._resolve_class(fm, type_name)
                if resolved is None:
                    return []
                other, cname = resolved
                if parts[2] in other.classes[cname].methods:
                    return [(other.path, f"{cname}.{parts[2]}")]
                return []
            return []
        if len(parts) == 1:
            target = parts[0]
            if target in fm.module_functions:
                return [(fm.path, fm.module_functions[target])]
            if target in fm.imports:
                mod, item = fm.imports[target]
                other = self._by_module.get(mod)
                if other is not None:
                    if item in other.module_functions:
                        return [(other.path, other.module_functions[item])]
            resolved = self._resolve_class(fm, target)
            if resolved is not None:
                other, cname = resolved
                if "__init__" in other.classes[cname].methods:
                    return [(other.path, f"{cname}.__init__")]
            return []
        if len(parts) == 2:
            head, meth = parts
            target_module = None
            if head in fm.module_imports:
                target_module = fm.module_imports[head]
            elif head in fm.imports:
                mod, item = fm.imports[head]
                target_module = f"{mod}.{item}"
                other = self._by_module.get(mod)
                if (
                    other is not None
                    and item in other.classes
                    and meth in other.classes[item].methods
                ):
                    return [(other.path, f"{item}.{meth}")]
            if target_module is not None:
                other = self._by_module.get(target_module)
                if other is not None and meth in other.module_functions:
                    return [(other.path, other.module_functions[meth])]
                return []
            if head in fm.classes and meth in fm.classes[head].methods:
                return [(fm.path, f"{head}.{meth}")]
        return []

    def _resolve_calls(self) -> None:
        for fm in self._files.values():
            for fn in fm.functions.values():
                out: List[Tuple[CallSite, FnKey]] = []
                for site in fn.calls:
                    for key in self._resolve_call(fm, fn, site.name):
                        if key in self._fn_index():
                            out.append((site, key))
                self._resolved[fn.key] = out

    def _fn_index(self) -> Dict[FnKey, _FnModel]:
        cached = getattr(self, "_fn_index_cache", None)
        if cached is None:
            cached = {
                fn.key: fn
                for fm in self._files.values()
                for fn in fm.functions.values()
            }
            self._fn_index_cache = cached
        return cached

    # -- transitive summaries --------------------------------------------

    @staticmethod
    def _chain_entry(key: FnKey, line: int) -> str:
        return f"{key[1]} ({package_relative(key[0])}:{line})"

    def _fixpoint(self) -> None:
        fns = self._fn_index()
        callers: Dict[FnKey, Set[FnKey]] = {}
        for key, edges in self._resolved.items():
            for _site, callee in edges:
                callers.setdefault(callee, set()).add(key)
        for key, fn in fns.items():
            self._locks_of[key] = {
                a.lock_id: (self._chain_entry(key, a.line),)
                for a in fn.acquisitions
            }
            self._block_of[key] = {
                b.reason: (self._chain_entry(key, b.line),)
                for b in fn.blocking
            }
        worklist = list(fns)
        while worklist:
            key = worklist.pop()
            changed = False
            for site, callee in self._resolved.get(key, ()):
                prefix = (self._chain_entry(key, site.line),)
                for lid, chain in self._locks_of.get(callee, {}).items():
                    if lid not in self._locks_of[key]:
                        self._locks_of[key][lid] = prefix + chain
                        changed = True
                for reason, chain in self._block_of.get(callee, {}).items():
                    if reason not in self._block_of[key]:
                        self._block_of[key][reason] = prefix + chain
                        changed = True
            if changed:
                worklist.extend(callers.get(key, ()))

    # -- lock-order graph --------------------------------------------------

    def _add_edge(
        self, src: str, dst: str, path: str, line: int, col: int,
        via: Tuple[str, ...],
    ) -> None:
        if src == dst:
            # re-acquiring an RLock is fine; a non-reentrant self-cycle
            # is reported as a one-lock cycle
            if self.lock_kind(src) != "lock":
                return
        key = (src, dst)
        existing = self.edges.get(key)
        if existing is None or (path, line) < (existing.path, existing.line):
            self.edges[key] = Edge(src, dst, path, line, col, via)

    def _build_edges(self) -> None:
        for fm in self._files.values():
            for fn in fm.functions.values():
                for acq in fn.acquisitions:
                    for held in acq.held:
                        self._add_edge(
                            held, acq.lock_id, fm.path, acq.line,
                            acq.col, (),
                        )
                for site, callee in self._resolved.get(fn.key, ()):
                    if not site.held:
                        continue
                    for lid, chain in self._locks_of.get(callee, {}).items():
                        for held in site.held:
                            self._add_edge(
                                held, lid, fm.path, site.line, site.col,
                                chain,
                            )

    def cycles(self) -> List[Cycle]:
        if self._cycles is None:
            self._cycles = self._find_cycles()
        return self._cycles

    def _find_cycles(self) -> List[Cycle]:
        graph: Dict[str, Set[str]] = {}
        for (src, dst) in self.edges:
            graph.setdefault(src, set()).add(dst)
            graph.setdefault(dst, set())
        out: List[Cycle] = []
        for scc in _tarjan(graph):
            if len(scc) == 1:
                node = next(iter(scc))
                if (node, node) not in self.edges:
                    continue
                ring = [node, node]
            else:
                ring = self._cycle_in_scc(graph, scc)
                if ring is None:
                    continue
            edges = tuple(
                self.edges[(ring[i], ring[i + 1])]
                for i in range(len(ring) - 1)
            )
            anchor = min(edges, key=lambda e: (e.path, e.line, e.col))
            out.append(Cycle(
                tuple(ring[:-1]), edges, anchor.path, anchor.line,
                anchor.col,
            ))
        out.sort(key=lambda c: (c.path, c.line, c.col))
        return out

    @staticmethod
    def _cycle_in_scc(
        graph: Dict[str, Set[str]], scc: Set[str]
    ) -> Optional[List[str]]:
        start = min(scc)
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        seen: Set[str] = set()
        while stack:
            node, trail = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt not in scc:
                    continue
                if nxt == start:
                    return trail + [start]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, trail + [nxt]))
        return None

    # -- blocking reachability ---------------------------------------------

    def blocking_findings(self) -> List[BlockingFinding]:
        """Call sites under a held lock that *transitively* reach a
        blocking call (direct blocking inside the with-body is
        lock-discipline's finding, not repeated here)."""
        if self._blocking is not None:
            return self._blocking
        out: List[BlockingFinding] = []
        seen: Set[Tuple[str, int, str, str]] = set()
        for fm in self._files.values():
            for fn in fm.functions.values():
                for site, callee in self._resolved.get(fn.key, ()):
                    if not site.held:
                        continue
                    for reason, chain in self._block_of.get(
                        callee, {}
                    ).items():
                        for held in site.held:
                            key = (fm.path, site.line, held, reason)
                            if key in seen:
                                continue
                            seen.add(key)
                            out.append(BlockingFinding(
                                held, reason, fm.path, site.line,
                                site.col, chain,
                            ))
        out.sort(key=lambda f: (f.path, f.line, f.col, f.lock_id))
        self._blocking = out
        return out

    # -- misc ------------------------------------------------------------

    def file_model(self, path: str) -> Optional[_FileModel]:
        return self._files.get(path)


def _tarjan(graph: Dict[str, Set[str]]) -> List[Set[str]]:
    """Strongly connected components (iterative Tarjan)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[Set[str]] = []
    counter = [0]

    for root in graph:
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            advanced = False
            succ = sorted(graph.get(node, ()))
            for i in range(pi, len(succ)):
                nxt = succ[i]
                if nxt not in index:
                    work[-1] = (node, i + 1)
                    work.append((nxt, 0))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if low[node] == index[node]:
                scc: Set[str] = set()
                while True:
                    top = stack.pop()
                    on_stack.discard(top)
                    scc.add(top)
                    if top == node:
                        break
                sccs.append(scc)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return sccs


def package_relative(path: str) -> str:
    """Path from the last ``mmlspark_tpu_torch`` segment on (stable across
    checkouts; the witness normalizes its allocation sites the same way)."""
    parts = path.replace("\\", "/").split("/")
    if PACKAGE in parts:
        i = len(parts) - 1 - parts[::-1].index(PACKAGE)
        return "/".join(parts[i:])
    return path.replace("\\", "/")


def concurrency_index(ctx: FileContext) -> ConcurrencyIndex:
    """The project-wide index for this lint run, cached on the run's
    TracedIndex (single-file fallback for lint_source / unit tests)."""
    tindex = getattr(ctx, "traced_index", None)
    if tindex is None:
        from mmlspark_tpu_torch.analysis.traced import TracedIndex

        tindex = TracedIndex([ctx])
        ctx.traced_index = tindex
    cached = getattr(tindex, "_concurrency_index", None)
    if cached is None:
        contexts = [fi.ctx for fi in tindex._files.values()]
        if ctx.path not in tindex._files:
            contexts.append(ctx)
        cached = ConcurrencyIndex(contexts)
        tindex._concurrency_index = cached
    return cached
