"""The builtin graftlint rule set.

The port's copy of ``mmlspark_tpu/analysis/rules.py``. Five framework
contracts, one rule each:

- ``jit-purity``: no host side effects inside compiled, traced or captured
  code.
- ``numpy-in-traced-code``: ``np.*`` reachable from a trace or a capture
  must be ``torch.*`` or hoisted to host-side setup.
- ``lock-discipline``: no blocking call while holding a lock in the
  threaded ``runtime/`` / ``serving/`` layers.
- ``bare-except-policy``: ``except Exception`` must re-raise, log, or
  carry an explicit justification.
- ``socket-deadline-policy``: every socket wait in ``runtime/`` /
  ``serving/`` must carry an explicit timeout — an unbounded socket is
  how a network partition becomes a hung gang.

The first two keep the reference's rule ids and banned lists; their index
is torch's (``analysis/traced.py``: ``torch.compile``, ``torch.jit``,
``torch.func``, ``make_graphed_callables``, ``triton.jit`` and the body of
``with torch.cuda.graph(...)``), and their messages name torch's remedy.
The last three carry over unchanged: their path parts are directory names
the port shares.

The reference's ``pallas-tile-alignment`` has no counterpart here. It
checks the (8, 128) register tile of the block shapes handed to Pallas's
``pl.BlockSpec``; the port writes no Pallas and has no ``BlockSpec``, and
its CUDA kernels pick their tiles in C++, where no Python rule can read
them. So the port's ``all_rules()`` is the reference's less that one.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from mmlspark_tpu_torch.analysis.base import (
    FileContext,
    Rule,
    Violation,
    dotted_name,
    register_rule,
)


def _traced_units(ctx: FileContext) -> List[Tuple[str, ast.AST]]:
    """``(label, node)`` for each traced def and each capture block of the
    file, from the project-wide index when the lint run attached one, else a
    single-file index (lint_source / unit tests). A capture block inside
    a traced def is covered by walking the def."""
    index = getattr(ctx, "traced_index", None)
    if index is None:
        from mmlspark_tpu_torch.analysis.traced import TracedIndex

        index = TracedIndex([ctx])
        ctx.traced_index = index
    units: List[Tuple[str, ast.AST]] = [
        (f"traced function '{func.name}'", func)
        for func in index.traced_defs(ctx)
    ]
    covered = {id(n) for _, func in units for n in ast.walk(func)}
    for block in index.capture_blocks(ctx):
        if id(block) not in covered:
            units.append((f"captured block (line {block.lineno})", block))
    return units


def _unit_nodes(unit: ast.AST) -> Iterator[ast.AST]:
    """A traced def's nodes, or a capture block's statements' nodes (the
    context expression runs outside the capture)."""
    if isinstance(unit, (ast.With, ast.AsyncWith)):
        for stmt in unit.body:
            yield from ast.walk(stmt)
    else:
        yield from ast.walk(unit)


@register_rule
class JitPurityRule(Rule):
    name = "jit-purity"
    description = (
        "No wall-clock reads, host RNG, printing, I/O, or global mutation "
        "inside compiled, traced or captured code (torch.compile, "
        "torch.jit, torch.func, triton.jit, a torch.cuda.graph block): "
        "side effects run once at trace or capture time, then silently "
        "never again on a replay."
    )

    _BANNED_PREFIXES = {
        "time.": "wall-clock read executes at trace or capture time only",
        "random.": "host RNG is frozen at trace time; draw with torch.rand "
        "and a torch.Generator",
        "np.random.": "host RNG is frozen at trace time; draw with "
        "torch.rand and a torch.Generator",
        "numpy.random.": "host RNG is frozen at trace time; draw with "
        "torch.rand and a torch.Generator",
    }
    _BANNED_CALLS = {
        "print": "print() runs at trace or capture time only; print the "
        "result outside the compiled or captured region",
        "input": "blocking host I/O inside traced code",
        "open": "host file I/O inside traced code",
    }

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for label, unit in _traced_units(ctx):
            for node in _unit_nodes(unit):
                if isinstance(node, ast.Global):
                    yield self.violation(
                        ctx, node,
                        f"global mutation of {', '.join(node.names)!s} inside "
                        f"{label} happens at trace time only",
                    )
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name is None:
                    continue
                if name in self._BANNED_CALLS:
                    yield self.violation(
                        ctx, node,
                        f"{name}() inside {label}: {self._BANNED_CALLS[name]}",
                    )
                    continue
                for prefix, why in self._BANNED_PREFIXES.items():
                    if name.startswith(prefix):
                        yield self.violation(
                            ctx, node, f"{name}() inside {label}: {why}",
                        )
                        break


@register_rule
class NumpyInTracedCodeRule(Rule):
    name = "numpy-in-traced-code"
    description = (
        "np.* calls reachable from compiled, traced or captured code: they "
        "run on the host once, at trace or capture, and their result is "
        "frozen into every replay; use torch.* or hoist to host-side setup "
        "(an lru_cache'd builder is the blessed hoist and is not flagged)."
    )

    # Host-side constant constructors that are fine under trace: dtypes,
    # scalar casts of static values, and dtype introspection.
    _ALLOWED_ATTRS = {
        "dtype", "errstate", "iinfo", "finfo", "can_cast", "result_type",
        "promote_types",
        "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
        "uint64", "float16", "float32", "float64", "bool_", "complex64",
        "complex128", "intp", "uintp", "generic",
    }

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for label, unit in _traced_units(ctx):
            for node in _unit_nodes(unit):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name is None:
                    continue
                for mod in ("np.", "numpy."):
                    if not name.startswith(mod):
                        continue
                    rest = name[len(mod):]
                    if rest.split(".")[0] in self._ALLOWED_ATTRS:
                        continue
                    if rest.startswith("random."):
                        continue  # jit-purity owns host RNG
                    yield self.violation(
                        ctx, node,
                        f"{name}() reachable from {label}: numpy runs on "
                        "the host at trace or capture time only; use "
                        f"torch.{rest} or hoist to host-side setup",
                    )
                    break


@register_rule
class LockDisciplineRule(Rule):
    name = "lock-discipline"
    description = (
        "No blocking call (thread join, sleep, queue get/put, network I/O) "
        "while holding a threading.Lock/RLock in runtime/, serving/, "
        "streaming/, observability/, resilience/, sweep/ or dataguard/: "
        "the lock serializes every heartbeat, reply, epoch-commit, "
        "breaker-decision and metrics-scrape path behind the wait."
    )

    _PATH_PARTS = (
        "runtime", "serving", "streaming", "observability", "resilience",
        "sweep", "dataguard",
    )
    _NETWORK_PREFIXES = (
        "urllib.request.urlopen", "urlopen", "requests.", "socket.",
        "http.client.",
    )
    _NETWORK_METHODS = {"recv", "recv_into", "accept", "connect", "urlopen"}

    def _applies(self, ctx: FileContext) -> bool:
        parts = ctx.path.replace("\\", "/").split("/")
        return any(p in parts for p in self._PATH_PARTS)

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not self._applies(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            lock_expr = self._held_lock(node)
            if lock_expr is None:
                continue
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        why = self._blocking_reason(sub)
                        if why is not None:
                            yield self.violation(
                                ctx, sub,
                                f"{why} while holding {lock_expr}: every "
                                "thread contending for the lock stalls "
                                "behind this wait",
                            )

    @staticmethod
    def _held_lock(node: ast.With) -> Optional[str]:
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                expr = expr.func
            name = dotted_name(expr)
            if name is not None and "lock" in name.lower():
                return name
        return None

    def _blocking_reason(self, call: ast.Call) -> Optional[str]:
        name = dotted_name(call.func)
        if name is not None:
            if name.startswith("time.") and name.endswith("sleep"):
                return f"{name}()"
            for prefix in self._NETWORK_PREFIXES:
                if name == prefix or name.startswith(prefix):
                    return f"network call {name}()"
        if not isinstance(call.func, ast.Attribute):
            return None
        attr = call.func.attr
        has_positional = bool(call.args)
        kwargs = {kw.arg for kw in call.keywords}
        if attr == "sleep":
            return "sleep()"
        if attr == "join" and not has_positional:
            # str.join always takes one positional iterable; thread/process
            # join takes none (timeouts arrive as keywords)
            return ".join()"
        if attr in ("get", "put") and (
            (not has_positional and not kwargs)
            or kwargs & {"timeout", "block"}
        ):
            # dict.get(key[, default]) always passes positionals without
            # timeout/block keywords; queue get/put is what remains
            return f"queue .{attr}()"
        if attr in self._NETWORK_METHODS:
            return f"network call .{attr}()"
        return None


@register_rule
class SocketDeadlinePolicyRule(Rule):
    name = "socket-deadline-policy"
    description = (
        "Every socket wait in runtime/ and serving/ must carry an explicit "
        "deadline: urlopen()/create_connection() without a timeout and "
        ".settimeout(None) wait forever, so a partitioned peer or a dead "
        "registry hangs the calling thread instead of failing over."
    )

    _PATH_PARTS = ("runtime", "serving")
    #: (callable suffix, index of the positional timeout argument)
    _TIMEOUT_CALLS = {
        "urlopen": 2,            # urlopen(url, data=None, timeout=...)
        "create_connection": 1,  # create_connection(address, timeout=...)
    }

    def _applies(self, ctx: FileContext) -> bool:
        parts = ctx.path.replace("\\", "/").split("/")
        return any(p in parts for p in self._PATH_PARTS)

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if not self._applies(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            short = (name or "").split(".")[-1]
            if short in self._TIMEOUT_CALLS:
                pos = self._TIMEOUT_CALLS[short]
                kwargs = {kw.arg for kw in node.keywords}
                if "timeout" in kwargs or len(node.args) > pos:
                    continue
                yield self.violation(
                    ctx, node,
                    f"{name or short}() without timeout=: the call blocks "
                    "forever when the peer is partitioned or dead — pass "
                    "an explicit deadline",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "settimeout"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value is None
            ):
                yield self.violation(
                    ctx, node,
                    ".settimeout(None) removes the socket deadline: a "
                    "silent peer then hangs this thread forever",
                )


@register_rule
class BareExceptPolicyRule(Rule):
    name = "bare-except-policy"
    description = (
        "`except:` / `except Exception:` must re-raise, log the exception, "
        "or carry an explicit justification (# noqa: BLE001 or a graftlint "
        "suppression) — silent swallowing hides scheduler and kernel bugs."
    )

    _BROAD = {"Exception", "BaseException"}
    _LOG_METHODS = {
        "debug", "info", "warning", "error", "exception", "critical", "log",
    }

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node):
                continue
            if self._justified(ctx, node):
                continue
            caught = "bare except" if node.type is None else (
                f"except {dotted_name(node.type)}"
            )
            yield self.violation(
                ctx, node,
                f"{caught} swallows the error: re-raise, log it, narrow "
                "the type, or justify with `# noqa: BLE001`",
            )

    def _is_broad(self, node: ast.ExceptHandler) -> bool:
        if node.type is None:
            return True
        name = dotted_name(node.type)
        return name in self._BROAD

    def _justified(self, ctx: FileContext, node: ast.ExceptHandler) -> bool:
        line = ctx.line_text(node.lineno)
        if "noqa" in line and "BLE001" in line:
            return True
        for sub in ast.walk(node):
            if isinstance(sub, ast.Raise):
                return True
            if isinstance(sub, ast.Call) and self._is_log_call(sub):
                return True
        return False

    def _is_log_call(self, call: ast.Call) -> bool:
        if not isinstance(call.func, ast.Attribute):
            return False
        if call.func.attr not in self._LOG_METHODS:
            return False
        base = dotted_name(call.func.value)
        return base is not None and "log" in base.lower()
