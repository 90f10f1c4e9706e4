"""Traced-code reachability index for the trace-aware rules.

The port's copy of ``mmlspark_tpu/analysis/traced.py``, with torch's trace
roots in place of JAX's. ``jit-purity`` and ``numpy-in-traced-code`` only
make sense inside code that runs under a trace or a capture, where a side
effect runs once (when torch compiles, scripts, traces or captures the
code) and never again on a replay. That set is:

- the first argument of ``torch.compile``, ``torch.jit.script``,
  ``torch.jit.trace``, ``torch.cuda.make_graphed_callables`` (each callable
  of a tuple there), ``torch.func.vmap``, ``torch.vmap``,
  ``torch.func.grad`` and ``torch.func.grad_and_value`` at a call site,
  also through ``functools.partial(f, ...)``;
- functions decorated with any of these, or with ``triton.jit``;
- the body of a ``with torch.cuda.graph(...)`` block. This root is a
  block, not a function: its own statements are checked, and the functions
  it calls by name are traced like a root function's callees;
- and — the part plain linters miss — every function those reach by call,
  **across modules** (a stray ``np.*`` in a helper of another module runs
  once at capture and is frozen into every replay).

The index is built in two passes over every linted file:

1. per-file: function defs, local traced roots and capture blocks, name
   aliases (``g = partial(f, ...)``), an import map (``from m import f [as
   g]``, ``from pkg import mod``), and the call edges out of every def;
2. global BFS from the roots over call edges, following edges into other
   linted files through the import map.

Like the reference's, the resolver follows no ``self.<method>()`` call: a
method's class is not known from the call alone. A capture block whose body
is ``self.run_step(...)`` (``vw/base.py``'s CUDA graph) is therefore
checked statement by statement, and the method it calls is not.

The walk stops at ``functools.lru_cache``/``functools.cache``-decorated
functions: their arguments must be hashable, so they can never receive
traced tensors — anything behind them is host-side memoized setup by
construction (the blessed "hoist it out of the hot loop" pattern).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from mmlspark_tpu_torch.analysis.base import FileContext, dotted_name

# Wrappers whose *first* argument becomes traced code.
_TRACE_WRAPPERS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.cuda.make_graphed_callables", "torch.func.vmap", "torch.vmap",
    "torch.func.grad", "torch.func.grad_and_value",
}
# Decorators that trace the function they wrap: the wrappers and Triton's.
_TRACE_DECORATORS = _TRACE_WRAPPERS | {"triton.jit"}
# Context managers whose body is captured: its statements run once, at
# capture, and the device replays what they launched.
_CAPTURE_BLOCKS = {"torch.cuda.graph"}
_PARTIALS = {"partial", "functools.partial"}
_HOST_BOUNDARY_DECOS = {
    "functools.lru_cache", "lru_cache", "functools.cache", "cache",
}


def _first_func_ref(node: ast.AST) -> Optional[str]:
    """The function name a wrapper argument refers to: ``f``,
    ``partial(f, ...)``, or ``module.f`` (returned dotted)."""
    if isinstance(node, (ast.Name, ast.Attribute)):
        return dotted_name(node)
    if isinstance(node, ast.Call):
        fn = dotted_name(node.func)
        if fn in _PARTIALS and node.args:
            return _first_func_ref(node.args[0])
    return None


def _func_refs(node: ast.AST) -> List[str]:
    """``_first_func_ref`` of an argument, or of each element of a tuple
    or list of callables (``make_graphed_callables((f, g), ...)``)."""
    if isinstance(node, (ast.Tuple, ast.List)):
        return [r for el in node.elts for r in _func_refs(el)]
    ref = _first_func_ref(node)
    return [] if ref is None else [ref]


def is_capture_block(node: ast.AST) -> bool:
    """A ``with torch.cuda.graph(...)`` statement."""
    return isinstance(node, (ast.With, ast.AsyncWith)) and any(
        isinstance(item.context_expr, ast.Call)
        and dotted_name(item.context_expr.func) in _CAPTURE_BLOCKS
        for item in node.items
    )


class _FileIndex:
    """One linted file's defs, roots, aliases, imports, and call edges."""

    def __init__(self, ctx: FileContext, module: Optional[str]):
        self.ctx = ctx
        self.module = module
        # bare name -> defs with that name (nested defs share the namespace;
        # a linter can afford the over-approximation)
        self.defs: Dict[str, List[ast.FunctionDef]] = {}
        self.host_boundary: Set[str] = set()
        self.roots: Set[str] = set()
        self.blocks: List[ast.With] = []  # capture blocks, in source order
        self.aliases: Dict[str, str] = {}  # g = partial(f, ...) -> {g: f}
        self.imports: Dict[str, Tuple[str, str]] = {}  # local -> (module, name)
        self.module_imports: Dict[str, str] = {}  # local alias -> module
        self._collect()

    def _collect(self) -> None:
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.setdefault(node.name, []).append(node)
                if self._is_traced_def(node):
                    self.roots.add(node.name)
                if any(
                    dotted_name(d) in _HOST_BOUNDARY_DECOS
                    or (
                        isinstance(d, ast.Call)
                        and dotted_name(d.func) in _HOST_BOUNDARY_DECOS
                    )
                    for d in node.decorator_list
                ):
                    self.host_boundary.add(node.name)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
                if isinstance(target, ast.Name):
                    ref = _first_func_ref(node.value)
                    if ref is not None and isinstance(node.value, ast.Call):
                        self.aliases[target.id] = ref
            elif isinstance(node, ast.Call):
                self._collect_call_roots(node)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (
                        node.module, alias.name
                    )
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    self.module_imports[alias.asname or alias.name.split(".")[0]] = (
                        alias.name
                    )
            if is_capture_block(node):
                self.blocks.append(node)
        self.blocks.sort(key=lambda b: (b.lineno, b.col_offset))

    @staticmethod
    def _is_traced_def(node: ast.AST) -> bool:
        for deco in node.decorator_list:
            name = dotted_name(deco)
            if name in _TRACE_DECORATORS:
                return True
            if isinstance(deco, ast.Call):
                fn = dotted_name(deco.func)
                if fn in _TRACE_DECORATORS:
                    return True
                if fn in _PARTIALS and deco.args:
                    if dotted_name(deco.args[0]) in _TRACE_DECORATORS:
                        return True
        return False

    def _collect_call_roots(self, node: ast.Call) -> None:
        fn = dotted_name(node.func)
        if fn in _TRACE_WRAPPERS and node.args:
            self.roots.update(_func_refs(node.args[0]))

    def resolve_local(self, name: str) -> str:
        """Follow ``g = partial(f, ...)`` aliases to the underlying name."""
        seen = set()
        while name in self.aliases and name not in seen:
            seen.add(name)
            name = self.aliases[name]
        return name


class TracedIndex:
    """Project-wide set of traced function defs and capture blocks,
    queryable per file."""

    def __init__(self, contexts: Iterable[FileContext]):
        self._files: Dict[str, _FileIndex] = {}
        self._by_module: Dict[str, _FileIndex] = {}
        for ctx in contexts:
            module = _module_name(ctx.path)
            idx = _FileIndex(ctx, module)
            self._files[ctx.path] = idx
            if module is not None:
                self._by_module[module] = idx
        self._traced: Set[Tuple[str, str]] = set()  # (path, func name)
        self._bfs()

    # -- queries -------------------------------------------------------------

    def _index(self, ctx: FileContext) -> _FileIndex:
        idx = self._files.get(ctx.path)
        if idx is None:
            idx = _FileIndex(ctx, _module_name(ctx.path))
            self._files[ctx.path] = idx
            self._seed_and_close_single(idx)
        return idx

    def traced_defs(self, ctx: FileContext) -> List[ast.FunctionDef]:
        """The traced FunctionDef nodes of one file (deduplicated: a nested
        def inside a traced def is covered by walking its parent)."""
        idx = self._index(ctx)
        out = []
        for name, defs in idx.defs.items():
            if (ctx.path, name) in self._traced:
                out.extend(defs)
        return out

    def capture_blocks(self, ctx: FileContext) -> List[ast.With]:
        """The ``with torch.cuda.graph(...)`` statements of one file."""
        return list(self._index(ctx).blocks)

    # -- closure -------------------------------------------------------------

    def _bfs(self) -> None:
        frontier: List[Tuple[str, str]] = []
        for idx in self._files.values():
            frontier.extend(self._seeds(idx))
        self._close(frontier)

    def _seeds(self, idx: _FileIndex) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        for root in idx.roots:
            if "." not in root:
                root = idx.resolve_local(root)
            out.extend(self._resolve_callee(idx, root))
        for block in idx.blocks:
            for stmt in block.body:
                out.extend(self._callees(idx, stmt))
        return out

    def _close(self, frontier: List[Tuple[str, str]]) -> None:
        while frontier:
            path, name = frontier.pop()
            if (path, name) in self._traced:
                continue
            self._traced.add((path, name))
            idx = self._files[path]
            for node in idx.defs.get(name, []):
                frontier.extend(self._callees(idx, node))

    def _seed_and_close_single(self, idx: _FileIndex) -> None:
        self._close(self._seeds(idx))

    def _callees(
        self, idx: _FileIndex, func: ast.AST
    ) -> List[Tuple[str, str]]:
        out: List[Tuple[str, str]] = []
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            out.extend(self._resolve_callee(idx, name))
        return out

    def _resolve_callee(
        self, idx: _FileIndex, name: str
    ) -> List[Tuple[str, str]]:
        head, _, rest = name.partition(".")
        # module-qualified call through `from pkg import mod` / `import m as x`
        if rest and "." not in rest:
            target_module = None
            if head in idx.module_imports:
                target_module = idx.module_imports[head]
            elif head in idx.imports:
                mod, item = idx.imports[head]
                target_module = f"{mod}.{item}"
            if target_module is not None:
                other = self._by_module.get(target_module)
                if (
                    other is not None
                    and rest in other.defs
                    and rest not in other.host_boundary
                ):
                    return [(other.ctx.path, rest)]
            return []
        if rest:
            return []
        local = idx.resolve_local(head)
        if local in idx.defs:
            if local in idx.host_boundary:
                return []
            return [(idx.ctx.path, local)]
        if local in idx.imports:
            mod, item = idx.imports[local]
            other = self._by_module.get(mod)
            if (
                other is not None
                and item in other.defs
                and item not in other.host_boundary
            ):
                return [(other.ctx.path, item)]
        return []


PACKAGE = "mmlspark_tpu_torch"


def _module_name(path: str) -> Optional[str]:
    """Dotted module name for files under a ``mmlspark_tpu_torch`` tree."""
    parts = path.replace("\\", "/").split("/")
    if PACKAGE not in parts:
        return None
    i = parts.index(PACKAGE)
    rel = parts[i:]
    if not rel[-1].endswith(".py"):
        return None
    rel[-1] = rel[-1][:-3]
    if rel[-1] == "__init__":
        rel = rel[:-1]
    return ".".join(rel)
