"""Runtime lock witness: record real acquisition orders, cross-check
the static lock graph (``MMLSPARK_TPU_LOCKCHECK=1``).

The port's copy of ``mmlspark_tpu/analysis/witness.py``. It reads the same
environment variables, and it marks and keys its sites on
``mmlspark_tpu_torch``: a lock allocated by a module of the JAX package or
of the standard library stays raw. ``uninstall`` puts back the factories
``install`` found, whatever they were.

The static analyzer (``analysis/lockgraph.py``) proves the *absence* of
lock-order cycles it can see; the witness catches what static analysis
cannot — orders taken through callbacks, reflection, or code paths the
resolver gives up on. The shim patches ``threading.Lock``/``RLock`` with
factories that wrap locks **allocated inside the mmlspark_tpu_torch package**
(identified by walking the allocation stack; everything else gets the
raw primitive, so stdlib/torch behavior is untouched). Each wrapped lock's
identity is its allocation site ``<package-relative path>:<line>`` —
exactly the site of the static model's ``LockDef``, so witnessed edges
and static edges land in one graph.

Per-thread held stacks live in a ``threading.local``; every successful
acquire records an edge ``held-site -> new-site``. At process exit the
report dumps as JSON (tmp+rename — we practice what we lint) to
``$MMLSPARK_TPU_LOCKCHECK_OUT/lockwitness-<pid>.json``, one file per
process so gang members never clobber each other.

Cross-check (``python -m mmlspark_tpu_torch.analysis.lint --witness-check
<dir-or-file> <paths>``):

1. witnessed inversion — both ``A -> B`` and ``B -> A`` observed at
   runtime (two instances of the same classes locked in opposite orders
   count: the static graph merges instances per class, and so does the
   witness);
2. a witnessed edge closes a cycle when merged with the static graph
   (the static side saw ``A -> B``, the run took ``B -> A``).

Both emit rule id ``lock-witness``.
"""

from __future__ import annotations

import atexit
import json
import linecache
import os
import sys
import threading
from typing import Dict, Iterable, List, Optional, Tuple

_ORIG_LOCK = threading.Lock

WITNESS_RULE = "lock-witness"
WITNESS_RULE_DESCRIPTION = (
    "A lock acquisition order observed at runtime (MMLSPARK_TPU_"
    "LOCKCHECK=1) contradicts itself or the static lock graph: two "
    "locks were taken in both orders, which is an ABBA deadlock waiting "
    "for the right interleaving."
)


PACKAGE = "mmlspark_tpu_torch"


def _normalize(path: str) -> str:
    """Package-relative path: from the last ``mmlspark_tpu_torch`` segment
    on (mirrors lockgraph.package_relative, duplicated so importing the
    witness never drags in the analyzer)."""
    parts = path.replace("\\", "/").split("/")
    if PACKAGE in parts:
        i = len(parts) - 1 - parts[::-1].index(PACKAGE)
        return "/".join(parts[i:])
    return path.replace("\\", "/")


class _WitnessedLock:
    """Thin wrapper delegating to the real primitive; records every
    successful acquire/release against the shared witness."""

    __slots__ = ("_lk", "_site", "_witness", "_kind")

    def __init__(self, lk, site: str, witness: "LockWitness", kind: str):
        self._lk = lk
        self._site = site
        self._witness = witness
        self._kind = kind

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            self._witness._record_acquire(self._site, self._kind)
        return ok

    def release(self) -> None:
        self._witness._record_release(self._site)
        self._lk.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self) -> "_WitnessedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<witnessed {self._kind} @ {self._site}>"


class LockWitness:
    """Process-wide acquisition-order recorder."""

    def __init__(self, package_markers: Tuple[str, ...] = (PACKAGE,)):
        self.package_markers = package_markers
        self._mu = _ORIG_LOCK()
        self._edges: Dict[Tuple[str, str], int] = {}
        self._sites: Dict[str, str] = {}  # site -> kind
        self._tls = threading.local()
        self._installed = False
        self._saved: Optional[Tuple[object, object]] = None

    # -- factory side ------------------------------------------------------

    def _alloc_site(self) -> Optional[str]:
        """Allocation site of the Lock() call when it is inside one of
        the marked packages, else None (leave the lock raw).

        A compiled extension that bound ``threading.Lock`` after the
        install (numpy's bit generators do) calls the factory from C, and
        the nearest Python frame is then the package line that called the
        extension (``np.random.default_rng(seed)``). That lock is the
        extension's: a line whose source is readable and calls no
        ``Lock(``/``RLock(`` keeps it raw, as the static model, which
        counts only those calls as allocation sites, would."""
        f = sys._getframe(1)
        while f is not None:
            filename = f.f_code.co_filename
            if filename != __file__:
                norm = filename.replace("\\", "/")
                for marker in self.package_markers:
                    if f"/{marker}/" in norm or norm.startswith(
                        f"{marker}/"
                    ):
                        text = linecache.getline(filename, f.f_lineno)
                        if text and "Lock(" not in text:
                            return None
                        return f"{_normalize(filename)}:{f.f_lineno}"
                return None
            f = f.f_back
        return None

    def install(self) -> None:
        if self._installed:
            return
        self._installed = True
        self._saved = (threading.Lock, threading.RLock)
        witness = self

        def _factory(kind: str, orig):
            def make():
                site = witness._alloc_site()
                if site is None:
                    return orig()
                with witness._mu:
                    witness._sites.setdefault(site, kind)
                return _WitnessedLock(orig(), site, witness, kind)

            return make

        threading.Lock = _factory("lock", self._saved[0])
        threading.RLock = _factory("rlock", self._saved[1])

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        threading.Lock, threading.RLock = self._saved
        self._saved = None

    # -- recording ---------------------------------------------------------

    def _stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def _record_acquire(self, site: str, kind: str) -> None:
        stack = self._stack()
        if stack:
            with self._mu:
                for held in stack:
                    if held == site and kind == "rlock":
                        continue  # reentrant re-acquire is not an edge
                    key = (held, site)
                    self._edges[key] = self._edges.get(key, 0) + 1
        stack.append(site)

    def _record_release(self, site: str) -> None:
        stack = self._stack()
        # out-of-order release: drop the matching *last* occurrence
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == site:
                del stack[i]
                return

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        with self._mu:
            return {
                "version": 1,
                "pid": os.getpid(),
                "sites": dict(self._sites),
                "edges": [
                    {"from": a, "to": b, "count": n}
                    for (a, b), n in sorted(self._edges.items())
                ],
            }

    def dump(self, path: str) -> None:
        data = json.dumps(self.report(), indent=2, sort_keys=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)


_ACTIVE: Optional[LockWitness] = None


def active_witness() -> Optional[LockWitness]:
    return _ACTIVE


def install_from_env() -> Optional[LockWitness]:
    """Install the witness when ``MMLSPARK_TPU_LOCKCHECK=1`` (idempotent;
    called from the package ``__init__`` so every lock allocated by any
    mmlspark_tpu_torch module in this process — gang workers included, the env
    var is inherited — is wrapped). ``MMLSPARK_TPU_LOCKCHECK_OUT`` names
    a directory for the per-process exit dump."""
    global _ACTIVE
    if os.environ.get("MMLSPARK_TPU_LOCKCHECK") != "1":
        return None
    if _ACTIVE is not None:
        return _ACTIVE
    _ACTIVE = LockWitness()
    _ACTIVE.install()
    out_dir = os.environ.get("MMLSPARK_TPU_LOCKCHECK_OUT", "")
    if out_dir:
        atexit.register(_dump_active, out_dir)
    return _ACTIVE


def _dump_active(out_dir: str) -> None:
    if _ACTIVE is None:
        return
    try:
        os.makedirs(out_dir, exist_ok=True)
        _ACTIVE.dump(
            os.path.join(out_dir, f"lockwitness-{os.getpid()}.json")
        )
    except OSError:
        pass  # exit-path best effort: losing the report must not fail the run


# ---------------------------------------------------------------------------
# Static cross-check
# ---------------------------------------------------------------------------


def load_reports(paths: Iterable[str]) -> List[dict]:
    """Witness reports from files and/or directories of
    ``lockwitness-*.json`` dumps."""
    out: List[dict] = []
    for path in paths:
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if name.startswith("lockwitness") and name.endswith(".json"):
                    with open(
                        os.path.join(path, name), "r", encoding="utf-8"
                    ) as fh:
                        out.append(json.load(fh))
        elif os.path.isfile(path):
            with open(path, "r", encoding="utf-8") as fh:
                out.append(json.load(fh))
        else:
            raise FileNotFoundError(path)
    return out


def check_witness(reports: Iterable[dict], contexts) -> List:
    """Violations (rule ``lock-witness``) from witnessed orders vs the
    static lock graph built over ``contexts``."""
    from mmlspark_tpu_torch.analysis.base import Violation
    from mmlspark_tpu_torch.analysis.lockgraph import ConcurrencyIndex

    index = ConcurrencyIndex(contexts)
    site_to_lock = {
        f"{path}:{line}": lock_id
        for (path, line), lock_id in index.lock_sites().items()
    }

    def ident(site: str) -> str:
        return site_to_lock.get(site, f"witness:{site}")

    witnessed: Dict[Tuple[str, str], str] = {}  # (a, b) -> example site pair
    for report in reports:
        for edge in report.get("edges", ()):
            a, b = ident(edge["from"]), ident(edge["to"])
            if a != b:
                witnessed.setdefault(
                    (a, b), f"{edge['from']} -> {edge['to']}"
                )

    def site_of(lock_id: str) -> Tuple[str, int]:
        d = index.lock_defs.get(lock_id)
        return (d.path, d.line) if d is not None else ("<witness>", 0)

    violations: List[Violation] = []
    seen_pairs = set()
    # 1. direct runtime inversion
    for (a, b), example in sorted(witnessed.items()):
        if (b, a) not in witnessed:
            continue
        pair = tuple(sorted((a, b)))
        if pair in seen_pairs:
            continue
        seen_pairs.add(pair)
        path, line = site_of(pair[0])
        violations.append(Violation(
            rule=WITNESS_RULE, path=path, line=line, col=0,
            message=(
                f"runtime lock-order inversion: {a} -> {b} AND {b} -> "
                f"{a} both observed under MMLSPARK_TPU_LOCKCHECK "
                f"(e.g. {example}) — an ABBA deadlock waiting for the "
                "right interleaving"
            ),
        ))
    # 2. a witnessed edge closes a cycle against the static graph
    static_edges = set(index.edges)
    for (a, b) in sorted(witnessed):
        if (b, a) in static_edges and (b, a) not in witnessed:
            pair = tuple(sorted((a, b)))
            if pair in seen_pairs:
                continue
            seen_pairs.add(pair)
            se = index.edges[(b, a)]
            path, line = site_of(a)
            violations.append(Violation(
                rule=WITNESS_RULE, path=path, line=line, col=0,
                message=(
                    f"witnessed order {a} -> {b} inverts the static "
                    f"lock-graph edge {b} -> {a} ({se.path}:{se.line}): "
                    "the two orders together are an ABBA deadlock"
                ),
            ))
    return violations
