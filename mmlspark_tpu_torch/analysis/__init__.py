"""Framework-aware static analysis (``graftlint``) for the port.

The port's copy of ``mmlspark_tpu/analysis/``. It lints the port's source,
and it imports no ``torch``: ``python -m mmlspark_tpu_torch.analysis.lint``
and the package's own import (which installs the lock witness) stay pure
``ast`` plus the standard library.

- :mod:`mmlspark_tpu_torch.analysis.lint` (``graftlint``): an AST-driven
  linter enforcing the framework's implicit contracts — purity and no
  ``np.*`` in compiled, traced or captured code (``torch.compile``,
  ``torch.jit``, ``torch.func``, ``make_graphed_callables``,
  ``triton.jit``, the body of ``with torch.cuda.graph(...)``), lock
  discipline in the threaded runtime/serving layers, socket deadlines, and
  the bare-except policy. Run as
  ``python -m mmlspark_tpu_torch.analysis.lint <paths>``. The reference's
  ``pallas-tile-alignment`` has no counterpart (``analysis/rules.py``
  says why).
- the whole-program concurrency & protocol analyzer
  (:mod:`mmlspark_tpu_torch.analysis.lockgraph`,
  :mod:`mmlspark_tpu_torch.analysis.concurrency`): interprocedural
  lock-order cycles (ABBA deadlocks), blocking calls under locks,
  collective deadline/rank-uniformity checks, and WAL/journal/tmp+rename
  protocol ordering — backed by the cross-module reachability index in
  :mod:`mmlspark_tpu_torch.analysis.traced` and cross-checked at runtime
  by the lock witness (:mod:`mmlspark_tpu_torch.analysis.witness`,
  ``MMLSPARK_TPU_LOCKCHECK=1``).
- SARIF 2.1.0 output (:mod:`mmlspark_tpu_torch.analysis.sarif`).
"""

from mmlspark_tpu_torch.analysis.base import (
    FileContext,
    Rule,
    Violation,
    all_rules,
    register_rule,
)

__all__ = [
    "FileContext",
    "Rule",
    "Violation",
    "all_rules",
    "register_rule",
    "lint_paths",
    "lint_source",
    "ConcurrencyIndex",
    "LockWitness",
    "install_from_env",
    "check_witness",
    "load_reports",
    "to_sarif",
]


def __getattr__(name):
    # Lazy so `python -m mmlspark_tpu_torch.analysis.lint` doesn't trip runpy's
    # already-in-sys.modules warning by importing the CLI module here.
    if name in ("lint_paths", "lint_source"):
        from mmlspark_tpu_torch.analysis import lint

        return getattr(lint, name)
    if name == "ConcurrencyIndex":
        from mmlspark_tpu_torch.analysis.lockgraph import ConcurrencyIndex

        return ConcurrencyIndex
    if name in ("LockWitness", "install_from_env", "check_witness",
                "load_reports"):
        from mmlspark_tpu_torch.analysis import witness

        return getattr(witness, name)
    if name == "to_sarif":
        from mmlspark_tpu_torch.analysis.sarif import to_sarif

        return to_sarif
    raise AttributeError(name)
