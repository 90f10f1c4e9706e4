"""What importing the port and its analysis tools costs, and the port's
top-level exports.

``import mmlspark_tpu_torch`` installs the lock witness from the
environment before any other module of the package, and neither it nor
``python -m mmlspark_tpu_torch.analysis.lint --help`` imports ``torch``,
``jax`` or the JAX package. The package's ``__all__`` is the reference's,
and each class name resolves, on first use, to the port's class.
"""

import os
import subprocess
import sys

import pytest

import _torch_reference  # noqa: F401  (the reference's import shim)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BANNED = "('torch', 'jax', 'mmlspark_tpu')"


def _run(code, **env):
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, **env))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_importing_the_package_imports_no_torch_and_installs_the_witness_first():
    out = _run(
        "import sys, threading\n"
        "import mmlspark_tpu_torch\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_BANNED}]\n"
        "assert not bad, bad\n"
        "from mmlspark_tpu_torch.analysis.witness import active_witness\n"
        "w = active_witness()\n"
        "assert w is not None and threading.Lock.__name__ == 'make'\n"
        "from mmlspark_tpu_torch.runtime import metrics\n"
        "assert type(metrics.RuntimeMetrics()._lock).__name__ == '_WitnessedLock'\n"
        "print(sorted(w.report()['sites']))\n",
        MMLSPARK_TPU_LOCKCHECK="1")
    assert "mmlspark_tpu_torch/runtime/metrics.py" in out


def test_lint_help_imports_no_torch():
    out = _run(
        "import runpy, sys\n"
        "sys.argv = ['lint', '--help']\n"
        "try:\n"
        "    runpy.run_module('mmlspark_tpu_torch.analysis.lint', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_BANNED}]\n"
        "assert not bad, bad\n")
    assert "--witness-check" in out and "--check-suppressions" in out


def test_analysis_sources_import_only_the_standard_library():
    import ast

    pkg = os.path.join(REPO, "mmlspark_tpu_torch", "analysis")
    names = sorted(f for f in os.listdir(pkg) if f.endswith(".py"))
    assert names == ["__init__.py", "base.py", "concurrency.py", "lint.py", "lockgraph.py",
                     "rules.py", "sarif.py", "traced.py", "witness.py"]
    # every import of the analysis modules; the package __init__'s at module
    # level (clear_compiled_caches imports torch when it is called)
    for name in names + [os.path.join("..", "__init__.py")]:
        with open(os.path.join(pkg, name), "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        nodes = tree.body if name.startswith("..") else ast.walk(tree)
        for node in nodes:
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            for root in roots:
                assert root not in ("torch", "triton", "jax", "numpy", "mmlspark_tpu"), \
                    (name, root)


def test_exports_are_the_references_and_resolve_to_the_ports_classes():
    import mmlspark_tpu
    import mmlspark_tpu_torch

    assert mmlspark_tpu_torch.__all__ == mmlspark_tpu.__all__
    for name in mmlspark_tpu.__all__:
        got = getattr(mmlspark_tpu_torch, name)
        want = getattr(mmlspark_tpu, name)
        if isinstance(want, type):
            assert got.__name__ == want.__name__
            assert got.__module__ == "mmlspark_tpu_torch." + want.__module__[len("mmlspark_tpu."):]
        elif name == "__version__":
            assert got == want
        else:
            assert callable(got) and got.__module__ == "mmlspark_tpu_torch"
    from mmlspark_tpu_torch.core.pipeline import Pipeline
    from mmlspark_tpu_torch.data.table import Table

    assert mmlspark_tpu_torch.Pipeline is Pipeline and mmlspark_tpu_torch.Table is Table
    with pytest.raises(AttributeError):
        mmlspark_tpu_torch.NoSuchName  # noqa: B018
