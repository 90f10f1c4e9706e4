"""The port's graftlint (``mmlspark_tpu_torch.analysis``) against the
reference's (``mmlspark_tpu.analysis``).

Parity is exact: the analysis is deterministic AST work, so the port gives
the reference's list of ``(rule, line, col)`` on every snippet of the rules
that carry over, with messages equal once the package name is mapped. The
trace rules run on torch transliterations of the reference's JAX snippets,
under every root kind (``@torch.compile``, ``torch.compile(f)`` at a call
site, ``make_graphed_callables``, the body of ``with torch.cuda.graph(g):``
and ``@triton.jit``), and must find what the reference finds on the JAX
original, at the same line and column. The snippets are shared through
``tests/_torch_analysis_cases.py``. The port's own tree lints clean, once,
through a module-scoped fixture.
"""

import ast
import json
import os

import pytest

import _torch_reference  # noqa: F401  (the reference's import shim)
import _torch_analysis_cases as C
from mmlspark_tpu_torch.analysis import all_rules
from mmlspark_tpu_torch.analysis.base import FileContext
from mmlspark_tpu_torch.analysis.lint import (
    _load_contexts,
    _run_rules,
    discover_files,
    lint_contexts,
    lint_paths,
    lint_source,
    main,
    stale_suppressions,
)
from mmlspark_tpu_torch.analysis.sarif import to_sarif
from mmlspark_tpu_torch.analysis.traced import TracedIndex

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")


def findings(violations):
    return [(v.rule, v.line, v.col) for v in violations]


def lint_both(case):
    """The reference's and the port's violations on one case."""
    from mmlspark_tpu.analysis.base import FileContext as JFileContext
    from mmlspark_tpu.analysis.lint import lint_contexts as jlint_contexts

    select = None if case.select is None else list(case.select)
    ref, _ = jlint_contexts([JFileContext(p, s) for p, s in case.files], select)
    port, _ = lint_contexts([FileContext(p, s) for p, s in case.port_files()], select)
    return ref, port


@pytest.fixture(scope="module")
def self_scan():
    """The port's tree under its full rule set, parsed and linted once."""
    contexts, errors = _load_contexts(discover_files([os.path.join(REPO, "mmlspark_tpu_torch")]))
    violations, suppressed = _run_rules(contexts)
    return contexts, errors, violations, suppressed


# ---------------------------------------------------------------------------
# the shared snippets are the reference's
# ---------------------------------------------------------------------------


def test_shared_cases_hold_every_reference_snippet():
    ref = set()
    for name in ("test_analysis_lint.py", "test_analysis_concurrency.py"):
        ref |= C.reference_snippets(os.path.join(TESTS, name))
    assert len(ref) == 71
    assert ref <= C.shared_snippets()


# ---------------------------------------------------------------------------
# the rules that carry over: equal findings, equal messages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", C.LINT_CARRIED, ids=lambda c: c.name)
def test_carried_rule_findings_equal_the_references(case):
    ref, port = lint_both(case)
    assert findings(port) == findings(ref)
    assert [(C.to_ref(v.path), C.to_ref(v.message)) for v in port] == \
        [(v.path, v.message) for v in ref]


def test_carried_cases_fire_where_the_reference_tests_say():
    fired = {c.name: findings(lint_both(c)[1]) for c in C.LINT_CARRIED}
    assert fired["lock_discipline_sleep"] == [("lock-discipline", 5, 8)]
    assert len(fired["lock_discipline_join_and_queue_get"]) == 2
    assert fired["lock_discipline_outside"] == fired["lock_discipline_suppressed"] == []
    assert fired["bare_except_swallow"] == [("bare-except-policy", 4, 4)]
    assert fired["socket_urlopen"] == [("socket-deadline-policy", 3, 11)]
    assert fired["socket_outside"] == fired["socket_settimeout_value"] == []


def test_rule_set_is_the_references_less_pallas_tile_alignment():
    from mmlspark_tpu.analysis import all_rules as jall_rules

    assert set(all_rules()) == set(jall_rules()) - {"pallas-tile-alignment"}
    for name, cls in all_rules().items():
        if name not in ("jit-purity", "numpy-in-traced-code"):
            assert cls.description == jall_rules()[name].description


@pytest.mark.parametrize("src", C.REFERENCE_ONLY, ids=lambda s: str(len(s)))
def test_pallas_tile_alignment_snippets_have_no_port_rule(src):
    assert lint_source(src) == []
    with pytest.raises(KeyError):
        lint_source(src, select=["pallas-tile-alignment"])


# ---------------------------------------------------------------------------
# jit-purity and numpy-in-traced-code under torch's trace roots
# ---------------------------------------------------------------------------

_TRACED_PARAMS = [(c, k) for c in C.TRACED for k in (C.ROOT_KINDS if c.rooted else ("none",))]


@pytest.mark.parametrize("case,kind", _TRACED_PARAMS,
                         ids=[f"{c.name}-{k}" for c, k in _TRACED_PARAMS])
def test_traced_findings_equal_the_references_on_the_jax_original(case, kind):
    from mmlspark_tpu.analysis.lint import lint_source as jlint_source

    select = None if case.select is None else list(case.select)
    want = findings(jlint_source(case.reference, select=select))
    src = C.torch_variant(case.template, kind) if case.rooted else case.template
    got = lint_source(src, select=select)
    assert findings(got) == want
    for v in got:
        assert "jax" not in v.message and "jnp" not in v.message, v.message


def test_traced_messages_name_torch_remedies():
    src = C.torch_variant(C.TRACED[0].template, "graph_block")
    msgs = [v.message for v in lint_source(src, select=["jit-purity"])]
    assert msgs == [
        "time.time() inside captured block (line 4): wall-clock read executes at trace "
        "or capture time only",
        "print() inside captured block (line 4): print() runs at trace or capture time "
        "only; print the result outside the compiled or captured region",
    ]
    np_case = next(c for c in C.TRACED if c.name == "np_in_traced")
    (v,) = lint_source(C.torch_variant(np_case.template, "decorator"),
                       select=["numpy-in-traced-code"])
    assert v.message == ("np.sum() reachable from traced function 'f': numpy runs on the "
                         "host at trace or capture time only; use torch.sum or hoist to "
                         "host-side setup")


@pytest.mark.parametrize("kind", C.ROOT_KINDS)
def test_traced_reach_crosses_modules_of_the_port(kind, tmp_path):
    from mmlspark_tpu.analysis.lint import lint_paths as jlint_paths

    ref_pkg = tmp_path / "ref" / "mmlspark_tpu"
    port_pkg = tmp_path / "port" / "mmlspark_tpu_torch"
    for pkg, caller in ((ref_pkg, C.CROSS_CALLER),
                        (port_pkg, C.torch_variant(C.CROSS_CALLER_TEMPLATE, kind))):
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text("")
        (pkg / "kernels.py").write_text(C.CROSS_KERNELS)
        (pkg / "caller.py").write_text(caller)
    want, _, errors = jlint_paths([str(ref_pkg)], select=["numpy-in-traced-code"])
    got, _, port_errors = lint_paths([str(port_pkg)], select=["numpy-in-traced-code"])
    assert errors == port_errors == []
    assert findings(got) == findings(want) == [("numpy-in-traced-code", 3, 11)]
    assert got[0].path.endswith(os.path.join("mmlspark_tpu_torch", "kernels.py"))


def test_capture_block_statements_and_their_bare_callees_are_checked():
    src = (
        "import time, torch\n"
        "import numpy as np\n"
        "def helper(x):\n"
        "    return np.abs(x)\n"
        "class Step:\n"
        "    def run(self, x):\n"
        "        print(x)\n"
        "    def capture(self, g, x):\n"
        "        with torch.cuda.graph(g, capture_error_mode='thread_local'):\n"
        "            self.run(x)\n"
        "            y = helper(x)\n"
        "            t = time.perf_counter()\n"
        "        print(y, t)\n"
    )
    got = lint_source(src, select=["jit-purity", "numpy-in-traced-code"])
    # the self.run() method is not followed (no self.<method> resolution);
    # the print after the block is outside the capture
    assert findings(got) == [("numpy-in-traced-code", 4, 11), ("jit-purity", 12, 16)]
    assert got[1].message.startswith("time.perf_counter() inside captured block (line 9)")


def test_block_inside_a_traced_def_is_reported_once_and_tuples_of_callables_are_roots():
    src = (
        "import torch, time\n"
        "@torch.compile\n"
        "def f(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        t = time.time()\n"
        "    return x\n"
        "def a(x):\n"
        "    print(x)\n"
        "def b(x):\n"
        "    open(x)\n"
        "graphed = torch.cuda.make_graphed_callables((a, b), ((1,), (2,)))\n"
    )
    assert findings(lint_source(src, select=["jit-purity"])) == [
        ("jit-purity", 5, 12), ("jit-purity", 8, 4), ("jit-purity", 10, 4)]


def test_the_ports_capture_of_the_vw_step_is_indexed_and_clean():
    path = os.path.join(REPO, "mmlspark_tpu_torch", "vw", "base.py")
    with open(path, "r", encoding="utf-8") as fh:
        ctx = FileContext("mmlspark_tpu_torch/vw/base.py", fh.read())
    blocks = TracedIndex([ctx]).capture_blocks(ctx)
    assert len(blocks) == 1
    assert "torch.cuda.graph(self.graph" in ctx.line_text(blocks[0].lineno)
    assert [ast.unparse(s) for s in blocks[0].body] == ["self.run_step(None, None)"]
    assert lint_contexts([ctx], ["jit-purity", "numpy-in-traced-code"])[0] == []


# ---------------------------------------------------------------------------
# the suppression machinery and the CLI
# ---------------------------------------------------------------------------


def test_unknown_rule_rejected_and_parse_errors_reported_like_the_reference(tmp_path):
    from mmlspark_tpu.analysis.lint import lint_paths as jlint_paths
    from mmlspark_tpu.analysis.lint import lint_source as jlint_source

    for fn in (lint_source, jlint_source):
        with pytest.raises(KeyError):
            fn("x = 1\n", select=["no-such-rule"])
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    port = lint_paths([str(bad)])
    assert port[:2] == ([], 0) and len(port[2]) == 1
    assert port == jlint_paths([str(bad)])


def test_suppression_parsing_and_stale_audit_equal_the_references():
    from mmlspark_tpu.analysis.base import FileContext as JFileContext
    from mmlspark_tpu.analysis.lint import _run_rules as jrun_rules
    from mmlspark_tpu.analysis.lint import stale_suppressions as jstale

    src = (
        '"""Mentions # graftlint: disable=lock-order in a docstring."""\n'
        "import threading, time\n"
        "lock = threading.Lock()\n"
        "def f():\n"
        "    with lock:\n"
        "        time.sleep(1)  # graftlint: disable=lock-discipline,no-such-rule\n"
        "    x = 1  # graftlint: disable\n"
        "    try:\n"
        "        pass\n"
        "    except Exception:  # graftlint: disable=socket-deadline-policy\n"
        "        pass\n"
    )
    path = "mmlspark_tpu/runtime/fake.py"
    jctx, ctx = JFileContext(path, src), FileContext(C.to_port(path), src)
    assert ctx.suppressions == jctx.suppressions
    jv, js = jrun_rules([jctx])
    v, s = _run_rules([ctx])
    assert findings(v) == findings(jv) == [("bare-except-policy", 10, 4)]
    assert findings(s) == findings(js)
    assert [C.to_ref(line) for line in stale_suppressions([ctx], s)] == jstale([jctx], js)
    assert len(stale_suppressions([ctx], s)) == 3


def test_main_exit_codes_and_sarif_output(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    dirty = tmp_path / "dirty.py"
    dirty_case = next(c for c in C.TRACED if c.name == "dirty")
    dirty.write_text(C.torch_variant(dirty_case.template, "decorator"))
    assert main([str(clean)]) == 0
    assert main([str(dirty), "--fail-on-violation", "-q"]) == 1
    assert main([]) == 2
    assert main([str(clean), "--select", "no-such-rule"]) == 2
    assert main([str(clean), "--check-suppressions", "--select", "jit-purity"]) == 2
    assert main([str(tmp_path / "missing.py")]) == 2
    capsys.readouterr()
    out = tmp_path / "out.sarif"
    assert main([str(dirty), "--format", "sarif", "--output", str(out)]) == 1
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(out.read_text())
    (result,) = printed["runs"][0]["results"]
    assert result["ruleId"] == "jit-purity"
    assert result["locations"][0]["physicalLocation"]["region"] == \
        {"startLine": 4, "startColumn": 16}
    assert main([str(dirty), "--ignore", "jit-purity"]) == 0
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert "pallas-tile-alignment" not in listed and "lock-order:" in listed


def test_sarif_equals_the_references_on_the_same_violations():
    from mmlspark_tpu.analysis.sarif import to_sarif as jto_sarif
    from mmlspark_tpu.analysis.witness import WITNESS_RULE, WITNESS_RULE_DESCRIPTION

    cases = [c for c in C.LINT_CARRIED + C.CONCURRENCY_CARRIED
             if c.name in ("lock_order_cross_module", "bare_except_swallow",
                           "lock_discipline_join_and_queue_get", "rank_branch_guarded",
                           "tmp_rename_journal_py")]
    ref, port = [], []
    for case in cases:
        r, p = lint_both(case)
        ref += r
        port += p
    assert len(port) == 6
    extra = {WITNESS_RULE: WITNESS_RULE_DESCRIPTION}
    for kwargs in ({}, {"extra_rules": extra}):
        got = json.loads(C.to_ref(json.dumps(to_sarif(port, **kwargs), sort_keys=True)))
        assert got == jto_sarif(ref, **kwargs)
    assert to_sarif([])["runs"][0]["results"] == []
    assert to_sarif([])["runs"][0]["tool"]["driver"]["name"] == "graftlint"


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------


def test_the_ports_tree_lints_clean_with_no_stale_suppression(self_scan):
    contexts, errors, violations, suppressed = self_scan
    assert errors == []
    assert violations == [], "\n".join(v.render() for v in violations)
    assert stale_suppressions(contexts, suppressed) == []
    assert len(contexts) == len(discover_files([os.path.join(REPO, "mmlspark_tpu_torch")])) > 150
    assert any(c.path.endswith(os.path.join("analysis", "witness.py")) for c in contexts)


def test_the_ports_trace_index_spans_its_modules(self_scan):
    contexts = self_scan[0]
    index = contexts[0].traced_index
    modules = {idx.module for idx in index._files.values()}
    assert "mmlspark_tpu_torch.vw.base" in modules
    assert "mmlspark_tpu_torch.analysis.traced" in modules
    blocks = [b for c in contexts for b in index.capture_blocks(c)]
    assert len(blocks) == 1
