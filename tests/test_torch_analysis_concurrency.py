"""The port's concurrency rules, lock graph and lock witness
(``mmlspark_tpu_torch.analysis``) against the reference's.

Every snippet of the reference's ``tests/test_analysis_concurrency.py``
(shared through ``tests/_torch_analysis_cases.py``) gives the port the
reference's findings, with the package mapped in paths, lock ids and
messages. The witness wraps locks allocated in port modules only, names
each by its allocation site ``mmlspark_tpu_torch/<path>:<line>`` (the
static graph's ``LockDef`` site), leaves ``threading.Lock`` and
``threading.RLock`` as it found them, and a CPU subprocess under
``MMLSPARK_TPU_LOCKCHECK=1`` dumps a report that ``--witness-check``
accepts.
"""

import ast
import glob
import json
import os
import subprocess
import sys
import threading

import pytest

import _torch_reference  # noqa: F401  (the reference's import shim)
import _torch_analysis_cases as C
from mmlspark_tpu_torch.analysis import witness as wmod
from mmlspark_tpu_torch.analysis.base import FileContext
from mmlspark_tpu_torch.analysis.lint import (
    _load_contexts,
    discover_files,
    lint_contexts,
    main,
)
from mmlspark_tpu_torch.analysis.lockgraph import ConcurrencyIndex, blocking_reason
from mmlspark_tpu_torch.analysis.witness import (
    WITNESS_RULE,
    LockWitness,
    check_witness,
    install_from_env,
    load_reports,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def findings(violations):
    return [(v.rule, v.line, v.col) for v in violations]


def mapped(obj):
    """A port value (report, lock ids, messages) with the package mapped
    to the reference's, through its JSON text."""
    return json.loads(C.to_ref(json.dumps(obj, sort_keys=True)))


def _pair_report(edges, sites=None):
    return {"version": 1, "sites": sites or {}, "edges": edges}


# ---------------------------------------------------------------------------
# the eight concurrency rules: equal findings, equal messages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", C.CONCURRENCY_CARRIED, ids=lambda c: c.name)
def test_concurrency_findings_equal_the_references(case):
    from mmlspark_tpu.analysis.base import FileContext as JFileContext
    from mmlspark_tpu.analysis.lint import lint_contexts as jlint_contexts

    select = list(case.select)
    ref, _ = jlint_contexts([JFileContext(p, s) for p, s in case.files], select)
    port, _ = lint_contexts([FileContext(p, s) for p, s in case.port_files()], select)
    assert findings(port) == findings(ref)
    assert [(C.to_ref(v.path), C.to_ref(v.message)) for v in port] == \
        [(v.path, v.message) for v in ref]


def test_concurrency_cases_fire_where_the_reference_tests_say():
    got = {}
    for case in C.CONCURRENCY_CARRIED:
        got[case.name], _ = lint_contexts(
            [FileContext(p, s) for p, s in case.port_files()], list(case.select))
    assert findings(got["lock_order_abba"]) == [("lock-order", 10, 12)]
    assert "ABBA" in got["lock_order_abba"][0].message
    assert findings(got["lock_order_cross_module"]) == [("lock-order", 11, 12)]
    assert got["lock_order_consistent"] == got["lock_order_suppressed"] == []
    assert "time.sleep" in got["lock_blocking_callee_sleep"][0].message
    assert "mmlspark_tpu_torch.runtime.w.W._lock" in got["lock_blocking_callee_sleep"][0].message
    assert got["lock_blocking_direct_is_not_its"] == []
    assert len(got["collective_deadline_wait_join"]) == 2
    assert "'rank'" in got["rank_branch_guarded"][0].message
    assert "RegistryRecovered" in got["onset_without_recovery"][0].message
    assert findings(got["tmp_rename_dataguard"]) == [("tmp-rename-atomicity", 2, 9)]


@pytest.mark.parametrize("call,blocks", C.BLOCKING_CALLS)
def test_blocking_reason_catalog_equals_the_references(call, blocks):
    from mmlspark_tpu.analysis.lockgraph import blocking_reason as jblocking_reason

    node = ast.parse(call).body[0].value
    assert blocking_reason(node) == jblocking_reason(node)
    assert bool(blocking_reason(node)) is blocks


def test_the_ports_dataguard_passes_its_own_rules():
    pkg_dir = os.path.join(REPO, "mmlspark_tpu_torch", "dataguard")
    contexts = []
    for path in sorted(glob.glob(os.path.join(pkg_dir, "*.py"))):
        with open(path, "r", encoding="utf-8") as fh:
            rel = os.path.join("mmlspark_tpu_torch", "dataguard", os.path.basename(path))
            contexts.append(FileContext(rel, fh.read()))
    assert any(c.path.endswith("dlq.py") for c in contexts)
    violations, _ = lint_contexts(
        contexts, select=["lock-discipline", "lock-blocking", "lock-order",
                          "tmp-rename-atomicity"])
    assert violations == []


# ---------------------------------------------------------------------------
# the lock graph
# ---------------------------------------------------------------------------


def test_concurrency_index_equals_the_references():
    from mmlspark_tpu.analysis.base import FileContext as JFileContext
    from mmlspark_tpu.analysis.lockgraph import ConcurrencyIndex as JConcurrencyIndex

    jindex = JConcurrencyIndex([JFileContext("mmlspark_tpu/runtime/pair.py", C.ABBA_SRC)])
    index = ConcurrencyIndex([FileContext("mmlspark_tpu_torch/runtime/pair.py", C.ABBA_SRC)])
    assert mapped({k: [d.path, d.line, d.kind] for k, d in index.lock_defs.items()}) == \
        {k: [d.path, d.line, d.kind] for k, d in jindex.lock_defs.items()}
    assert mapped(sorted(f"{a}>{b}" for a, b in index.edges)) == \
        sorted(f"{a}>{b}" for a, b in jindex.edges)
    assert [C.to_ref(c.describe()) for c in index.cycles()] == \
        [c.describe() for c in jindex.cycles()]
    assert len(index.cycles()) == 1
    sites = index.lock_sites()
    assert sites[("mmlspark_tpu_torch/runtime/pair.py", 5)] == \
        "mmlspark_tpu_torch.runtime.pair.A._a_lock"
    assert ("mmlspark_tpu_torch/runtime/pair.py", 15) in sites


def test_lock_sites_are_the_sites_the_witness_records(tmp_path):
    """A small package in a temporary mmlspark_tpu_torch/: the static
    graph's lock sites are the witness's allocation sites."""
    pkg = tmp_path / "mmlspark_tpu_torch" / "runtime"
    pkg.mkdir(parents=True)
    sources = {
        "pair.py": C.ABBA_SRC,
        "mod.py": ("import threading\n"
                   "_GUARD = threading.RLock()\n"
                   "class Store:\n"
                   "    def __init__(self):\n"
                   "        self._lock = threading.Lock()\n"),
    }
    for name, src in sources.items():
        (pkg / name).write_text(src)
    contexts, errors = _load_contexts(discover_files([str(tmp_path / "mmlspark_tpu_torch")]))
    assert errors == []
    static = {f"{p}:{line}" for p, line in ConcurrencyIndex(contexts).lock_sites()}
    w = LockWitness()
    w.install()
    try:
        for name, src in sources.items():
            ns = {}
            exec(compile(src, str(pkg / name), "exec"), ns)
            if name == "pair.py":
                a = ns["A"](None)
                a.b = ns["B"](a)
                a.forward()
            else:
                ns["Store"]()
    finally:
        w.uninstall()
    report = w.report()
    assert set(report["sites"]) == static == {
        "mmlspark_tpu_torch/runtime/pair.py:5", "mmlspark_tpu_torch/runtime/pair.py:15",
        "mmlspark_tpu_torch/runtime/mod.py:2", "mmlspark_tpu_torch/runtime/mod.py:5"}
    assert report["sites"]["mmlspark_tpu_torch/runtime/mod.py:2"] == "rlock"
    assert report["edges"] == [{"from": "mmlspark_tpu_torch/runtime/pair.py:5",
                                "to": "mmlspark_tpu_torch/runtime/pair.py:15", "count": 1}]


# ---------------------------------------------------------------------------
# the runtime lock witness
# ---------------------------------------------------------------------------


def test_witness_wraps_port_allocations_only():
    w = LockWitness()
    raw = type(threading.Lock())
    w.install()
    try:
        exec(compile(C.FIXTURE_MOD, "mmlspark_tpu_torch/fake/fx.py", "exec"), {})
        ref_ns, std_ns = {}, {}
        exec(compile(C.FIXTURE_MOD, "/src/mmlspark_tpu/fake/fx.py", "exec"), ref_ns)
        exec(compile(C.FIXTURE_MOD, "/usr/lib/python3.12/fx.py", "exec"), std_ns)
        kept = threading.Lock()  # this test file is outside the package
    finally:
        w.uninstall()
    assert type(kept) is raw
    assert type(ref_ns["a"]) is raw and type(std_ns["b"]) is raw
    assert w.report()["sites"] == {"mmlspark_tpu_torch/fake/fx.py:2": "lock",
                                   "mmlspark_tpu_torch/fake/fx.py:3": "lock"}


def test_a_lock_an_extension_allocates_from_a_port_line_stays_raw(tmp_path):
    """A factory called from C (here defaultdict's, as numpy's bit
    generators call it) sees a port line as its nearest frame; that line
    calls no Lock(), so the lock is not the port's and stays raw."""
    pkg = tmp_path / "mmlspark_tpu_torch"
    pkg.mkdir()
    src = ("import collections, threading\n"
           "locks = collections.defaultdict(threading.Lock)\n"
           "made = locks['k']\n"
           "own = threading.Lock()\n")
    (pkg / "ext.py").write_text(src)
    w = LockWitness()
    w.install()
    try:
        ns = {}
        exec(compile(src, str(pkg / "ext.py"), "exec"), ns)
    finally:
        w.uninstall()
    assert type(ns["made"]) is type(threading.Lock())
    assert type(ns["own"]).__name__ == "_WitnessedLock"
    assert w.report()["sites"] == {"mmlspark_tpu_torch/ext.py:4": "lock"}


def test_witness_report_equals_the_references():
    from mmlspark_tpu.analysis.witness import LockWitness as JLockWitness

    reports = []
    for cls, path in ((JLockWitness, "mmlspark_tpu/fake/fx.py"),
                      (LockWitness, "mmlspark_tpu_torch/fake/fx.py")):
        w = cls()
        w.install()
        try:
            exec(compile(C.FIXTURE_MOD, path, "exec"), {})
        finally:
            w.uninstall()
        rep = w.report()
        rep.pop("pid")
        reports.append(rep)
    assert mapped(reports[1]) == reports[0]
    assert reports[1]["edges"] == [{"from": "mmlspark_tpu_torch/fake/fx.py:2",
                                    "to": "mmlspark_tpu_torch/fake/fx.py:3", "count": 1}]


def test_uninstall_restores_the_factories_install_found(monkeypatch):
    def lock_factory():
        return "lock"

    def rlock_factory():
        return "rlock"

    before = (threading.Lock, threading.RLock)
    monkeypatch.setattr(threading, "Lock", lock_factory)
    monkeypatch.setattr(threading, "RLock", rlock_factory)
    w = LockWitness()
    w.install()
    assert threading.Lock is not lock_factory
    w.uninstall()
    assert threading.Lock is lock_factory and threading.RLock is rlock_factory
    monkeypatch.undo()
    w2 = LockWitness()
    w2.install()
    w2.uninstall()
    assert (threading.Lock, threading.RLock) == before


def test_rlock_reentry_is_not_an_edge():
    w = LockWitness()
    w._record_acquire("mmlspark_tpu_torch/x.py:1", "rlock")
    w._record_acquire("mmlspark_tpu_torch/x.py:1", "rlock")
    assert w.report()["edges"] == []
    w._record_acquire("mmlspark_tpu_torch/y.py:2", "lock")
    assert [e["to"] for e in w.report()["edges"]] == ["mmlspark_tpu_torch/y.py:2"]


def test_dump_and_load_round_trip(tmp_path):
    w = LockWitness()
    w._record_acquire("mmlspark_tpu_torch/x.py:1", "lock")
    w._record_acquire("mmlspark_tpu_torch/y.py:2", "lock")
    out = tmp_path / "lockwitness-1.json"
    w.dump(str(out))
    assert not list(tmp_path.glob("*.tmp.*"))  # tmp+rename, no litter
    (tmp_path / "other.json").write_text("{}")
    reports = load_reports([str(tmp_path)])
    assert reports == [w.report()] == load_reports([str(out)])
    with pytest.raises(FileNotFoundError):
        load_reports([str(tmp_path / "missing")])


def test_install_from_env_requires_the_flag(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_LOCKCHECK", raising=False)
    monkeypatch.setattr(wmod, "_ACTIVE", None)
    assert install_from_env() is None
    monkeypatch.setenv("MMLSPARK_TPU_LOCKCHECK", "0")
    assert install_from_env() is None
    assert wmod.active_witness() is None


# ---------------------------------------------------------------------------
# the witness against the static graph
# ---------------------------------------------------------------------------


_CHECK_REPORTS = [
    # witnessed B -> A, inverting the static A -> B
    _pair_report([{"from": "mmlspark_tpu/runtime/pair.py:15",
                   "to": "mmlspark_tpu/runtime/pair.py:5", "count": 3}],
                 {"mmlspark_tpu/runtime/pair.py:5": "lock",
                  "mmlspark_tpu/runtime/pair.py:15": "lock"}),
    # a runtime-only inversion between two locks the static graph lacks
    _pair_report([{"from": "mmlspark_tpu/io/h.py:10", "to": "mmlspark_tpu/io/h.py:20",
                   "count": 1},
                  {"from": "mmlspark_tpu/io/h.py:20", "to": "mmlspark_tpu/io/h.py:10",
                   "count": 1}]),
    # the static order: consistent
    _pair_report([{"from": "mmlspark_tpu/runtime/pair.py:5",
                   "to": "mmlspark_tpu/runtime/pair.py:15", "count": 7}]),
]


@pytest.mark.parametrize("report", _CHECK_REPORTS, ids=["static", "runtime", "consistent"])
def test_check_witness_equals_the_references(report):
    from mmlspark_tpu.analysis.base import FileContext as JFileContext
    from mmlspark_tpu.analysis.witness import check_witness as jcheck_witness

    jctx = JFileContext("mmlspark_tpu/runtime/pair.py", C.ABBA_CONSISTENT)
    ctx = FileContext("mmlspark_tpu_torch/runtime/pair.py", C.ABBA_CONSISTENT)
    want = jcheck_witness([report], [jctx])
    got = check_witness([json.loads(C.to_port(json.dumps(report)))], [ctx])
    assert findings(got) == findings(want)
    assert [(C.to_ref(v.path), C.to_ref(v.message)) for v in got] == \
        [(v.path, v.message) for v in want]
    assert len(got) == (0 if report is _CHECK_REPORTS[2] else 1)


_INVERTED = (
    "import threading\n"
    "class A:\n"
    "    def __init__(self):\n"
    "        self._a_lock = threading.Lock()\n"
    "class B:\n"
    "    def __init__(self, a):\n"
    "        self._b_lock = threading.Lock()\n"
    "        self.a = a\n"
    "    def forward(self):\n"
    "        with self.a._a_lock:\n"
    "            with self._b_lock:\n"
    "                pass\n"
    "def take(first, second):\n"
    "    with first:\n"
    "        with second:\n"
    "            pass\n"
    "x_lock = threading.Lock()\n"
    "y_lock = threading.Lock()\n"
)


def test_an_inverted_order_in_a_package_is_a_lock_witness_finding(tmp_path):
    """The static graph holds A -> B; at runtime B -> A is taken through a
    helper the resolver cannot see, and two module locks are taken in both
    orders: two ``lock-witness`` findings, one against the static edge and
    one a runtime-only inversion."""
    pkg = tmp_path / "mmlspark_tpu_torch" / "serving"
    pkg.mkdir(parents=True)
    path = pkg / "inv.py"
    path.write_text(_INVERTED)
    w = LockWitness()
    w.install()
    try:
        ns = {}
        exec(compile(_INVERTED, str(path), "exec"), ns)
        a = ns["A"]()
        b = ns["B"](a)  # B.forward (A then B) never runs
        ns["take"](b._b_lock, a._a_lock)
        ns["take"](ns["x_lock"], ns["y_lock"])
        ns["take"](ns["y_lock"], ns["x_lock"])
    finally:
        w.uninstall()
    contexts, _ = _load_contexts([str(path)])
    found = check_witness([w.report()], contexts)
    assert [v.rule for v in found] == [WITNESS_RULE, WITNESS_RULE]
    messages = sorted(v.message for v in found)
    assert messages[0].startswith("runtime lock-order inversion: "
                                  "mmlspark_tpu_torch.serving.inv.x_lock -> ")
    assert messages[1].startswith("witnessed order mmlspark_tpu_torch.serving.inv.B._b_lock -> "
                                  "mmlspark_tpu_torch.serving.inv.A._a_lock inverts the static")
    assert lint_contexts(contexts)[0] == []  # the static lint alone sees no cycle


def test_a_witnessed_cpu_workload_is_consistent_with_the_static_graph(tmp_path):
    """A subprocess under MMLSPARK_TPU_LOCKCHECK=1 imports the port and runs
    the partition scheduler with 2 executors and a ModelStore commit on the
    CPU: its dump is non-empty, every site is a static lock site, and
    ``--witness-check`` over the port's tree exits 0."""
    out = tmp_path / "witness"
    code = (
        "import sys\n"
        "import mmlspark_tpu_torch\n"
        "from mmlspark_tpu_torch import runtime as rt\n"
        "from mmlspark_tpu_torch.runtime.journal import ModelStore\n"
        "pol = rt.SchedulerPolicy(max_workers=2, backoff_base=0.01, heartbeat_interval=0.02)\n"
        "assert rt.run_partitioned(lambda x: x * 2, list(range(8)), pol) == "
        "[x * 2 for x in range(8)]\n"
        f"assert ModelStore({str(tmp_path / 'store')!r}).commit('tree') == 1\n"
        "from mmlspark_tpu_torch.analysis.witness import active_witness\n"
        "assert active_witness() is not None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'mmlspark_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, MMLSPARK_TPU_LOCKCHECK="1", MMLSPARK_TPU_LOCKCHECK_OUT=str(out))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (report,) = load_reports([str(out)])
    assert report["sites"]
    contexts, _ = _load_contexts(discover_files([os.path.join(REPO, "mmlspark_tpu_torch")]))
    index = ConcurrencyIndex(contexts)
    static = {f"{p}:{line}": lock_id for (p, line), lock_id in index.lock_sites().items()}
    assert set(report["sites"]) <= set(static)
    # the store's per-root lock is allocated at its LockDef site
    assert "mmlspark_tpu_torch.runtime.journal.ModelStore._lock" in \
        {static[site] for site in report["sites"]}
    assert check_witness([report], contexts) == []
    assert main([os.path.join(REPO, "mmlspark_tpu_torch"), "--witness-check", str(out),
                 "-q"]) == 0
