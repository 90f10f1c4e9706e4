"""The reference analysis tests' source snippets, shared by the port's
analysis test files.

Every snippet of ``tests/test_analysis_lint.py`` and
``tests/test_analysis_concurrency.py`` stands here once, verbatim:

- ``LINT_CARRIED`` and ``CONCURRENCY_CARRIED``: the snippets of the
  rules that carry over unchanged (the three generic lint rules, the eight
  concurrency rules and the suppression machinery), each with the paths
  and the rule selection the reference's test lints it under. The port lints the same source with
  ``mmlspark_tpu`` mapped to ``mmlspark_tpu_torch`` in its paths, and must
  give the same findings.
- ``TRACED``: the ``jit-purity`` and ``numpy-in-traced-code`` snippets, each
  with a torch transliteration written as a template over the trace root
  (``torch_variant``). Each variant keeps the reference's line and column
  of every finding.
- ``REFERENCE_ONLY``: the ``pallas-tile-alignment`` snippets, a rule with no
  counterpart in the port.

``test_torch_analysis_lint.py`` checks that these sets hold every snippet
of the two reference files. Not a test module: pytest collects nothing
here.
"""

import ast
import dataclasses
from typing import Optional, Tuple

REF_PKG, PORT_PKG = "mmlspark_tpu", "mmlspark_tpu_torch"


def to_port(text: str) -> str:
    """A reference path or source with its package segment renamed."""
    return text.replace(f"{REF_PKG}/", f"{PORT_PKG}/").replace(
        f"from {REF_PKG}.", f"from {PORT_PKG}.")


def to_ref(text: str) -> str:
    """A port message or path with the package name mapped back."""
    return text.replace(PORT_PKG, REF_PKG)


@dataclasses.dataclass(frozen=True)
class Case:
    """One reference test's lint: files ((path, source), ...), the rule
    selection (None: the full set)."""

    name: str
    files: Tuple[Tuple[str, str], ...]
    select: Optional[Tuple[str, ...]]

    def port_files(self):
        return tuple((to_port(p), to_port(s)) for p, s in self.files)


def _case(name, src, select, path="<string>"):
    return Case(name, ((path, src),), None if select is None else tuple(select))


# ---------------------------------------------------------------------------
# Snippets of the rules that carry over (tests/test_analysis_lint.py)
# ---------------------------------------------------------------------------

_RT = "mmlspark_tpu/runtime/fake.py"
_SLEEP_UNDER_LOCK = (
    "import threading, time\n"
    "lock = threading.Lock()\n"
    "def f():\n"
    "    with lock:\n"
    "        time.sleep(1)\n"
)
_URLOPEN = (
    "import urllib.request\n"
    "def f(url):\n"
    "    return urllib.request.urlopen(url).read()\n"
)

LINT_CARRIED = [
    # lock-discipline
    _case("lock_discipline_sleep", _SLEEP_UNDER_LOCK, ["lock-discipline"], _RT),
    _case("lock_discipline_join_and_queue_get", (
        "import threading\n"
        "lock = threading.Lock()\n"
        "def f(t, q):\n"
        "    with lock:\n"
        "        t.join()\n"
        "        q.get(timeout=5)\n"
    ), ["lock-discipline"], _RT),
    _case("lock_discipline_str_join_dict_get", (
        "import threading\n"
        "lock = threading.Lock()\n"
        "def f(d):\n"
        "    with lock:\n"
        "        s = ','.join(['a', 'b'])\n"
        "        v = d.get('key')\n"
        "    return s, v\n"
    ), ["lock-discipline"], _RT),
    _case("lock_discipline_streaming", _SLEEP_UNDER_LOCK, ["lock-discipline"],
          "mmlspark_tpu/streaming/fake.py"),
    _case("lock_discipline_sweep", _SLEEP_UNDER_LOCK, ["lock-discipline"],
          "mmlspark_tpu/sweep/fake.py"),
    _case("lock_discipline_outside", _SLEEP_UNDER_LOCK, ["lock-discipline"],
          "mmlspark_tpu/ops/fake.py"),
    _case("lock_discipline_suppressed", (
        "import threading, time\n"
        "lock = threading.Lock()\n"
        "def f():\n"
        "    with lock:\n"
        "        time.sleep(1)  # graftlint: disable=lock-discipline\n"
    ), ["lock-discipline"], _RT),
    # bare-except-policy
    _case("bare_except_swallow", (
        "def f():\n"
        "    try:\n"
        "        work()\n"
        "    except Exception:\n"
        "        pass\n"
    ), ["bare-except-policy"]),
    _case("bare_except_reraise", (
        "def f():\n"
        "    try:\n"
        "        work()\n"
        "    except Exception:\n"
        "        cleanup()\n"
        "        raise\n"
    ), ["bare-except-policy"]),
    _case("bare_except_logging", (
        "import logging\n"
        "logger = logging.getLogger(__name__)\n"
        "def f():\n"
        "    try:\n"
        "        work()\n"
        "    except Exception as e:\n"
        "        logger.warning('failed: %s', e)\n"
    ), ["bare-except-policy"]),
    _case("bare_except_narrow", (
        "def f():\n"
        "    try:\n"
        "        work()\n"
        "    except ValueError:\n"
        "        pass\n"
    ), ["bare-except-policy"]),
    _case("bare_except_noqa", (
        "def f():\n"
        "    try:\n"
        "        work()\n"
        "    except Exception:  # noqa: BLE001 — best-effort cleanup\n"
        "        pass\n"
    ), ["bare-except-policy"]),
    _case("bare_except_suppressed", (
        "def f():\n"
        "    try:\n"
        "        work()\n"
        "    except Exception:  # graftlint: disable=bare-except-policy\n"
        "        pass\n"
    ), ["bare-except-policy"]),
    # socket-deadline-policy
    _case("socket_urlopen", _URLOPEN, ["socket-deadline-policy"],
          "mmlspark_tpu/serving/fake.py"),
    _case("socket_urlopen_timeout", (
        "import urllib.request\n"
        "def f(url):\n"
        "    return urllib.request.urlopen(url, timeout=5).read()\n"
    ), ["socket-deadline-policy"], "mmlspark_tpu/serving/fake.py"),
    _case("socket_create_connection", (
        "import socket\n"
        "def f(port):\n"
        "    return socket.create_connection(('127.0.0.1', port))\n"
    ), ["socket-deadline-policy"], "mmlspark_tpu/serving/fake.py"),
    _case("socket_create_connection_timeout", (
        "import socket\n"
        "def f(port):\n"
        "    return socket.create_connection(('x', port), timeout=1.0)\n"
    ), ["socket-deadline-policy"], "mmlspark_tpu/serving/fake.py"),
    _case("socket_settimeout_none", (
        "def f(conn):\n"
        "    conn.settimeout(None)\n"
    ), ["socket-deadline-policy"], _RT),
    _case("socket_settimeout_value", (
        "def f(conn):\n"
        "    conn.settimeout(30.0)\n"
    ), ["socket-deadline-policy"], "mmlspark_tpu/serving/fake.py"),
    _case("socket_outside", _URLOPEN, ["socket-deadline-policy"], "mmlspark_tpu/ops/fake.py"),
    # the suppression machinery on a source of no rule
    _case("clean_source", "x = 1\n", None),
]


# ---------------------------------------------------------------------------
# Snippets of the concurrency rules (tests/test_analysis_concurrency.py)
# ---------------------------------------------------------------------------

ABBA_SRC = (
    "import threading\n"
    "\n"
    "class A:\n"
    "    def __init__(self, b):\n"
    "        self._a_lock = threading.Lock()\n"
    "        self.b = b\n"
    "\n"
    "    def forward(self):\n"
    "        with self._a_lock:\n"
    "            with self.b._b_lock:\n"
    "                pass\n"
    "\n"
    "class B:\n"
    "    def __init__(self, a):\n"
    "        self._b_lock = threading.Lock()\n"
    "        self.a = a\n"
    "\n"
    "    def backward(self):\n"
    "        with self._b_lock:\n"
    "            with self.a._a_lock:\n"
    "                pass\n"
)
# the consistent order, A then B on both paths (TestLockOrder, TestWitnessCheck)
ABBA_CONSISTENT = ABBA_SRC.replace(
    "        with self._b_lock:\n"
    "            with self.a._a_lock:\n",
    "        with self.a._a_lock:\n"
    "            with self._b_lock:\n",
)
MOD_A = (
    "import threading\n"
    "from mmlspark_tpu.runtime.modb import B\n"
    "\n"
    "class A:\n"
    "    def __init__(self):\n"
    "        self._a_lock = threading.Lock()\n"
    "        self.b = B()\n"
    "\n"
    "    def forward(self):\n"
    "        with self._a_lock:\n"
    "            self.b.poke()\n"
)
MOD_B = (
    "import threading\n"
    "\n"
    "class B:\n"
    "    def __init__(self):\n"
    "        self._b_lock = threading.Lock()\n"
    "        self.a = None\n"
    "\n"
    "    def poke(self):\n"
    "        with self._b_lock:\n"
    "            pass\n"
    "\n"
    "    def backward(self):\n"
    "        with self._b_lock:\n"
    "            with self.a._a_lock:\n"
    "                pass\n"
)
_W_SLEEPS = (
    "import threading, time\n"
    "\n"
    "class W:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "\n"
    "    def slow(self):\n"
    "        time.sleep(1.0)\n"
    "\n"
    "    def work(self):\n"
    "        with self._lock:\n"
    "            self.slow()\n"
)
_W_DIRECT = (
    "import threading, time\n"
    "\n"
    "class W:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "\n"
    "    def work(self):\n"
    "        with self._lock:\n"
    "            time.sleep(1.0)\n"
)
_W = "mmlspark_tpu/runtime/w.py"
_G = "mmlspark_tpu/runtime/g.py"
_C = "mmlspark_tpu/runtime/c.py"
_Q = "mmlspark_tpu/streaming/q.py"
_S = "mmlspark_tpu/streaming/s.py"
_CK = "mmlspark_tpu/streaming/ckpt.py"
_COMMIT_ONLY = (
    "class Q:\n"
    "    def step(self, epoch):\n"
    "        self._write_commit(epoch)\n"
)
_SAVE_W = (
    "def save(path, data):\n"
    "    with open(path, 'w') as fh:\n"
    "        fh.write(data)\n"
)
_RANK_PSUM = (
    "def f(rank, grad):\n"
    "    if rank == 0:\n"
    "        return psum(grad)\n"
    "    return grad\n"
)

CONCURRENCY_CARRIED = [
    # lock-order
    _case("lock_order_abba", ABBA_SRC, ["lock-order"]),
    _case("lock_order_consistent", ABBA_CONSISTENT, ["lock-order"]),
    Case("lock_order_cross_module", (("mmlspark_tpu/runtime/moda.py", MOD_A),
                                     ("mmlspark_tpu/runtime/modb.py", MOD_B)), ("lock-order",)),
    _case("lock_order_suppressed", ABBA_SRC.replace(
        "            with self.b._b_lock:\n",
        "            with self.b._b_lock:  # graftlint: disable=lock-order\n"), ["lock-order"]),
    # lock-blocking
    _case("lock_blocking_callee_sleep", _W_SLEEPS, ["lock-blocking"], _W),
    _case("lock_blocking_direct_is_not_its", _W_DIRECT, ["lock-blocking"], _W),
    _case("lock_blocking_direct_is_lock_disciplines", _W_DIRECT, ["lock-discipline"], _W),
    _case("lock_blocking_non_blocking_callee", (
        "import threading\n"
        "\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._n = 0\n"
        "\n"
        "    def bump(self):\n"
        "        self._n += 1\n"
        "\n"
        "    def work(self):\n"
        "        with self._lock:\n"
        "            self.bump()\n"
    ), ["lock-blocking"], _W),
    _case("lock_blocking_outside", _W_SLEEPS, ["lock-blocking"],
          "mmlspark_tpu/cognitive/w.py"),
    # collective-deadline
    _case("collective_deadline_group", (
        "def form(members, size):\n"
        "    return AllreduceGroup(members, size)\n"
    ), ["collective-deadline"], _G),
    _case("collective_deadline_wait_join", (
        "def f(ev, t):\n"
        "    ev.wait()\n"
        "    t.join()\n"
    ), ["collective-deadline"], _G),
    _case("collective_deadline_bounded", (
        "def f(members, size, ev, t, parts):\n"
        "    g = AllreduceGroup(members, size, timeout=5.0)\n"
        "    ev.wait(timeout=2.0)\n"
        "    t.join(1.0)\n"
        "    return ', '.join(parts)\n"
    ), ["collective-deadline"], _G),
    _case("collective_deadline_suppressed", (
        "def f(ev):\n"
        "    ev.wait()  # graftlint: disable=collective-deadline\n"
    ), ["collective-deadline"], _G),
    # collective-rank-branch
    _case("rank_branch_guarded", _RANK_PSUM, ["collective-rank-branch"], _C),
    _case("rank_branch_member_attribute", (
        "def f(self, grad):\n"
        "    if self.member_id != 0:\n"
        "        barrier()\n"
    ), ["collective-rank-branch"], _C),
    _case("rank_branch_world_size", (
        "def f(world_size, grad):\n"
        "    if world_size > 1:\n"
        "        return psum(grad)\n"
        "    return grad\n"
    ), ["collective-rank-branch"], _C),
    _case("rank_branch_nested_function", (
        "def f(rank, grad):\n"
        "    if rank == 0:\n"
        "        def helper(g):\n"
        "            return psum(g)\n"
        "    return grad\n"
    ), ["collective-rank-branch"], _C),
    _case("rank_branch_suppressed", (
        "def f(rank, grad):\n"
        "    if rank == 0:\n"
        "        return psum(grad)  # graftlint: disable=collective-rank-branch\n"
    ), ["collective-rank-branch"], _C),
    # wal-before-commit
    _case("wal_commit_without_wal", _COMMIT_ONLY, ["wal-before-commit"], _Q),
    _case("wal_commit_before_wal", (
        "class Q:\n"
        "    def step(self, epoch):\n"
        "        self._write_commit(epoch)\n"
        "        self._write_wal(epoch)\n"
    ), ["wal-before-commit"], _Q),
    _case("wal_then_commit", (
        "class Q:\n"
        "    def step(self, epoch):\n"
        "        self._write_wal(epoch)\n"
        "        self._write_commit(epoch)\n"
    ), ["wal-before-commit"], _Q),
    _case("wal_outside_streaming", _COMMIT_ONLY, ["wal-before-commit"],
          "mmlspark_tpu/serving/q.py"),
    # journal-before-store
    _case("journal_store_without_journal", (
        "class Sink:\n"
        "    def flush(self, text):\n"
        "        self._store.commit(text)\n"
    ), ["journal-before-store"], _S),
    _case("journal_record_first", (
        "class Sink:\n"
        "    def flush(self, epoch, text):\n"
        "        self._journal.record(epoch)\n"
        "        self._store.commit(text)\n"
    ), ["journal-before-store"], _S),
    _case("journal_caller_records", (
        "class Sink:\n"
        "    def run(self, epoch, text):\n"
        "        self._journal.record(epoch)\n"
        "        self._commit(text)\n"
        "\n"
        "    def _commit(self, text):\n"
        "        self._store.commit(text)\n"
    ), ["journal-before-store"], _S),
    # tmp-rename-atomicity
    _case("tmp_rename_bare_open", _SAVE_W, ["tmp-rename-atomicity"], _CK),
    _case("tmp_rename_write_text", (
        "def save(path, data):\n"
        "    path.write_text(data)\n"
    ), ["tmp-rename-atomicity"], _CK),
    _case("tmp_rename_renaming_writer", (
        "import os\n"
        "def save(path, data):\n"
        "    tmp = path + '.tmp'\n"
        "    with open(tmp, 'w') as fh:\n"
        "        fh.write(data)\n"
        "    os.replace(tmp, path)\n"
    ), ["tmp-rename-atomicity"], _CK),
    _case("tmp_rename_atomic_named", (
        "def _atomic_write(path, data):\n"
        "    with open(path, 'w') as fh:\n"
        "        fh.write(data)\n"
    ), ["tmp-rename-atomicity"], _CK),
    _case("tmp_rename_append", (
        "def log(path, line):\n"
        "    with open(path, 'a') as fh:\n"
        "        fh.write(line)\n"
    ), ["tmp-rename-atomicity"], _CK),
    _case("tmp_rename_journal_py", _SAVE_W, ["tmp-rename-atomicity"],
          "mmlspark_tpu/runtime/journal.py"),
    _case("tmp_rename_dataguard", (
        "def save_manifest(path, data):\n"
        "    with open(path, 'w') as fh:\n"
        "        fh.write(data)\n"
    ), ["tmp-rename-atomicity"], "mmlspark_tpu/dataguard/dlq.py"),
    # onset-recovery-pairing
    _case("onset_without_recovery", (
        "def down(bus, name):\n"
        "    bus.publish(RegistryUnavailable(source=name))\n"
    ), ["onset-recovery-pairing"]),
    _case("onset_paired", (
        "def down(bus, name):\n"
        "    bus.publish(RegistryUnavailable(source=name))\n"
        "\n"
        "def up(bus, name):\n"
        "    bus.publish(RegistryRecovered(source=name))\n"
    ), ["onset-recovery-pairing"]),
    _case("onset_literal_pressure", (
        "def warn(bus):\n"
        "    bus.publish(MemoryPressure(level='critical'))\n"
    ), ["onset-recovery-pairing"]),
    _case("onset_dynamic_pressure", (
        "def report(bus, level):\n"
        "    bus.publish(MemoryPressure(level=level))\n"
    ), ["onset-recovery-pairing"]),
    _case("onset_degradation_event", (
        "def warn(bus):\n"
        "    bus.publish(MemoryPressure(level='critical'))\n"
        "    bus.publish(RequestShed(count=1))\n"
    ), ["onset-recovery-pairing"]),
]

# The lock witness's fixture module (TestLockWitness)
FIXTURE_MOD = (
    "import threading\n"
    "a = threading.Lock()\n"
    "b = threading.Lock()\n"
    "with a:\n"
    "    with b:\n"
    "        pass\n"
)

# blocking_reason's catalog (TestLockBlocking): call -> blocks?
BLOCKING_CALLS = [
    ("time.sleep(1)", True), ("sock.recv(1024)", True), ("t.join()", True),
    ("q.get()", True), ("t.join(timeout=1.0)", False), ("', '.join(parts)", False),
    ("d.get('k')", False),
]


# ---------------------------------------------------------------------------
# jit-purity and numpy-in-traced-code: the reference's snippet and a torch
# template over the trace root
# ---------------------------------------------------------------------------
#
# Template lines: "@@ROOT" is the root's own line (a decorator, a comment
# where the root is a call made below, or the CUDA graph), "@@DEF <def>" the
# traced function's def (the ``with torch.cuda.graph(g):`` line of a capture
# block), "@@RET" inside a line the def's "return " (the block's "_out = ",
# as long, so every column stays), and "@@TAIL" the call-site root's line.

ROOT_KINDS = ("decorator", "call_site", "graphed_callables", "graph_block", "triton_jit")

_ROOT_LINES = {
    "decorator": "@torch.compile",
    "call_site": "# compiled at its call site below",
    "graphed_callables": "# graphed at its call site below",
    "graph_block": "g = torch.cuda.CUDAGraph()",
    "triton_jit": "@triton.jit",
}
_TAILS = {
    "call_site": "compiled = torch.compile({name})",
    "graphed_callables": "graphed = torch.cuda.make_graphed_callables({name}, (x,))",
}


def torch_variant(template: str, kind: str) -> str:
    """The torch source of ``template`` under one root kind."""
    name = None
    for line in template.splitlines():
        if line.startswith("@@DEF "):
            name = line.split()[2].split("(")[0]
    ret = "_out = " if kind == "graph_block" else "return "
    out = []
    for line in template.splitlines():
        if line == "@@ROOT":
            line = _ROOT_LINES[kind]
        elif line.startswith("@@DEF "):
            line = ("with torch.cuda.graph(g):" if kind == "graph_block"
                    else line[len("@@DEF "):])
        elif line == "@@TAIL":
            line = _TAILS.get(kind, "").format(name=name)
        out.append(line.replace("@@RET", ret))
    return "\n".join(out) + "\n"


@dataclasses.dataclass(frozen=True)
class TracedCase:
    """A reference snippet, its torch template, and the lint's selection.
    ``rooted`` is False for the reference's host-only snippet, which has no
    root to transliterate."""

    name: str
    reference: str
    template: str
    select: Optional[Tuple[str, ...]]
    rooted: bool = True


TRACED = [
    TracedCase("time_and_print", (
        "import time\n"
        "import jax\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    t = time.time()\n"
        "    print(x)\n"
        "    return x + t\n"
    ), (
        "import time\n"
        "import torch, triton\n"
        "@@ROOT\n"
        "@@DEF def f(x):\n"
        "    t = time.time()\n"
        "    print(x)\n"
        "    @@RETx + t\n"
        "@@TAIL\n"
    ), ("jit-purity",)),
    TracedCase("global_mutation", (
        "import jax\n"
        "_STATE = 0\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    global _STATE\n"
        "    _STATE = 1\n"
        "    return x\n"
    ), (
        "import torch, triton\n"
        "_STATE = 0\n"
        "@@ROOT\n"
        "@@DEF def f(x):\n"
        "    global _STATE\n"
        "    _STATE = 1\n"
        "    @@RETx\n"
        "@@TAIL\n"
    ), ("jit-purity",)),
    # the reference's call-site root leaves no line above the def: the
    # transliteration imports last, so the root line keeps its place
    TracedCase("random_at_call_site", (
        "import jax, random\n"
        "def f(x):\n"
        "    return x * random.random()\n"
        "g = jax.jit(f)\n"
    ), (
        "@@ROOT\n"
        "@@DEF def f(x):\n"
        "    @@RETx * random.random()\n"
        "@@TAIL\n"
        "import torch, triton, random\n"
    ), ("jit-purity",)),
    TracedCase("clean_outside_trace", (
        "import time\n"
        "def host():\n"
        "    print(time.time())\n"
    ), (
        "import time\n"
        "def host():\n"
        "    print(time.time())\n"
    ), ("jit-purity",), rooted=False),
    TracedCase("jit_purity_suppressed", (
        "import time, jax\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    t = time.time()  # graftlint: disable=jit-purity\n"
        "    return x + t\n"
    ), (
        "import time, torch, triton\n"
        "@@ROOT\n"
        "@@DEF def f(x):\n"
        "    t = time.time()  # graftlint: disable=jit-purity\n"
        "    @@RETx + t\n"
        "@@TAIL\n"
    ), ("jit-purity",)),
    TracedCase("np_in_traced", (
        "import jax\n"
        "import numpy as np\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    return np.sum(x)\n"
    ), (
        "import torch, triton\n"
        "import numpy as np\n"
        "@@ROOT\n"
        "@@DEF def f(x):\n"
        "    @@RETnp.sum(x)\n"
        "@@TAIL\n"
    ), ("numpy-in-traced-code",)),
    TracedCase("np_through_call_chain", (
        "import jax\n"
        "import numpy as np\n"
        "def helper(x):\n"
        "    return np.abs(x)\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    return helper(x)\n"
    ), (
        "import torch, triton\n"
        "import numpy as np\n"
        "def helper(x):\n"
        "    return np.abs(x)\n"
        "@@ROOT\n"
        "@@DEF def f(x):\n"
        "    @@REThelper(x)\n"
        "@@TAIL\n"
    ), ("numpy-in-traced-code",)),
    TracedCase("lru_cache_boundary", (
        "import functools, jax\n"
        "import numpy as np\n"
        "import jax.numpy as jnp\n"
        "@functools.lru_cache(maxsize=8)\n"
        "def table(n):\n"
        "    return np.arange(n)\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    return x + jnp.asarray(table(4))\n"
    ), (
        "import functools, torch\n"
        "import numpy as np\n"
        "import triton\n"
        "@functools.lru_cache(maxsize=8)\n"
        "def table(n):\n"
        "    return np.arange(n)\n"
        "@@ROOT\n"
        "@@DEF def f(x):\n"
        "    @@RETx + torch.as_tensor(table(4))\n"
        "@@TAIL\n"
    ), ("numpy-in-traced-code",)),
    TracedCase("dtype_accessors", (
        "import jax\n"
        "import numpy as np\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    return x.astype(np.float32)\n"
    ), (
        "import torch, triton\n"
        "import numpy as np\n"
        "@@ROOT\n"
        "@@DEF def f(x):\n"
        "    @@RETx * np.float32(2.0) + np.finfo(np.float32).eps\n"
        "@@TAIL\n"
    ), ("numpy-in-traced-code",)),
    # the reference's Pallas kernel: a kernel under each root (triton_jit
    # is the Pallas kernel's own counterpart)
    TracedCase("kernel_covered", (
        "from jax.experimental import pallas as pl\n"
        "import numpy as np\n"
        "import jax, jax.numpy as jnp\n"
        "def kern(x_ref, o_ref):\n"
        "    o_ref[...] = np.maximum(x_ref[...], 0)\n"
        "def run(x):\n"
        "    return pl.pallas_call(kern, out_shape=x)(x)\n"
    ), (
        "import triton\n"
        "import numpy as np\n"
        "@@ROOT\n"
        "@@DEF def kern(x_ref, o_ref):\n"
        "    o_ref[...] = np.maximum(x_ref[...], 0)\n"
        "def run(x):\n"
        "    return kern[(1,)](x, x)\n"
        "@@TAIL\n"
        "import torch\n"
    ), ("numpy-in-traced-code",)),
    TracedCase("np_suppressed", (
        "import jax\n"
        "import numpy as np\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    return np.sum(x)  # graftlint: disable=numpy-in-traced-code\n"
    ), (
        "import torch, triton\n"
        "import numpy as np\n"
        "@@ROOT\n"
        "@@DEF def f(x):\n"
        "    @@RETnp.sum(x)  # graftlint: disable=numpy-in-traced-code\n"
        "@@TAIL\n"
    ), ("numpy-in-traced-code",)),
    # a bare disable silences every rule; the CLI's dirty file
    TracedCase("bare_disable", (
        "import jax, time\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    return x + time.time()  # graftlint: disable\n"
    ), (
        "import torch, triton, time\n"
        "@@ROOT\n"
        "@@DEF def f(x):\n"
        "    @@RETx + time.time()  # graftlint: disable\n"
        "@@TAIL\n"
    ), None),
    TracedCase("dirty", (
        "import jax, time\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    return x + time.time()\n"
    ), (
        "import torch, triton, time\n"
        "@@ROOT\n"
        "@@DEF def f(x):\n"
        "    @@RETx + time.time()\n"
        "@@TAIL\n"
    ), None),
]

# TestCrossModule: a jitted step in one module reaches np.* in another
CROSS_KERNELS = (
    "import numpy as np\n"
    "def inner(x):\n"
    "    return np.sum(x)\n"
)
CROSS_CALLER = (
    "import jax\n"
    "from mmlspark_tpu.kernels import inner\n"
    "@jax.jit\n"
    "def step(x):\n"
    "    return inner(x)\n"
)
CROSS_CALLER_TEMPLATE = (
    "import torch, triton\n"
    "from mmlspark_tpu_torch.kernels import inner\n"
    "@@ROOT\n"
    "@@DEF def step(x):\n"
    "    @@RETinner(x)\n"
    "@@TAIL\n"
)


# ---------------------------------------------------------------------------
# pallas-tile-alignment: the reference's only, no counterpart in the port
# ---------------------------------------------------------------------------

REFERENCE_ONLY = [
    "from jax.experimental import pallas as pl\n"
    "spec = pl.BlockSpec((8, 100), lambda i: (i, 0))\n",
    "from jax.experimental import pallas as pl\n"
    "spec = pl.BlockSpec(block_shape=(5, 128), index_map=lambda i: (i, 0))\n",
    "from jax.experimental import pallas as pl\n"
    "_LANE = 128\n"
    "_SUB = 8\n"
    "def build():\n"
    "    tn = _LANE * 2\n"
    "    return pl.BlockSpec((_SUB, tn), lambda i: (i, 0))\n",
    "from jax.experimental import pallas as pl\n"
    "spec = pl.BlockSpec((1, 128), lambda i: (i, 0))\n",
    "from jax.experimental import pallas as pl\n"
    "def build(bw):\n"
    "    return pl.BlockSpec((8, bw), lambda i: (i, 0))\n",
    "from jax.experimental import pallas as pl\n"
    "spec = pl.BlockSpec((8, 3), lambda i: (i, 0))"
    "  # graftlint: disable=pallas-tile-alignment\n",
]


def reference_snippets(path: str):
    """Every string literal of a reference test file that parses as a
    module (the snippets its tests lint), but the blank one."""
    with open(path, "r", encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "\n" in node.value and node.value.strip():
            try:
                ast.parse(node.value)
            except SyntaxError:
                continue
            out.add(node.value)
    return out


def shared_snippets():
    """Every snippet this module holds."""
    out = {s for case in LINT_CARRIED + CONCURRENCY_CARRIED for _, s in case.files}
    out |= {c.reference for c in TRACED}
    out |= set(REFERENCE_ONLY) | {FIXTURE_MOD, CROSS_KERNELS, CROSS_CALLER, MOD_A, MOD_B,
                                  ABBA_SRC}
    return out
