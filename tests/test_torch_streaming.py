"""The port's streaming engine (mmlspark_tpu_torch.streaming) and the stream
plane of its fault plan: the cases of tests/test_streaming.py against the
port (sources, query, triggers, WAL replay, restart, events, the model
commit sink, hot swap, the registry's model version), the reference's bytes
from ``corrupt_record_bytes``, a query SIGKILLed in a child process at both
crash windows, checkpoints read across the packages, and a streamed
LightGBM fit against the reference's within ``model_texts_close``.

Reference modules are imported inside fixtures (the card machine imports
this file without jax). The port's copies of the reference's slow
``TestModelCommitSink`` cases are slow here too.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_gbdt import _import_reference

# At import, so that every pytest worker has the JAX package's fit path
# before it collects the JAX package's own test files (see
# tests/test_torch_gbdt.py); the card machine has no jax.
try:
    _import_reference()
except ModuleNotFoundError as err:
    if err.name != "jax":
        raise

from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.lightgbm.procfit import model_texts_close
from mmlspark_tpu_torch.observability.events import (
    ModelSwapped,
    StreamEpochCommitted,
    StreamEpochStarted,
    StreamSourceAdvanced,
    format_timeline,
    get_bus,
    timeline,
)
from mmlspark_tpu_torch.observability.registry import MetricsRegistry
from mmlspark_tpu_torch.runtime import faults as tfaults
from mmlspark_tpu_torch.runtime.faults import FaultPlan, corrupt_record_bytes, inject_faults
from mmlspark_tpu_torch.runtime.journal import ModelStore
from mmlspark_tpu_torch.serving import RegistrationService, ServiceInfo, ServingServer
from mmlspark_tpu_torch.streaming import (
    AvailableNow,
    FileStreamSource,
    ForeachBatchSink,
    MemorySink,
    MemoryStream,
    ModelCommitSink,
    Once,
    ProcessingTime,
    StreamingQuery,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    from mmlspark_tpu.data.table import Table as JTable
    from mmlspark_tpu.runtime import faults as jfaults
    from mmlspark_tpu import streaming as jstreaming

    return SimpleNamespace(Table=JTable, faults=jfaults, streaming=jstreaming)


def _chunk(rng, rows=40, cols=4):
    X = rng.normal(size=(rows, cols))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    return Table({"features": X, "label": y})


def _drop_npz(d, index, table):
    final = os.path.join(d, f"part-{index:05d}.npz")
    np.savez(final + ".tmp.npz", **{name: table.column(name) for name in table.columns})
    os.rename(final + ".tmp.npz", final)


def _auc(y, score):
    order = np.argsort(score)
    ranks = np.empty(len(y))
    ranks[order] = np.arange(1, len(y) + 1)
    pos = y > 0
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


# -- the reference's cases (tests/test_streaming.py) ---------------------------


class TestSources:
    def test_memory_stream_offsets_and_blocks(self):
        ms = MemoryStream()
        assert ms.latest_offset() == 0
        ms.add(Table({"x": np.arange(3)}))
        ms.add(Table({"x": np.arange(3, 7)}))
        assert ms.latest_offset() == 2
        assert ms.plan_batch(0, 2) == [0, 1]
        assert ms.load_batch([1]).num_rows == 4
        with pytest.raises(ValueError):
            ms.plan_batch(0, 3)
        with pytest.raises(ValueError, match="not survive a restart"):
            ms.load_batch([9])

    def test_file_source_orders_and_hides_partials(self, tmp_path):
        d = str(tmp_path)
        rng = np.random.default_rng(0)
        _drop_npz(d, 1, _chunk(rng))
        _drop_npz(d, 0, _chunk(rng))
        # half-written outputs and dotfiles never become offsets
        open(os.path.join(d, "part-00002.npz.tmp"), "w").close()
        open(os.path.join(d, ".hidden.npz"), "w").close()
        src = FileStreamSource(d, pattern="part-*")
        assert src.latest_offset() == 2
        assert src.plan_batch(0, 2) == ["part-00000.npz", "part-00001.npz"]
        assert src.load_batch(src.plan_batch(0, 2)).num_rows == 80

    def test_file_source_offsets_stable_across_rescans(self, tmp_path):
        d = str(tmp_path)
        rng = np.random.default_rng(0)
        _drop_npz(d, 5, _chunk(rng))
        src = FileStreamSource(d)
        assert src.latest_offset() == 1
        # a late-arriving earlier name must NOT shift existing offsets
        _drop_npz(d, 1, _chunk(rng))
        assert src.latest_offset() == 2
        assert src.plan_batch(0, 2) == ["part-00005.npz", "part-00001.npz"]

    def test_file_source_jsonl_and_unknown_ext(self, tmp_path):
        d = str(tmp_path)
        with open(os.path.join(d, "rows.jsonl"), "w") as fh:
            fh.write('{"a": 1}\n{"a": 2}\n')
        src = FileStreamSource(d, pattern="*.jsonl")
        assert src.load_batch(src.plan_batch(0, src.latest_offset())).num_rows == 2
        with open(os.path.join(d, "bad.xyz"), "w") as fh:
            fh.write("nope")
        src2 = FileStreamSource(d, pattern="*.xyz")
        with pytest.raises(ValueError, match="no loader"):
            src2.load_batch(src2.plan_batch(0, src2.latest_offset()))


class TestQuery:
    def test_once_and_available_now(self, tmp_path):
        ms = MemoryStream(max_per_trigger=1)
        for i in range(3):
            ms.add(Table({"x": np.full(2, i)}))
        sink = MemorySink()
        q = StreamingQuery(ms, sink, trigger=Once(), checkpoint_dir=str(tmp_path / "q"))
        q.start()
        assert q.await_termination(10)
        assert [e for e, _ in sink.batches] == [0]  # Once = one rate-limited epoch
        q2 = StreamingQuery(ms, sink, trigger=AvailableNow(),
                            checkpoint_dir=str(tmp_path / "q"))
        q2.start()
        assert q2.await_termination(10)
        assert q2.exception is None
        assert [e for e, _ in sink.batches] == [0, 1, 2]
        assert sink.rows == 6
        assert q2.committed_epochs == [0, 1, 2]

    def test_processing_time_picks_up_live_data(self, tmp_path):
        ms = MemoryStream()
        sink = MemorySink()
        q = StreamingQuery(ms, sink, trigger=ProcessingTime(0.02),
                           checkpoint_dir=str(tmp_path / "q"))
        with q:
            ms.add(Table({"x": np.arange(2)}))
            deadline = time.monotonic() + 10
            while sink.rows < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            ms.add(Table({"x": np.arange(3)}))
            while sink.rows < 5 and time.monotonic() < deadline:
                time.sleep(0.01)
        assert sink.rows == 5
        assert not q.active

    def test_restart_resumes_from_commit_log(self, tmp_path):
        d, ckpt = str(tmp_path / "in"), str(tmp_path / "ckpt")
        os.makedirs(d)
        rng = np.random.default_rng(1)
        for i in range(2):
            _drop_npz(d, i, _chunk(rng, rows=5))
        sink = MemorySink()
        q = StreamingQuery(FileStreamSource(d, max_per_trigger=1), sink,
                           trigger=AvailableNow(), checkpoint_dir=ckpt)
        q.start()
        assert q.await_termination(10) and q.exception is None
        assert q.committed_epochs == [0, 1]
        # restart: fresh source + sink on the same checkpoint, plus new data
        _drop_npz(d, 2, _chunk(rng, rows=5))
        sink2 = MemorySink()
        q2 = StreamingQuery(FileStreamSource(d, max_per_trigger=1), sink2,
                            trigger=AvailableNow(), checkpoint_dir=ckpt)
        assert q2._next_epoch == 2 and q2._offset == 2
        q2.start()
        assert q2.await_termination(10) and q2.exception is None
        # only the NEW epoch processed; committed epochs never re-deliver
        assert [e for e, _ in sink2.batches] == [2]
        assert q2.committed_epochs == [0, 1, 2]

    def test_wal_replay_pins_manifest(self, tmp_path):
        """An uncommitted planned epoch replays the exact WAL manifest,
        even though the directory has since grown."""
        d, ckpt = str(tmp_path / "in"), str(tmp_path / "ckpt")
        os.makedirs(d)
        rng = np.random.default_rng(2)
        _drop_npz(d, 0, _chunk(rng, rows=5))
        # hand-build the crashed run's checkpoint: epoch 0 planned, no commit
        os.makedirs(os.path.join(ckpt, "offsets"))
        with open(os.path.join(ckpt, "offsets", "000000.json"), "w") as fh:
            json.dump({"epoch": 0, "start": 0, "end": 1, "manifest": ["part-00000.npz"]}, fh)
        _drop_npz(d, 1, _chunk(rng, rows=7))  # arrives after the "crash"
        sink = MemorySink()
        q = StreamingQuery(FileStreamSource(d), sink, trigger=AvailableNow(),
                           checkpoint_dir=ckpt)
        assert q._replay is not None
        q.start()
        assert q.await_termination(10) and q.exception is None
        # epoch 0 = the pinned single-file manifest; epoch 1 = the rest
        assert sink.batches[0][0] == 0 and sink.batches[0][1].num_rows == 5
        assert sink.batches[1][0] == 1 and sink.batches[1][1].num_rows == 7

    def test_sinks_dedupe_replayed_epochs(self):
        seen = []
        fb = ForeachBatchSink(lambda t, e: seen.append(e))
        t = Table({"x": np.arange(2)})
        fb.process_batch(0, t)
        fb.process_batch(0, t)  # WAL replay duplicate
        assert seen == [0]
        ms = MemorySink()
        ms.process_batch(3, t)
        ms.process_batch(3, t)
        assert len(ms.batches) == 1

    def test_kill_stream_directive_sigkills(self, monkeypatch):
        kills = []
        monkeypatch.setattr("mmlspark_tpu_torch.streaming.query.os.kill",
                            lambda pid, sig: kills.append((pid, sig)))
        ms = MemoryStream()
        ms.add(Table({"x": np.arange(2)}))
        q = StreamingQuery(ms, MemorySink(), checkpoint_dir=None)
        plan = FaultPlan(seed=0).kill_stream(0, "pre_commit")
        with inject_faults(plan):
            q.process_all_available()
        assert kills and kills[0][0] == os.getpid()
        assert plan.fired == [("kill_stream", 0, 0)]
        with pytest.raises(ValueError):
            FaultPlan(seed=0).kill_stream(0, "mid_sink")

    def test_streaming_events_fold_into_timeline(self, tmp_path):
        events = []
        bus = get_bus()
        bus.add_listener(events.append)
        try:
            ms = MemoryStream()
            ms.add(Table({"x": np.arange(4)}))
            q = StreamingQuery(ms, MemorySink(), trigger=Once(), name="tq",
                               checkpoint_dir=str(tmp_path))
            q.start()
            assert q.await_termination(10)
        finally:
            bus.remove_listener(events.append)
        assert any(isinstance(e, StreamEpochStarted) for e in events)
        committed = [e for e in events if isinstance(e, StreamEpochCommitted)]
        assert committed and committed[0].rows == 4
        summary = timeline(events)
        assert summary["streaming"]["epochs"] == 1
        assert summary["streaming"]["rows"] == 4
        assert summary["streaming"]["queries"] == {"tq": [0]}
        assert "== streaming ==" in format_timeline(summary)


def test_query_registry_series():
    """The query's series: epochs, rows, the epoch-time histogram and the
    committed offset, labeled by query."""
    reg = MetricsRegistry()
    ms = MemoryStream(max_per_trigger=1)
    for n in (3, 5):
        ms.add(Table({"x": np.arange(n)}))
    q = StreamingQuery(ms, MemorySink(), name="rq", registry=reg)
    assert q.process_all_available() == 8
    s = reg.summary()
    assert s["streaming_epochs_total"] == {"query=rq": 2.0}
    assert s["streaming_rows_total"] == {"query=rq": 8.0}
    assert s["streaming_offset"] == {"query=rq": 2.0}
    assert reg.histogram("streaming_epoch_seconds").labels(query="rq").count == 2
    assert q.last_progress["epoch"] == 1 and q.last_progress["rows"] == 5


# -- the stream fault plane against the reference -------------------------------


def _record_trace(faults, paths):
    """Every (path, index, data) through one package's corrupt_record_bytes
    under one plan: the bytes, the plan's fired list and its pending count
    after each read."""
    plan = (faults.FaultPlan(seed=3).corrupt_record("events", index=1, count=2)
            .corrupt_record("rows.jsonl", index=0).kill_stream(2, "post_wal")
            .kill_stream(4, "pre_commit").truncate_shard("part-7"))
    out = [plan.pending]
    rng = np.random.default_rng(12)
    with faults.inject_faults(plan):
        for path in paths:
            for index in range(3):
                data = bytes(rng.integers(0, 256, size=int(rng.integers(0, 40)),
                                          dtype=np.uint8))
                out.append((faults.corrupt_record_bytes(path, index, data), plan.pending))
        for epoch, point in ((2, "pre_commit"), (2, "post_wal"), (2, "post_wal"),
                             (4, "pre_commit")):
            out.append((plan.should_kill_stream(epoch, point), plan.pending))
    return out, plan.fired


def test_corrupt_record_bytes_and_kill_stream_equal_the_references(ref):
    paths = ["/d/events-0.jsonl", "/d/rows.jsonl", "/d/events-1.jsonl", "/d/other.json",
             "/d/events-2.jsonl"]
    port, jref = _record_trace(tfaults, paths), _record_trace(ref.faults, paths)
    assert port == jref
    assert sum(1 for item in port[0][1:] if isinstance(item[0], bytes)
               and item[0].startswith(b"\xff\xfe<corrupt>")) == 3
    # no plan: the bytes pass untouched in both
    assert corrupt_record_bytes("/d/x.jsonl", 0, b"{}") == b"{}"
    assert ref.faults.corrupt_record_bytes("/d/x.jsonl", 0, b"{}") == b"{}"


def test_permissive_jsonl_quarantines_the_corrupt_record_as_the_reference(ref, tmp_path):
    """A garbled jsonl line quarantines alone; the rest of the file loads,
    the same rows and quarantine in both packages."""
    d = tmp_path / "in"
    d.mkdir()
    (d / "a.jsonl").write_text("".join(json.dumps({"x": i, "y": i * 0.5}) + "\n"
                                       for i in range(6)))
    (d / "b.jsonl").write_text('{"x": 10, "y": 1.0}\n')
    got = []
    for streaming, faults in ((sys.modules["mmlspark_tpu_torch.streaming"], tfaults),
                              (ref.streaming, ref.faults)):
        src = streaming.FileStreamSource(str(d), pattern="*.jsonl", mode="permissive")
        plan = faults.FaultPlan(seed=0).corrupt_record("a.jsonl", index=2)
        with faults.inject_faults(plan):
            table = src.load_batch(src.plan_batch(0, src.latest_offset()))
        got.append(({c: table.column(c).tolist() for c in table.columns},
                    [(os.path.basename(r.source), r.index, r.reason)
                     for r in src.last_quarantined], plan.fired))
    assert got[0] == got[1]
    assert got[0][1] == [("a.jsonl", 2, got[0][1][0][2])]
    with pytest.raises(ValueError):
        src = FileStreamSource(str(d), pattern="*.jsonl")  # failfast
        with inject_faults(FaultPlan(seed=0).corrupt_record("a.jsonl", index=2)):
            src.load_batch(src.plan_batch(0, src.latest_offset()))


def test_checkpoints_resume_across_the_packages(ref, tmp_path):
    """The reference's checkpoint resumes in the port at the reference's
    next epoch, and the reverse: the same layout on disk."""
    d = str(tmp_path / "in")
    os.makedirs(d)
    rng = np.random.default_rng(4)
    for i in range(4):
        _drop_npz(d, i, _chunk(rng, rows=3 + i))
    port_mod = sys.modules["mmlspark_tpu_torch.streaming"]
    for first, second in ((ref.streaming, port_mod), (port_mod, ref.streaming)):
        ckpt = str(tmp_path / f"ckpt-{first.__name__}")
        q = first.StreamingQuery(first.FileStreamSource(d, max_per_trigger=1),
                                 first.MemorySink(), checkpoint_dir=ckpt)
        q.process_next()
        q.process_next()
        sink = second.MemorySink()
        q2 = second.StreamingQuery(second.FileStreamSource(d, max_per_trigger=1), sink,
                                   checkpoint_dir=ckpt)
        assert (q2._next_epoch, q2._offset) == (2, 2)
        q2.process_all_available()
        assert [(e, t.num_rows) for e, t in sink.batches] == [(2, 5), (3, 6)]
        assert q2.committed_epochs == [0, 1, 2, 3]


_CHILD = """
import json, os, sys
sys.path.insert(0, {repo!r})
from mmlspark_tpu_torch.runtime.faults import FaultPlan, inject_faults
from mmlspark_tpu_torch.streaming import FileStreamSource, MemorySink, StreamingQuery

sink = MemorySink()
query = StreamingQuery(FileStreamSource({incoming!r}, max_per_trigger=1), sink,
                       checkpoint_dir={ckpt!r})
plan = FaultPlan(seed=0)
if len(sys.argv) > 1:
    plan.kill_stream(int(sys.argv[1]), sys.argv[2])
with open({log!r}, "a") as fh:
    fh.write(json.dumps({{"start": query._next_epoch,
                         "replay": query._replay is not None}}) + "\\n")
with inject_faults(plan):
    query.process_all_available()
with open({log!r}, "a") as fh:
    fh.write(json.dumps({{"batches": [[e, t.num_rows] for e, t in sink.batches]}}) + "\\n")
"""


def test_child_query_sigkilled_at_both_windows_commits_each_epoch_once(tmp_path):
    """A query in a child process dies by a real SIGKILL at post_wal of
    epoch 1 and at pre_commit of epoch 2; each restart replays the
    uncommitted epoch from its WAL, and the commit log holds every epoch
    once."""
    incoming, ckpt = str(tmp_path / "in"), str(tmp_path / "ckpt")
    os.makedirs(incoming)
    rng = np.random.default_rng(5)
    sizes = [3, 4, 5, 6]
    for i, n in enumerate(sizes):
        _drop_npz(incoming, i, _chunk(rng, rows=n))
    log = str(tmp_path / "child.jsonl")
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=str(REPO), incoming=incoming, ckpt=ckpt, log=log))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for kill in (["1", "post_wal"], ["2", "pre_commit"], []):
        proc = subprocess.run([sys.executable, str(script)] + kill, env=env, timeout=120)
        assert proc.returncode == (-signal.SIGKILL if kill else 0), proc.returncode
    lines = [json.loads(line) for line in open(log)]
    assert [ln.get("start") for ln in lines if "start" in ln] == [0, 1, 2]
    assert [ln["replay"] for ln in lines if "start" in ln] == [False, True, True]
    # only the last run lived to report its batches: the replayed epoch 2
    # (its sink output died with the second child) and epoch 3
    assert [ln["batches"] for ln in lines if "batches" in ln] == [[[2, 5], [3, 6]]]
    commits = sorted(os.listdir(os.path.join(ckpt, "commits")))
    assert commits == [f"{e:06d}.json" for e in range(4)]
    rows = [json.load(open(os.path.join(ckpt, "commits", c)))["rows"] for c in commits]
    assert rows == sizes


# -- the model commit sink -------------------------------------------------------


def _factory():
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier

    return LightGBMClassifier(numIterations=4, numLeaves=7, seed=3, device="cpu")


def _run_stream(chunks, root, factory=_factory, name="m"):
    ms = MemoryStream(max_per_trigger=1)
    for c in chunks:
        ms.add(c)
    sink = ModelCommitSink(factory, name=name, root=root)
    q = StreamingQuery(ms, sink, trigger=AvailableNow(), checkpoint_dir=os.path.join(root, "q"))
    q.start()
    assert q.await_termination(300)
    if q.exception is not None:
        raise q.exception
    return sink


@pytest.mark.slow
class TestModelCommitSink:
    """Incremental-fit parity: the streamed path must not silently shift
    models relative to the manual modelString chaining it is built on."""

    def _chunks(self, k=3, rows=40):
        rng = np.random.default_rng(9)
        return [_chunk(rng, rows=rows) for _ in range(k)]

    def test_streamed_fit_matches_manual_chaining(self, tmp_path):
        from mmlspark_tpu_torch.lightgbm.base import _merge_boosters
        from mmlspark_tpu_torch.lightgbm.booster import Booster

        chunks = self._chunks()
        sink = _run_stream(chunks, str(tmp_path))
        assert sink.committed_epochs == [0, 1, 2]
        assert sink.versions == {0: 1, 1: 2, 2: 3}
        # manual modelString chaining over the same chunks, byte-for-byte
        text = None
        for c in chunks:
            est = _factory()
            if text:
                est.set("modelString", text)
            delta = est.fit(c).booster
            merged = _merge_boosters([Booster.from_string(text), delta]) if text else delta
            text = merged.model_to_string()
        assert text == sink.latest_text()

    def test_streamed_fit_auc_parity_with_concat_fit(self, tmp_path):
        from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
        from mmlspark_tpu_torch.lightgbm.booster import Booster

        chunks = self._chunks(k=3, rows=80)
        sink = _run_stream(chunks, str(tmp_path))
        streamed = Booster.from_string(sink.latest_text())
        concat = Table.concat(chunks)
        # one warm-start-free fit over everything, same total tree budget
        single = LightGBMClassifier(numIterations=12, numLeaves=7, seed=3,
                                    device="cpu").fit(concat).booster
        rng = np.random.default_rng(77)
        Xt = rng.normal(size=(300, 4))
        yt = (Xt[:, 0] + 0.5 * Xt[:, 1] > 0).astype(np.float64)
        auc_stream = _auc(yt, streamed.raw_margin(Xt, device="cpu")[:, 0])
        auc_single = _auc(yt, single.raw_margin(Xt, device="cpu")[:, 0])
        assert streamed.num_trees == 12
        assert auc_stream > 0.85
        assert abs(auc_stream - auc_single) < 0.08

    def test_merge_round_trip_preserves_margins(self):
        from mmlspark_tpu_torch.lightgbm.base import _merge_boosters
        from mmlspark_tpu_torch.lightgbm.booster import Booster

        a, b = self._chunks(k=2)
        base = _factory().fit(a).booster
        est = _factory()
        est.set("modelString", base.model_to_string())
        delta = est.fit(b).booster
        merged = _merge_boosters([Booster.from_string(base.model_to_string()), delta])
        again = Booster.from_string(merged.model_to_string())
        X = np.asarray(a.column("features"))
        np.testing.assert_allclose(merged.raw_margin(X, device="cpu"),
                                   again.raw_margin(X, device="cpu"), rtol=1e-6)
        np.testing.assert_allclose(
            merged.raw_margin(X, device="cpu"),
            base.raw_margin(X, device="cpu") + delta.raw_margin(X, device="cpu"),
            rtol=1e-5, atol=1e-6)

    def test_duplicate_epoch_never_refits_or_recommits(self, tmp_path):
        calls = []

        def counting_factory():
            calls.append(1)
            return _factory()

        root = str(tmp_path)
        chunks = self._chunks(k=2)
        sink = ModelCommitSink(counting_factory, name="m", root=root)
        sink.process_batch(0, chunks[0])
        v = sink.process_batch(0, chunks[0])  # WAL replay duplicate
        assert len(calls) == 1
        assert v == 1 and sink.versions == {0: 1}
        sink.close()
        # a fresh sink instance (restarted process) restores the journal
        # and also refuses to refit the journaled epoch
        sink2 = ModelCommitSink(counting_factory, name="m", root=root)
        assert sink2.committed_epochs == [0]
        v = sink2.process_batch(0, chunks[0])
        assert len(calls) == 1 and v == 1
        assert ModelStore(os.path.join(root, "models")).current_version("m") == 1
        sink2.process_batch(1, chunks[1])
        assert len(calls) == 2 and sink2.versions[1] == 2
        sink2.close()

    def test_requires_durable_root(self, monkeypatch):
        monkeypatch.delenv("MMLSPARK_TPU_CHECKPOINT_DIR", raising=False)
        with pytest.raises(ValueError, match="durable root"):
            ModelCommitSink(_factory)


def test_commit_sink_events_series_and_empty_epoch(tmp_path):
    """One epoch's ModelCommitted event and the sink's series; an epoch
    whose rows were all quarantined fits nothing and keeps the version."""
    events = []
    bus = get_bus()
    bus.add_listener(events.append)
    reg = MetricsRegistry()
    try:
        rng = np.random.default_rng(8)
        sink = ModelCommitSink(_factory, name="m", root=str(tmp_path), registry=reg)
        assert sink.process_batch(0, _chunk(rng, rows=60)) == 1
        assert sink.process_batch(1, Table({})) == 1
        sink.close()
    finally:
        bus.remove_listener(events.append)
    committed = [e for e in events if type(e).__name__ == "ModelCommitted" and e.model == "m"]
    assert [(e.version, e.detail) for e in committed] == [(1, "stream epoch 0")]
    assert reg.summary()["streaming_model_version"] == 1.0
    assert reg.histogram("streaming_fit_seconds").count == 1
    assert sink.committed_epochs == [0]


def test_streamed_fit_holds_the_references_within_model_texts_close(ref, tmp_path):
    """2 epochs x 400 rows x 5 features, 3 iterations, through each
    package's StreamingQuery + ModelCommitSink over one directory of
    chunks: the ensembles' texts agree within model_texts_close (rtol
    1e-3), epoch by epoch, with the same store versions."""
    from mmlspark_tpu.lightgbm import LightGBMClassifier as JClassifier

    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier

    d = str(tmp_path / "in")
    os.makedirs(d)
    rng = np.random.default_rng(16)
    for i in range(2):
        X = rng.normal(size=(400, 5))
        logit = X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=400)
        _drop_npz(d, i, Table({"features": X, "label": (logit > 0).astype(np.float64)}))
    # the reference's streaming cases' 7 leaves: at 15 leaves of 400 rows,
    # leaves near min_data_in_leaf tie within float32 noise, and the
    # reference's float32 sums and the port's exact ones pick either split
    params = dict(numIterations=3, numLeaves=7, seed=7, minGainToSplit=1e-3)
    texts = {}
    for label, streaming, factory in (
            ("port", sys.modules["mmlspark_tpu_torch.streaming"],
             lambda: LightGBMClassifier(**params, device="cpu")),
            ("ref", ref.streaming, lambda: JClassifier(**params, parallelism="serial"))):
        root = str(tmp_path / label)
        per_epoch = []

        class Recording(streaming.ModelCommitSink):
            def process_batch(self, epoch, table):
                version = super().process_batch(epoch, table)
                per_epoch.append((epoch, version, self.latest_text()))
                return version

        sink = Recording(factory, name="m", root=root)
        q = streaming.StreamingQuery(streaming.FileStreamSource(d, max_per_trigger=1), sink,
                                     trigger=streaming.AvailableNow(),
                                     checkpoint_dir=os.path.join(root, "q"))
        q.start()
        assert q.await_termination(300)
        assert q.exception is None, q.exception
        sink.close()
        texts[label] = per_epoch
    assert [(e, v) for e, v, _ in texts["port"]] == [(0, 1), (1, 2)]
    assert [(e, v) for e, v, _ in texts["ref"]] == [(0, 1), (1, 2)]
    for (_, _, a), (_, _, b) in zip(texts["port"], texts["ref"]):
        assert model_texts_close(a, b, rtol=1e-3)
    assert texts["port"][-1][2].count("Tree=") == 6


def test_warm_start_margins_are_a_sequential_tree_sum():
    """The warm start reads ``raw_margin`` of the ensemble so far: the trees
    are added one after another in float32, so a row's margin has the same
    bits in any batch of rows (and on any device): the sum in tree order of
    the leaf values, plus the init score."""
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier

    rng = np.random.default_rng(31)
    X = rng.normal(size=(300, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=300) > 0).astype(np.float64)
    booster = LightGBMClassifier(numIterations=40, numLeaves=7, learningRate=0.3,
                                 device="cpu").fit(Table({"features": X, "label": y})).booster
    whole = booster.raw_margin(X, device="cpu")
    for lo, hi in ((0, 1), (7, 8), (10, 43), (100, 300)):
        assert whole[lo:hi].tobytes() == booster.raw_margin(X[lo:hi], device="cpu").tobytes()
    leaves = booster.predict_leaf(X, device="cpu")
    want = np.asarray(booster.leaf_values, np.float32)[np.arange(leaves.shape[1]), leaves]
    acc = want[:, 0].copy()
    for t in range(1, want.shape[1]):
        acc = (acc + want[:, t]).astype(np.float32)
    acc = (acc + np.float32(booster.init_score[0])).astype(np.float32)
    assert acc.tobytes() == whole[:, 0].tobytes()


# -- hot swap and the registry's model version (tests/test_streaming.py) --------


class _Scaler(Transformer):
    """Cheap text-loadable model for hot-swap tests: scales input by k."""

    def __init__(self, k, **kw):
        super().__init__(**kw)
        self.k = k

    def transform(self, table):
        x = np.asarray(table.column("input"), dtype=np.float64)
        return table.with_column("prediction", x * self.k)


def _post(url, payload, timeout=10):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


class TestHotSwap:
    def test_current_swap_between_requests_without_restart(self, tmp_path):
        store = ModelStore(str(tmp_path / "models"))
        store.commit("3.0", name="scaler")
        swapped = []

        def on_event(e):
            if isinstance(e, ModelSwapped):
                swapped.append(e)

        bus = get_bus()
        bus.add_listener(on_event)
        try:
            srv = ServingServer(_Scaler(1.0), max_latency_ms=1.0)
            srv.enable_hot_swap(lambda text: _Scaler(float(text)), root=str(tmp_path),
                                name="scaler", poll_s=0.02)
            with srv:
                deadline = time.monotonic() + 10
                while srv.model_version != 1 and time.monotonic() < deadline:
                    time.sleep(0.01)
                status, out = _post(srv.info.url, {"input": 7.0})
                assert status == 200 and out["prediction"] == 21.0
                assert _get(srv.info.url + "healthz")["model_version"] == 1
                # a new commit lands; the SAME listener swaps between requests
                store.commit("5.0", name="scaler")
                while srv.model_version != 2 and time.monotonic() < deadline:
                    time.sleep(0.01)
                status, out = _post(srv.info.url, {"input": 7.0})
                assert status == 200 and out["prediction"] == 35.0
                assert _get(srv.info.url + "healthz")["model_version"] == 2
                assert srv.info.model_version == 2
        finally:
            bus.remove_listener(on_event)
        assert [e.version for e in swapped] == [1, 2]
        assert all(e.server == "serving" for e in swapped)

    def test_bad_commit_keeps_serving_old_model(self, tmp_path):
        store = ModelStore(str(tmp_path / "models"))
        store.commit("2.0", name="scaler")
        srv = ServingServer(_Scaler(1.0), max_latency_ms=1.0)
        srv.enable_hot_swap(lambda text: _Scaler(float(text)), root=str(tmp_path),
                            name="scaler", poll_s=0.02)
        with srv:
            deadline = time.monotonic() + 10
            while srv.model_version != 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            store.commit("not-a-number", name="scaler")  # loader will raise
            time.sleep(0.2)
            status, out = _post(srv.info.url, {"input": 4.0})
            assert status == 200 and out["prediction"] == 8.0  # still v1
            assert srv.model_version == 1

    def test_hot_swap_requires_root(self, monkeypatch):
        monkeypatch.delenv("MMLSPARK_TPU_CHECKPOINT_DIR", raising=False)
        srv = ServingServer(_Scaler(1.0))
        with pytest.raises(ValueError, match="ModelStore root"):
            srv.enable_hot_swap(lambda text: _Scaler(float(text)))


def test_streamed_commits_hot_swap_a_served_lightgbm_model(tmp_path):
    """The continuous path on the CPU: a stream's commits reach a watching
    server, whose replies are the committed ensemble's."""
    from mmlspark_tpu_torch.lightgbm import LightGBMClassificationModel

    rng = np.random.default_rng(21)
    chunks = [_chunk(rng, rows=80) for _ in range(2)]
    root = str(tmp_path)
    ms = MemoryStream(max_per_trigger=1)
    ms.add(chunks[0])
    sink = ModelCommitSink(_factory, name="m", root=root)
    q = StreamingQuery(ms, sink, checkpoint_dir=os.path.join(root, "q"))
    q.process_all_available()

    def loader(text):
        return LightGBMClassificationModel.from_model_string(text, device="cpu")

    srv = ServingServer(loader(sink.latest_text()), input_col="features",
                        output_col="probability", max_latency_ms=1.0)
    srv.enable_hot_swap(loader, root=root, name="m", poll_s=0.02)
    row = [0.3, -1.2, 0.8, 0.1]
    with srv:
        ms.add(chunks[1])
        q.process_all_available()
        deadline = time.monotonic() + 20
        while srv.model_version != 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.model_version == 2
        status, out = _post(srv.info.url, {"features": row})
    sink.close()
    want = loader(sink.latest_text()).transform(
        Table({"features": np.asarray([row])})).column("probability")[0]
    assert status == 200
    np.testing.assert_allclose(out["probability"], want, rtol=0, atol=1e-6)


class TestRegistryModelVersion:
    def test_services_reports_model_version(self):
        with RegistrationService() as reg:
            reg.register(ServiceInfo("a", "127.0.0.1", 1234, model_version=3))
            svcs = _get(reg.info.url + "services")
            assert svcs == [{"name": "a", "host": "127.0.0.1", "port": 1234,
                             "model_version": 3}]
            # a heartbeat carrying a new version updates the lease metadata
            assert reg.heartbeat("a", model_version=4)
            assert _get(reg.info.url + "services")[0]["model_version"] == 4

    def test_http_register_and_heartbeat_carry_version(self):
        with RegistrationService() as reg:
            base = reg.info.url.rstrip("/")
            req = urllib.request.Request(
                base + "/register",
                data=json.dumps({"name": "w", "host": "127.0.0.1", "port": 9,
                                 "model_version": 7}).encode(),
                method="POST")
            assert urllib.request.urlopen(req, timeout=10).status == 200
            assert _get(base + "/services")[0]["model_version"] == 7
            req = urllib.request.Request(
                base + "/heartbeat",
                data=json.dumps({"name": "w", "model_version": 8}).encode(), method="POST")
            assert urllib.request.urlopen(req, timeout=10).status == 200
            assert _get(base + "/services")[0]["model_version"] == 8


# -- isolation ----------------------------------------------------------------------


def test_streaming_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, mmlspark_tpu_torch.streaming, mmlspark_tpu_torch.streaming.query, "
        "mmlspark_tpu_torch.streaming.sink, mmlspark_tpu_torch.streaming.source\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mmlspark_tpu.'))"
        " or m == 'mmlspark_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=str(REPO),
                   timeout=120)


def test_port_tools_import_neither_jax_nor_the_jax_package():
    """The port's two tools import the port only (a source scan: running
    them takes real processes)."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|mmlspark_tpu)(\s|\.|$)", re.M)
    for name in ("torch_streaming_chaos_smoke.py", "torch_loadgen.py"):
        source = (REPO / "tools" / name).read_text()
        assert not pattern.search(source), name
        assert "mmlspark_tpu_torch" in source, name


def test_streaming_exports_the_references_names(ref):
    port_mod = sys.modules["mmlspark_tpu_torch.streaming"]
    assert port_mod.__all__ == ref.streaming.__all__
    for name in port_mod.__all__:
        assert getattr(port_mod, name) is not None


def test_events_of_one_epoch(tmp_path):
    """Started, source-advanced and committed, in that order, with the
    epoch's offsets."""
    events = []
    bus = get_bus()
    bus.add_listener(events.append)
    try:
        ms = MemoryStream(max_per_trigger=2)
        for n in (2, 3, 4):
            ms.add(Table({"x": np.arange(n)}))
        StreamingQuery(ms, MemorySink(), name="eq",
                       checkpoint_dir=str(tmp_path)).process_all_available()
    finally:
        bus.remove_listener(events.append)
    got = [(type(e).__name__, getattr(e, "epoch", None), getattr(e, "start", None),
            getattr(e, "end", None)) for e in events
           if isinstance(e, (StreamEpochStarted, StreamSourceAdvanced, StreamEpochCommitted))]
    assert got == [("StreamEpochStarted", 0, 0, 2), ("StreamSourceAdvanced", None, 0, 2),
                   ("StreamEpochCommitted", 0, None, None),
                   ("StreamEpochStarted", 1, 2, 3), ("StreamSourceAdvanced", None, 2, 3),
                   ("StreamEpochCommitted", 1, None, None)]
