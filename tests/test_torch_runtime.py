"""The port's partition runtime (mmlspark_tpu_torch.runtime) against the JAX
package's (mmlspark_tpu.runtime).

Every fault is injected from a seeded FaultPlan keyed on (task, attempt), so
each scenario runs the same recovery sequence in both packages: the port's
results, fired faults, attempt reasons and metric counts must be the
reference's. The durable plane is checked across packages: a FitJournal or
ModelStore written by one is read by the other. Every pool is shut down by
the scheduler that owns it, with the reference's fast knobs, so no test
leaves a thread running.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from mmlspark_tpu import runtime as jrt
from mmlspark_tpu_torch import runtime as trt
from mmlspark_tpu_torch.runtime import pressure as tpressure

FAST = dict(backoff_base=0.01, heartbeat_interval=0.02)


def _policy(rt, **kw):
    return rt.SchedulerPolicy(**{**FAST, **kw})


@pytest.fixture(autouse=True)
def _no_threads_left():
    before = {t.ident for t in threading.enumerate()}
    yield
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        left = [t for t in threading.enumerate()
                if t.ident not in before and t.name.startswith("runtime-worker")]
        if not left:
            return
        time.sleep(0.02)
    raise AssertionError(f"threads left running: {[t.name for t in left]}")


def _both(fn):
    """``fn(rt)`` for the reference and the port."""
    return fn(jrt), fn(trt)


# -- scheduler core --------------------------------------------------------------


def test_results_ordered_despite_stragglers():
    def run(rt):
        def work(x):
            if x == 0:
                time.sleep(0.2)  # task 0 finishes last
            return x + 100
        return rt.run_partitioned(work, [0, 1, 2, 3], _policy(rt, max_workers=4))

    ref, port = _both(run)
    assert port == ref == [100, 101, 102, 103]


@pytest.mark.parametrize("seed,base,factor,jitter,cap", [
    (0, 0.05, 2.0, 0.25, 5.0), (42, 0.1, 2.0, 0.25, 1.0), (7, 0.01, 3.0, 0.5, 0.2)])
def test_backoff_schedule_equals_the_reference(seed, base, factor, jitter, cap):
    kw = dict(seed=seed, backoff_base=base, backoff_factor=factor, backoff_jitter=jitter,
              backoff_max=cap)
    want = [jrt.SchedulerPolicy(**kw).backoff(t, k) for t in range(5) for k in range(1, 9)]
    got = [trt.SchedulerPolicy(**kw).backoff(t, k) for t in range(5) for k in range(1, 9)]
    assert got == want


def test_policy_fields_equal_the_reference():
    import dataclasses

    names = [f.name for f in dataclasses.fields(jrt.SchedulerPolicy)]
    assert [f.name for f in dataclasses.fields(trt.SchedulerPolicy)] == names
    ref, port = jrt.SchedulerPolicy(), trt.SchedulerPolicy()
    assert [getattr(port, n) for n in names] == [getattr(ref, n) for n in names]


@pytest.mark.parametrize("seed", [0, 5, 11, 123])
def test_kill_random_task_victim_equals_the_reference(seed, monkeypatch):
    for n in (3, 8, 32):
        ref = jrt.FaultPlan(seed=seed).kill_random_task(n).kill_random_task(n)
        port = trt.FaultPlan(seed=seed).kill_random_task(n).kill_random_task(n)
        assert port._kill.keys() == ref._kill.keys()
    # seed None reads MMLSPARK_TPU_FAULT_SEED in both packages
    monkeypatch.setenv("MMLSPARK_TPU_FAULT_SEED", str(seed))
    assert (trt.FaultPlan().kill_random_task(16)._kill.keys()
            == jrt.FaultPlan().kill_random_task(16)._kill.keys())


def test_retry_exhaustion_fails_with_the_reference_reasons():
    def run(rt):
        m = rt.RuntimeMetrics()
        with pytest.raises(rt.JobFailedError) as ei:
            rt.run_partitioned(lambda x: (_ for _ in ()).throw(ValueError("always")), [5],
                               _policy(rt, max_workers=1, max_retries=2), metrics=m)
        hist = ei.value.history[0]
        s = m.summary()
        return ([(a.attempt, a.reason, a.speculative) for a in hist],
                s["failures_error"], s["retries_total"], str(ei.value))

    ref, port = _both(run)
    assert port == ref
    assert port[0] == [(0, "error", False), (1, "error", False), (2, "error", False)]


def test_executor_death_retries_on_a_replacement_worker():
    def run(rt):
        plan = rt.FaultPlan(seed=7).kill_task(2).kill_task(0)
        m = rt.RuntimeMetrics()
        out = rt.run_partitioned(lambda x: x * 2, [0, 1, 2, 3],
                                 _policy(rt, max_workers=1, faults=plan), metrics=m)
        s = m.summary()
        return out, sorted(plan.fired), s["failures_executor_death"], s["retries_per_task"]

    ref, port = _both(run)
    assert port == ref
    assert port[0] == [0, 2, 4, 6]


def test_heartbeat_loss_and_timeout_redispatch():
    def run(rt):
        plan = rt.FaultPlan(seed=3).drop_heartbeat(0).delay_task(2, 1.5)
        m = rt.RuntimeMetrics()
        out = rt.run_partitioned(lambda x: x + 1, [10, 20, 30],
                                 _policy(rt, max_workers=2, faults=plan, heartbeat_timeout=0.5,
                                         task_timeout=0.75), metrics=m)
        s = m.summary()
        return out, sorted(plan.fired), s["failures_heartbeat"], s["failures_timeout"]

    ref, port = _both(run)
    assert port == ref
    assert port == ([11, 21, 31], [("delay", 2, 0), ("drop_heartbeat", 0, 0)], 1, 1)


def test_speculation_overtakes_a_slow_task_and_the_first_result_wins():
    shards = [np.arange(16, dtype=np.float64) + i for i in range(4)]

    def run(rt):
        seen = {}
        lock = threading.Lock()

        def work(x):
            with lock:
                seen.setdefault(int(x[0]), []).append(threading.current_thread().name)
            return np.sqrt(x) * 2.0

        plan = rt.FaultPlan(seed=11).slow_task(3, 30.0)
        m = rt.RuntimeMetrics()
        t0 = time.monotonic()
        out = rt.run_partitioned(work, shards, _policy(
            rt, max_workers=2, speculation=True, speculation_quantile=0.5, faults=plan),
            metrics=m)
        s = m.summary()
        return (time.monotonic() - t0, [o.tobytes() for o in out], plan.fired,
                s["speculative_launched"], s["speculative_wins"], len(set(seen[3])))

    for got in _both(run):
        elapsed, out, fired, launched, wins, workers = got
        assert elapsed < 10.0  # not the 30 s straggle
        assert out == [(np.sqrt(s) * 2.0).tobytes() for s in shards]
        assert fired == [("slow_task", 3, 0)]
        assert launched >= 1 and wins >= 1 and workers >= 2


def test_all_workers_quarantined_fails_fast():
    def run(rt):
        with pytest.raises(rt.AllWorkersQuarantinedError) as ei:
            rt.run_partitioned(lambda x: (_ for _ in ()).throw(ValueError("boom")), [0],
                               _policy(rt, max_workers=1, max_retries=8,
                                       quarantine_threshold=2.0, parole_s=60.0))
        err = ei.value
        assert isinstance(err, rt.JobFailedError)
        return [a.reason for a in err.history[0]], "parole" in str(err)

    ref, port = _both(run)
    assert port == ref == (["error", "error"], True)


def test_health_tracker_quarantine_and_parole_on_a_fake_clock():
    def run(rt):
        now = [0.0]
        seen = []
        ht = rt.HealthTracker(threshold=2.0, window_s=10.0, parole_s=5.0, clock=lambda: now[0],
                              on_quarantine=lambda w, s: seen.append(("q", w, s)),
                              on_parole=lambda w: seen.append(("p", w)))
        ht.note_failure(1)
        ht.note_straggle(2)
        now[0] = 11.0  # worker 1's failure leaves the window
        ht.note_failure(1)
        ht.note_failure(2, reason="oom")  # 2.0 alone
        out = [ht.is_quarantined(1), ht.is_quarantined(2), ht.next_parole_in()]
        now[0] = 16.5
        out += [ht.is_quarantined(2), ht.quarantines, ht.paroles, seen]
        return out

    ref, port = _both(run)
    assert port == ref == [False, True, 5.0, False, 1, 1, [("q", 2, 2.0), ("p", 2)]]


def test_corrupt_result_is_caught_by_result_integrity():
    def run(rt):
        plan = rt.FaultPlan(seed=5).corrupt_result(1).corrupt_result(2)
        m = rt.RuntimeMetrics()
        out = rt.run_partitioned(lambda x: np.full(4, x, dtype=np.float32), [0, 1, 2, 3],
                                 _policy(rt, max_workers=2, faults=plan,
                                         result_integrity=True), metrics=m)
        s = m.summary()
        return [o.tolist() for o in out], sorted(plan.fired), s["failures_corrupt"]

    ref, port = _both(run)
    assert port == ref
    assert port[2] == 2 and port[0] == [[float(i)] * 4 for i in range(4)]


def test_oom_task_is_an_oom_failure_with_a_reduced_footprint_retry():
    def run(rt, footprint):
        plan = rt.FaultPlan().oom_task(1, kind="host").oom_task(2, kind="device")
        m = rt.RuntimeMetrics()
        hints = {}

        def work(x):
            hints.setdefault(x, []).append(footprint())
            return x

        out = rt.run_partitioned(work, [0, 1, 2], _policy(rt, max_workers=1, faults=plan),
                                 metrics=m)
        return out, sorted(plan.fired), m.summary()["failures_total"], hints

    from mmlspark_tpu.runtime.pressure import reduced_footprint

    ref = run(jrt, reduced_footprint)
    port = run(trt, trt.reduced_footprint)
    assert port == ref
    assert port[3] == {0: [0], 1: [1], 2: [1]}
    assert trt.is_oom_error(trt.DeviceOomError("RESOURCE_EXHAUSTED: x"))
    assert trt.is_oom_error(MemoryError()) and not trt.is_oom_error(ValueError("x"))
    import torch

    assert trt.is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of memory"))


def test_lineage_recompute_of_a_lost_partition():
    def run(rt):
        lin = rt.Lineage()
        shards = [lin.record(i, lambda i=i: 40 + i, lambda v: v + 2, describe=f"{i}")
                  for i in range(3)]
        lost = {1}
        lock = threading.Lock()

        def work(x):
            with lock:
                if x - 42 in lost:
                    lost.discard(x - 42)
                    raise rt.PartitionLostError("input evicted")
            return x * 2

        m = rt.RuntimeMetrics()
        out = rt.run_partitioned(work, shards, _policy(rt, max_workers=2), lineage=lin,
                                 metrics=m)
        return out, dict(lin.recomputes), m.summary()["lineage_recomputes"]

    ref, port = _both(run)
    assert port == ref == ([84, 86, 88], {1: 1}, 1)


def test_metrics_summary_keys_and_counts_equal_the_reference():
    def run(rt):
        plan = rt.FaultPlan().kill_task(1)
        m = rt.RuntimeMetrics()
        with rt.Scheduler(policy=_policy(rt, max_workers=2, faults=plan), metrics=m) as sched:
            sched.run(lambda x: x, [0, 1, 2])
            sched.run(lambda x: x, [3, 4])
        s = m.summary()
        counts = {k: v for k, v in s.items() if isinstance(v, int)}
        return (sorted(s), counts, sorted(s["phases"]), sorted(s["per_task"]),
                {i: t["attempts"] for i, t in s["per_task"].items()})

    ref, port = _both(run)
    assert port == ref
    assert port[1]["tasks_done"] == 5 and port[1]["retries_total"] == 1


def test_ambient_policy_and_faults():
    def run(rt):
        plan = rt.FaultPlan(seed=1).kill_task(0)
        with rt.inject_faults(plan) as p, rt.policy(max_workers=2, **FAST) as pol:
            assert rt.current_faults() is p and rt.current_policy() is pol
            out = rt.run_partitioned(lambda x: -x, [1, 2])
        assert rt.current_faults() is None and rt.current_policy() is None
        return out, plan.fired

    ref, port = _both(run)
    assert port == ref == ([-1, -2], [("kill", 0, 0)])


def test_concurrent_jobs_on_more_workers_than_cores_keep_every_result():
    """A stress run: several jobs at once on more executors than cores, with
    a short switch interval; a lost update would drop or misplace a
    result."""
    workers = 2 * (os.cpu_count() or 2)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    results = {}
    try:
        def job(j):
            plan = trt.FaultPlan(seed=j).kill_random_task(64)
            results[j] = trt.run_partitioned(lambda x: x * j, list(range(64)),
                                             _policy(trt, max_workers=workers, faults=plan))

        threads = [threading.Thread(target=job, args=(j,)) for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert results == {j: [x * j for x in range(64)] for j in range(4)}


# -- the durable plane -------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(jrt, trt), (trt, jrt)],
                         ids=["reference-to-port", "port-to-reference"])
def test_fit_journal_restores_across_packages(tmp_path, writer, reader):
    shards = [np.arange(5, dtype=np.uint8) + i for i in range(4)]
    calls = []

    def work(x):
        calls.append(int(x[0]))
        return x * 2

    with writer.FitJournal(str(tmp_path), key="job", num_tasks=4) as j1:
        first = writer.run_partitioned(work, shards, _policy(writer, max_workers=2), journal=j1)
        assert j1.appended == 4
    lines = (tmp_path / os.listdir(tmp_path)[0] / "journal.jsonl").read_text().splitlines()
    calls.clear()
    m = reader.RuntimeMetrics()
    with reader.FitJournal(str(tmp_path), key="job", num_tasks=4) as j2:
        again = reader.run_partitioned(work, shards, _policy(reader, max_workers=2), journal=j2,
                                       metrics=m)
        assert j2.appended == 0
    assert calls == [] and m.summary()["tasks_recovered"] == 4
    assert [a.tobytes() for a in again] == [a.tobytes() for a in first]
    assert (tmp_path / os.listdir(tmp_path)[0] / "journal.jsonl").read_text().splitlines() \
        == lines
    assert sorted(json.loads(x)["task"] for x in lines) == [0, 1, 2, 3]


def test_journal_directory_and_files_are_the_reference_layout(tmp_path):
    with jrt.FitJournal(str(tmp_path / "ref"), key="a key/with:odd chars", num_tasks=2) as j:
        j.record(1, np.arange(3))
    with trt.FitJournal(str(tmp_path / "port"), key="a key/with:odd chars", num_tasks=2) as j:
        j.record(1, np.arange(3))
    ref_dir, = os.listdir(tmp_path / "ref")
    port_dir, = os.listdir(tmp_path / "port")
    assert port_dir == ref_dir
    for name in ("meta.json", "journal.jsonl", "task-00001.ckpt"):
        assert ((tmp_path / "port" / port_dir / name).read_bytes()
                == (tmp_path / "ref" / ref_dir / name).read_bytes())
    assert trt.CHECKPOINT_DIR_ENV == jrt.CHECKPOINT_DIR_ENV == "MMLSPARK_TPU_CHECKPOINT_DIR"
    assert trt.result_crc(np.arange(7)) == jrt.result_crc(np.arange(7))


def test_model_store_latest_reads_across_packages(tmp_path):
    trt.ModelStore(str(tmp_path)).commit("tree=1\n", name="m")
    assert jrt.ModelStore(str(tmp_path)).latest("m") == (1, "tree=1\n")
    jrt.ModelStore(str(tmp_path)).commit("tree=2\n", name="m")
    assert trt.ModelStore(str(tmp_path)).latest("m") == (2, "tree=2\n")
    # a torn CURRENT falls back to the newest verified version
    (tmp_path / "m.CURRENT").write_text("{not json")
    assert trt.ModelStore(str(tmp_path)).latest("m") == (2, "tree=2\n")
    (tmp_path / "m-000002.txt").write_text("tree=torn")
    assert trt.ModelStore(str(tmp_path)).latest("m") == (1, "tree=1\n")


def test_disk_full_leaves_no_torn_file(tmp_path, monkeypatch):
    monkeypatch.setenv(trt.CHECKPOINT_DIR_ENV, str(tmp_path))
    assert trt.default_checkpoint_dir() == str(tmp_path)
    store = trt.ModelStore(str(tmp_path / "models"))
    store.commit("v1", name="m")
    plan = trt.FaultPlan().disk_full("m-000002", count=1)
    with trt.inject_faults(plan), pytest.raises(OSError) as ei:
        store.commit("v2", name="m")
    assert ei.value.errno == 28 and plan.fired == [("disk_full", 0, 0)]
    assert sorted(os.listdir(tmp_path / "models")) == ["m-000001.txt", "m-000001.txt.crc32",
                                                        "m.CURRENT"]
    assert store.latest("m") == (1, "v1")
    # a full volume under the journal fails the record, not the job
    plan = trt.FaultPlan().disk_full("task-00001", count=1)
    with trt.inject_faults(plan), trt.FitJournal(str(tmp_path / "j"), key="k",
                                                 num_tasks=2) as j:
        out = trt.run_partitioned(lambda x: x, [1, 2], _policy(trt, max_workers=1), journal=j)
        assert out == [1, 2] and j.completed() == [0]
    names = os.listdir(tmp_path / "j" / os.listdir(tmp_path / "j")[0])
    assert not any(n.endswith(".tmp") for n in names) and "task-00001.ckpt" not in names


# -- pressure ----------------------------------------------------------------------


def test_pressure_levels_and_footprint_hint():
    assert trt.current_pressure_level("memory") is trt.PressureLevel.OK
    prev = trt.set_pressure_level("memory", trt.PressureLevel.CRITICAL)
    try:
        assert prev is trt.PressureLevel.OK
        assert trt.current_pressure_level("memory") >= trt.PressureLevel.WARN
        assert trt.current_pressure_level("disk") is trt.PressureLevel.OK
    finally:
        trt.set_pressure_level("memory", prev)
    assert [int(x) for x in trt.PressureLevel] == [int(x) for x in jrt.PressureLevel]
    assert trt.reduced_footprint() == 0
    with tpressure._footprint_hint(3):
        assert trt.reduced_footprint() == 3
    assert trt.reduced_footprint() == 0


def test_watchdog_levels_from_injected_samplers(tmp_path):
    def run(rt, **kw):
        wd = rt.ResourceWatchdog(checkpoint_dir=str(tmp_path), **kw)
        try:
            return {k: int(v) for k, v in wd.poll().items()}
        finally:
            rt.set_pressure_level("memory", rt.PressureLevel.OK)
            rt.set_pressure_level("disk", rt.PressureLevel.OK)

    cases = [
        dict(hbm_sampler=lambda: [("d0", 50.0, 100.0)], rss_sampler=lambda: (10.0, 100.0),
             disk_sampler=lambda p: (90.0, 100.0)),
        dict(hbm_sampler=lambda: [("d0", 90.0, 100.0)], rss_sampler=lambda: (10.0, 100.0),
             disk_sampler=lambda p: (3.0, 100.0)),
        dict(hbm_sampler=lambda: [], rss_sampler=lambda: (97.0, 100.0),
             disk_sampler=lambda p: None),
    ]
    for kw in cases:
        assert run(trt, **kw) == run(jrt, registry=None, **kw)


def test_sample_hbm_is_empty_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tpressure.sample_hbm() == []


# -- events, spans and the registry ----------------------------------------------------

#: the scheduler events' fields that depend on timing or on the process
UNTIMED = {"t", "job_id", "duration", "age", "median", "queue_depth"}


def _scheduled_events(rt, events_mod, tracer, **policy):
    """A one-worker job under a seeded plan (a killed executor, an error on a
    task's first attempt, a quarantine and its parole) with its events and
    the tracer's spans; a quarantined worker waits out its parole."""
    seen = []
    bus = events_mod.get_bus()
    bus.add_listener(seen.append)
    tracer.clear()
    failed_once = set()

    def work(x):
        if x == 2 and x not in failed_once:
            failed_once.add(x)
            raise ValueError("first attempt of task 2")
        return x * 3

    plan = rt.FaultPlan(seed=5).kill_task(0)
    m = rt.RuntimeMetrics()
    try:
        out = rt.run_partitioned(work, [0, 1, 2, 3], _policy(
            rt, max_workers=1, faults=plan, quarantine_threshold=1.0, parole_s=0.05,
            quarantine_fail_fast=False, **policy), metrics=m)
    finally:
        bus.remove_listener(seen.append)
    records = [{k: v for k, v in e.to_record().items() if k not in UNTIMED} for e in seen
               if type(e).__name__ != "SpanRecorded"]  # the spans are compared apart
    # worker ids count up across the process: number them by creation
    rank = {w: i for i, w in enumerate(sorted({r["worker"] for r in records if "worker" in r
                                               and r["worker"] >= 0}))}
    for r in records:
        if r.get("worker", -1) >= 0:
            r["worker"] = rank[r["worker"]]
    spans = [(sp["name"], sp["status"]) for sp in tracer.export()]
    return out, records, spans, m.summary()


def _per_task(records):
    """Each task's events in their order (tasks run on one worker, but the
    scheduling loop re-dispatches a retry while the queue still drains, so
    the interleaving across tasks is timing's)."""
    out = {}
    for r in records:
        key = ("task", r["task_id"]) if "task_id" in r else ("worker", r["worker"])
        out.setdefault(key, []).append(r)
    return out


def test_scheduler_publishes_the_references_events_and_spans():
    from mmlspark_tpu.observability import events as jevents
    from mmlspark_tpu.observability import tracing as jtracing
    from mmlspark_tpu_torch.observability import events as tevents
    from mmlspark_tpu_torch.observability import tracing as ttracing

    port = _scheduled_events(trt, tevents, ttracing.get_tracer())
    jref = _scheduled_events(jrt, jevents, jtracing.get_tracer())
    assert port[0] == jref[0] == [0, 3, 6, 9]
    key = lambda r: json.dumps(r, sort_keys=True)  # noqa: E731
    assert sorted(map(key, port[1])) == sorted(map(key, jref[1]))
    assert _per_task(port[1]) == _per_task(jref[1])
    assert sorted(port[2]) == sorted(jref[2])
    kinds = {r["event"] for r in port[1]}
    assert {"TaskDispatched", "TaskFailed", "TaskRetried", "WorkerQuarantined",
            "WorkerParoled"} <= kinds
    assert ("scheduler.job", "ok") in port[2]
    assert {"executor_death", "error"} <= {status for _, status in port[2]}
    s = port[3]
    dispatched = sum(r["event"] == "TaskDispatched" for r in port[1])
    assert (dispatched, s["retries_total"], s["failures_total"]) == (
        s["dispatches"], sum(r["event"] == "TaskRetried" for r in port[1]),
        sum(r["event"] == "TaskFailed" for r in port[1]))


def test_speculation_and_recovery_events_equal_the_references(tmp_path):
    from mmlspark_tpu.observability import events as jevents
    from mmlspark_tpu_torch.observability import events as tevents

    def run(rt, events_mod):
        seen = []
        bus = events_mod.get_bus()
        bus.add_listener(seen.append)
        try:
            plan = rt.FaultPlan(seed=11).slow_task(3, 30.0)
            rt.run_partitioned(lambda x: x + 1, [0, 1, 2, 3], _policy(
                rt, max_workers=2, speculation=True, speculation_quantile=0.5, faults=plan))
            root = str(tmp_path / rt.__name__)
            with rt.FitJournal(root, "key", num_tasks=2) as j:
                rt.run_partitioned(lambda x: -x, [5, 6], _policy(rt, max_workers=1), journal=j)
            with rt.FitJournal(root, "key", num_tasks=2) as j:
                rt.run_partitioned(lambda x: -x, [5, 6], _policy(rt, max_workers=1), journal=j)
        finally:
            bus.remove_listener(seen.append)
        spec = [{k: v for k, v in e.to_record().items() if k not in UNTIMED | {"original_worker"}}
                for e in seen if type(e).__name__ == "TaskSpeculated"]
        recovered = [{k: v for k, v in e.to_record().items() if k not in UNTIMED}
                     for e in seen if type(e).__name__ == "TaskRecovered"]
        return spec[:1], recovered

    port, jref = run(trt, tevents), run(jrt, jevents)
    assert port == jref
    assert port[0] == [{"event": "TaskSpeculated", "task_id": 3}]
    assert port[1] == [{"event": "TaskRecovered", "task_id": 0},
                       {"event": "TaskRecovered", "task_id": 1}]


COUNTERS = {
    "scheduler_tasks_done_total": "tasks_done", "scheduler_dispatches_total": "dispatches",
    "scheduler_retries_total": "retries_total", "scheduler_quarantines_total": "quarantines",
    "scheduler_paroles_total": "paroles", "scheduler_tasks_recovered_total": "tasks_recovered",
    "scheduler_speculative_launched_total": "speculative_launched",
    "scheduler_speculative_wins_total": "speculative_wins",
    "scheduler_lineage_recomputes_total": "lineage_recomputes",
    "scheduler_wasted_results_total": "wasted_results",
}


@pytest.mark.parametrize("rt", [trt, jrt], ids=["port", "ref"])
def test_runtime_metrics_registry_counters_equal_the_summary(rt):
    from mmlspark_tpu.observability import registry as jregistry
    from mmlspark_tpu_torch.observability import registry as tregistry

    reg = (tregistry if rt is trt else jregistry).MetricsRegistry()
    m = rt.RuntimeMetrics(registry=reg)
    plan = rt.FaultPlan(seed=2).kill_task(1).corrupt_result(2)
    with rt.Scheduler(policy=_policy(rt, max_workers=2, faults=plan, result_integrity=True,
                                     quarantine_threshold=0.5, parole_s=0.01,
                                     quarantine_fail_fast=False), metrics=m) as sched:
        sched.run(lambda x: x, [0, 1, 2, 3])
    s = m.summary()
    for metric, key in COUNTERS.items():
        assert reg.get(metric).value == s[key], metric
    failures = reg.get("scheduler_failures_total")
    assert failures.labels(reason="executor_death").value == s["failures_executor_death"] == 1
    assert failures.labels(reason="corrupt").value == s["failures_corrupt"] == 1
    assert reg.get("scheduler_max_queue_depth").value == s["max_queue_depth"]
    assert reg.get("scheduler_task_run_seconds").count == s["tasks_done"] == 4


def test_runtime_metrics_render_the_references_counters():
    from mmlspark_tpu.observability import registry as jregistry
    from mmlspark_tpu_torch.observability import registry as tregistry

    def script(rt, registry_mod):
        reg = registry_mod.MetricsRegistry()
        m = rt.RuntimeMetrics(registry=reg)
        for i in range(3):
            m.note_dispatch(i, queue_depth=i + 2)
            m.note_start(i, 0.25)
            m.note_done(i, 0.5)
        m.note_failure(1, "oom")
        m.note_retry(1)
        m.note_recompute(1)
        m.note_wasted_result()
        m.note_speculative_launch(2)
        m.note_speculative_win(2)
        m.note_recovered(0)
        m.note_quarantine(4)
        m.note_parole(4)
        m.note_quarantine(5)
        return reg.exposition(), m.summary()

    assert script(trt, tregistry) == script(jrt, jregistry)


def test_watchdog_publishes_the_references_pressure_events_and_gauges(tmp_path):
    from mmlspark_tpu.observability import events as jevents
    from mmlspark_tpu.observability import registry as jregistry
    from mmlspark_tpu_torch.observability import events as tevents
    from mmlspark_tpu_torch.observability import registry as tregistry

    rounds = [  # (card used, host rss, checkpoint free, event-log free) of 100
        (50.0, 10.0, 90.0, 80.0), (86.0, 10.0, 90.0, 80.0), (96.0, 10.0, 12.0, 80.0),
        (40.0, 97.0, 4.0, 80.0), (10.0, 10.0, 90.0, 80.0), (10.0, 10.0, 90.0, 2.0),
    ]

    def run(rt, registry_mod, events_mod):
        reg = registry_mod.MetricsRegistry()
        state = {}
        ckpt, evdir = str(tmp_path / "ckpt"), str(tmp_path / "events")
        wd = rt.ResourceWatchdog(
            checkpoint_dir=ckpt, eventlog_dir=evdir, registry=reg,
            hbm_sampler=lambda: [("cuda:0", state["r"][0], 100.0)],
            rss_sampler=lambda: (state["r"][1], 100.0),
            disk_sampler=lambda p: (state["r"][2] if p == ckpt else state["r"][3], 100.0))
        seen = []
        bus = events_mod.get_bus()
        bus.add_listener(seen.append)
        levels = []
        try:
            for r in rounds:
                state["r"] = r
                levels.append({k: int(v) for k, v in wd.poll().items()})
        finally:
            bus.remove_listener(seen.append)
            rt.set_pressure_level("memory", rt.PressureLevel.OK)
            rt.set_pressure_level("disk", rt.PressureLevel.OK)
        records = [{k: v for k, v in e.to_record().items() if k != "t"} for e in seen]
        return levels, records, reg.exposition().replace(str(tmp_path), "<tmp>")

    port = run(trt, tregistry, tevents)
    assert port == run(jrt, jregistry, jevents)
    kinds = [(r["event"], r["level"]) for r in port[1]]
    assert ("MemoryPressure", "critical") in kinds and ("MemoryPressure", "ok") in kinds
    assert ("DiskPressure", "warn") in kinds and ("DiskPressure", "ok") in kinds
    assert "pressure_hbm_fraction" in port[2]


def test_watchdog_watches_the_event_log_volume_by_default(tmp_path, monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_EVENT_LOG", str(tmp_path / "logs" / "events.jsonl"))
    assert trt.ResourceWatchdog().eventlog_dir == jrt.ResourceWatchdog().eventlog_dir == \
        str(tmp_path / "logs")
    monkeypatch.setenv("MMLSPARK_TPU_EVENT_LOG", "events.jsonl")
    assert trt.ResourceWatchdog().eventlog_dir == jrt.ResourceWatchdog().eventlog_dir == "."
    monkeypatch.delenv("MMLSPARK_TPU_EVENT_LOG")
    assert trt.ResourceWatchdog().eventlog_dir is None
    assert trt.get_watchdog() is trt.get_watchdog()


def test_runtime_imports_neither_jax_nor_the_reference():
    code = ("import sys, mmlspark_tpu_torch.runtime, mmlspark_tpu_torch.lightgbm, "
            "mmlspark_tpu_torch.data.sharded\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'mmlspark_tpu' or m.startswith('mmlspark_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
