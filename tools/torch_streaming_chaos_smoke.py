#!/usr/bin/env python
"""Kill-and-restart smoke of the port's streaming engine
(``mmlspark_tpu_torch.streaming``); the port's copy of
``tools/streaming_chaos_smoke.py``.

A child process runs a checkpointed :class:`StreamingQuery` (file source,
``max_per_trigger=1``: one epoch per chunk) whose :class:`ModelCommitSink`
fits LightGBM incrementally on the estimator's device (the card unless
``--device cpu``). The parent SIGKILLs the child at both designated crash
windows, ``post_wal`` (epoch planned and logged, nothing processed) and
``pre_commit`` (sink ran and journaled, commit log missing), through the
ambient :class:`FaultPlan`'s ``kill_stream`` directive, then restarts it.
Each restart is a standby process, started while its victim still runs
and released once the victim is dead, so that a restart does not wait
for the next process's imports and CUDA context.
The exactly-once invariants, held against an undisturbed run:

  * every epoch lands in the commit log exactly once;
  * a journaled epoch is never refitted across restarts (the fit journal
    holds exactly one record per epoch over all runs together);
  * the final ModelStore version and model text equal the undisturbed
    run's, byte for byte;
  * a warm-restarted server serves that same version.

Exit code 0 and "streaming chaos smoke OK" on success; the last line of
standard output is a JSON record of both runs.

Usage:
  python tools/torch_streaming_chaos_smoke.py --device cpu        # the smoke
  python tools/torch_streaming_chaos_smoke.py --incoming DIR --work DIR \\
      --params '{"numIterations": 10}' --kill 2:post_wal --kill 5:pre_commit \\
      --chaos-only --kernel-library LIB                            # chaos only
  python tools/torch_streaming_chaos_smoke.py --child SPEC_JSON     # a victim

The tool runs the undisturbed run itself in a child process; with
``--chaos-only`` it runs none and leaves the comparison of the final
version and text to its caller (the chaos run can then go on beside the
caller's undisturbed run). Children never build the kernels:
with ``--kernel-library`` they load that library, otherwise the parent
builds once and passes it on (a SIGKILL while a child holds the build lock
would hang later builds).
"""

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import zlib

# runnable straight from a checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

NUM_CHUNKS = 4
MODEL = "chaos"
QUERY = "chaos"
DEFAULT_PARAMS = {"numIterations": 4, "numLeaves": 7, "seed": 5}
DEFAULT_KILLS = ("1:post_wal", "2:pre_commit")
CHILD_TIMEOUT_S = 600.0


def make_chunks(incoming: str) -> None:
    """The reference tool's chunks: 4 of 60 rows x 4 features, published by
    write-then-rename."""
    rng = np.random.default_rng(11)
    os.makedirs(incoming, exist_ok=True)
    for i in range(NUM_CHUNKS):
        X = rng.normal(size=(60, 4))
        y = (X[:, 0] - 0.5 * X[:, 2] > 0).astype(np.float64)
        final = os.path.join(incoming, f"part-{i:05d}.npz")
        np.savez(final + ".tmp.npz", features=X, label=y)
        os.rename(final + ".tmp.npz", final)


def run_child(spec: dict) -> None:
    """One (re)start of the query; dies mid-epoch when a kill is armed. A
    standby child pays its start (imports, the kernels' library, the CUDA
    context) and then waits for a line on stdin before it opens the
    checkpoint: the parent starts it while the child before it still
    runs, and sends the line once that child is dead."""
    os.environ["MMLSPARK_TPU_CHECKPOINT_DIR"] = spec["root"]
    if spec.get("kernel_library"):
        from mmlspark_tpu_torch.kernels.build import use_prebuilt

        use_prebuilt(spec["kernel_library"])
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier
    from mmlspark_tpu_torch.runtime.faults import FaultPlan, inject_faults
    from mmlspark_tpu_torch.streaming import FileStreamSource, ModelCommitSink, StreamingQuery

    params = dict(spec["params"])
    if spec.get("standby"):
        device = str(params.get("device", "cuda"))
        if device != "cpu":
            import torch

            torch.zeros(1, device=device)
        if not sys.stdin.readline():
            return  # the parent went away
    source = FileStreamSource(spec["incoming"], pattern="part-*.npz", max_per_trigger=1)
    sink = ModelCommitSink(lambda: LightGBMClassifier(**params), name=MODEL)
    query = StreamingQuery(source, sink, name=QUERY)
    plan = FaultPlan(seed=spec.get("seed"))
    if spec.get("kill"):
        epoch, point = spec["kill"]
        plan.kill_stream(int(epoch), point)
    with inject_faults(plan):
        query.process_all_available()
    sink.close()


def spawn(root: str, incoming: str, params: dict, kill=None, kernel_library=None,
          seed=None, standby=False) -> subprocess.Popen:
    """A child; a ``standby`` one starts its query at :func:`release`."""
    spec = {"root": root, "incoming": incoming, "params": params, "kill": kill,
            "kernel_library": kernel_library, "seed": seed, "standby": standby}
    argv = [sys.executable, os.path.abspath(__file__), "--child", json.dumps(spec)]
    return subprocess.Popen(argv, env=dict(os.environ),
                            stdin=subprocess.PIPE if standby else None, text=True)


def release(child: subprocess.Popen) -> None:
    """Start a standby child's query."""
    child.stdin.write("go\n")
    child.stdin.close()


def final_state(root: str):
    """(version, model text, committed epochs, journal epochs) under a
    query's checkpoint root."""
    from mmlspark_tpu_torch.runtime.journal import ModelStore

    store = ModelStore(os.path.join(root, "models"))
    version, text = store.latest(MODEL)
    commits = sorted(
        int(os.path.basename(p)[:-5])
        for p in glob.glob(os.path.join(root, "streaming", QUERY, "commits", "*.json")))
    journal_epochs = []
    for path in glob.glob(os.path.join(root, "streaming-models", "**", "journal.jsonl"),
                          recursive=True):
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                if line.strip():
                    journal_epochs.append(int(json.loads(line)["task"]))
    return version, text, commits, sorted(journal_epochs)


def _wait(child: subprocess.Popen) -> int:
    try:
        return child.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        raise


def _kernel_library(params: dict):
    """The built kernels' library for the children (None on the CPU)."""
    if str(params.get("device", "cuda")) == "cpu":
        return None
    from mmlspark_tpu_torch.kernels.build import histogram_extension

    return histogram_extension().__file__


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tools/torch_streaming_chaos_smoke.py",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--incoming", default=None,
                        help="directory of part-*.npz chunks (default: 4 small chunks "
                             "made in the work directory)")
    parser.add_argument("--work", default=None,
                        help="directory for the checkpoint roots (default: a new temp dir)")
    parser.add_argument("--params", default=None,
                        help="LightGBMClassifier params as JSON (default: the reference "
                             "tool's 4 iterations, 7 leaves, seed 5)")
    parser.add_argument("--device", default=None,
                        help="the estimator's device (default: params' or cuda)")
    parser.add_argument("--kill", action="append", default=None,
                        help="EPOCH:POINT, post_wal or pre_commit; one child per kill "
                             "(default: 1:post_wal and 2:pre_commit)")
    parser.add_argument("--chaos-only", action="store_true",
                        help="no undisturbed run and no comparison with one: check the "
                             "commit log and the journal, print the final state")
    parser.add_argument("--kernel-library", default=None,
                        help="built kernels the children load instead of building")
    args = parser.parse_args(argv)

    work = args.work or tempfile.mkdtemp(prefix="mmlspark-tpu-torch-streamchaos-")
    incoming = args.incoming or os.path.join(work, "incoming")
    if args.incoming is None:
        make_chunks(incoming)
    params = json.loads(args.params) if args.params else dict(DEFAULT_PARAMS)
    if args.device is not None:
        params["device"] = args.device
    kills = [(int(k.split(":")[0]), k.split(":")[1]) for k in (args.kill or DEFAULT_KILLS)]
    seed = int(os.environ.get("MMLSPARK_TPU_FAULT_SEED", "0"))
    lib = args.kernel_library or _kernel_library(params)
    num_chunks = len(glob.glob(os.path.join(incoming, "part-*.npz")))
    record = {"chunks": num_chunks, "kills": kills, "fault_seed": seed, "children": []}

    ref_root = None
    if not args.chaos_only:
        ref_root = os.path.join(work, "ref")
        t0 = time.perf_counter()
        child = spawn(ref_root, incoming, params, kernel_library=lib, seed=seed)
        assert _wait(child) == 0, "undisturbed run failed"
        record["undisturbed_s"] = time.perf_counter() - t0
    if ref_root is not None:
        ref_version, ref_text, ref_commits, _ = final_state(ref_root)
        ref_crc = zlib.crc32(ref_text.encode())
        assert ref_commits == list(range(num_chunks)), ref_commits
        print(f"undisturbed run: v{ref_version:06d} crc={ref_crc:08x} epochs={ref_commits}",
              flush=True)

    # chaos run: one child per kill, each SIGKILLed at its window, then a
    # final restart that finishes; one checkpoint root throughout. Each
    # restart is a standby child started beside the one before it and
    # released once that one is dead; a child's seconds run from its
    # release to its end
    chaos_root = os.path.join(work, "chaos")
    victims = kills + [None]
    t0 = time.perf_counter()
    child = spawn(chaos_root, incoming, params, kill=victims[0], kernel_library=lib, seed=seed)
    standby = None
    try:
        for i, kill in enumerate(victims):
            if i + 1 < len(victims):
                standby = spawn(chaos_root, incoming, params, kill=victims[i + 1],
                                kernel_library=lib, seed=seed, standby=True)
            rc = _wait(child)
            record["children"].append({"kill": list(kill) if kill else None, "rc": rc,
                                       "seconds": time.perf_counter() - t0})
            if kill is None:
                assert rc == 0, "final restart failed"
                break
            assert rc == -signal.SIGKILL, f"expected SIGKILL death at {kill}, got rc={rc}"
            print(f"child SIGKILLed at epoch {kill[0]} ({kill[1]})", flush=True)
            t0 = time.perf_counter()
            release(standby)
            child, standby = standby, None
    finally:
        if standby is not None:  # a victim that did not die as planned
            standby.kill()
            standby.wait()

    version, text, commits, journal = final_state(chaos_root)
    crc = zlib.crc32(text.encode())
    print(f"chaos run:       v{version:06d} crc={crc:08x} epochs={commits}", flush=True)
    assert commits == list(range(num_chunks)), f"each epoch must commit exactly once: {commits}"
    assert journal == list(range(num_chunks)), (
        f"a journaled epoch was refitted (or skipped): {journal}")
    if ref_root is not None:
        assert (version, text) == (ref_version, ref_text), (
            f"diverged from undisturbed run: v{version} crc={crc:08x} "
            f"!= v{ref_version} crc={ref_crc:08x}")

    # the serving plane recovers the identical version after the chaos
    from mmlspark_tpu_torch.lightgbm import LightGBMClassificationModel
    from mmlspark_tpu_torch.serving import recover_model, warm_restart_server

    def loader(model_text):
        return LightGBMClassificationModel.from_model_string(
            model_text, device=params.get("device", "cuda"))

    recovered = recover_model(loader, root=chaos_root, name=MODEL)
    assert recovered is not None and recovered[0] == version
    server = warm_restart_server(loader, root=chaos_root, name=MODEL)
    try:
        assert server.model_version == version
        assert server.info.model_version == version
    finally:
        server._httpd.server_close()
    print(f"warm restart serves v{server.model_version:06d}"
          + (" (matches undisturbed run)" if ref_root is not None else ""), flush=True)
    record.update(version=version, crc32=f"{crc:08x}", commits=commits, journal=journal,
                  text_equal=True if ref_root is not None else None, chaos_root=chaos_root)
    print("streaming chaos smoke OK", flush=True)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        run_child(json.loads(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())
