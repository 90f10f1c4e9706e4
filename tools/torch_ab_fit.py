#!/usr/bin/env python3
"""Phase 5's fit of chip_smoke.py timed in turns between two checkouts.

    python3 tools/torch_ab_fit.py OLD_DIR NEW_DIR [--pairs 6] [--reuse-bins]

OLD_DIR and NEW_DIR are roots of two checkouts of this repo (for example
the parent commit unpacked with ``git archive`` and the working tree).
One worker process per checkout imports ``mmlspark_tpu_torch`` from its
own checkout, makes the same 11,000,000 HIGGS-shaped rows (chip_smoke.py's
generator, row count and phase 5's estimator params, all from the
checkout this script lies in) and fits once to build its kernels. Then
the fits run one at a time in the order old, new, new, old, ... until
each checkout has fitted ``--pairs`` times; the other worker waits idle
meanwhile. Each fit reports ``FitStats``' boosting and binning seconds
and its wall time.
With ``--reuse-bins`` each worker bins once, in its warm-up fit, and every
later fit takes those bins back from ``base.bin_dataset``: the turns then
time the boosting path without the host binning between them.

Prints one JSON line per fit, then one summary line: for each checkout the
median, least and greatest of each time, and the new-minus-old difference
of every pair with its median. Needs one CUDA card; exits non-zero
without one.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TAG = "AB_FIT "  # prefix of the worker's protocol lines on its stdout
TIMES = ("boosting_s", "binning_s", "fit_s")


def _smoke():
    """This checkout's chip_smoke.py, loaded as a module (its main does not run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _say(obj):
    print(TAG + json.dumps(obj), flush=True)


def worker(tree, reuse_bins):
    """Fit phase 5's classifier on the card each time a line ``fit``
    arrives on stdin; answer each with one tagged JSON line."""
    tree = os.path.realpath(tree)
    sys.path.insert(0, tree)
    import torch

    import mmlspark_tpu_torch
    from mmlspark_tpu_torch.data.table import Table
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier, base

    if not os.path.realpath(mmlspark_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"mmlspark_tpu_torch came from {mmlspark_tpu_torch.__file__}, "
                           f"not from {tree}")
    smoke = _smoke()
    X, y = smoke._make_data(smoke.N_FIT, smoke.N_FEATURES, seed=0)
    table = Table({"features": X, "label": y})
    if reuse_bins:
        bin_dataset, binned = base.bin_dataset, []

        def bin_once(*a, **kw):
            if not binned:
                binned.append(bin_dataset(*a, **kw))
            return binned[0]

        base.bin_dataset = bin_once

    def fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = LightGBMClassifier(**smoke.HIGGS_PARAMS).fit(table)
        torch.cuda.synchronize()
        st = model.fit_stats
        return dict(fit_s=time.perf_counter() - t0, boosting_s=st.boost_seconds,
                    binning_s=st.binning_seconds, trees=st.trees,
                    text_bytes=len(model.get_model_string()))

    warm = fit()  # builds the kernels; not reported as a turn
    _say(dict(ready=True, tree=tree, warm_up=warm))
    for line in sys.stdin:
        if line.strip() != "fit":
            break
        _say(fit())


def _read(proc):
    """The worker's next tagged line, skipping anything else it prints."""
    for line in proc.stdout:
        if line.startswith(TAG):
            return json.loads(line[len(TAG):])
    raise RuntimeError(f"worker exited with code {proc.wait()}")


def _spread(values):
    return dict(median=statistics.median(values), least=min(values), greatest=max(values))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--reuse-bins", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.old, args.reuse_bins)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_ab_fit: no CUDA device")
    trees = {"old": os.path.realpath(args.old), "new": os.path.realpath(args.new)}
    procs = {}
    try:
        for name, tree in trees.items():  # started in turn: the warm-up fits do not overlap
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), tree, "-", "--worker"]
                + (["--reuse-bins"] if args.reuse_bins else []),
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=tree)
            print(json.dumps(dict(name=name, **_read(procs[name]))), flush=True)
        order = [("old", "new", "new", "old")[i % 4] for i in range(2 * args.pairs)]
        runs = {name: [] for name in trees}
        for i, name in enumerate(order):
            procs[name].stdin.write("fit\n")
            procs[name].stdin.flush()
            rec = _read(procs[name])
            runs[name].append(rec)
            print(json.dumps(dict(turn=i, name=name, **rec)), flush=True)
    finally:
        for proc in procs.values():
            if proc.stdin:
                proc.stdin.close()
        for proc in procs.values():
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
    diffs = {k: [b[k] - a[k] for a, b in zip(runs["old"], runs["new"])] for k in TIMES}
    summary = {name: {k: _spread([r[k] for r in recs]) for k in TIMES}
               for name, recs in runs.items()}
    summary["new_minus_old"] = {k: dict(per_pair=v, median=statistics.median(v))
                                for k, v in diffs.items()}
    summary["device"] = torch.cuda.get_device_name(0)
    summary["order"] = order
    summary["reuse_bins"] = args.reuse_bins
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
