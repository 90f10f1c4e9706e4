#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, nvcc and no network.
It imports nothing of JAX or of the JAX package. Phases (any failure exits
non-zero and prints no result):

1. Device: the card's name and power limit.
2. Build: compiles the histogram kernel (kernels/csrc/histogram.cu) for sm_90a.
3. Kernel against its plain version on the card at HIGGS width (11,000,000
   rows x 28 features x 256 bins) for 1, 8 and 42 nodes: bit-equal to the
   plain version (both sum g and h in 64-bit fixed point), two launches
   bit-identical, counts bit-equal to a float64 index_add_ and g and h
   within 1e-5 * sum|x| + 1e-6 of it; times of the kernel, the plain
   version and one index_add_ call; the byte bound.
4. Fit parity: 1,000,000 rows, 3 iterations, kernel against the plain
   version forced in: identical trees, margins within 1e-4.
5. The main path: LightGBMClassifier.fit on 11,000,000 x 28 rows (maxBin
   255, 31 leaves, leafBatch 8, 10 iterations) on cuda, then transform of
   500,000 held-out rows; the kernel launch counts of this run.
6. One JSON line with every kernel of the path, then the card line, then
   the result line.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N_KERNEL = 11_000_000  # HIGGS's row count
N_FEATURES = 28  # HIGGS's width
NUM_BINS = 256
N_PARITY = 1_000_000
N_FIT = 11_000_000
N_TEST = 500_000
FIT_ITERS = 10

# Card memory rate (bytes/s) and float32 peak outside the tensor cores
# (ops/s), by name: NVIDIA's data sheets at the full power limit.
CARDS = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),
)


def _make_data(n, f, seed=0):
    """bench.py's HIGGS-shaped generator."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float64)
    logit = X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + 0.8 * np.sin(X[:, 3]) + 0.5 * rng.normal(size=n)
    y = (logit > 0).astype(np.float64)
    return X, y


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _rates(name):
    for key, bw, flops in CARDS:
        if key in name:
            return bw, flops
    raise RuntimeError(f"no memory rate known for card {name!r}")


def _time_ms(torch, fn, reps):
    """Median milliseconds of ``reps`` runs of ``fn``, each between two
    CUDA events, after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel(torch, hh, rates):
    """Kernel against the plain version at HIGGS width; returns per-k records."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    n, f, b = N_KERNEL, N_FEATURES, NUM_BINS
    bins_t = torch.randint(0, b, (f, n), device=dev, generator=gen, dtype=torch.int32).to(torch.uint8)
    grad = torch.randn(n, device=dev, generator=gen)
    hess = torch.rand(n, device=dev, generator=gen) * 0.25
    count = torch.ones(n, device=dev)
    records = {}
    for k, entry in ((1, hh.build_histograms_combined_cuda), (8, hh.build_histograms_cuda),
                     (42, hh.build_histograms_cuda)):
        # keys in [0, k]: key k is out of range and must add nothing
        node = torch.randint(0, k + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
        if k == 1:
            node.zero_()  # the root pass keys every row to node 0
        args = (bins_t, grad, hess, count, node)
        out = entry(*args, k, b)
        again = entry(*args, k, b)
        torch.cuda.synchronize()
        plain = hh.build_histograms_plain(*args, k, b)
        max_err = float((out - plain).abs().max())
        if not torch.equal(out, plain):
            raise AssertionError(f"k={k}: kernel differs from the plain version "
                                 f"(max abs err {max_err})")
        del plain
        if not torch.equal(out, again):
            raise AssertionError(f"k={k}: two launches on the same input differ")
        ref = hh.build_histograms_plain(bins_t, grad.double(), hess.double(), count.double(),
                                        node, k, b)
        absref = hh.build_histograms_plain(bins_t, grad.double().abs(), hess.double(),
                                           count.double(), node, k, b)
        counts_equal = torch.equal(out[..., 2].double(), ref[..., 2])
        err = (out[..., :2].double() - ref[..., :2]).abs()
        tol = 1e-5 * absref[..., :2] + 1e-6
        within = bool((err <= tol).all())
        max_err_f64 = float((out.double() - ref).abs().max())
        del ref, absref, err, tol
        if not (counts_equal and within):
            raise AssertionError(f"k={k}: kernel disagrees with the float64 sums "
                                 f"(counts equal {counts_equal}, max abs err {max_err_f64})")
        ms = _time_ms(torch, lambda: entry(*args, k, b), 20)
        plain_ms = _time_ms(torch, lambda: hh.build_histograms_plain(*args, k, b), 3)
        # library yardstick: the one index_add_ call inside the plain version
        keep = node < k
        rows = keep.nonzero().squeeze(1)
        ids = ((node[rows].long()[None, :] * f + torch.arange(f, device=dev)[:, None]) * b
               + bins_t[:, rows].long()).reshape(-1)
        data = torch.stack([grad[rows], hess[rows], count[rows]], 1).repeat(f, 1)
        acc = torch.zeros(k * f * b, 3, device=dev)
        library_ms = _time_ms(torch, lambda: acc.index_add_(0, ids, data), 3)
        n_in = int(rows.numel())
        del ids, data, acc, rows, keep
        bw, flops = rates
        byte_ms = hh.bytes_needed(n, f, n_in, k, b) / bw * 1e3
        op_ms = hh.adds_needed(f, n_in) / flops * 1e3
        rec = dict(
            k=k, rows_in_range=n_in, max_abs_err=max_err, max_abs_err_f64=max_err_f64,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(byte_ms, op_ms), bound_by="bytes" if byte_ms >= op_ms else "operations",
        )
        print(f"kernel k={k}: " + json.dumps(rec), flush=True)
        records[k] = rec
    del bins_t, grad, hess, count
    torch.cuda.empty_cache()
    return records


def phase_parity(torch, hh, histogram, binning, train):
    """3 iterations with the kernel and 3 with the plain version forced in."""
    X, y = _make_data(N_PARITY, N_FEATURES, seed=1)
    bins, mapper = binning.bin_dataset(X, max_bin=NUM_BINS - 1)
    opts = train.TrainOptions(objective="binary", num_iterations=3, num_leaves=31,
                              learning_rate=0.1, max_bin=NUM_BINS - 1, leaf_batch=8)
    kern = train.train(bins, y, opts, mapper=mapper, device="cuda").booster
    saved = histogram.build_histograms
    histogram.build_histograms = lambda bins_t, g, h, c, node, k, b: hh.build_histograms_plain(
        bins_t, g, h, c, node, k, b)
    try:
        plain = train.train(bins, y, opts, mapper=mapper, device="cuda").booster
    finally:
        histogram.build_histograms = saved
    for field in ("split_feature", "split_bin", "left_child", "right_child", "is_leaf"):
        if not np.array_equal(getattr(kern, field), getattr(plain, field)):
            raise AssertionError(f"fit parity: {field} differs; gains kernel "
                                 f"{kern.split_gain.tolist()} plain {plain.split_gain.tolist()}")
    Xs = X[:100_000]
    dm = float(np.abs(kern.raw_margin(Xs, device="cuda") - plain.raw_margin(Xs, device="cuda")).max())
    if not dm <= 1e-4:
        raise AssertionError(f"fit parity: margins differ by {dm}")
    print(f"fit parity: {N_PARITY} rows, 3 iterations, identical trees, "
          f"max margin delta {dm}", flush=True)


def phase_fit(torch, hh, histogram, Table, LightGBMClassifier, auc, rows):
    """The main path: fit and predict through the estimator on cuda, with
    CUDA events around every histogram launch."""
    X, y = _make_data(rows + N_TEST, N_FEATURES, seed=0)
    train_t = Table({"features": X[:rows], "label": y[:rows]})
    test_t = Table({"features": X[rows:], "label": y[rows:]})
    events = []
    wrapped = {}
    for name in ("build_histograms_cuda", "build_histograms_combined_cuda"):
        fn = getattr(histogram, name)

        def timed(*a, _fn=fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _fn(*a)
            end.record()
            events.append((start, end))
            return out

        wrapped[name] = fn
        setattr(histogram, name, timed)
    est = LightGBMClassifier(numIterations=FIT_ITERS, numLeaves=31, maxBin=NUM_BINS - 1,
                             leafBatch=8, learningRate=0.1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hh.build_histograms_cuda.launches = 0
    hh.build_histograms_combined_cuda.launches = 0
    try:
        t0 = time.perf_counter()
        model = est.fit(train_t)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {"panel": hh.build_histograms_cuda.launches,
                    "combined": hh.build_histograms_combined_cuda.launches}
        t1 = time.perf_counter()
        out = model.transform(test_t)
        predict_s = time.perf_counter() - t1
    finally:
        for name, fn in wrapped.items():
            setattr(histogram, name, fn)
    peak = torch.cuda.max_memory_allocated()
    hist_ms = sum(s.elapsed_time(e) for s, e in events)
    prob = out["probability"]
    if prob.shape != (N_TEST, 2) or not np.isfinite(prob).all():
        raise AssertionError(f"bad probability column {prob.shape}")
    test_auc = auc(y[rows:], prob[:, 1], np.ones(N_TEST))
    if not test_auc > 0.75:
        raise AssertionError(f"held-out AUC {test_auc} is too low for this data")
    st = model.fit_stats
    rec = dict(
        rows=rows, features=N_FEATURES, iterations=FIT_ITERS, fit_s=fit_s,
        binning_s=st.binning_seconds, boosting_s=st.boost_seconds, predict_s=predict_s,
        predict_rows=N_TEST, trees=st.trees, passes=st.passes,
        hist_launches_per_tree=(launches["panel"] + launches["combined"]) / st.trees,
        hist_ms=hist_ms, hist_share_of_fit=hist_ms / 1e3 / fit_s,
        hist_share_of_boosting=hist_ms / 1e3 / st.boost_seconds,
        host_syncs_per_tree=st.syncs / st.trees, peak_device_bytes=peak,
        held_out_auc=test_auc, launches=launches,
    )
    print("fit: " + json.dumps(rec), flush=True)
    return rec


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mmlspark_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mmlspark_tpu_torch.data.table import Table
    from mmlspark_tpu_torch.kernels.build import histogram_extension
    from mmlspark_tpu_torch.lightgbm import LightGBMClassifier, binning, train
    from mmlspark_tpu_torch.lightgbm.objectives import auc
    from mmlspark_tpu_torch.ops import histogram
    from mmlspark_tpu_torch.ops import hopper_histogram as hh

    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)
    rates = _rates(kind)

    t0 = time.perf_counter()
    histogram_extension()
    print(f"build: histogram.cu for sm_90a in {time.perf_counter() - t0:.3f} s", flush=True)

    kernel = phase_kernel(torch, hh, rates)
    phase_parity(torch, hh, histogram, binning, train)
    fit = phase_fit(torch, hh, histogram, Table, LightGBMClassifier, auc, N_FIT)

    src = "mmlspark_tpu_torch/kernels/csrc/histogram.cu"
    entries = []
    for name, k, replaces, key in (
        ("hist_panel", 8, "mmlspark_tpu/ops/pallas_histogram.py:86", "panel"),
        ("hist_combined", 1, "mmlspark_tpu/ops/pallas_histogram.py:177", "combined"),
    ):
        r = kernel[k]
        if fit["launches"][key] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=fit["launches"][key], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
        ))
    print(json.dumps({"kernels": entries}), flush=True)
    print(_card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
