#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, nvcc and no network.
It imports nothing of JAX or of the JAX package. Phases (any failure exits
non-zero and prints no result):

1. Device: the card's name and power limit.
2. Build: compiles the histogram kernels (kernels/csrc/histogram.cu,
   u_histogram.cu, bin_scatter.cu) for sm_90a in one extension; counts the
   atomic opcodes of each in its SASS (kernels/sass_atomics.py) and fails
   on a compare-and-swap loop (ATOMS.CAST.SPIN).
3. Kernel against its plain version on the card at HIGGS width (11,000,000
   rows x 28 features x 256 bins) for 1, 8 and 42 nodes: bit-equal to the
   plain version (both sum g and h in 64-bit fixed point), two launches
   bit-identical, counts bit-equal to a float64 index_add_ and g and h
   within 1e-5 * sum|x| + 1e-6 of it; times of the kernel, the plain
   version and one index_add_ call; the byte bound. Then, at 8 nodes,
   skewed bins (3 distinct values on a third of the features) and
   11,000,003 rows, each bit-equal to the plain version and across two
   launches, and timed; and the kernel's time under each launch plan of
   HIST_PLANS at 1, 8 and 42 nodes and on the skewed bins. Then the
   depthwise levels of 64 and 128 nodes, wider than one launch: the
   node-panel entry runs them as 2 and 4 node-group launches, bit-equal to
   the plain version over all nodes and across two runs, and timed against
   the same byte bound.
4. Fit parity: 1,000,000 rows, 3 iterations, kernel against the plain
   version forced in: identical trees, margins within 1e-4.
5. The default path: LightGBMClassifier.fit on 11,000,000 x 28 rows (maxBin
   255, 31 leaves, leafBatch 8, 10 iterations) on cuda, then transform of
   500,000 held-out rows; the kernel launch counts of this run. Then the
   first 200,000 of its rows fitted on the card and on the CPU port: the
   same model text, byte for byte (the default path's float32 reductions
   are one chain in the same order on both devices).
6. U pass kernel (u_histogram.cu) at 1,000,000 x 28 x 256 (U of 7.2 GB),
   for 1, 8 and 42 nodes, quantized and bf16 stats: bit-equal to its plain
   version, two launches bit-identical; times of the kernel, the plain
   version and one PyTorch product (torch._int_mm, or a bf16 mm); the
   byte bound; and the kernel's time under each budget of U_PLANS.
7. Bin-scatter kernel (bin_scatter.cu) at 11,000,000 x 28 x 256, the same
   cases: driven once through build_histograms_bin_scatter (its launch
   count), then equal to the U pass on the first 1,000,000 rows; on the
   flat (F, N) bins, on the same bins as the chunked U pass's stack of 19
   row chunks (equal to the flat result), on skewed bins (3 values on 9 of
   the 28 features) and on 11,000,003 rows: bit-equal to its plain version
   and across two launches, with times of the kernel, the plain version and
   one packed-space index_add_, and the bound. Then the kernel's time under
   each launch plan of BIN_SCATTER_PLANS.
8. U fit parity: 1,000,000 rows, 3 iterations of train(histogram_method=
   "u"), quantized and bf16: the kernel against its plain version forced
   in gives identical trees and margins; chunked passes (bin-scatter, 4
   chunks) give the resident passes' model text on both paths.
9. The U path: train(histogram_method="u", use_quantized_grad=True) at
   HIGGS width (31 leaves, leaf_batch 8, 10 iterations) on 1,000,000 rows
   (resident U, U pass launches) and on 11,000,000 rows (19 chunks at the
   8 GB budget, bin-scatter launches): binning / U build / boosting
   seconds, peak device bytes, held-out AUC on 500,000 rows.
10. Categorical fit, in the shape of the airline set of szilard/benchm-ml
   (dep_delayed_15min; LightGBM's "Expo" categorical experiment):
   10,000,000 rows, Month, DayofMonth, DayOfWeek, UniqueCarrier, Origin and
   Dest categorical (Zipf-skewed; Origin and Dest overflow the 254 value
   bins), DepTime and Distance numeric. LightGBMClassifier.fit with
   categoricalSlotIndexes on the default path against the same fit on the
   codes as numbers (held-out AUC on 500,000 rows must be higher, predict
   throughput); then the quantized U path on 1,000,000 rows (resident U,
   categorical routing by the membership product) and 10,000,000 (chunked);
   the three kernels on the categorical bins, bit-equal to their plain
   versions.
11. Exclusive Feature Bundling: the same columns one-hot encoded (672 0/1
   columns and the 2 numeric ones) at 1,000,000 rows (cut from 10,000,000:
   the raw float matrix is 5.4 GB of host memory at 1M). The host parts
   timed apart (binning, bundle plan, packing), C and K before and after;
   bundled against unbundled fits on the default path (identical trees) and
   the resident quantized U path (identical model text); the three kernels
   on the packed columns and on widths 2 and 256, bit-equal to their plain
   versions.
12. The U path's out-of-memory ladder on phase 9's 1,000,000-row resident
   fit: FaultPlan.oom_task(0, kind="device") injects a device OOM at
   iteration 0 (through runtime.inject_faults); the fit halves the U budget
   once, takes chunked passes and writes phase 9's model text. Then a real one: a ballast allocation takes the
   card's free memory once U is built (the line says whether it raised).
13. Validation sets, bagging and early stopping at full width:
   LightGBMClassifier.fit on 11,500,000 HIGGS-shaped rows, 500,000 of them
   flagged by validationIndicatorCol, with metric auc, baggingFraction 0.8,
   baggingFreq 5, featureFraction 0.8, a decaying learning-rate schedule
   (a callback), earlyStoppingRound and improvementTolerance set so that
   the fit stops before numIterations: the iterations run, the best
   iteration (below them), the valid AUC history, the held-out AUC on
   500,000 separate rows, the per-iteration seconds of the bag draw, the
   mask upload, boosting, the valid update and the evaluation, peak device
   bytes and the histogram.cu launches. Then the training metric
   (isProvideTrainingMetric) on a 1,000,000-row fit, timed.
14. Warm start: phase 13's model continued for 5 iterations through
   modelString and through initScoreCol holding the raw margins of the
   model that text holds; the two delta boosters' model texts are equal.
15. The quantized path's noise on the card: train.quant_noise (jax's
   threefry2x32 and uniform) against known answers computed with
   jax.random on the CPU (bits at four positions and the sum of all bits
   of each row); the split search's prefix sums (torch.cumsum over the bin
   axis) add in bin order in float32 on the card, as the quantized path's
   parity with the reference needs; one 11,000,000-row draw and one
   1,000,000-row draw timed; then a bagged quantized U
   fit (baggingFraction 0.8, baggingFreq 5, featureFraction 0.8) on
   1,000,000 rows, resident and forced chunked: equal model text.
16. Multiclass at the width of UCI Covertype (XGBoost's
   demo/gpu_acceleration/cover_type.py): 581,012 rows of 54 features (10
   continuous, 4 one-hot wilderness areas, 40 one-hot soil types) and 7
   classes at the data set's priors, generated from a seed. maxBin 255, 31
   leaves, 10 iterations: the default path through LightGBMClassifier; the
   same with 100,000 validation rows (multi_logloss, early stopping); with
   featureBundling (the trees and the model text but its split gains equal
   the unbundled fit's); and the quantized U path (resident or chunked,
   whichever the U budget picks), unbundled and bundled (the same model
   text). Per fit: boosting seconds, trees, passes, launches, held-out
   multi_error (below the majority class's 0.512) and multi_logloss on
   100,000 rows, peak bytes.
17. Boosting types and depthwise growth on phase 5's 11,000,000 bins (no
   second binning), 10 iterations each: goss (top_rate 0.2, other_rate
   0.1), dart (drop_rate 0.1), rf (baggingFraction 0.8, baggingFreq 1),
   depthwise at max_depth 6 and 8 (levels of 64 and 128 nodes in 2 and 4
   node-group launches, checked per level), and goss on the 1,000,000-row
   quantized resident U path: boosting seconds, launches, held-out AUC on
   phase 5's 500,000 test rows (above 0.75), peak bytes.
18. Regression at the shape of YearPredictionMSD (UCI, the standard split):
   463,715 training and 51,630 test rows of 90 audio features, an integer
   year in 1922-2011 skewed toward the 2000s, generated. LightGBMRegressor
   with regression, regression_l1, huber and quantile (alpha 0.9) on the
   default path; quantile on the quantized resident U path (U of 10.7 GB,
   the U budget raised for it); regression with maxBinByFeature capping
   the first 12 columns at 63 bins. Per fit: binning and boosting seconds,
   renewal ms per iteration, peak bytes, launches, the held-out metric
   (below the init-only model's), and for quantile the held-out share of
   targets below the prediction. histogram.cu on each objective's
   iteration-0 stats (and the U pass on the quantized ones) bit for bit its
   plain version; renewal on the card against the CPU port on tree 0's
   partition (unit weights: equal, and equal to the fit's leaves;
   fractional weights: each leaf the CPU port's row or its neighbour).
19. Poisson and tweedie at the shape of freMTPL2freq (OpenML 41214): 678,013
   policies, 10% held out; Area, VehBrand, Region and VehGas categorical,
   VehPower, VehAge, DrivAge, BonusMalus and Density numeric, Exposure the
   weight, about 5% of policies with a claim. poisson on ClaimNb/Exposure,
   tweedie (variance power 1.9) on the pure premium: held-out l2 on the
   response scale below the init-only model's, every prediction positive;
   histogram.cu on each objective's iteration-0 stats.
20. Lambdarank at the shape of MSLR-WEB10K Fold1: 6,000 training and 2,000
   test queries (sizes lognormal, mean about 120, the longest near 1,000),
   136 features, relevance 0-4 at the set's frequencies. The chunked
   lambdarank step at iteration 0 (ms, peak bytes), histogram.cu on its
   stats, then LightGBMRanker with groupCol and LightGBM's
   examples/lambdarank settings: held-out NDCG@1/3/5 (NDCG@5 above the
   all-equal model's).
21. Explain: leafPredictionCol and featuresShapCol on 10,000 held-out rows
   of phase 5's and phase 16's boosters (SHAP adds up to the margin within
   1e-5 and equals the CPU port's within 1e-9 on 1,000 rows; leaves equal
   the CPU port's), and a linear-tree booster (random leaf models on the
   HIGGS trees, 5% NaN inputs) equal to the CPU port; rows/s of each.
22. Sparse input: phase 10's 10,000,000 airline rows one-hot (phase 11's
   674 columns) as a SparseRows features column, built from the codes (the
   dense matrix never exists), through LightGBMClassifier.fit with
   featureBundling: CSR build, mapper, bundle plan, apply-and-pack,
   upload and boosting seconds, peak host RSS and device bytes, held-out
   AUC on 500,000 sparse rows beside phase 10's categorical fit, predict
   rows/s on them and SHAP rows/s on 10,000 CSR rows (SHAP adds up to the
   margin within 1e-5); histogram.cu at k = 1 and 8 on the packed columns
   and the fit's iteration-0 stats, bit-equal to the plain version, timed
   with its bound. Then phase 11's 1,000,000 rows fitted sparse and dense:
   the same model text.
23. Out of core: 44,000,000 HIGGS-width rows (float32) written by
   ShardedDataset.write_shards as 22 .npz shards of 2,000,000 rows with CRC
   sidecars into the git-ignored smoke_data/ (fewer rows when the disk
   lacks room; the line says so; removed when phase 24 ends), then
   fit_gbdt_sharded on the card: write, scan, mapper, streamed binning,
   upload and boosting seconds, host RSS growth over the ingest (below a
   quarter of the float64 matrix), peak device bytes, held-out AUC above
   0.75 on 500,000 rows; histogram.cu on the memmap's bins and iteration-0
   stats as in phase 22. Then a copy of the first 4 shards with shard 1
   truncated: a permissive fit quarantines it to the dead-letter store and
   writes the model text of a fit over the 3 clean shards; a failfast fit
   raises.
24. The partition runtime (mmlspark_tpu_torch.runtime) on phase 5's
   11,000,000 rows: inline against numExecutors=8 binning (seconds of
   each, equal bins); a fit binning under an ambient
   runtime.policy(max_workers=8, result_integrity=True) with
   kill_random_task(8), corrupt_result and a host oom_task, under a
   checkpoint root in smoke_data/ (phase 5's model text, 3 retries, the
   histogram.cu launches of the fit); its durable rerun (no journal line
   added, restore seconds, ModelStore.latest holds the text); numBatches=4
   (held-out AUC on phase 5's 500,000 rows, _ensemble_margin on the card
   within 1e-5 of the merged booster's raw_margin). Then phase 23's shards
   through the scheduler path of bin_to_memmap (8 executors, tasks of
   250,000 rows): the sequential pass's bytes, bin seconds, host RSS growth
   below the same limit; a memory-pressure WARN run on 4 shards halves each
   shard's task; sample_hbm against torch.cuda.memory_allocated() and
   mem_get_info's total.
25. Persistence and the pipeline on phase 5's 11,000,000 rows: 11,000
   rows get a NaN feature and 1,100 others label -1; Pipeline(stages=
   [LightGBMClassifier(phase 5's params, numExecutors=8, so that binning
   opens the reference's lightgbm.binning span)], invalidDataPolicy=
   "drop") fits on the card under MMLSPARK_TPU_EVENT_LOG: 12,100 rows
   dropped, the model text byte for byte a plain fit's on the clean
   complement, histogram.cu 50 + 20 launches, the event log replays with
   the Pipeline's four events, the tracer holds fit:LightGBMClassifier and
   lightgbm.binning; the guard's scan and row filter timed on their own;
   binary g and h on the card are the CPU's bits, and the gradient's time
   against the same function written with torch.sigmoid (medians of 20,
   in turns). Then
   PipelineModel save, load and transform of 500,000 rows (output columns
   bit-equal; save and load seconds, bytes on disk); save_native_model and
   load_native_model, from_model_string (margins within 1e-6 of their
   largest magnitude), the
   booster's JSON dump (margins bit-equal), get_feature_importances (split
   and gain); histogram.cu on the fit's bins and iteration-0 stats.
26. Observability: phase 5's fit on its bins, unprofiled and then under
   the device profiler (observability.profiler, enabled) and
   core.profiling.profile_trace: equal model text, both boosting times,
   histogram.cu's 50 + 20 launches; from key_averages() and the Chrome
   trace the device time by kernel (top 10), histogram.cu's trace time per
   launch against phase 5's CUDA-event time, boosting split into the
   step's regions (gradient, histogram, subtraction, split search, sync,
   routing, tree update, margin update; a kernel belongs to the region open
   on the host when it launched), the device-busy share of the step
   windows and the five longest idle gaps with the host region at each
   (with no device time in the trace: the regions timed by CUDA events and
   the idle share null); host syncs per tree; histogram.cu's two entries
   through DeviceProfiler.wrap with their costs, and the snapshot's
   roofline rows against the card's peaks. Then phase 24's numExecutors=8
   fit with one killed executor under an event log: the timeline's
   dispatched, retried and failed counts equal RuntimeMetrics.summary(),
   the failed attempt's span carries its status, format_timeline printed.
   Then phase 25's Pipeline fit on its first 2,000,000 rows (cut for the
   phase's budget) under MMLSPARK_TPU_QUALITY_STORE and
   MMLSPARK_TPU_INCIDENT_DIR: the reference profile committed and read back
   through its CRC; a transform of phase 5's 500,000 held-out rows drifts
   nowhere, the same rows with feature 0 shifted by one standard deviation
   drift on features[0] (and on no other input) and the incident recorder
   writes its bundle; transform times with the monitor on and off, outputs
   bit-equal. Then ResourceWatchdog.poll(): the profiler's device-memory
   gauges within 1 MiB of torch.cuda.memory_allocated() and
   max_memory_allocated().
27. One JSON line with every kernel (the grouped wide-level launches and
   phases 22, 23, 24 and 25's cases among them), then the card line, then
   the result line. Each phase prints its wall time; TF32 matmuls must be
   off.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import zipfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N_KERNEL = 11_000_000  # HIGGS's row count
N_KERNEL_ODD = 11_000_003  # feature rows of the bins off the 32-bit boundary
N_FEATURES = 28  # HIGGS's width
NUM_BINS = 256
N_PARITY = 1_000_000
N_CPU_TEXT = 200_000  # phase 5's rows fitted on the card and the CPU port: equal text
N_FIT = 11_000_000
N_TEST = 500_000
FIT_ITERS = 10
N_U = 1_000_000  # U pass rows: a 7.2 GB U at 28 x 256
U_BUDGET_4_CHUNKS = 2 * 7168 * 262_144  # 1M rows in 4 chunks of 262,144
PLAN_REPS = 5  # timed launches of each case in the launch-plan sweeps
WIDE_LEVELS = (64, 128)  # depthwise levels 6 and 7: node-grouped histogram.cu launches
# phase 5's estimator params, which phases 23 and 24 share
HIGGS_PARAMS = dict(numIterations=FIT_ITERS, numLeaves=31, maxBin=NUM_BINS - 1, leafBatch=8,
                    learningRate=0.1, device="cuda")



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


def _rates(profiler, name):
    """The card's peaks from the package's table
    (``observability.profiler.device_peaks``: NVIDIA's data sheets)."""
    peaks = profiler.device_peaks(name)
    if not peaks.known:
        raise RuntimeError(f"no memory rate known for card {name!r}")
    return peaks


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
    nodes = {}
    for k, entry in ((1, hh.build_histograms_combined_cuda), (8, hh.build_histograms_cuda),
                     (42, hh.build_histograms_cuda)):
        # keys in [0, k]: key k is out of range and must add nothing
        node = torch.randint(0, k + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
        if k == 1:
            node.zero_()  # the root pass keys every row to node 0
        rec = _hist_record(torch, hh, rates, entry, bins_t, grad, hess, count, node, k, b,
                           f"k={k}", f64_check=True)
        print(f"kernel k={k}: " + json.dumps(rec), flush=True)
        records[k] = rec
        nodes[k] = node

    # Two harder inputs at k = 8: three distinct bins on a third of the
    # features (HIGGS's b-tag columns), and a row count that is not a
    # multiple of 4 (feature rows off the 32-bit boundary).
    skewed = bins_t.clone()
    skewed[: f // 3] = torch.randint(0, 3, (f // 3, n), device=dev, generator=gen,
                                     dtype=torch.int32).to(torch.uint8)
    records["k8_skewed"] = _kernel_case(torch, hh, "k8_skewed", skewed, grad, hess, count,
                                        nodes[8], 8, b)
    records["plans"] = _kernel_plans(torch, hh, bins_t, skewed, grad, hess, count, nodes, b)
    del skewed
    for k in WIDE_LEVELS:
        records[k] = _wide_level_case(torch, hh, rates, bins_t, grad, hess, count, k, b, gen)
    n_odd = N_KERNEL_ODD
    records["k8_odd_n"] = _kernel_case(
        torch, hh, "k8_odd_n",
        torch.randint(0, b, (f, n_odd), device=dev, generator=gen, dtype=torch.int32).to(torch.uint8),
        torch.randn(n_odd, device=dev, generator=gen),
        torch.rand(n_odd, device=dev, generator=gen) * 0.25, torch.ones(n_odd, device=dev),
        torch.randint(0, 9, (n_odd,), device=dev, generator=gen, dtype=torch.int32), 8, b)
    del bins_t, grad, hess, count, nodes
    torch.cuda.empty_cache()
    return records


def _hist_record(torch, hh, rates, entry, bins_t, grad, hess, count, node, k, b, label,
                 f64_check=False):
    """One entry of histogram.cu against its plain version: bit-equal, two
    launches bit-identical (and with ``f64_check`` counts equal to a float64
    sum, g and h within 1e-5 * sum|x| + 1e-6 of it); the times of the kernel
    (20 launches), the plain version and one index_add_ call, and the bound
    of the pass on these inputs."""
    dev = bins_t.device
    f, n = bins_t.shape
    args = (bins_t, grad, hess, count, node)
    out = entry(*args, k, b)
    again = entry(*args, k, b)
    torch.cuda.synchronize()
    plain = hh.build_histograms_plain(*args, k, b)
    max_err = float((out - plain).abs().max())
    if not torch.equal(out, plain):
        raise AssertionError(f"{label}: kernel differs from the plain version "
                             f"(max abs err {max_err})")
    del plain
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: two launches on the same input differ")
    rec = dict(k=k, rows=n, columns=f, num_bins=b)
    if f64_check:
        ref = hh.build_histograms_plain(bins_t, grad.double(), hess.double(), count.double(),
                                        node, k, b)
        absref = hh.build_histograms_plain(bins_t, grad.double().abs(), hess.double(),
                                           count.double(), node, k, b)
        counts_equal = torch.equal(out[..., 2].double(), ref[..., 2])
        err = (out[..., :2].double() - ref[..., :2]).abs()
        within = bool((err <= 1e-5 * absref[..., :2] + 1e-6).all())
        rec["max_abs_err_f64"] = float((out.double() - ref).abs().max())
        del ref, absref, err
        if not (counts_equal and within):
            raise AssertionError(f"{label}: kernel disagrees with the float64 sums (counts "
                                 f"equal {counts_equal}, max abs err {rec['max_abs_err_f64']})")
    del out, again
    ms = _time_ms(torch, lambda: entry(*args, k, b), 20)
    plain_ms = _time_ms(torch, lambda: hh.build_histograms_plain(*args, k, b), 3)
    # library yardstick: the one index_add_ call inside the plain version
    rows = (node < k).nonzero().squeeze(1)
    ids = ((node[rows].long()[None, :] * f + torch.arange(f, device=dev)[:, None]) * b
           + bins_t[:, rows].long()).reshape(-1)
    data = torch.stack([grad[rows], hess[rows], count[rows]], 1).repeat(f, 1)
    acc = torch.zeros(k * f * b, 3, device=dev)
    library_ms = _time_ms(torch, lambda: acc.index_add_(0, ids, data), 3)
    n_in = int(rows.numel())
    del ids, data, acc, rows
    torch.cuda.empty_cache()
    bound_ms, bound_by = rates.bound_ms(hh.bytes_needed(n, f, n_in, k, b), hh.adds_needed(f, n_in))
    rec.update(rows_in_range=n_in, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    return rec


def _wide_level_case(torch, hh, rates, bins_t, grad, hess, count, k, b, gen):
    """A depthwise level wider than one launch (k = 64 and 128 at 256 bins):
    the node-panel entry runs it as len(node_groups) launches of
    histogram.cu, each over all rows with shifted keys. The result must
    equal the plain version over all k nodes bit for bit and repeat bit for
    bit; its time beside the byte bound of the one function (the groups
    reread every row, the bound counts each input once)."""
    dev = bins_t.device
    f, n = bins_t.shape
    node = torch.randint(0, k + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
    args = (bins_t, grad, hess, count, node)
    groups = hh.node_groups(k, b)
    before = hh.build_histograms_cuda.launches
    out = hh.build_histograms_cuda(*args, k, b)
    launched = hh.build_histograms_cuda.launches - before
    again = hh.build_histograms_cuda(*args, k, b)
    torch.cuda.synchronize()
    if launched != len(groups):
        raise AssertionError(f"k={k}: {launched} launches for {len(groups)} node groups")
    plain = hh.build_histograms_plain(*args, k, b)
    max_err = float((out - plain).abs().max())
    if not torch.equal(out, plain):
        raise AssertionError(f"k={k}: grouped launches differ from the plain version "
                             f"(max abs err {max_err})")
    if not torch.equal(out, again):
        raise AssertionError(f"k={k}: two grouped runs on the same input differ")
    del out, again, plain
    ms = _time_ms(torch, lambda: hh.build_histograms_cuda(*args, k, b), 10)
    plain_ms = _time_ms(torch, lambda: hh.build_histograms_plain(*args, k, b), 3)
    rows = (node < k).nonzero().squeeze(1)
    ids = ((node[rows].long()[None, :] * f + torch.arange(f, device=dev)[:, None]) * b
           + bins_t[:, rows].long()).reshape(-1)
    data = torch.stack([grad[rows], hess[rows], count[rows]], 1).repeat(f, 1)
    acc = torch.zeros(k * f * b, 3, device=dev)
    library_ms = _time_ms(torch, lambda: acc.index_add_(0, ids, data), 3)
    n_in = int(rows.numel())
    del ids, data, acc, rows
    bound_ms, bound_by = rates.bound_ms(hh.bytes_needed(n, f, n_in, k, b), hh.adds_needed(f, n_in))
    rec = dict(k=k, groups=[list(g) for g in groups], launches_per_pass=launched,
               rows_in_range=n_in, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    print(f"kernel wide level k={k}: " + json.dumps(rec), flush=True)
    return rec


def _kernel_case(torch, hh, label, bins_t, grad, hess, count, node, k, b):
    """One more input for the node-panel entry: bit-equal to the plain
    version, two launches bit-identical, and its time."""
    args = (bins_t, grad, hess, count, node)
    out = hh.build_histograms_cuda(*args, k, b)
    again = hh.build_histograms_cuda(*args, k, b)
    plain = hh.build_histograms_plain(*args, k, b)
    torch.cuda.synchronize()
    max_err = float((out - plain).abs().max())
    if not torch.equal(out, plain):
        raise AssertionError(f"{label}: kernel differs from the plain version "
                             f"(max abs err {max_err})")
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: two launches on the same input differ")
    del out, again, plain
    rec = dict(case=label, k=k, rows=bins_t.shape[1], max_abs_err=max_err,
               ms=_time_ms(torch, lambda: hh.build_histograms_cuda(*args, k, b), 20))
    print("kernel case: " + json.dumps(rec), flush=True)
    return rec


# Launch plans of histogram.cu tried at HIGGS width: (name, shared-memory
# budget a block, threads a block, threads an SM holds, waves of blocks).
HIST_PLANS = (
    ("half_smem_1024", 112 * 1024, 1024, 1024, 2),
    ("full_smem_1024", 232_448, 1024, 1024, 2),
    ("full_smem_1024_w1", 232_448, 1024, 1024, 1),
    ("full_smem_1024_w4", 232_448, 1024, 1024, 4),
    ("half_smem_512", 112 * 1024, 512, 1024, 2),
)


def _kernel_plans(torch, hh, bins_t, skewed, grad, hess, count, nodes, b):
    """Times of the kernel under each plan of HIST_PLANS at k = 1, 8, 42 and
    on the skewed bins at k = 8; every plan's result must equal the module's
    own plan's bit for bit."""
    names = ("HIST_SMEM_BUDGET", "HIST_THREADS", "HIST_THREADS_PER_SM", "HIST_WAVES")
    saved = tuple(getattr(hh, a) for a in names)
    props = torch.cuda.get_device_properties(0)
    cases = [(f"k{k}", bins_t, k, node) for k, node in nodes.items()]
    cases.append(("k8_skewed", skewed, 8, nodes[8]))
    want = {label: hh.build_histograms_cuda(bt, grad, hess, count, node, k, b)
            for label, bt, k, node in cases}
    results = {}
    try:
        for plan in HIST_PLANS:
            name, values = plan[0], plan[1:]
            for a, v in zip(names, values):
                setattr(hh, a, v)
            times = {}
            for label, bt, k, node in cases:
                args = (bt, grad, hess, count, node)
                got = hh.build_histograms_cuda(*args, k, b)
                if not torch.equal(got, want[label]):
                    raise AssertionError(f"plan {name} {label}: result differs")
                lp = hh.launch_plan(bt.shape[1], bt.shape[0], k, b,
                                    props.multi_processor_count)
                times[label] = dict(
                    ms=_time_ms(torch, lambda: hh.build_histograms_cuda(*args, k, b), PLAN_REPS),
                    fg=lp.fg, groups=lp.groups, row_blocks=lp.row_blocks,
                    smem_bytes=lp.smem_bytes)
            results[name] = times
            print(f"plan {name}: " + json.dumps(times), flush=True)
    finally:
        for a, v in zip(names, saved):
            setattr(hh, a, v)
    return results


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


def phase_fit(torch, hh, histogram, base, Table, LightGBMClassifier, auc, rows):
    """The main path: fit and predict through the estimator on cuda, with
    CUDA events around every histogram launch. Returns the record and the
    fit's rows, bins, mapper and labels with the held-out rows (phase 17
    fits on them without binning again; phase 24 fits the rows again)."""
    X, y = _make_data(rows + N_TEST, N_FEATURES, seed=0)
    train_t = Table({"features": X[:rows], "label": y[:rows]})
    test_t = Table({"features": X[rows:], "label": y[rows:]})
    binned = []
    bin_dataset = base.bin_dataset

    def keep_bins(*a, **kw):
        out = bin_dataset(*a, **kw)
        binned.append(out)
        return out

    base.bin_dataset = keep_bins
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
    est = LightGBMClassifier(**HIGGS_PARAMS)
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
        base.bin_dataset = bin_dataset
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
    # the default path is device-independent: the card's text on N_CPU_TEXT
    # of these rows is the CPU port's byte for byte
    small = Table({"features": X[:N_CPU_TEXT], "label": y[:N_CPU_TEXT]})
    t1 = time.perf_counter()
    card_text = LightGBMClassifier(**HIGGS_PARAMS).fit(small).get_model_string()
    t2 = time.perf_counter()
    cpu_text = LightGBMClassifier(**dict(HIGGS_PARAMS, device="cpu")).fit(small).get_model_string()
    t3 = time.perf_counter()
    if card_text != cpu_text:
        raise AssertionError(f"fit: the card's model text on {N_CPU_TEXT} rows differs from "
                             "the CPU port's")
    rec["cpu_text"] = dict(rows=N_CPU_TEXT, text_equal=True, card_fit_s=t2 - t1,
                           cpu_fit_s=t3 - t2)
    print("fit card against CPU: " + json.dumps(rec["cpu_text"]), flush=True)
    bins, mapper = binned[0]
    return rec, dict(bins=bins, mapper=mapper, X=X[:rows], y=y[:rows], X_test=X[rows:],
                     y_test=y[rows:], booster=model.booster)


def _packed_cases(torch, uh, g, h, c, gen):
    """(name, stats, scale) of the two stat paths: quantized and bf16."""
    n = g.shape[0]
    qstats, _ = uh.stat_rows_quant(g, h, c, torch.rand((2, n), device=g.device, generator=gen))
    bstats = uh.stat_rows(g, h, c)
    return (("quant", qstats, None), ("bf16", bstats, uh.stat_scales(bstats)))


def phase_packed_kernels(torch, uh, hh, rates):
    """The two packed-space kernels against their plain versions: the U pass
    on 1,000,000 rows, bin-scatter on 11,000,000 (and on the 1,000,000-row
    prefix against the U pass). Returns per-(kernel, k, path) records and
    the launches of build_histograms_bin_scatter's own run."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    n, f, b = N_KERNEL, N_FEATURES, NUM_BINS
    spec = uh.make_u_spec(b, f)
    bins_t = torch.randint(0, b, (f, n), device=dev, generator=gen, dtype=torch.int32).to(torch.uint8)
    g = torch.randn(n, device=dev, generator=gen)
    h = torch.rand(n, device=dev, generator=gen) * 0.25
    c = torch.ones(n, device=dev)
    cases = _packed_cases(torch, uh, g, h, c, gen)
    nodes = {}
    for k in (1, 8, 42):
        # keys in [0, k]: key k is out of range and must add nothing
        nodes[k] = torch.randint(0, k + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
        if k == 1:
            nodes[k].zero_()

    # build_histograms_bin_scatter, the ops-level entry point, driven once
    # per case with its launch count set to 0 just before.
    hh.bin_scatter.launches = 0
    for k in nodes:
        for _, stats, scale in cases:
            q = stats if scale is not None else (stats, torch.ones(3, device=dev))
            hh.build_histograms_bin_scatter(bins_t, g, h, c, nodes[k], k, spec, stats=q)
    torch.cuda.synchronize()
    entry_launches = hh.bin_scatter.launches

    # Harder inputs for bin-scatter: the chunked U pass's stack of row chunks
    # (19 of 599,040 rows at the 8 GB budget), three distinct bins on 9 of
    # the 28 features (HIGGS's b-tag columns), and 11,000,003 rows (feature
    # and stat rows off their vector boundary).
    chunked = uh.chunked_u_spec(n, spec, uh.DEFAULT_U_BUDGET)
    stack = uh.prepare_chunked_bins(bins_t, chunked)
    skewed = bins_t.clone()
    skewed[: f // 3] = torch.randint(0, 3, (f // 3, n), device=dev, generator=gen,
                                     dtype=torch.int32).to(torch.uint8)
    n_odd = N_KERNEL_ODD
    odd_bins = torch.randint(0, b, (f, n_odd), device=dev, generator=gen,
                             dtype=torch.int32).to(torch.uint8)
    odd_cases = {path: (stats, scale) for path, stats, scale in _packed_cases(
        torch, uh, torch.randn(n_odd, device=dev, generator=gen),
        torch.rand(n_odd, device=dev, generator=gen) * 0.25, torch.ones(n_odd, device=dev),
        gen)}
    odd_nodes = {k: torch.randint(0, k + 1, (n_odd,), device=dev, generator=gen,
                                  dtype=torch.int32) for k in nodes}
    odd_nodes[1].zero_()

    records = {}
    u = uh.build_u(bins_t[:, :N_U].contiguous(), spec)
    n_pad = u.shape[1]
    u_bf16 = None
    for k, node in nodes.items():
        node_u = node[:N_U].contiguous()
        for path, stats, scale in cases:
            quant = scale is None
            stats_u = stats[:, :N_U].contiguous()
            args = (u, stats_u, node_u, k, scale)
            out = uh.fused_panel_dot(*args)
            again = uh.fused_panel_dot(*args)
            plain = uh.fused_panel_dot_plain(*args)
            torch.cuda.synchronize()
            max_err = float((out - plain).abs().max())
            if not torch.equal(out, plain):
                raise AssertionError(f"U pass k={k} {path}: kernel differs from the plain "
                                     f"version (max abs err {max_err})")
            if not torch.equal(out, again):
                raise AssertionError(f"U pass k={k} {path}: two launches differ")
            del plain, again
            ms = _time_ms(torch, lambda: uh.fused_panel_dot(*args), 20)
            plain_ms = _time_ms(torch, lambda: uh.fused_panel_dot_plain(*args), 3)
            # library yardstick: the same product as one PyTorch call
            width = max(8, -(-3 * k // 8) * 8)
            panel_t = torch.zeros((width, n_pad), device=dev,
                                  dtype=torch.int8 if quant else torch.bfloat16)
            panel_t[:3 * k] = uh._stat_panel_t(stats_u, node_u, k, n_pad)
            panel = panel_t.t()  # (n_pad, width), column-major
            if quant:
                u8 = u.view(torch.int8)
                library_ms = _time_ms(torch, lambda: torch._int_mm(u8, panel), 5)
            else:
                if u_bf16 is None:
                    u_bf16 = u.to(torch.bfloat16)
                library_ms = _time_ms(torch, lambda: torch.mm(u_bf16, panel), 5)
            del panel, panel_t
            n_in = int((node_u < k).sum())
            bound_ms, bound_by = rates.bound_ms(
                uh.panel_dot_bytes(spec.k_pad, n_pad, N_U, k, quant),
                hh.adds_needed(f, n_in))
            rec = dict(kernel="u_panel_dot", k=k, path=path, rows=N_U, rows_in_range=n_in,
                       max_abs_err=max_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            print("u pass: " + json.dumps(rec), flush=True)
            records[("u_panel_dot", k, path)] = rec

            # bin-scatter: the same function from the bins, on the prefix first
            prefix = hh.bin_scatter(bins_t[:, :N_U].contiguous(), stats_u, node_u, k, spec, scale)
            if not torch.equal(prefix, out):
                raise AssertionError(f"bin scatter k={k} {path}: differs from the U pass on "
                                     f"the first {N_U} rows")
            del out, prefix
            flat = _scatter_case(torch, hh, rates, "bin_scatter", bins_t, bins_t, stats, node,
                                 k, spec, scale)
            records[("bin_scatter", k, path)] = flat
            # the chunked U pass's entry: the same bins as a stack of row
            # chunks, one launch over all of them
            stacked = _scatter_case(torch, hh, rates, "bin_scatter_stack", stack, bins_t, stats,
                                    node, k, chunked, scale, want=flat["out"])
            records[("bin_scatter_stack", k, path)] = stacked
            records[("bin_scatter_skewed", k, path)] = _scatter_case(
                torch, hh, rates, "bin_scatter_skewed", skewed, skewed, stats, node, k, spec,
                scale)
            odd_stats, odd_scale = odd_cases[path]
            records[("bin_scatter_odd_n", k, path)] = _scatter_case(
                torch, hh, rates, "bin_scatter_odd_n", odd_bins, odd_bins, odd_stats,
                odd_nodes[k], k, spec, odd_scale)
            for label in ("bin_scatter", "bin_scatter_stack", "bin_scatter_skewed",
                          "bin_scatter_odd_n"):
                records[(label, k, path)].pop("out", None)
    records["u_plans"] = _u_plans(torch, uh, u, cases, nodes)
    records["bin_scatter_plans"] = _scatter_plans(torch, hh, bins_t, skewed, cases, nodes, spec)
    del u, u_bf16, bins_t, stack, skewed, odd_bins, g, h, c, cases, nodes, odd_nodes, odd_cases
    torch.cuda.empty_cache()
    return records, entry_launches


def _scatter_case(torch, hh, rates, label, bins, flat_bins, stats, node, k, spec, scale,
                  want=None):
    """One bin-scatter input: bit-equal to the plain version (and to
    ``want``, the flat entry's result, when given), two launches
    bit-identical; the times of the kernel, the plain version and one
    packed-space float32 index_add_ on the flat bins; the bound."""
    dev = bins.device
    quant = scale is None
    args = (bins, stats, node, k, spec, scale)
    out = hh.bin_scatter(*args)
    again = hh.bin_scatter(*args)
    plain = hh.bin_scatter_plain(*args)
    torch.cuda.synchronize()
    max_err = float((out - plain).abs().max())
    path = "quant" if quant else "bf16"
    if not torch.equal(out, plain):
        raise AssertionError(f"{label} k={k} {path}: kernel differs from the plain version "
                             f"(max abs err {max_err})")
    if not torch.equal(out, again):
        raise AssertionError(f"{label} k={k} {path}: two launches differ")
    if want is not None and not torch.equal(out, want):
        raise AssertionError(f"{label} k={k} {path}: differs from the flat (F, N) entry")
    del again, plain
    ms = _time_ms(torch, lambda: hh.bin_scatter(*args), 20)
    plain_ms = _time_ms(torch, lambda: hh.bin_scatter_plain(*args), 3)
    f, n = flat_bins.shape
    rows = ((node >= 0) & (node < k)).nonzero().squeeze(1)
    ids = ((flat_bins[:, rows].long() + torch.arange(f, device=dev)[:, None] * NUM_BINS) * k
           + node[rows].long()[None, :]).reshape(-1)
    data = stats[:, rows].float().t().repeat(f, 1)
    acc = torch.zeros(f * NUM_BINS * k, 3, device=dev)
    library_ms = _time_ms(torch, lambda: acc.index_add_(0, ids, data), 3)
    n_in = int(rows.numel())
    del ids, data, acc, rows
    bound_ms, bound_by = rates.bound_ms(hh.bin_scatter_bytes(n, f, n_in, spec.k_pad, k, quant),
                                        hh.adds_needed(f, n_in))
    rec = dict(kernel=label, k=k, path=path, rows=n, rows_in_range=n_in, max_abs_err=max_err,
               ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    print("bin scatter: " + json.dumps(rec), flush=True)
    rec["out"] = out
    return rec


# Shared-memory budgets of u_histogram.cu tried on 1,000,000 rows: (name,
# budget a block on int8 stats, on bf16 stats).
U_PLANS = (
    ("112KB", 112 * 1024, 112 * 1024),
    ("quant_112KB_bf16_227KB", 112 * 1024, 232_448),
    ("227KB", 232_448, 232_448),
)


def _u_plans(torch, uh, u, cases, nodes):
    """Times of the U pass under each budget of U_PLANS at k = 1, 8, 42,
    quantized and bf16; every plan's result must equal the module's own
    plan's bit for bit."""
    names = ("SMEM_BUDGET", "SMEM_BUDGET_BF16")
    saved = tuple(getattr(uh, a) for a in names)
    runs = [(f"k{k}_{path}", k, stats[:, :N_U].contiguous(), scale, nodes[k][:N_U].contiguous())
            for k in nodes for path, stats, scale in cases]
    want = {label: uh.fused_panel_dot(u, stats, node, k, scale)
            for label, k, stats, scale, node in runs}
    results = {}
    try:
        for name, *values in U_PLANS:
            for a, v in zip(names, values):
                setattr(uh, a, v)
            times = {}
            for label, k, stats, scale, node in runs:
                args = (u, stats, node, k, scale)
                if not torch.equal(uh.fused_panel_dot(*args), want[label]):
                    raise AssertionError(f"U pass plan {name} {label}: result differs")
                plan = uh.panel_dot_plan(*u.shape, k, scale is None,
                                         torch.cuda.get_device_properties(0).multi_processor_count)
                times[label] = dict(ms=_time_ms(torch, lambda: uh.fused_panel_dot(*args), PLAN_REPS),
                                    chunks=plan.grid_x, smem_bytes=plan.smem_bytes)
            results[name] = times
            print(f"u pass plan {name}: " + json.dumps(times), flush=True)
    finally:
        for a, v in zip(names, saved):
            setattr(uh, a, v)
    return results


# Launch plans of bin_scatter.cu tried at HIGGS width: (name, shared-memory
# budget a block, threads a block, threads an SM holds, waves of blocks).
BIN_SCATTER_PLANS = (
    ("half_smem_1024", 112 * 1024, 1024, 1024, 2),
    ("full_smem_1024", 232_448, 1024, 1024, 2),
    ("full_smem_1024_w1", 232_448, 1024, 1024, 1),
    ("full_smem_1024_w4", 232_448, 1024, 1024, 4),
    ("full_smem_1024_w8", 232_448, 1024, 1024, 8),
    ("half_smem_512", 112 * 1024, 512, 1024, 2),
)


def _scatter_plans(torch, hh, bins_t, skewed, cases, nodes, spec):
    """Times of bin_scatter under each plan of BIN_SCATTER_PLANS at k = 1,
    8, 42, quantized and bf16, and on the skewed bins at k = 8; every plan's
    result must equal the module's own plan's bit for bit."""
    names = ("BIN_SCATTER_SMEM_BUDGET", "BIN_SCATTER_THREADS", "BIN_SCATTER_THREADS_PER_SM",
             "BIN_SCATTER_WAVES")
    saved = tuple(getattr(hh, a) for a in names)
    props = torch.cuda.get_device_properties(0)
    runs = [(f"k{k}_{path}", bins_t, k, stats, scale)
            for k in nodes for path, stats, scale in cases]
    runs += [(f"k8_skewed_{path}", skewed, 8, stats, scale) for path, stats, scale in cases]
    want = {label: hh.bin_scatter(bt, stats, nodes[k], k, spec, scale)
            for label, bt, k, stats, scale in runs}
    results = {}
    try:
        for plan in BIN_SCATTER_PLANS:
            name, values = plan[0], plan[1:]
            for a, v in zip(names, values):
                setattr(hh, a, v)
            times = {}
            for label, bt, k, stats, scale in runs:
                args = (bt, stats, nodes[k], k, spec, scale)
                if not torch.equal(hh.bin_scatter(*args), want[label]):
                    raise AssertionError(f"bin scatter plan {name} {label}: result differs")
                bp = hh.bin_scatter_plan(bt.shape[1], spec, k, scale is None,
                                         props.multi_processor_count)
                times[label] = dict(ms=_time_ms(torch, lambda: hh.bin_scatter(*args), PLAN_REPS),
                                    chunks=bp.grid_x, row_blocks=bp.grid_y,
                                    smem_bytes=bp.smem_bytes)
            results[name] = times
            print(f"bin scatter plan {name}: " + json.dumps(times), flush=True)
    finally:
        for a, v in zip(names, saved):
            setattr(hh, a, v)
    return results


def phase_u_parity(torch, uh, hh, binning, train):
    """3 iterations of the U path with the kernel and with its plain version
    forced in, quantized and bf16; chunked passes (bin-scatter) against
    resident ones (the U pass), both paths."""
    X, y = _make_data(N_PARITY, N_FEATURES, seed=2)
    bins, mapper = binning.bin_dataset(X, max_bin=NUM_BINS - 1)
    Xs = X[:100_000]
    for quant in (True, False):
        opts = train.TrainOptions(objective="binary", num_iterations=3, num_leaves=31,
                                  learning_rate=0.1, max_bin=NUM_BINS - 1, leaf_batch=8,
                                  histogram_method="u", use_quantized_grad=quant)
        kern = train.train(bins, y, opts, mapper=mapper, device="cuda")
        saved = uh.fused_panel_dot
        uh.fused_panel_dot = uh.fused_panel_dot_plain
        try:
            plain = train.train(bins, y, opts, mapper=mapper, device="cuda")
        finally:
            uh.fused_panel_dot = saved
        if kern.stats.histogram_path != "u" or kern.stats.quantized != quant:
            raise AssertionError(f"U parity ran {kern.stats}")
        kb, pb = kern.booster, plain.booster
        for field in ("split_feature", "split_bin", "left_child", "right_child", "is_leaf"):
            if not np.array_equal(getattr(kb, field), getattr(pb, field)):
                raise AssertionError(f"U fit parity ({'quant' if quant else 'bf16'}): {field} "
                                     f"differs")
        dm = float(np.abs(kb.raw_margin(Xs, device="cuda") - pb.raw_margin(Xs, device="cuda")).max())
        if dm != 0.0:
            raise AssertionError(f"U fit parity: margins differ by {dm}")
        path = "quant" if quant else "bf16"
        os.environ["MMLSPARK_TPU_U_BUDGET"] = str(U_BUDGET_4_CHUNKS)
        uh.fused_panel_dot.launches = hh.bin_scatter.launches = 0
        try:
            chunked = train.train(bins, y, opts, mapper=mapper, device="cuda")
        finally:
            del os.environ["MMLSPARK_TPU_U_BUDGET"]
        if (chunked.stats.histogram_path != "u_chunked" or hh.bin_scatter.launches == 0
                or uh.fused_panel_dot.launches != 0):
            raise AssertionError(f"chunked parity ran {chunked.stats} with "
                                 f"{hh.bin_scatter.launches} bin-scatter and "
                                 f"{uh.fused_panel_dot.launches} U pass launches")
        if chunked.booster.model_to_string() != kb.model_to_string():
            raise AssertionError(f"chunked {path} model text differs from resident")
        print(f"u fit parity: {N_PARITY} rows, 3 iterations, {path}: identical trees, max "
              f"margin delta {dm}; {chunked.stats.u_chunks} chunks "
              f"({hh.bin_scatter.launches} bin-scatter launches): identical model text",
              flush=True)


def phase_u_fit(torch, uh, hh, binning, train, auc, rows):
    """The U path at HIGGS width: binning, then train() with quantized
    gradients; the launches of the U pass (resident U) and of bin-scatter
    (chunked passes) in this run."""
    X, y = _make_data(rows + N_TEST, N_FEATURES, seed=3)
    t0 = time.perf_counter()
    bins, mapper = binning.bin_dataset(X[:rows], max_bin=NUM_BINS - 1)
    binning_s = time.perf_counter() - t0
    opts = train.TrainOptions(objective="binary", num_iterations=FIT_ITERS, num_leaves=31,
                              learning_rate=0.1, max_bin=NUM_BINS - 1, leaf_batch=8,
                              histogram_method="u", use_quantized_grad=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    uh.fused_panel_dot.launches = hh.bin_scatter.launches = 0
    t1 = time.perf_counter()
    result = train.train(bins, y[:rows], opts, mapper=mapper, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    u_launches, scatter_launches = uh.fused_panel_dot.launches, hh.bin_scatter.launches
    peak = torch.cuda.max_memory_allocated()
    st = result.stats
    # the resident pass runs the U pass kernel; chunked passes run bin-scatter
    launches = scatter_launches if st.histogram_path == "u_chunked" else u_launches
    if launches == 0 or u_launches + scatter_launches != launches or not st.quantized:
        raise AssertionError(f"the U path did not run its quantized passes: {st}, "
                             f"{u_launches} U pass and {scatter_launches} bin-scatter launches")
    margin = result.booster.raw_margin(X[rows:], device="cuda")
    if margin.shape != (N_TEST, 1) or not np.isfinite(margin).all():
        raise AssertionError(f"bad margins {margin.shape}")
    test_auc = auc(y[rows:], margin[:, 0], np.ones(N_TEST))
    if not test_auc > 0.75:
        raise AssertionError(f"U path held-out AUC {test_auc} is too low for this data")
    text = result.booster.model_to_string()
    rec = dict(rows=rows, features=N_FEATURES, iterations=FIT_ITERS,
               histogram_path=st.histogram_path, u_chunks=st.u_chunks,
               fit_s=binning_s + train_s, binning_s=binning_s, u_build_s=st.u_build_seconds,
               boosting_s=st.boost_seconds, trees=st.trees, passes=st.passes,
               u_pass_launches=u_launches, bin_scatter_launches=scatter_launches,
               launches_per_tree=launches / st.trees,
               host_syncs_per_tree=st.syncs / st.trees, peak_device_bytes=peak,
               held_out_auc=test_auc)
    print("u fit: " + json.dumps(rec), flush=True)
    return rec, text


# -- categorical features, bundling and the out-of-memory ladder --------------

N_AIR = 10_000_000  # the airline set's 10M-row training set
N_AIR_U = 1_000_000  # resident U on the airline columns
N_EFB = 1_000_000  # one-hot airline rows: the raw float matrix is 5.4 GB of host memory
AIR_CATEGORICAL = (("Month", 12), ("DayofMonth", 31), ("DayOfWeek", 7), ("UniqueCarrier", 22),
                   ("Origin", 300), ("Dest", 300))
AIR_CATS = list(range(len(AIR_CATEGORICAL)))


def _airline_data(n, seed):
    """Rows in the shape of szilard/benchm-ml's airline set
    (dep_delayed_15min; LightGBM's docs/Experiments.rst "Expo" categorical
    run): six categorical columns with Zipf-skewed frequencies (Origin and
    Dest have more values than maxBin 255's 254 value bins, so their rarest
    ones share bin 0), then DepTime and Distance. The label carries a random
    effect per category, so a category's code says nothing by its order."""
    rng = np.random.default_rng(seed)
    X = np.empty((n, len(AIR_CATEGORICAL) + 2), np.float64)
    logit = np.full(n, -1.2)
    for j, (_, card) in enumerate(AIR_CATEGORICAL):
        p = 1.0 / np.arange(1, card + 1) ** 1.1
        ids = rng.choice(card, size=n, p=p / p.sum())
        logit += rng.normal(0.0, 0.45, card)[ids]
        X[:, j] = rng.permutation(card)[ids] + 1  # codes unrelated to frequency
    dep = rng.integers(0, 24, n) * 100 + rng.integers(0, 60, n)
    dist = np.exp(rng.normal(6.5, 0.6, n)).round()
    logit += 1.2 * (dep / 2400.0) + 0.15 * (np.log(dist) - 6.5)
    X[:, -2], X[:, -1] = dep, dist
    y = (logit + rng.logistic(size=n) > 0).astype(np.float64)
    return X, y


def _one_hot_airline(X):
    """The airline rows with each categorical column one-hot encoded (672
    0/1 columns), then DepTime and Distance: a column-major float64 matrix."""
    n = X.shape[0]
    width = sum(c for _, c in AIR_CATEGORICAL) + 2
    out = np.zeros((n, width), np.float64, order="F")
    off, rows = 0, np.arange(n)
    for j, (_, card) in enumerate(AIR_CATEGORICAL):
        out[rows, off + X[:, j].astype(np.int64) - 1] = 1.0
        off += card
    out[:, off:] = X[:, -2:]
    return out


def _zero_counts(uh, hh):
    hh.build_histograms_cuda.launches = 0
    hh.build_histograms_combined_cuda.launches = 0
    uh.fused_panel_dot.launches = 0
    hh.bin_scatter.launches = 0


def _counts(uh, hh):
    return {"hist_panel": hh.build_histograms_cuda.launches,
            "hist_combined": hh.build_histograms_combined_cuda.launches,
            "u_panel_dot": uh.fused_panel_dot.launches,
            "bin_scatter": hh.bin_scatter.launches}


def _need(counts, names, label):
    """Fail unless each named kernel launched in the run just read."""
    missing = [k for k in names if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: {missing} not launched ({counts})")


def _kernels_on_bins(torch, uh, hh, label, bins_t, spec, num_bins, k=8, seed=0):
    """The three histogram kernels on one fit's bins (categorical value
    bins or packed bundle columns) at k nodes, quantized and bf16 stats:
    each bit-equal to its plain version; the times of the kernels."""
    dev = bins_t.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = bins_t.shape[1]
    g = torch.randn(n, device=dev, generator=gen)
    h = torch.rand(n, device=dev, generator=gen) * 0.25
    c = torch.ones(n, device=dev)
    node = torch.randint(0, k + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
    rec = dict(case=label, rows=n, columns=bins_t.shape[0], k=k, widths_min=min(spec.widths),
               widths_max=max(spec.widths), k_pad=spec.k_pad)
    out = hh.build_histograms_cuda(bins_t, g, h, c, node, k, num_bins)
    if not torch.equal(out, hh.build_histograms_plain(bins_t, g, h, c, node, k, num_bins)):
        raise AssertionError(f"{label}: histogram.cu differs from its plain version")
    rec["hist_ms"] = _time_ms(torch, lambda: hh.build_histograms_cuda(
        bins_t, g, h, c, node, k, num_bins), 5)
    del out
    u = uh.build_u(bins_t, spec) if uh.u_bytes(n, spec) <= (12 << 30) else None
    for path, stats, scale in _packed_cases(torch, uh, g, h, c, gen):
        if u is not None:
            got = uh.fused_panel_dot(u, stats, node, k, scale)
            if not torch.equal(got, uh.fused_panel_dot_plain(u, stats, node, k, scale)):
                raise AssertionError(f"{label} {path}: u_histogram.cu differs from its plain "
                                     f"version")
            rec[f"u_pass_{path}_ms"] = _time_ms(
                torch, lambda: uh.fused_panel_dot(u, stats, node, k, scale), 5)
        scat = hh.bin_scatter(bins_t, stats, node, k, spec, scale)
        if not torch.equal(scat, hh.bin_scatter_plain(bins_t, stats, node, k, spec, scale)):
            raise AssertionError(f"{label} {path}: bin_scatter.cu differs from its plain version")
        if u is not None and not torch.equal(scat, got):
            raise AssertionError(f"{label} {path}: bin_scatter.cu differs from the U pass")
        rec[f"bin_scatter_{path}_ms"] = _time_ms(
            torch, lambda: hh.bin_scatter(bins_t, stats, node, k, spec, scale), 5)
    del u
    torch.cuda.empty_cache()
    print("kernels on bins: " + json.dumps(rec), flush=True)
    return rec


def phase_categorical(torch, uh, hh, binning, train, Table, LightGBMClassifier, auc):
    """The airline set's categorical fit: the estimator on the default path
    against the same fit with the six columns read as numeric codes; then
    train(histogram_method="u", use_quantized_grad=True) on 1,000,000 rows
    (resident U, the membership product) and on 10,000,000 (chunked); the
    kernels on the categorical bins."""
    X, y = _airline_data(N_AIR + N_TEST, seed=7)
    Xtr, ytr, Xte, yte = X[:N_AIR], y[:N_AIR], X[N_AIR:], y[N_AIR:]
    params = dict(numIterations=FIT_ITERS, numLeaves=31, maxBin=NUM_BINS - 1, leafBatch=8,
                  learningRate=0.1, device="cuda")
    recs = {}
    for name, extra in (("categorical", dict(categoricalSlotIndexes=AIR_CATS)),
                        ("numeric_codes", {})):
        est = LightGBMClassifier(**params, **extra)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(uh, hh)
        t0 = time.perf_counter()
        model = est.fit(Table({"features": Xtr, "label": ytr}))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = _counts(uh, hh)
        _need(counts, ("hist_panel", "hist_combined"), f"airline {name} fit")
        peak = torch.cuda.max_memory_allocated()
        t1 = time.perf_counter()
        prob = model.transform(Table({"features": Xte}))["probability"]
        predict_s = time.perf_counter() - t1
        if prob.shape != (N_TEST, 2) or not np.isfinite(prob).all():
            raise AssertionError(f"airline {name}: bad probability column {prob.shape}")
        st = model.fit_stats
        booster = model.booster
        recs[name] = dict(
            rows=N_AIR, fit_s=fit_s, binning_s=st.binning_seconds, boosting_s=st.boost_seconds,
            trees=st.trees, passes=st.passes, host_syncs_per_tree=st.syncs / st.trees,
            predict_s=predict_s, predict_rows_per_s=N_TEST / predict_s,
            held_out_auc=auc(yte, prob[:, 1], np.ones(N_TEST)), peak_device_bytes=peak,
            categorical_splits=int(booster.cat_nodes.sum()) if booster.has_categorical else 0,
            launches=counts)
        print(f"airline fit {name}: " + json.dumps(recs[name]), flush=True)
    if not recs["categorical"]["categorical_splits"]:
        raise AssertionError("the categorical fit made no categorical split")
    if not recs["categorical"]["held_out_auc"] > recs["numeric_codes"]["held_out_auc"]:
        raise AssertionError(f"categorical AUC {recs['categorical']['held_out_auc']} is not above "
                             f"the numeric codes' {recs['numeric_codes']['held_out_auc']}")

    opts = train.TrainOptions(objective="binary", num_iterations=FIT_ITERS, num_leaves=31,
                              learning_rate=0.1, max_bin=NUM_BINS - 1, leaf_batch=8,
                              histogram_method="u", use_quantized_grad=True)
    for rows, path, kernel in ((N_AIR_U, "u", "u_panel_dot"),
                               (N_AIR, "u_chunked", "bin_scatter")):
        t0 = time.perf_counter()
        bins, mapper = binning.bin_dataset(Xtr[:rows], max_bin=NUM_BINS - 1,
                                           categorical_features=AIR_CATS)
        binning_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(uh, hh)
        t1 = time.perf_counter()
        res = train.train(bins, ytr[:rows], opts, mapper=mapper, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        counts = _counts(uh, hh)
        _need(counts, (kernel,), f"airline U fit {rows}")
        st = res.stats
        if st.histogram_path != path or not st.quantized:
            raise AssertionError(f"airline U fit {rows} ran {st}")
        margin = res.booster.raw_margin(Xte, device="cuda")
        if margin.shape != (N_TEST, 1) or not np.isfinite(margin).all():
            raise AssertionError(f"airline U fit {rows}: bad margins {margin.shape}")
        rec = dict(rows=rows, histogram_path=st.histogram_path, u_chunks=st.u_chunks,
                   binning_s=binning_s, u_build_s=st.u_build_seconds, boosting_s=st.boost_seconds,
                   train_s=train_s, passes=st.passes, host_syncs_per_tree=st.syncs / st.trees,
                   peak_device_bytes=torch.cuda.max_memory_allocated(),
                   held_out_auc=auc(yte, margin[:, 0], np.ones(N_TEST)),
                   categorical_splits=int(res.booster.cat_nodes.sum()), launches=counts)
        print(f"airline u fit {rows}: " + json.dumps(rec), flush=True)
        recs[f"u_{rows}"] = rec
        if rows == N_AIR_U:
            spec = uh.make_u_spec(NUM_BINS, bins.shape[1], mapper.num_bins)
            bins_t = torch.as_tensor(bins, device="cuda").t().contiguous()
            recs["kernels"] = _kernels_on_bins(torch, uh, hh, "airline categorical bins",
                                               bins_t, spec, NUM_BINS)
            del bins_t
        del bins
    torch.cuda.empty_cache()
    return recs


def phase_bundling(torch, uh, hh, binning, bundling, train, auc):
    """Exclusive Feature Bundling on the one-hot airline columns (672 0/1
    columns and 2 numeric) at 1,000,000 rows: the host parts timed apart,
    then the unbundled and the bundled fit on the default path (the same
    trees: no conflicts) and on the resident quantized U path (the same
    model text); the kernels on the packed columns, and on packed widths at
    both of the kernels' limits (256-wide bundles, width-2 columns)."""
    Xa, y = _airline_data(N_EFB + N_TEST, seed=8)
    t0 = time.perf_counter()
    X = _one_hot_airline(Xa[:N_EFB])
    Xte = _one_hot_airline(Xa[N_EFB:])
    yte = y[N_EFB:]
    y = y[:N_EFB]
    onehot_s = time.perf_counter() - t0
    del Xa
    t0 = time.perf_counter()
    mapper = binning.fit_bin_mapper(X, max_bin=NUM_BINS - 1)
    fit_mapper_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = binning.apply_bins(X, mapper)
    apply_s = time.perf_counter() - t0
    mapper_b = binning.BinMapper(edges=mapper.edges, num_bins=mapper.num_bins,
                                 max_bin=mapper.max_bin)
    t0 = time.perf_counter()
    spec = binning.fit_bundles_inplace(mapper_b, raw)
    bundle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = bundling.pack_bundles(raw, spec)
    pack_s = time.perf_counter() - t0
    k_before = int(sum(int(w) for w in mapper.num_bins))
    plan = dict(rows=N_EFB, features=X.shape[1], columns=spec.num_columns, k_before=k_before,
                k_after=spec.k_packed, conflicts=spec.conflict_count,
                widths=sorted(spec.widths), onehot_s=onehot_s, fit_mapper_s=fit_mapper_s,
                apply_bins_s=apply_s, fit_bundles_s=bundle_s, pack_s=pack_s)
    print("efb plan: " + json.dumps(plan), flush=True)
    if spec.conflict_count != 0 or spec.num_columns >= X.shape[1]:
        raise AssertionError(f"one-hot columns did not bundle without conflicts: {plan}")
    del X

    recs = {"plan": plan}
    for path, kw in (("compare", {}), ("u", dict(histogram_method="u", use_quantized_grad=True))):
        opts = train.TrainOptions(objective="binary", num_iterations=FIT_ITERS, num_leaves=31,
                                  learning_rate=0.1, max_bin=NUM_BINS - 1, leaf_batch=8, **kw)
        boosters = {}
        for name, bins, m in (("unbundled", raw, mapper), ("bundled", packed, mapper_b)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts(uh, hh)
            t0 = time.perf_counter()
            res = train.train(bins, y, opts, mapper=m, device="cuda")
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = _counts(uh, hh)
            _need(counts, ("u_panel_dot",) if path == "u" else ("hist_panel", "hist_combined"),
                  f"efb {path} {name}")
            st = res.stats
            if st.histogram_path != path:
                raise AssertionError(f"efb {path} {name} ran {st}")
            margin = res.booster.raw_margin(Xte, device="cuda")
            rec = dict(path=path, bins=name, columns=bins.shape[1], train_s=train_s,
                       u_build_s=st.u_build_seconds, boosting_s=st.boost_seconds,
                       passes=st.passes, peak_device_bytes=torch.cuda.max_memory_allocated(),
                       held_out_auc=auc(yte, margin[:, 0], np.ones(N_TEST)), launches=counts)
            print("efb fit: " + json.dumps(rec), flush=True)
            recs[(path, name)] = rec
            boosters[name] = res.booster
        ub, bb = boosters["unbundled"], boosters["bundled"]
        for field in ("split_feature", "split_bin", "left_child", "right_child", "is_leaf"):
            if not np.array_equal(getattr(ub, field), getattr(bb, field)):
                raise AssertionError(f"efb {path}: bundled {field} differs from unbundled")
        if path == "u" and bb.model_to_string() != ub.model_to_string():
            raise AssertionError("efb: the quantized bundled fit's model text differs")
        print(f"efb {path}: bundled trees equal the unbundled ones"
              + (", model text identical" if path == "u" else
                 f", max leaf delta {float(np.abs(ub.leaf_values - bb.leaf_values).max())}"),
              flush=True)

    bins_t = torch.as_tensor(packed, device="cuda").t().contiguous()
    uspec = uh.make_u_spec(spec.num_bins, spec.num_columns, spec.widths)
    recs["kernels"] = _kernels_on_bins(torch, uh, hh, "efb packed columns", bins_t, uspec,
                                       spec.num_bins)
    del bins_t, raw, packed
    # packed widths at the kernels' limits: 256-wide bundles and width-2 columns
    gen = torch.Generator(device="cuda").manual_seed(99)
    widths = (256, 2, 2, 256, 2, 37, 2, 256) + (2,) * 20
    cols = [torch.randint(0, w, (N_EFB,), device="cuda", generator=gen, dtype=torch.int32)
            for w in widths]
    bins_t = torch.stack(cols).to(torch.uint8)
    recs["kernels_limits"] = _kernels_on_bins(
        torch, uh, hh, "widths 2 and 256", bins_t, uh.make_u_spec(256, len(widths), widths), 256)
    del bins_t, cols
    torch.cuda.empty_cache()
    return recs


def phase_oom(torch, uh, hh, runtime, binning, train, want_text):
    """The out-of-memory ladder on phase 9's 1,000,000-row resident U fit:
    an injected device OOM (``FaultPlan.oom_task(0, kind="device")``) at
    iteration 0; the fit must halve the U budget once, take chunked passes
    and write the undisturbed fit's model text. Then a real one: after U is
    built, a ballast allocation takes the card's free memory."""
    X, y = _make_data(N_U + N_TEST, N_FEATURES, seed=3)
    bins, mapper = binning.bin_dataset(X[:N_U], max_bin=NUM_BINS - 1)
    y = y[:N_U]
    opts = train.TrainOptions(objective="binary", num_iterations=FIT_ITERS, num_leaves=31,
                              learning_rate=0.1, max_bin=NUM_BINS - 1, leaf_batch=8,
                              histogram_method="u", use_quantized_grad=True)
    fault = runtime.FaultPlan().oom_task(0, kind="device")
    _zero_counts(uh, hh)
    with runtime.inject_faults(fault):
        res = train.train(bins, y, opts, mapper=mapper, device="cuda")
    counts = _counts(uh, hh)
    _need(counts, ("bin_scatter",), "oom ladder (injected)")
    st = res.stats
    if (fault.fired != [("oom_device", 0, 0)] or st.oom_retries != 1 or st.histogram_path != "u_chunked"
            or st.u_budget != uh.u_budget() // 2):
        raise AssertionError(f"injected OOM: fired {fault.fired}, {st}")
    if res.booster.model_to_string() != want_text:
        raise AssertionError("injected OOM: the degraded fit's model text differs")
    recs = {"injected": dict(retries=st.oom_retries, u_budget=st.u_budget,
                             histogram_path=st.histogram_path, u_chunks=st.u_chunks,
                             launches=counts, model_text_identical=True)}
    print("oom ladder injected: " + json.dumps(recs["injected"]), flush=True)

    # A real allocation failure: fill the card once U is built.
    ballast = []
    build_u = uh.build_u

    def build_u_then_fill(bins_t, spec):
        u = build_u(bins_t, spec)
        if not ballast:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            free = torch.cuda.mem_get_info()[0]
            # the largest block that the allocator grants, leaving a few MB
            for slack_mb in (4, 16, 64, 256, 1024):
                try:
                    ballast.append(torch.empty(max(0, free - (slack_mb << 20)),
                                               dtype=torch.uint8, device="cuda"))
                    break
                except torch.cuda.OutOfMemoryError:
                    continue
        return u

    uh.build_u = build_u_then_fill
    _zero_counts(uh, hh)
    try:
        res = train.train(bins, y, opts, mapper=mapper, device="cuda")
    finally:
        uh.build_u = build_u
        ballast_bytes = ballast[0].numel() if ballast else 0
        ballast.clear()
        torch.cuda.empty_cache()
    st = res.stats
    rec = dict(ballast_bytes=ballast_bytes, retries=st.oom_retries, u_budget=st.u_budget,
               histogram_path=st.histogram_path, launches=_counts(uh, hh))
    if st.oom_retries:
        rec["model_text_identical"] = res.booster.model_to_string() == want_text
        if not rec["model_text_identical"]:
            raise AssertionError("ballast OOM: the degraded fit's model text differs")
    print("oom ladder ballast: " + json.dumps(rec), flush=True)
    recs["ballast"] = rec
    return recs


# -- validation, early stopping, warm start and the quantized path's noise -----

N_ES = 11_500_000  # phase 13's table: N_VALID of its rows are flagged for validation
N_VALID = 500_000
ES_MAX_ITERS = 60
ES_ROUNDS = 3
ES_TOLERANCE = 5e-4  # valid AUC gains below this count as no improvement
N_TRAIN_METRIC = 1_000_000
WARM_ITERS = 5
BAGGING = dict(baggingFraction=0.8, baggingFreq=5, featureFraction=0.8)


def _lr_decay(iteration):
    """Phase 13's learning-rate schedule: 0.5, decaying 15% an iteration."""
    return 0.5 * 0.85 ** iteration


def phase_early_stopping(torch, uh, hh, binning, train, callbacks, Table, LightGBMClassifier,
                         auc):
    """Validation set, bagging, feature fraction, an LR schedule and early
    stopping through the estimator at HIGGS width; then the training
    metric on a 1,000,000-row fit. Returns the record, the model and the
    rows it was trained on (the validation rows left out)."""
    X, y = _make_data(N_ES + N_TEST, N_FEATURES, seed=4)
    flag = np.zeros(N_ES, bool)
    flag[N_ES - N_VALID:] = True
    est = LightGBMClassifier(numIterations=ES_MAX_ITERS, numLeaves=31, maxBin=NUM_BINS - 1,
                             leafBatch=8, learningRate=0.1, metric="auc",
                             earlyStoppingRound=ES_ROUNDS, improvementTolerance=ES_TOLERANCE,
                             validationIndicatorCol="valid", device="cuda", **BAGGING)
    est.set_delegate(callbacks.LearningRateSchedule(_lr_decay))
    table = Table({"features": X[:N_ES], "label": y[:N_ES], "valid": flag})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(uh, hh)
    t0 = time.perf_counter()
    model = est.fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = _counts(uh, hh)
    _need(counts, ("hist_panel", "hist_combined"), "early stopping fit")
    peak = torch.cuda.max_memory_allocated()
    booster, st = model.booster, model.fit_stats
    run, best = booster.num_iterations, booster.best_iteration
    history = model._train_evals["valid_0"]["auc"]
    if not 0 < best < run < ES_MAX_ITERS or len(history) != run:
        raise AssertionError(f"early stopping: {run} iterations run, best {best}, "
                             f"{len(history)} evals")
    out = model.transform(Table({"features": X[N_ES:]}))
    prob = out["probability"]
    if prob.shape != (N_TEST, 2) or not np.isfinite(prob).all():
        raise AssertionError(f"bad probability column {prob.shape}")
    test_auc = auc(y[N_ES:], prob[:, 1], np.ones(N_TEST))
    if not test_auc > 0.75:
        raise AssertionError(f"early stopping fit: held-out AUC {test_auc} is too low")
    per_it = st.per_iteration
    rec = dict(rows=N_ES - N_VALID, valid_rows=N_VALID, max_iterations=ES_MAX_ITERS,
               iterations_run=run, best_iteration=best, valid_auc=history,
               held_out_auc=test_auc, fit_s=fit_s, binning_s=st.binning_seconds,
               boosting_s=st.boost_seconds, trees=st.trees, passes=st.passes,
               per_iteration_mean={k: statistics.mean(it[k] for it in per_it)
                                   for k in per_it[0]},
               bag_draw_s_at_redraws=[it["bag_draw"] for i, it in enumerate(per_it)
                                      if i % BAGGING["baggingFreq"] == 0],
               peak_device_bytes=peak, launches=counts)
    print("early stopping fit: " + json.dumps(rec), flush=True)
    for i, it in enumerate(per_it):
        print("early stopping iteration: " + json.dumps(dict(iteration=i, **it)), flush=True)

    # The training metric: a fetch of every margin and a host AUC each
    # iteration, at 1,000,000 rows.
    bins, mapper = binning.bin_dataset(X[:N_TRAIN_METRIC], max_bin=NUM_BINS - 1)
    opts = train.TrainOptions(objective="binary", num_iterations=5, num_leaves=31,
                              max_bin=NUM_BINS - 1, leaf_batch=8, metric="auc",
                              provide_training_metric=True)
    _zero_counts(uh, hh)
    res = train.train(bins, y[:N_TRAIN_METRIC], opts, mapper=mapper, device="cuda")
    _need(_counts(uh, hh), ("hist_panel", "hist_combined"), "training metric fit")
    scores = res.evals["training"]["auc"]
    if len(scores) != 5 or not all(0.5 < s_ < 1.0 for s_ in scores):
        raise AssertionError(f"training metric: {scores}")
    tm = dict(rows=N_TRAIN_METRIC, training_auc=scores,
              eval_s=[it["eval"] for it in res.stats.per_iteration],
              boost_s=[it["boost"] for it in res.stats.per_iteration])
    print("training metric: " + json.dumps(tm), flush=True)
    rec["training_metric"] = tm
    return rec, model, X[:N_ES - N_VALID], y[:N_ES - N_VALID]


def phase_warm_start(torch, uh, hh, Table, LightGBMClassifier, Booster, model, X, y):
    """Phase 13's model continued for WARM_ITERS iterations two ways: from
    its text (modelString) and from the raw margins of the model that text
    holds (initScoreCol). The delta boosters must write the same text."""
    text = model.get_model_string()
    prev = Booster.from_string(text)
    init = prev.raw_margin(X, device="cuda")[:, 0]
    common = dict(numIterations=WARM_ITERS, numLeaves=31, maxBin=NUM_BINS - 1, leafBatch=8,
                  learningRate=0.1, device="cuda", **BAGGING)
    rec = {}
    texts = {}
    for name, params, cols in (("modelString", dict(modelString=text), {}),
                               ("initScoreCol", dict(initScoreCol="init"), {"init": init})):
        _zero_counts(uh, hh)
        t0 = time.perf_counter()
        delta = LightGBMClassifier(**common, **params).fit(
            Table({"features": X, "label": y, **cols}))
        torch.cuda.synchronize()
        counts = _counts(uh, hh)
        _need(counts, ("hist_panel", "hist_combined"), f"warm start ({name})")
        if delta.booster.init_score.tolist() != [0.0] or delta.booster.num_iterations != WARM_ITERS:
            raise AssertionError(f"warm start ({name}): not a {WARM_ITERS}-tree delta model")
        texts[name] = delta.booster.model_to_string()
        rec[name] = dict(fit_s=time.perf_counter() - t0, launches=counts)
    if texts["modelString"] != texts["initScoreCol"]:
        raise AssertionError("warm start: modelString and initScoreCol model texts differ")
    rec.update(rows=len(y), iterations=WARM_ITERS, model_text_identical=True)
    print("warm start: " + json.dumps(rec), flush=True)
    return rec


#: (seed, iteration, column, n, bits at rows [0, 1, n // 2, n - 1] of the g
#: and h uniforms, sum of all bits of each row): jax.random's float32
#: uniforms under the reference's per-tree key, computed with jax 0.9.0 on
#: the CPU (x64 off, partitionable threefry).
NOISE_CASES = (
    (0, 0, 0, 7, ((1059004724, 1059280412, 1047618024, 1058808574),
                  (1062328078, 1053687004, 1053185072, 1050621356)),
     (7379610108, 7380552128)),
    (2**31 + 5, 3, 1, 1001, ((1011874944, 1062248066, 1022800192, 1016162816),
                             (1060766148, 1061299734, 1058099522, 1050940292)),
     (1053753625810, 1053533056960)),
    (-1, 17, 2, 100_003, ((1062732274, 1058607604, 1046326104, 1055052572),
                          (1060342138, 1059913086, 1054172132, 1063173908)),
     (105281232672134, 105285687792610)),
    (2**40 + 3, 5, 0, 11_000_000, ((1050493624, 1061488742, 1043046192, 1038500048),
                                   (1054469836, 1064472154, 1049368180, 1058592722)),
     (11580521422214578, 11580489359183812)),
)


def phase_quant_noise(torch, uh, hh, binning, train):
    """The quantized noise against jax's known answers on the card, one
    11M-row draw timed, and a bagged quantized U fit resident and chunked."""
    dev = torch.device("cuda")
    for seed, it, col, n, picks, sums in NOISE_CASES:
        u = train.quant_noise(seed, it, col, n, dev)
        if u.shape != (2, n) or u.dtype != torch.float32 or u.device.type != "cuda":
            raise AssertionError(f"quant_noise: {u.shape} {u.dtype} on {u.device}")
        bits = u.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        pos = torch.tensor([0, 1, n // 2, n - 1], device=dev)
        got_picks = tuple(tuple(r) for r in bits[:, pos].cpu().tolist())
        got_sums = tuple(bits.sum(dim=1).cpu().tolist())
        if got_picks != picks or got_sums != sums:
            raise AssertionError(f"quant_noise({seed}, {it}, {col}, {n}) differs from jax: "
                                 f"{got_picks} {got_sums}")
    # The quantized split search's prefix sums: torch.cumsum over the bin
    # axis of a (k, F, B, 3) histogram must add in bin order in float32.
    gen = torch.Generator(device=dev).manual_seed(7)
    hist = torch.randn((8, N_FEATURES, NUM_BINS, 3), device=dev, generator=gen) * 100.0
    in_order = np.cumsum(hist.cpu().numpy(), axis=2, dtype=np.float32)
    if not np.array_equal(train._bin_prefix(hist, True).cpu().numpy(), in_order):
        raise AssertionError("torch.cumsum over the bin axis does not add in bin order in "
                             "float32 on the card")
    rec = dict(known_answer_cases=len(NOISE_CASES), prefix_in_bin_order=True, draw_rows=N_FIT,
               draw_ms=_time_ms(torch, lambda: train.quant_noise(0, 1, 0, N_FIT, dev), 5),
               draw_ms_1m=_time_ms(torch, lambda: train.quant_noise(0, 1, 0, N_U, dev), 5))

    X, y = _make_data(N_U, N_FEATURES, seed=5)
    bins, mapper = binning.bin_dataset(X, max_bin=NUM_BINS - 1)
    opts = train.TrainOptions(objective="binary", num_iterations=FIT_ITERS, num_leaves=31,
                              learning_rate=0.1, max_bin=NUM_BINS - 1, leaf_batch=8,
                              histogram_method="u", use_quantized_grad=True,
                              bagging_fraction=0.8, bagging_freq=5, feature_fraction=0.8)
    texts = {}
    saved = os.environ.pop("MMLSPARK_TPU_U_BUDGET", None)
    try:
        for name, budget, kernel in (("resident", None, "u_panel_dot"),
                                     ("chunked", U_BUDGET_4_CHUNKS, "bin_scatter")):
            if budget is not None:
                os.environ["MMLSPARK_TPU_U_BUDGET"] = str(budget)
            _zero_counts(uh, hh)
            res = train.train(bins, y, opts, mapper=mapper, device="cuda")
            counts = _counts(uh, hh)
            _need(counts, (kernel,), f"bagged quantized U fit ({name})")
            st = res.stats
            if not st.quantized or st.histogram_path != ("u" if budget is None else "u_chunked"):
                raise AssertionError(f"bagged quantized U fit ({name}): {st}")
            texts[name] = res.booster.model_to_string()
            tree_ms = 1e3 * st.boost_seconds / st.trees
            rec[name] = dict(boosting_s=st.boost_seconds, tree_ms=tree_ms, u_chunks=st.u_chunks,
                             noise_share_of_tree=rec["draw_ms_1m"] / tree_ms, launches=counts,
                             bag_draw_s=sum(it["bag_draw"] for it in st.per_iteration))
    finally:
        os.environ.pop("MMLSPARK_TPU_U_BUDGET", None)
        if saved is not None:
            os.environ["MMLSPARK_TPU_U_BUDGET"] = saved
    if texts["resident"] != texts["chunked"]:
        raise AssertionError("bagged quantized U fit: resident and chunked model texts differ")
    rec["model_text_identical"] = True
    print("quant noise: " + json.dumps(rec), flush=True)
    return rec


# Phase 16: the UCI Covertype shape (XGBoost's demo/gpu_acceleration/cover_type.py):
# 581,012 rows of 54 features (10 continuous, 4 one-hot wilderness areas, 40
# one-hot soil types), 7 cover types at the data set's class priors.
N_COVER = 581_012
N_COVER_VALID = 100_000
N_COVER_TEST = 100_000
COVER_PRIORS = (0.365, 0.488, 0.062, 0.005, 0.016, 0.030, 0.035)
COVER_MAJORITY_ERROR = 1.0 - max(COVER_PRIORS)  # 0.512


def _covertype_data(n, seed):
    """Covertype-shaped rows from a seed (nothing is downloaded): integer
    continuous columns in the data set's ranges (elevation, aspect, slope,
    hydrology, road and fire distances, three hillshades), one wilderness
    area and one soil type per row (the soil follows the area and the
    elevation), and a label drawn from a nonlinear per-class score (an
    elevation band per cover type, soil and area effects, aspect, slope
    and distances) with Gumbel noise, its class biases set so that the
    label frequencies are COVER_PRIORS."""
    rng = np.random.default_rng(seed)
    c = len(COVER_PRIORS)
    elev = np.round(rng.normal(2959, 280, n)).clip(1859, 3858)
    aspect = rng.integers(0, 361, n).astype(np.float64)
    slope = np.round(rng.gamma(4.0, 3.5, n)).clip(0, 66)
    hhyd = np.round(rng.exponential(270, n)).clip(0, 1397)
    vhyd = np.round(rng.normal(46, 58, n)).clip(-173, 601)
    hroad = np.round(rng.exponential(2350, n)).clip(0, 7117)
    face = np.cos(np.radians(aspect - 135))
    hs9 = np.round(212 + 27 * face - slope + rng.normal(0, 8, n)).clip(0, 254)
    hsn = np.round(223 - 0.6 * slope + rng.normal(0, 12, n)).clip(0, 254)
    hs3 = np.round(142 - 35 * face + rng.normal(0, 20, n)).clip(0, 254)
    hfire = np.round(rng.exponential(1980, n)).clip(0, 7173)
    wild = np.clip((elev - 1859) / 500 + rng.normal(0, 0.9, n), 0, 3.999).astype(int)
    soil = np.clip(wild * 10 + rng.integers(0, 10, n) + (elev > 3200) * rng.integers(0, 3, n),
                   0, 39)
    X = np.zeros((n, 54))
    X[:, :10] = np.stack([elev, aspect, slope, hhyd, vhyd, hroad, hs9, hsn, hs3, hfire], 1)
    X[np.arange(n), 10 + wild] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    band = np.array([3130, 2920, 2390, 2220, 2790, 2430, 3360], np.float64)
    score = -((elev[:, None] - band[None]) / 160.0) ** 2
    score += rng.normal(0, 0.8, (40, c))[soil] + rng.normal(0, 0.6, (4, c))[wild]
    score += 0.4 * np.sin(np.radians(aspect))[:, None] * np.linspace(-1, 1, c)[None]
    score += hhyd[:, None] / 500.0 * np.array([0.3, 0.1, -0.4, -0.8, 0.2, -0.3, 0.5])
    score += hroad[:, None] / 3000.0 * np.array([0.2, -0.2, -0.3, -0.5, 0.1, -0.1, 0.4])
    score += slope[:, None] / 20.0 * np.array([-0.1, 0.0, 0.4, 0.2, 0.1, 0.5, 0.3])
    score += rng.gumbel(size=(n, c))
    bias = np.log(np.asarray(COVER_PRIORS))
    for _ in range(8):
        freq = np.bincount((score + bias).argmax(1), minlength=c) / n
        bias += np.log(np.asarray(COVER_PRIORS) / np.maximum(freq, 1e-9))
    return X, (score + bias).argmax(1).astype(np.float64)


def _multiclass_record(torch, objectives, label, st, counts, peak, y_test, margins, **extra):
    c = len(COVER_PRIORS)
    if margins.shape != (len(y_test), c) or not np.isfinite(margins).all():
        raise AssertionError(f"{label}: bad margins {margins.shape}")
    w = np.ones(len(y_test))
    err = objectives.multi_error(y_test, margins, w)
    rec = dict(fit=label, boosting_s=st.boost_seconds, binning_s=st.binning_seconds,
               u_build_s=st.u_build_seconds, trees=st.trees, passes=st.passes,
               histogram_path=st.histogram_path, u_chunks=st.u_chunks, quantized=st.quantized,
               launches=counts, launches_per_tree={k: v / st.trees for k, v in counts.items()},
               held_out_multi_error=err,
               held_out_multi_logloss=objectives.multi_logloss(y_test, margins, w),
               peak_device_bytes=peak, **extra)
    print("multiclass fit: " + json.dumps(rec), flush=True)
    if not err < COVER_MAJORITY_ERROR:
        raise AssertionError(f"{label}: held-out multi_error {err} is not below the majority "
                             f"class's {COVER_MAJORITY_ERROR}")
    return rec


def phase_multiclass(torch, uh, hh, binning, train, objectives, Table, LightGBMClassifier):
    """Multiclass at Covertype width: the default path through the
    estimator, the same with a validation set (multi_logloss, early
    stopping), the quantized U path, and EFB on the one-hot columns (default
    path against the unbundled fit; quantized U bundled against unbundled)."""
    n_all = N_COVER + N_COVER_VALID + N_COVER_TEST
    X, y = _covertype_data(n_all, seed=16)
    Xtr, ytr = X[:N_COVER], y[:N_COVER]
    Xte, yte = X[N_COVER + N_COVER_VALID:], y[N_COVER + N_COVER_VALID:]
    freq = np.bincount(ytr.astype(int), minlength=len(COVER_PRIORS)) / N_COVER
    print("covertype: " + json.dumps(dict(rows=N_COVER, features=X.shape[1],
                                         class_freq=freq.tolist())), flush=True)
    common = dict(numIterations=FIT_ITERS, numLeaves=31, maxBin=NUM_BINS - 1, leafBatch=8,
                  learningRate=0.1, device="cuda")
    recs = {}

    def estimator_fit(label, table, **params):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(uh, hh)
        model = LightGBMClassifier(**common, **params).fit(table)
        torch.cuda.synchronize()
        counts = _counts(uh, hh)
        _need(counts, ("hist_panel", "hist_combined"), label)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        out = model.transform(Table({"features": Xte}))
        predict_s = time.perf_counter() - t0
        prob = out["probability"]
        if prob.shape != (N_COVER_TEST, 7) or not np.allclose(prob.sum(axis=1), 1.0, atol=1e-5):
            raise AssertionError(f"{label}: bad probability column {prob.shape}")
        return model, _multiclass_record(torch, objectives, label, model.fit_stats, counts, peak,
                                         yte, out["rawPrediction"], predict_s=predict_s)

    default, recs["default"] = estimator_fit("default", Table({"features": Xtr, "label": ytr}))
    if default.booster.num_classes != 7 or default.fit_stats.trees != 7 * FIT_ITERS:
        raise AssertionError(f"default fit: {default.booster.num_classes} classes, "
                             f"{default.fit_stats.trees} trees")

    flag = np.zeros(N_COVER + N_COVER_VALID, bool)
    flag[N_COVER:] = True
    valid, rec = estimator_fit(
        "validation", Table({"features": X[:N_COVER + N_COVER_VALID],
                             "label": y[:N_COVER + N_COVER_VALID], "valid": flag}),
        validationIndicatorCol="valid", metric="multi_logloss", earlyStoppingRound=2)
    history = valid._train_evals["valid_0"]["multi_logloss"]
    if len(history) != valid.booster.num_iterations or not all(np.isfinite(history)):
        raise AssertionError(f"validation fit: history {history}")
    rec.update(iterations_run=valid.booster.num_iterations,
               best_iteration=valid.booster.best_iteration, valid_multi_logloss=history)
    print("multiclass validation: " + json.dumps(dict(
        iterations_run=rec["iterations_run"], best_iteration=rec["best_iteration"],
        valid_multi_logloss=history)), flush=True)
    recs["validation"] = rec

    bundled, recs["bundled"] = estimator_fit("bundled", Table({"features": Xtr, "label": ytr}),
                                             featureBundling=True)
    ub, bb = default.booster, bundled.booster
    for field in ("split_feature", "split_bin", "left_child", "right_child", "is_leaf"):
        if not np.array_equal(getattr(ub, field), getattr(bb, field)):
            raise AssertionError(f"bundled default fit: {field} differs from the unbundled fit")
    text_u, text_b = ub.model_to_string(), bb.model_to_string()
    # On float histograms a bundled member's default bin is the node total less
    # its other bins, so split gains may differ from the unbundled fit's in
    # float32 rounding of their terms (each at most the largest gain's
    # order: within 1e-5 of it); every other line of the text must be
    # identical.
    other = [(a, b) for a, b in zip(text_u.splitlines(), text_b.splitlines())
             if a != b and not a.startswith(("split_gain=", "tree_sizes="))]
    gains_u, gains_b = (np.array([float(v) for line in text.splitlines()
                                  if line.startswith("split_gain=") for v in line[11:].split()])
                        for text in (text_u, text_b))
    if other or gains_u.shape != gains_b.shape:
        raise AssertionError(f"bundled default fit: model text differs ({other[:2]})")
    delta, top = float(np.abs(gains_u - gains_b).max()), float(np.abs(gains_u).max())
    recs["bundled"].update(text_identical=text_u == text_b, max_split_gain_delta=delta,
                           max_split_gain=top)
    print(f"multiclass bundled: trees and text equal the unbundled fit's but split gains, "
          f"within {delta} of {top}", flush=True)
    if not delta <= 1e-5 * top:
        raise AssertionError(f"bundled default fit: split gains differ by {delta} (largest "
                             f"gain {top})")

    for name, bundling in (("u_quant", False), ("u_quant_bundled", True)):
        t0 = time.perf_counter()
        bins, mapper = binning.bin_dataset(Xtr, max_bin=NUM_BINS - 1,
                                           feature_bundling=bundling)
        binning_s = time.perf_counter() - t0
        opts = train.TrainOptions(objective="multiclass", num_class=7, num_iterations=FIT_ITERS,
                                  num_leaves=31, learning_rate=0.1, max_bin=NUM_BINS - 1,
                                  leaf_batch=8, histogram_method="u", use_quantized_grad=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(uh, hh)
        res = train.train(bins, ytr, opts, mapper=mapper, device="cuda")
        torch.cuda.synchronize()
        counts = _counts(uh, hh)
        kernel = "bin_scatter" if res.stats.histogram_path == "u_chunked" else "u_panel_dot"
        _need(counts, (kernel,), name)
        if not res.stats.quantized:
            raise AssertionError(f"{name}: {res.stats}")
        res.stats.binning_seconds = binning_s
        margins = res.booster.raw_margin(Xte, device="cuda")
        recs[name] = _multiclass_record(torch, objectives, name, res.stats, counts,
                                        torch.cuda.max_memory_allocated(), yte, margins,
                                        columns=bins.shape[1])
        recs[name]["text"] = res.booster.model_to_string()
    if recs["u_quant"].pop("text") != recs["u_quant_bundled"].pop("text"):
        raise AssertionError("quantized U fit: the bundled model text differs from the "
                             "unbundled one")
    print(f"multiclass: quantized U path {recs['u_quant']['histogram_path']} "
          f"({recs['u_quant']['u_chunks']} chunks); bundled model text identical", flush=True)
    return recs, dict(booster=default.booster, X_test=Xte)


# Phase 17: boosting types and depthwise growth at HIGGS width, on phase 5's bins.
HIGGS_MODES = (
    ("goss", dict(boosting_type="goss", top_rate=0.2, other_rate=0.1)),
    ("dart", dict(boosting_type="dart", drop_rate=0.1)),
    ("rf", dict(boosting_type="rf", bagging_fraction=0.8, bagging_freq=1)),
    ("depthwise_6", dict(growth="depthwise", max_depth=6)),
    ("depthwise_8", dict(growth="depthwise", max_depth=8)),
)


def phase_boosting_types(torch, uh, hh, train, auc, higgs):
    """goss, dart, rf and depthwise growth (max_depth 6 and 8: levels of 64
    and 128 nodes in node-grouped histogram.cu launches) on the 11,000,000
    rows of phase 5, and one goss fit on the 1,000,000-row quantized
    resident U path; held-out AUC on phase 5's 500,000 test rows."""
    bins, mapper, y = higgs["bins"], higgs["mapper"], higgs["y"]
    Xte, yte = higgs["X_test"], higgs["y_test"]
    recs = {}
    fits = [(name, bins, y, kw) for name, kw in HIGGS_MODES]
    fits.append(("goss_u_quant_1m", bins[:N_U], y[:N_U],
                 dict(boosting_type="goss", histogram_method="u", use_quantized_grad=True)))
    for name, b, yy, kw in fits:
        opts = train.TrainOptions(objective="binary", num_iterations=FIT_ITERS, num_leaves=31,
                                  learning_rate=0.1, max_bin=NUM_BINS - 1, leaf_batch=8, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(uh, hh)
        res = train.train(b, yy, opts, mapper=mapper, device="cuda")
        torch.cuda.synchronize()
        counts = _counts(uh, hh)
        st = res.stats
        _need(counts, ("u_panel_dot",) if "u_quant" in name else ("hist_panel", "hist_combined"),
              name)
        margin = res.booster.raw_margin(Xte, device="cuda")[:, 0]
        test_auc = auc(yte, margin, np.ones(len(yte)))
        rec = dict(fit=name, rows=len(yy), boosting_s=st.boost_seconds, trees=st.trees,
                   passes=st.passes, histogram_path=st.histogram_path, quantized=st.quantized,
                   launches=counts, held_out_auc=test_auc,
                   peak_device_bytes=torch.cuda.max_memory_allocated())
        if st.level_launches:
            rec["level_launches"] = st.level_launches
            rec["launches_per_tree_by_level"] = [v / st.trees for v in st.level_launches]
        if st.dart_drops:
            rec["dropped_trees"] = sum(len(d) for d in st.dart_drops)
        print("boosting type fit: " + json.dumps(rec), flush=True)
        if not test_auc > 0.75:
            raise AssertionError(f"{name}: held-out AUC {test_auc} is too low for this data")
        if name == "depthwise_8":
            want = [len(hh.node_groups(1 << d, NUM_BINS)) for d in range(8)]
            if rec["launches_per_tree_by_level"] != want:
                raise AssertionError(f"depthwise_8: launches by level "
                                     f"{rec['launches_per_tree_by_level']}, want {want}")
        if name == "dart" and not rec["dropped_trees"]:
            raise AssertionError("dart: no tree was dropped")
        recs[name] = rec
    return recs


# -- phases 18-21: regression, poisson and tweedie, lambdarank, explain ----------

N_YEAR = 463_715  # YearPredictionMSD's standard training split
N_YEAR_TEST = 51_630
YEAR_FEATURES = 90  # 12 timbre averages and 78 timbre covariances
YEAR_FITS = (("regression", "l2"), ("regression_l1", "l1"), ("huber", "l2"),
             ("quantile", "quantile"))
QUANTILE_ALPHA = 0.9
CAPPED_COLUMNS, CAP_BINS = 12, 63  # maxBinByFeature: the timbre averages at 63 bins
U_RESIDENT_BUDGET = 16 << 30  # above phase 18's 10.7 GB U: the resident pass
KERNEL_CHECK_NODES = 8


def _year_data(n, seed):
    """YearPredictionMSD's shape: 12 timbre averages and 78 covariances
    (correlated with them, other scales) and an integer year in 1922-2011,
    skewed toward the 2000s, driven by a nonlinear score."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 12))
    cov = means @ (rng.normal(size=(12, 78)) / np.sqrt(12)) + 0.5 * rng.normal(size=(n, 78))
    X = np.concatenate([means * 10.0, cov * 30.0], axis=1)
    s = means[:, 0] + 0.6 * means[:, 1] * means[:, 2] + 0.4 * np.tanh(cov[:, 0]) \
        - 0.3 * means[:, 3] ** 2
    s = (s - s.mean()) / s.std()
    y = np.clip(np.round(2011.0 - 9.0 * np.exp(-0.6 * s + 0.5 * rng.normal(size=n))), 1922, 2011)
    return X, y


def _stats_check(torch, uh, hh, label, bins_t, g, h, k=KERNEL_CHECK_NODES, u=None):
    """The kernels on one fit's iteration-0 stats: histogram.cu at k nodes
    bit for bit its plain version, and with ``u`` the U pass on the
    quantized stats; returns the record."""
    dev = bins_t.device
    n = g.shape[0]
    gen = torch.Generator(device=dev).manual_seed(k)
    node = torch.randint(0, k + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
    count = torch.ones(n, device=dev)
    args = (bins_t, g.contiguous(), h.contiguous(), count, node, k, NUM_BINS)
    out = hh.build_histograms_cuda(*args)
    if not torch.equal(out, hh.build_histograms_plain(*args)):
        raise AssertionError(f"{label}: histogram.cu differs from its plain version on the "
                             f"iteration-0 stats")
    rec = dict(case=label, rows=n, k=k, g_min=float(g.min()), g_max=float(g.max()),
               h_min=float(h.min()), h_max=float(h.max()), zero_g_rows=int((g == 0).sum()),
               hist_ms=_time_ms(torch, lambda: hh.build_histograms_cuda(*args), 5))
    if u is not None:
        noise = torch.rand((2, n), device=dev, generator=gen)
        stats, _ = uh.stat_rows_quant(g, h, count, noise)
        got = uh.fused_panel_dot(u, stats, node, k)
        if not torch.equal(got, uh.fused_panel_dot_plain(u, stats, node, k)):
            raise AssertionError(f"{label}: u_histogram.cu differs from its plain version on "
                                 f"the quantized iteration-0 stats")
        rec["u_pass_ms"] = _time_ms(torch, lambda: uh.fused_panel_dot(u, stats, node, k), 5)
    print("kernels on new stats: " + json.dumps(rec), flush=True)
    return rec


def _iteration0(torch, objective, y, w, dev, **kw):
    """(g, h) of ``objective`` at its init score, on ``dev``."""
    yd = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    wd = torch.as_tensor(np.asarray(w, np.float32), device=dev) if w is not None \
        else torch.ones_like(yd)
    init = objective.init_score(yd.cpu().numpy(), 1, wd.cpu().numpy())
    margins = torch.as_tensor(init, device=dev)[None, :].expand(len(y), 1).contiguous()
    g, h = objective.grad_hess(margins, yd, wd, **kw)
    return g[:, 0], h[:, 0]


def _renewal_hold(torch, train, label, leaf, resid, w, pct, lr):
    """The leaf renewal on the card against the CPU port on the same inputs.
    With integer weights every sum is exact: the leaves must be equal. With
    fractional ones the leaf totals come from the card's float32 atomics
    (order unspecified) while the prefix sum is the reference's order on
    both, so a leaf whose cumulative weight lands within rounding of its
    threshold may take the next row of its residual order: the card's value
    must be the CPU port's row or a neighbour of it in that order."""
    dev = torch.device("cuda")
    lv = torch.zeros(int(leaf.max()) + 1)
    args = [torch.as_tensor(a) for a in (leaf, resid, w)]
    cpu = train.renew_leaves(lv, *args, pct, lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = train.renew_leaves(lv.to(dev), *(a.to(dev) for a in args), pct, lr)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    card = card.cpu()
    equal = int((card == cpu).sum())
    integer = bool(np.all(np.asarray(w) == np.round(np.asarray(w))))
    if integer and equal != len(cpu):
        raise AssertionError(f"{label}: renewal on the card differs from the CPU port with "
                             f"integer weights ({len(cpu) - equal} leaves)")
    for j in np.flatnonzero((card != cpu).numpy()):
        r = np.sort(np.asarray(resid)[np.asarray(leaf) == j]).astype(np.float32) * np.float32(lr)
        i = int(np.searchsorted(r, cpu[j].item()))
        if card[j].item() not in r[max(0, i - 1): i + 2]:
            raise AssertionError(f"{label}: renewed leaf {j} is {card[j].item()} on the card, "
                                 f"{cpu[j].item()} on the CPU: not neighbours")
    rec = dict(case=label, rows=len(resid), leaves=len(cpu), equal_leaves=equal,
               integer_weights=integer, card_ms=ms)
    print("renewal on the card: " + json.dumps(rec), flush=True)
    return card.numpy()


def phase_regression(torch, uh, hh, binning, train, objectives, Table, LightGBMRegressor):
    """YearPredictionMSD's shape: the four regression objectives through
    LightGBMRegressor on the default path, quantile on the quantized
    resident U path, l2 with maxBinByFeature; each against its init-only
    model on the held-out rows; the kernels on each objective's iteration-0
    stats; renewal on the card against the CPU port."""
    dev = torch.device("cuda")
    X, y = _year_data(N_YEAR + N_YEAR_TEST, seed=18)
    Xtr, ytr, Xte, yte = X[:N_YEAR], y[:N_YEAR], X[N_YEAR:], y[N_YEAR:]
    print("year: " + json.dumps(dict(rows=N_YEAR, test_rows=N_YEAR_TEST, features=X.shape[1],
                                     year_min=float(y.min()), year_median=float(np.median(y)),
                                     year_max=float(y.max()))), flush=True)
    common = dict(numIterations=FIT_ITERS, numLeaves=31, maxBin=NUM_BINS - 1, leafBatch=8,
                  learningRate=0.1, device="cuda")
    w_te = np.ones(N_YEAR_TEST)
    t0 = time.perf_counter()
    bins, mapper = binning.bin_dataset(Xtr, max_bin=NUM_BINS - 1)
    binning_s = time.perf_counter() - t0
    bins_t = torch.as_tensor(bins, device=dev).t().contiguous()
    recs, checks = {}, []

    def held_out(label, objective, metric, booster, st, counts, peak, **extra):
        margin = booster.raw_margin(Xte, device="cuda")[:, 0]
        if margin.shape != (N_YEAR_TEST,) or not np.isfinite(margin).all():
            raise AssertionError(f"{label}: bad predictions")
        fn = objectives.METRICS[metric][0]
        kw = dict(alpha=QUANTILE_ALPHA) if metric == "quantile" else {}
        loss = fn(yte, margin, w_te, **kw)
        init_loss = fn(yte, np.full(N_YEAR_TEST, float(booster.init_score[0])), w_te, **kw)
        rec = dict(fit=label, objective=objective, binning_s=st.binning_seconds,
                   boosting_s=st.boost_seconds, renewal_ms_per_iteration=(
                       st.renewal_seconds / FIT_ITERS * 1e3),
                   histogram_path=st.histogram_path, quantized=st.quantized, trees=st.trees,
                   passes=st.passes, launches=counts, peak_device_bytes=peak,
                   held_out_metric=metric, held_out=loss, init_only_held_out=init_loss, **extra)
        if objective == "quantile":
            rec["held_out_share_below"] = float(np.mean(yte <= margin))
        print("regression fit: " + json.dumps(rec), flush=True)
        if not loss < init_loss:
            raise AssertionError(f"{label}: held-out {metric} {loss} does not beat the init-only "
                                 f"model's {init_loss}")
        recs[label] = rec

    models = {}
    for objective, metric in YEAR_FITS:
        obj = objectives.get_objective(objective)
        g, h = _iteration0(torch, obj, ytr, None, dev, alpha=QUANTILE_ALPHA)
        checks.append(_stats_check(torch, uh, hh, f"year_{objective}", bins_t, g, h))
        del g, h
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(uh, hh)
        model = LightGBMRegressor(objective=objective, alpha=QUANTILE_ALPHA, **common).fit(
            Table({"features": Xtr, "label": ytr}))
        torch.cuda.synchronize()
        counts = _counts(uh, hh)
        _need(counts, ("hist_panel", "hist_combined"), objective)
        st = model.fit_stats
        if (st.renewal_seconds > 0) != (objective in train.RENEWED_OBJECTIVES):
            raise AssertionError(f"{objective}: renewal ran {st.renewal_seconds} s")
        pred = model.transform(Table({"features": Xte}))["prediction"]
        held_out(objective, objective, metric, model.booster, st, counts,
                 torch.cuda.max_memory_allocated())
        if not np.allclose(pred, model.booster.raw_margin(Xte, device="cuda")[:, 0]):
            raise AssertionError(f"{objective}: transform differs from the booster's margins")
        models[objective] = model

    # renewal on the card against the CPU port: tree 0's partition of the
    # training rows, residuals from the init score
    for objective in ("quantile", "regression_l1"):
        b = models[objective].booster
        leaf = b.predict_leaf(Xtr, num_iteration=1, device="cuda")[:, 0].astype(np.int64)
        resid = (ytr.astype(np.float32) - np.float32(b.init_score[0])).astype(np.float32)
        pct = QUANTILE_ALPHA if objective == "quantile" else 0.5
        ones = np.ones(N_YEAR, np.float32)
        card = _renewal_hold(torch, train, f"{objective}_unit_weights", leaf, resid, ones, pct,
                             0.1)
        live = b.is_leaf[0] & (b.cover[0] > 0)
        if not np.array_equal(card[np.flatnonzero(live)], b.leaf_values[0][live]):
            raise AssertionError(f"{objective}: renewing tree 0's partition does not give the "
                                 f"fit's leaves")
        frac = np.random.default_rng(19).uniform(0.05, 1.0, N_YEAR).astype(np.float32)
        _renewal_hold(torch, train, f"{objective}_fractional_weights", leaf, resid, frac, pct,
                      0.1)
    del models

    # quantile on the quantized resident U path
    opts = train.TrainOptions(objective="quantile", alpha=QUANTILE_ALPHA,
                              num_iterations=FIT_ITERS, num_leaves=31, learning_rate=0.1,
                              max_bin=NUM_BINS - 1, leaf_batch=8, histogram_method="u",
                              use_quantized_grad=True)
    saved = os.environ.get("MMLSPARK_TPU_U_BUDGET")
    os.environ["MMLSPARK_TPU_U_BUDGET"] = str(U_RESIDENT_BUDGET)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(uh, hh)
        res = train.train(bins, ytr, opts, mapper=mapper, device="cuda")
        torch.cuda.synchronize()
        counts = _counts(uh, hh)
        peak = torch.cuda.max_memory_allocated()
    finally:
        if saved is None:
            os.environ.pop("MMLSPARK_TPU_U_BUDGET", None)
        else:
            os.environ["MMLSPARK_TPU_U_BUDGET"] = saved
    st = res.stats
    if st.histogram_path != "u" or not st.quantized:
        raise AssertionError(f"quantile U fit took {st.histogram_path}, quantized {st.quantized}")
    _need(counts, ("u_panel_dot",), "quantile_u_quant")
    st.binning_seconds = binning_s
    spec = uh.make_u_spec(NUM_BINS, bins.shape[1], [int(x) for x in mapper.num_bins])
    held_out("quantile_u_quant", "quantile", "quantile", res.booster, st, counts, peak,
             u_bytes=uh.u_bytes(N_YEAR, spec), u_build_s=st.u_build_seconds)
    del res
    torch.cuda.empty_cache()
    u = uh.build_u(bins_t, spec)
    g, h = _iteration0(torch, objectives.get_objective("quantile"), ytr, None, dev,
                       alpha=QUANTILE_ALPHA)
    checks.append(_stats_check(torch, uh, hh, "year_quantile_u", bins_t, g, h, u=u))
    del u, g, h, bins_t
    torch.cuda.empty_cache()

    # l2 with the timbre averages capped at 63 bins
    caps = [CAP_BINS] * CAPPED_COLUMNS + [NUM_BINS - 1] * (YEAR_FEATURES - CAPPED_COLUMNS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(uh, hh)
    model = LightGBMRegressor(objective="regression", maxBinByFeature=caps, **common).fit(
        Table({"features": Xtr, "label": ytr}))
    torch.cuda.synchronize()
    counts = _counts(uh, hh)
    _need(counts, ("hist_panel", "hist_combined"), "max_bin_by_feature")
    edges = model.booster.bin_edges
    used = np.isfinite(edges).sum(axis=1)
    if used[:CAPPED_COLUMNS].max() > CAP_BINS - 1 or used[CAPPED_COLUMNS:].max() <= CAP_BINS - 1:
        raise AssertionError(f"maxBinByFeature: edges per column {used.tolist()}")
    held_out("regression_max_bin_by_feature", "regression", "l2", model.booster,
             model.fit_stats, counts, torch.cuda.max_memory_allocated(),
             edges_capped_columns=int(used[:CAPPED_COLUMNS].max()),
             edges_other_columns=int(used[CAPPED_COLUMNS:].max()))
    return recs, checks


# Phase 19: freMTPL2freq's shape (OpenML 41214).
N_MTPL = 678_013
MTPL_CATEGORICAL = (("Area", 6), ("VehBrand", 11), ("Region", 22), ("VehGas", 2))
TWEEDIE_POWER = 1.9


def _mtpl_data(n, seed):
    """freMTPL2freq's columns: Area, VehBrand, Region and VehGas as category
    codes; VehPower, VehAge, DrivAge, BonusMalus and Density; Exposure in
    (0, 1]; ClaimNb from a Poisson frequency (about 5% of policies claim)
    and a gamma-sized amount per claim (freMTPL2sev's scale)."""
    rng = np.random.default_rng(seed)
    cols = []
    effects = np.zeros(n)
    for _, card in MTPL_CATEGORICAL:
        p = rng.dirichlet(np.ones(card) * 2.0)
        code = rng.choice(card, n, p=p)
        effects += rng.normal(0, 0.25, card)[code]
        cols.append(code.astype(np.float64))
    veh_power = rng.integers(4, 16, n).astype(np.float64)
    veh_age = np.minimum(np.round(rng.exponential(7.0, n)), 100.0)
    driv_age = np.clip(np.round(18 + rng.gamma(4.0, 7.0, n)), 18, 100)
    bonus = np.clip(50 + np.round(rng.exponential(8.0, n)) * (rng.random(n) < 0.35), 50, 230)
    density = np.round(np.exp(rng.uniform(0.0, 10.2, n)))
    exposure = np.where(rng.random(n) < 0.3, 1.0, rng.uniform(0.003, 1.0, n))
    log_freq = (np.log(0.036) + effects + 0.02 * (bonus - 50) + 0.6 * (driv_age < 25)
                + 0.08 * np.log(density) - 0.03 * np.minimum(veh_age, 15) + 0.03 * veh_power)
    claims = np.minimum(rng.poisson(exposure * np.exp(log_freq)), 4).astype(np.float64)
    amount = np.where(claims > 0, rng.gamma(0.8 * np.maximum(claims, 1), 2300.0 / 0.8), 0.0)
    X = np.stack(cols + [veh_power, veh_age, driv_age, bonus, density], axis=1)
    return X, claims, amount, exposure


def phase_insurance(torch, uh, hh, binning, objectives, Table, LightGBMRegressor):
    """Claim frequency (poisson) and pure premium (tweedie at variance power
    1.9) with the categorical columns and Exposure as the weight, through
    LightGBMRegressor; held-out l2 on the response scale against the
    init-only model; the kernels on each objective's iteration-0 stats."""
    dev = torch.device("cuda")
    X, claims, amount, exposure = _mtpl_data(N_MTPL, seed=19)
    n_test = N_MTPL // 10
    n_tr = N_MTPL - n_test
    cats = list(range(len(MTPL_CATEGORICAL)))
    print("mtpl: " + json.dumps(dict(policies=N_MTPL, test=n_test, features=X.shape[1],
                                     share_with_claims=float(np.mean(claims > 0)),
                                     mean_exposure=float(exposure.mean()))), flush=True)
    bins, _ = binning.bin_dataset(X[:n_tr], max_bin=NUM_BINS - 1, categorical_features=cats)
    bins_t = torch.as_tensor(bins, device=dev).t().contiguous()
    recs, checks = {}, []
    for objective, target in (("poisson", claims / exposure), ("tweedie", amount / exposure)):
        y_tr, y_te, w_tr, w_te = target[:n_tr], target[n_tr:], exposure[:n_tr], exposure[n_tr:]
        obj = objectives.get_objective(objective)
        g, h = _iteration0(torch, obj, y_tr, w_tr, dev, tweedie_variance_power=TWEEDIE_POWER)
        checks.append(_stats_check(torch, uh, hh, f"mtpl_{objective}", bins_t, g, h))
        del g, h
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(uh, hh)
        model = LightGBMRegressor(objective=objective, tweedieVariancePower=TWEEDIE_POWER,
                                  categoricalSlotIndexes=cats, weightCol="exposure",
                                  numIterations=FIT_ITERS, numLeaves=31, maxBin=NUM_BINS - 1,
                                  learningRate=0.1, device="cuda").fit(
            Table({"features": X[:n_tr], "label": y_tr, "exposure": w_tr}))
        torch.cuda.synchronize()
        counts = _counts(uh, hh)
        _need(counts, ("hist_panel", "hist_combined"), objective)
        peak = torch.cuda.max_memory_allocated()
        pred = model.transform(Table({"features": X[n_tr:]}))["prediction"]
        if not (np.isfinite(pred).all() and (pred > 0).all()):
            raise AssertionError(f"{objective}: predictions must be finite and positive")
        st = model.fit_stats
        l2 = objectives.l2_loss(y_te, pred, w_te)
        init_l2 = objectives.l2_loss(y_te, np.full(n_test, np.exp(model.booster.init_score[0])),
                                     w_te)
        rec = dict(fit=objective, binning_s=st.binning_seconds, boosting_s=st.boost_seconds,
                   trees=st.trees, passes=st.passes, launches=counts, peak_device_bytes=peak,
                   held_out_l2_response=l2, init_only_held_out_l2_response=init_l2,
                   pred_min=float(pred.min()), pred_mean=float(np.average(pred, weights=w_te)),
                   target_mean=float(np.average(y_te, weights=w_te)))
        print("insurance fit: " + json.dumps(rec), flush=True)
        if not l2 < init_l2:
            raise AssertionError(f"{objective}: held-out l2 {l2} does not beat the init-only "
                                 f"model's {init_l2}")
        recs[objective] = rec
    del bins_t
    torch.cuda.empty_cache()
    return recs, checks


# Phase 20: MSLR-WEB10K Fold1's shape.
N_QUERIES, N_QUERIES_TEST = 6_000, 2_000
MSLR_FEATURES = 136
MSLR_RELEVANCE = (0.52, 0.32, 0.13, 0.02, 0.01)  # relevance 0-4
NDCG_AT = (1, 3, 5)
# LightGBM's examples/lambdarank/train.conf, 10 of its 100 trees
LAMBDARANK_PARAMS = dict(learningRate=0.1, numLeaves=31, maxBin=NUM_BINS - 1, minDataInLeaf=50,
                         minSumHessianInLeaf=5.0, evalAt=5)


def _mslr_data(nq, seed):
    """Query sizes lognormal (mean about 120, the longest near 1,000), 136
    features, relevance 0-4 at MSLR-WEB10K's frequencies from a score with a
    per-query offset, strong enough that some queries hold one label only
    (their rows get g = 0 and h = 1e-16, as in the real set)."""
    rng = np.random.default_rng(seed)
    sizes = np.clip(np.round(rng.lognormal(np.log(90.0), 0.75, nq)), 1, 1000).astype(np.int64)
    group = np.repeat(np.arange(nq), sizes)
    n = len(group)
    X = rng.normal(size=(n, MSLR_FEATURES))
    s = (X[:, 0] + 0.7 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.4 * np.tanh(X[:, 4])
         + 2.0 * rng.normal(size=nq)[group] + 0.8 * rng.normal(size=n))
    cuts = np.quantile(s, np.cumsum(MSLR_RELEVANCE)[:-1])
    return X, np.searchsorted(cuts, s).astype(np.float64), group, sizes


def phase_lambdarank(torch, uh, hh, binning, ranker, Table, LightGBMRanker):
    """LightGBMRanker with groupCol at MSLR-WEB10K's shape: the chunked
    lambdarank step's time and peak bytes at iteration 0, the kernels on its
    stats, the fit, and held-out NDCG@1/3/5 against the all-equal model."""
    dev = torch.device("cuda")
    X, y, group, sizes = _mslr_data(N_QUERIES, seed=20)
    Xt, yt, gt, _ = _mslr_data(N_QUERIES_TEST, seed=21)
    idx, g_max = ranker.group_structure(group)
    chunks = ranker.lambdarank_chunks(idx, len(y))
    print("mslr: " + json.dumps(dict(
        queries=N_QUERIES, rows=len(y), mean_size=float(sizes.mean()), max_size=g_max,
        relevance_freq=(np.bincount(y.astype(int), minlength=5) / len(y)).tolist(),
        test_rows=len(yt), chunks=len(chunks),
        largest_chunk_cells=max(c.shape[0] * c.shape[1] ** 2 for c in chunks),
        padded_one_shot_cells=N_QUERIES * g_max ** 2)), flush=True)
    obj = ranker.make_lambdarank_objective(idx)
    yd = torch.as_tensor(y.astype(np.float32), device=dev)
    wd = torch.ones_like(yd)
    m0 = torch.zeros((len(y), 1), device=dev)
    obj.grad_hess(m0, yd, wd)  # the chunk index tensors go to the card once
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        g, h = obj.grad_hess(m0, yd, wd)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    step_peak = torch.cuda.max_memory_allocated() - base
    bins, _ = binning.bin_dataset(X, max_bin=NUM_BINS - 1)
    bins_t = torch.as_tensor(bins, device=dev).t().contiguous()
    check = _stats_check(torch, uh, hh, "mslr_lambdarank", bins_t, g[:, 0], h[:, 0])
    if check["zero_g_rows"] == 0:
        raise AssertionError("the lambdarank stats hold no row at g = 0 (one-label queries)")
    del bins_t, bins, g, h, m0
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(uh, hh)
    t0 = time.perf_counter()
    model = LightGBMRanker(groupCol="query", numIterations=FIT_ITERS, device="cuda",
                           **LAMBDARANK_PARAMS).fit(Table({"features": X, "label": y,
                                                           "query": group}))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = _counts(uh, hh)
    _need(counts, ("hist_panel", "hist_combined"), "lambdarank")
    peak = torch.cuda.max_memory_allocated()
    pred = model.transform(Table({"features": Xt}))["prediction"]
    ndcg = {k: ranker.ndcg_at_k(yt, pred, gt, k) for k in NDCG_AT}
    flat = {k: ranker.ndcg_at_k(yt, np.zeros(len(yt)), gt, k) for k in NDCG_AT}
    st = model.fit_stats
    rec = dict(fit_s=fit_s, binning_s=st.binning_seconds, boosting_s=st.boost_seconds,
               trees=st.trees, passes=st.passes, launches=counts, peak_device_bytes=peak,
               lambdarank_ms=times, lambdarank_step_peak_bytes=step_peak,
               held_out_ndcg=ndcg, all_equal_ndcg=flat)
    print("lambdarank fit: " + json.dumps(rec), flush=True)
    if not ndcg[5] > flat[5]:
        raise AssertionError(f"held-out NDCG@5 {ndcg[5]} is not above the all-equal model's "
                             f"{flat[5]}")
    return rec, [check]


N_EXPLAIN = 10_000
N_EXPLAIN_CPU = 1_000  # rows whose SHAP the CPU port recomputes


def phase_explain(torch, Table, LightGBMClassificationModel, Booster, boosters):
    """predict_leaf and featuresShapCol on 10,000 held-out rows of phase 5's
    HIGGS booster and phase 16's 7-class booster: SHAP adds up to the
    card's margin (1e-5) and equals the CPU port's (1e-9) on the first
    1,000 rows, leaves equal the CPU port's; a linear-tree booster (random
    leaf models on the HIGGS trees, NaNs in the input) predicts on the card
    as on the CPU; rows/s of each."""
    recs = {}
    for name, booster, X in boosters:
        X = X[:N_EXPLAIN]
        model = LightGBMClassificationModel(
            boosterData=booster.to_dict(), numClasses=max(2, booster.num_classes),
            leafPredictionCol="leaves", featuresShapCol="shap", device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.transform(Table({"features": X}))
        transform_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        leaves = booster.predict_leaf(X, device="cuda")
        leaf_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        shap = booster.features_shap(X, device="cuda")
        shap_s = time.perf_counter() - t0
        c, f = booster.num_classes, X.shape[1]
        if out["shap"].shape != (N_EXPLAIN, c * (f + 1)) or \
                not np.array_equal(out["shap"].reshape(N_EXPLAIN, c, f + 1), shap):
            raise AssertionError(f"{name}: featuresShapCol layout or values")
        if not np.array_equal(out["leaves"], leaves.astype(np.float64)):
            raise AssertionError(f"{name}: leafPredictionCol differs from predict_leaf")
        margin = booster.raw_margin(X, device="cuda")
        add_err = float(np.abs(shap.sum(-1) - margin).max())
        if not add_err <= 1e-5:
            raise AssertionError(f"{name}: SHAP adds up to the margin within {add_err}")
        if not np.array_equal(leaves, booster.predict_leaf(X, device="cpu")):
            raise AssertionError(f"{name}: leaf slots differ from the CPU port's")
        cpu = booster.features_shap(X[:N_EXPLAIN_CPU], device="cpu")
        cpu_err = float(np.abs(shap[:N_EXPLAIN_CPU] - cpu).max())
        if not cpu_err <= 1e-9:
            raise AssertionError(f"{name}: SHAP on the card differs from the CPU port's by "
                                 f"{cpu_err}")
        rec = dict(booster=name, rows=N_EXPLAIN, trees=booster.num_trees, classes=c,
                   max_depth=booster.max_depth, transform_s=transform_s,
                   predict_leaf_rows_per_s=N_EXPLAIN / leaf_s,
                   shap_rows_per_s=N_EXPLAIN / shap_s, shap_additivity_err=add_err,
                   shap_vs_cpu_err=cpu_err)
        print("explain: " + json.dumps(rec), flush=True)
        recs[name] = rec

    name, booster, X = boosters[0]
    rng = np.random.default_rng(21)
    t, m = booster.split_feature.shape
    d = booster.to_dict()
    d.update(leaf_const=rng.normal(size=(t, m)), leaf_coeff=rng.normal(size=(t, m, 3)) * 0.1,
             leaf_feat=rng.integers(-1, X.shape[1], (t, m, 3)).astype(np.int32))
    linear = Booster.from_dict(d)
    Xn = X[:N_EXPLAIN].copy()
    Xn[rng.random(Xn.shape) < 0.05] = np.nan
    t0 = time.perf_counter()
    card = linear.raw_margin(Xn, device="cuda")
    linear_s = time.perf_counter() - t0
    cpu = linear.raw_margin(Xn, device="cpu")
    if not np.array_equal(card, cpu) or not np.isfinite(card).all():
        raise AssertionError("linear-tree margins on the card differ from the CPU port's")
    plain = booster.raw_margin(Xn, device="cuda")
    recs["linear"] = dict(booster=f"{name}_linear", rows=N_EXPLAIN,
                          rows_per_s=N_EXPLAIN / linear_s,
                          max_shift_from_plain=float(np.abs(card - plain).max()))
    print("explain: " + json.dumps(recs["linear"]), flush=True)
    return recs


# -- phases 22-23: sparse (CSR) input and out-of-core sharded ingest -------------

N_SHAP_SPARSE = 10_000
N_OOC = 44_000_000  # four times HIGGS's 11,000,000 rows
OOC_SHARD_ROWS = 2_000_000
OOC_CORRUPT_SHARDS = 4  # the copy the read modes run on; its shard 1 is truncated
OOC_BYTES_PER_ROW = N_FEATURES * 4 + 8 + N_FEATURES  # npz float32 X, float64 y; uint8 bins
DATA_DIR = os.path.join(ROOT, "smoke_data")  # git-ignored; removed when phase 24 ends


_RSS_POLL = """
import select, sys
path = "/proc/%s/status" % sys.argv[1]

def rss():
    with open(path) as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024

peak = rss()
print(peak, flush=True)
while True:
    asked = select.select([sys.stdin], [], [], 0.01)[0]
    peak = max(peak, rss())
    if asked:
        print(peak, flush=True)
        if not sys.stdin.readline():
            break
"""


class _RssPeak:
    """This process's resident memory over a window, read from
    /proc/<pid>/status every 10 ms by a child process, so no thread of this
    one competes with the timed work: ``base`` at the start, ``now()`` the
    peak so far, ``peak`` the peak when the window closed."""

    def __enter__(self):
        import subprocess

        self._proc = subprocess.Popen([sys.executable, "-c", _RSS_POLL, str(os.getpid())],
                                      stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.base = int(self._proc.stdout.readline())
        return self

    def now(self):
        self._proc.stdin.write("\n")
        self._proc.stdin.flush()
        return int(self._proc.stdout.readline())

    def __exit__(self, *exc):
        self._proc.stdin.close()
        self.peak = int(self._proc.stdout.readline())
        self._proc.wait(timeout=10)


def _airline_sparse(SparseRows, X):
    """Phase 11's one-hot airline columns (672 one-hot, DepTime, Distance)
    as a SparseRows column built straight from the codes: the dense matrix
    never exists, and a zero DepTime is an implicit entry, as a zero cell
    of the dense matrix is."""
    n = X.shape[0]
    width = sum(c for _, c in AIR_CATEGORICAL) + 2
    idx = np.empty((n, len(AIR_CATEGORICAL) + 2), np.int32)
    val = np.ones(idx.shape, np.float32)
    off = 0
    for j, (_, card) in enumerate(AIR_CATEGORICAL):
        idx[:, j] = off + X[:, j].astype(np.int32) - 1
        off += card
    idx[:, -2:] = (off, off + 1)
    val[:, -2:] = X[:, -2:]
    keep = val != 0
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    return SparseRows(idx[keep], val[keep], indptr, width)


def _timed_calls(module, names, seconds):
    """Wrap ``module``'s functions ``names`` so that each call adds its wall
    seconds to ``seconds[name]``; returns the originals to restore."""
    saved = {name: getattr(module, name) for name in names}
    for name, fn in saved.items():
        def timed(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                seconds[_name] = seconds.get(_name, 0.0) + time.perf_counter() - t0
        setattr(module, name, timed)
    return saved


def _path_kernels(torch, hh, rates, label, bins_t, g, h, num_bins):
    """histogram.cu's two entries on one fit's bins and iteration-0 stats:
    the combined entry at k = 1 (the root pass) and the node-panel entry at
    k = 8, each bit-equal to its plain version, timed, with its bound."""
    dev = bins_t.device
    n = bins_t.shape[1]
    gen = torch.Generator(device=dev).manual_seed(KERNEL_CHECK_NODES)
    count = torch.ones(n, device=dev)
    recs = {}
    for k, entry in ((1, hh.build_histograms_combined_cuda), (8, hh.build_histograms_cuda)):
        node = (torch.zeros(n, dtype=torch.int32, device=dev) if k == 1 else
                torch.randint(0, k + 1, (n,), device=dev, generator=gen, dtype=torch.int32))
        rec = _hist_record(torch, hh, rates, entry, bins_t, g.contiguous(), h.contiguous(),
                           count, node, k, num_bins, f"{label} k={k}")
        rec["case"] = label
        print(f"kernel on {label} k={k}: " + json.dumps(rec), flush=True)
        recs[k] = rec
        del node
    torch.cuda.empty_cache()
    return recs


def phase_sparse_airline(torch, uh, hh, rates, base, binning, objectives, train, Table,
                         LightGBMClassifier, SparseRows, CSRMatrix, auc, categorical_auc):
    """Phase 10's 10,000,000 airline rows one-hot (phase 11's 674 columns)
    as a sparse features column through LightGBMClassifier.fit with
    featureBundling: the host parts timed apart, peak host RSS and device
    bytes, held-out AUC on 500,000 sparse rows against phase 10's
    categorical fit, predict and SHAP rows/s on CSR rows; histogram.cu on
    the packed columns and iteration-0 stats; then on phase 11's 1,000,000
    rows the sparse fit's model text against the dense fit's."""
    X, y = _airline_data(N_AIR + N_TEST, seed=7)  # phase 10's rows
    t0 = time.perf_counter()
    col = _airline_sparse(SparseRows, X[:N_AIR])
    csr_build_s = time.perf_counter() - t0
    test_col = _airline_sparse(SparseRows, X[N_AIR:])
    ytr, yte = y[:N_AIR], y[N_AIR:]
    del X
    params = dict(numIterations=FIT_ITERS, numLeaves=31, maxBin=NUM_BINS - 1, leafBatch=8,
                  learningRate=0.1, featureBundling=True, device="cuda")
    seconds = {}
    binned = []
    bin_dataset = base.bin_dataset

    def keep_bins(*a, **kw):
        out = bin_dataset(*a, **kw)
        binned.append(out)
        return out

    saved = _timed_calls(binning, ("fit_bin_mapper_csr", "_apply_bins_csr_raw",
                                   "fit_bundles_inplace", "apply_bins_csr"), seconds)
    base.bin_dataset = keep_bins
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(uh, hh)
    try:
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            model = LightGBMClassifier(**params).fit(Table({"features": col, "label": ytr}))
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
    finally:
        base.bin_dataset = bin_dataset
        for name, fn in saved.items():
            setattr(binning, name, fn)
    counts = _counts(uh, hh)
    _need(counts, ("hist_panel", "hist_combined"), "sparse airline fit")
    peak = torch.cuda.max_memory_allocated()
    st = model.fit_stats
    bins, mapper = binned[0]
    spec = mapper.bundles
    if spec is None or spec.num_columns >= col.dim:
        raise AssertionError("the sparse one-hot columns did not bundle")
    t1 = time.perf_counter()
    prob = model.transform(Table({"features": test_col}))["probability"]
    predict_s = time.perf_counter() - t1
    if prob.shape != (N_TEST, 2) or not np.isfinite(prob).all():
        raise AssertionError(f"sparse airline: bad probability column {prob.shape}")
    held_out = auc(yte, prob[:, 1], np.ones(N_TEST))
    if not held_out > 0.6:
        raise AssertionError(f"sparse airline: held-out AUC {held_out}")
    booster = model.booster
    csr = CSRMatrix(test_col.values, test_col.indices, test_col.indptr,
                    (N_TEST, test_col.dim)).row_slice(0, N_SHAP_SPARSE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    shap = booster.features_shap(csr, device="cuda")
    shap_s = time.perf_counter() - t1
    add_err = float(np.abs(shap.sum(-1) - booster.raw_margin(csr, device="cuda")).max())
    if shap.shape != (N_SHAP_SPARSE, 1, col.dim + 1) or not add_err <= 1e-5:
        raise AssertionError(f"sparse airline SHAP: shape {shap.shape}, additivity {add_err}")
    rec = dict(rows=N_AIR, features=col.dim, nnz=col.nnz, csr_bytes=col.indices.nbytes
               + col.values.nbytes + col.indptr.nbytes, columns=spec.num_columns,
               k_before=int(sum(int(w) for w in mapper.num_bins)), k_after=spec.k_packed,
               conflicts=spec.conflict_count, csr_build_s=csr_build_s,
               mapper_s=seconds["fit_bin_mapper_csr"],
               plan_sample_bins_s=seconds["_apply_bins_csr_raw"],
               bundle_plan_s=seconds["fit_bundles_inplace"],
               apply_and_pack_s=seconds["apply_bins_csr"], binning_s=st.binning_seconds,
               upload_s=st.upload_seconds, boosting_s=st.boost_seconds, fit_s=fit_s,
               trees=st.trees, passes=st.passes, host_rss_base=rss.base,
               host_rss_peak=rss.peak, host_rss_growth=rss.peak - rss.base,
               peak_device_bytes=peak, held_out_auc=held_out,
               categorical_fit_auc=categorical_auc, predict_rows_per_s=N_TEST / predict_s,
               shap_rows_per_s=N_SHAP_SPARSE / shap_s, shap_additivity_err=add_err,
               launches=counts)
    print("sparse airline fit: " + json.dumps(rec), flush=True)
    del col, test_col, prob, model
    dev = torch.device("cuda")
    bins_t = train.upload_bins(bins, dev)
    g, h = _iteration0(torch, objectives.get_objective("binary"), ytr, None, dev)
    rec["kernels"] = _path_kernels(torch, hh, rates, "sparse airline packed columns", bins_t,
                                   g, h, spec.num_bins)
    del bins_t, g, h, bins, binned

    # the sparse fit writes the dense fit's model text (phase 11's rows)
    Xa, ya = _airline_data(N_EFB + N_TEST, seed=8)
    texts = {}
    for name, feats in (("sparse", _airline_sparse(SparseRows, Xa[:N_EFB])),
                        ("dense", _one_hot_airline(Xa[:N_EFB]))):
        t0 = time.perf_counter()
        m = LightGBMClassifier(**params).fit(Table({"features": feats, "label": ya[:N_EFB]}))
        texts[name] = (m.get_model_string(), time.perf_counter() - t0, m.fit_stats.binning_seconds)
        del feats, m
    if texts["sparse"][0] != texts["dense"][0]:
        raise AssertionError("the sparse fit's model text differs from the dense fit's")
    rec["check_1m"] = dict(rows=N_EFB, text_equal=True, sparse_fit_s=texts["sparse"][1],
                           sparse_binning_s=texts["sparse"][2], dense_fit_s=texts["dense"][1],
                           dense_binning_s=texts["dense"][2])
    print("sparse airline 1M: " + json.dumps(rec["check_1m"]), flush=True)
    torch.cuda.empty_cache()
    return rec


class _HiggsShardRows:
    """bench.py's HIGGS generator by row range, for
    ShardedDataset.write_shards: ``X[lo:hi]`` and ``y[lo:hi]`` make rows lo
    to hi from a seed of their own (float32 features, float64 labels), so
    the matrix is never in memory whole."""

    def __init__(self, n, seed):
        self.n, self.seed, self._last = n, seed, None
        self.X, self.y = self._Part(self, 0), self._Part(self, 1)

    def rows(self, lo, hi):
        if self._last is None or self._last[0] != (lo, hi):
            X, y = _make_data(hi - lo, N_FEATURES, seed=(self.seed, lo))
            self._last = ((lo, hi), X.astype(np.float32), y)
        return self._last[1:]

    class _Part:
        def __init__(self, owner, i):
            self.owner, self.i = owner, i

        def __len__(self):
            return self.owner.n

        def __getitem__(self, sl):
            return self.owner.rows(sl.start, sl.stop)[self.i]


def _ooc_fit(torch, fit_gbdt_sharded, LightGBMClassifier, ds, bins_path):
    est = LightGBMClassifier(**HIGGS_PARAMS)
    return fit_gbdt_sharded(est, ds, bins_path=bins_path)


def phase_out_of_core(torch, uh, hh, rates, objectives, train, sharded, PartitionLostError,
                      Table, LightGBMClassifier, auc):
    """HIGGS width out of core: 44,000,000 rows written as 22 .npz shards of
    2,000,000 rows (CRC sidecars), then fit_gbdt_sharded on the card: the
    scan, mapper, streamed binning, upload and boosting timed apart, host
    RSS growth over the ingest (below a quarter of the float64 matrix),
    peak device bytes, held-out AUC on 500,000 rows; histogram.cu on the
    memmap's bins and iteration-0 stats. Then a copy of the first 4 shards
    with shard 1 truncated: permissive quarantines it to the dead-letter
    store and writes the model text of a fit over the 3 clean shards;
    failfast raises. Returns the record and what phase 24 reads again: the
    shard paths, the fit's mapper and its memmap's path; the caller
    removes DATA_DIR."""
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    os.makedirs(DATA_DIR)
    free = shutil.disk_usage(DATA_DIR).free
    copy_bytes = OOC_CORRUPT_SHARDS * OOC_SHARD_ROWS * OOC_BYTES_PER_ROW
    fits = (free - copy_bytes - (2 << 30)) // OOC_BYTES_PER_ROW // OOC_SHARD_ROWS
    rows = min(N_OOC, max(OOC_CORRUPT_SHARDS, fits) * OOC_SHARD_ROWS)
    print(f"out of core: {free} bytes free, {rows} rows"
          + (f" (cut from {N_OOC} for disk space)" if rows < N_OOC else ""), flush=True)
    return _out_of_core(torch, uh, hh, rates, objectives, train, sharded,
                        PartitionLostError, Table, LightGBMClassifier, auc, rows)


def _out_of_core(torch, uh, hh, rates, objectives, train, sharded, PartitionLostError, Table,
                 LightGBMClassifier, auc, rows):
    gen = _HiggsShardRows(rows, seed=44)
    t0 = time.perf_counter()
    paths = sharded.ShardedDataset.write_shards(os.path.join(DATA_DIR, "shards"), gen.X, gen.y,
                                                rows_per_shard=OOC_SHARD_ROWS).paths
    write_s = time.perf_counter() - t0
    del gen
    disk = sum(os.path.getsize(p) for p in paths)
    Xte, yte = _make_data(N_TEST, N_FEATURES, seed=(44, rows))
    Xte = Xte.astype(np.float32)
    ds = sharded.ShardedDataset(paths)
    seconds, ingest = {}, {}
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        ds.num_rows
        seconds["scan"] = time.perf_counter() - t0
        for name in ("fit_mapper", "bin_to_memmap"):
            fn = getattr(ds, name)

            def timed(*a, _fn=fn, _name=name, **kw):
                t1 = time.perf_counter()
                out = _fn(*a, **kw)
                seconds[_name] = time.perf_counter() - t1
                if _name == "bin_to_memmap":
                    ingest["peak"] = rss.now()
                    ingest["y"] = out[1]
                else:
                    ingest["mapper"] = out
                return out
            setattr(ds, name, timed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(uh, hh)
        t0 = time.perf_counter()
        model = _ooc_fit(torch, sharded.fit_gbdt_sharded, LightGBMClassifier, ds,
                         os.path.join(DATA_DIR, "bins.u8"))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    counts = _counts(uh, hh)
    _need(counts, ("hist_panel", "hist_combined"), "out-of-core fit")
    peak = torch.cuda.max_memory_allocated()
    st = model.fit_stats
    float64_bytes = rows * N_FEATURES * 8
    growth = ingest["peak"] - rss.base
    if not growth < float64_bytes / 4:
        raise AssertionError(f"out of core: host RSS grew {growth} bytes over the ingest, not "
                             f"below a quarter of the {float64_bytes}-byte float64 matrix")
    t1 = time.perf_counter()
    prob = model.transform(Table({"features": Xte}))["probability"]
    predict_s = time.perf_counter() - t1
    held_out = auc(yte, prob[:, 1], np.ones(N_TEST))
    if not held_out > 0.75:
        raise AssertionError(f"out of core: held-out AUC {held_out}")
    rec = dict(rows=rows, shards=len(paths), shard_bytes_on_disk=disk,
               float64_matrix_bytes=float64_bytes, bins_bytes=rows * N_FEATURES,
               write_s=write_s, scan_s=seconds["scan"], mapper_s=seconds["fit_mapper"],
               bin_s=seconds["bin_to_memmap"], upload_s=st.upload_seconds,
               boosting_s=st.boost_seconds, fit_s=fit_s, trees=st.trees, passes=st.passes,
               host_rss_base=rss.base, host_rss_growth_ingest=growth,
               host_rss_growth_fit=rss.peak - rss.base, peak_device_bytes=peak,
               held_out_auc=held_out, predict_rows_per_s=N_TEST / predict_s, launches=counts)
    print("out-of-core fit: " + json.dumps(rec), flush=True)
    del model, prob
    dev = torch.device("cuda")
    bins = np.memmap(os.path.join(DATA_DIR, "bins.u8"), dtype=np.uint8, mode="r",
                     shape=(rows, N_FEATURES))
    # upload_bins reads a memmap through its file; the same bins as a plain
    # view of the map take the block loop, which maps the file's pages in
    upload, got = {}, {}
    for name, src in (("read_through", bins), ("mapped_blocks", np.asarray(bins))):
        torch.cuda.synchronize()
        with _RssPeak() as rss_up:
            t1 = time.perf_counter()
            got[name] = train.upload_bins(src, dev)
            torch.cuda.synchronize()
            upload[name + "_s"] = time.perf_counter() - t1
        upload[name + "_rss_growth"] = rss_up.peak - rss_up.base
    bins_t = got.pop("read_through")
    if not torch.equal(bins_t, got.pop("mapped_blocks")):
        raise AssertionError("out of core: the two uploads of the memmap differ")
    rec["upload"] = upload
    print("out-of-core upload: " + json.dumps(upload), flush=True)
    g, h = _iteration0(torch, objectives.get_objective("binary"), ingest.pop("y"), None, dev)
    rec["kernels"] = _path_kernels(torch, hh, rates, "out-of-core memmap bins", bins_t, g, h,
                                   NUM_BINS)
    del bins_t, g, h, bins

    # the read modes on a copy of the first 4 shards, shard 1 truncated
    copy_dir = os.path.join(DATA_DIR, "corrupt")
    os.makedirs(copy_dir)
    copies = []
    for p in paths[:OOC_CORRUPT_SHARDS]:
        q = os.path.join(copy_dir, os.path.basename(p))
        shutil.copy(p, q)
        shutil.copy(p + ".crc32", q + ".crc32")
        copies.append(q)
    with open(copies[1], "r+b") as fh:
        fh.truncate(os.path.getsize(copies[1]) // 2)
    dlq = os.path.join(DATA_DIR, "dead_letters")
    permissive = sharded.ShardedDataset(copies, mode="permissive", bad_records_path=dlq)
    text = _ooc_fit(torch, sharded.fit_gbdt_sharded, LightGBMClassifier, permissive,
                    os.path.join(DATA_DIR, "permissive.u8")).get_model_string()
    clean = [q for i, q in enumerate(copies) if i != 1]
    want = _ooc_fit(torch, sharded.fit_gbdt_sharded, LightGBMClassifier,
                    sharded.ShardedDataset(clean),
                    os.path.join(DATA_DIR, "clean.u8")).get_model_string()
    with open(os.path.join(dlq, "manifest", "000000.json")) as fh:
        manifest = json.load(fh)
    if [r.source for r in permissive.quarantined] != [copies[1]] or manifest["count"] != 1:
        raise AssertionError(f"permissive: quarantined {permissive.quarantined}, {manifest}")
    if text != want:
        raise AssertionError("permissive: the fit over the corrupted shards differs from the "
                             "fit over the clean ones")
    try:
        _ooc_fit(torch, sharded.fit_gbdt_sharded, LightGBMClassifier,
                 sharded.ShardedDataset(copies), os.path.join(DATA_DIR, "failfast.u8"))
    except (PartitionLostError, zipfile.BadZipFile) as err:  # a torn zip, or a CRC mismatch
        failfast = f"{type(err).__name__}: {err}"
    else:
        raise AssertionError("failfast: the fit over a truncated shard did not raise")
    rec["read_modes"] = dict(shards=len(copies), permissive_quarantined=[
        r.to_record() for r in permissive.quarantined], dead_letter_manifest=manifest,
        permissive_text_equals_clean=True, failfast=failfast)
    print("out-of-core read modes: " + json.dumps(rec["read_modes"]), flush=True)
    # phase 24 reads the shards and the memmap again; the rest makes room
    shutil.rmtree(copy_dir)
    for name in ("permissive.u8", "clean.u8", "failfast.u8"):
        if os.path.exists(os.path.join(DATA_DIR, name)):
            os.remove(os.path.join(DATA_DIR, name))
    torch.cuda.empty_cache()
    return rec, dict(rows=rows, paths=paths, mapper=ingest["mapper"],
                     bins_path=os.path.join(DATA_DIR, "bins.u8"), bin_s=seconds["bin_to_memmap"])


# -- phase 24: the partition runtime --------------------------------------------

RT_WORKERS = 8  # numExecutors and the scheduled ingest's executors
RT_FAULT_SEED = 24
# Scheduled ingest: 8 tasks of 250,000 rows hold about 8 x 250,000 x 28 x
# (4 + 8 + 1) bytes of float32 reads, float64 rows and bins at once
# (0.73 GB), below the 2.46 GB limit with phase 23's 0.35 GB of labels.
RT_ROWS_PER_TASK = 250_000
RT_WARN_SHARDS = 4  # the memory-pressure run: 4 shards, whole-shard tasks halved
RT_WARN_WORKERS = 2
RT_BATCHES = 4


def _journal_lines(root):
    lines = []
    for d in sorted(os.listdir(root)):
        with open(os.path.join(root, d, "journal.jsonl")) as fh:
            lines += fh.read().splitlines()
    return lines


def phase_runtime(torch, uh, hh, runtime, binning, base, sharded, Table, LightGBMClassifier,
                  auc, higgs, phase5_auc, ooc):
    """The partition runtime on phase 5's 11,000,000 rows and phase 23's
    shards: inline against numExecutors=8 binning (seconds, equal bins); a
    fit binning under an ambient runtime.policy(max_workers=8,
    result_integrity=True) with kill_random_task(8), corrupt_result and a
    host oom_task, under a checkpoint root (phase 5's model text, the
    retries counted, histogram.cu launches); its durable rerun (no journal
    line added, restore seconds, ModelStore.latest); numBatches=4 (held-out
    AUC, _ensemble_margin against the merged booster's raw_margin); the
    44,000,000-row ingest through the scheduler path (the sequential
    pass's bytes, bin seconds, host RSS growth) and a memory-pressure WARN
    run (task count doubled); sample_hbm against torch.cuda's allocator."""
    import filecmp

    X, y = higgs["X"], higgs["y"]
    train_t = Table({"features": X, "label": y})
    want_text = higgs["booster"].model_to_string()
    name = "lightgbmclassificationmodel"
    rec = {}

    # inline against numExecutors=8 binning
    est = LightGBMClassifier(numExecutors=RT_WORKERS, **HIGGS_PARAMS)
    opts = est._make_options()
    t0 = time.perf_counter()
    b_inline, _ = binning.bin_dataset(X, max_bin=opts.max_bin)
    inline_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b_part, _ = est._bin_dataset(X, opts, set())
    part_s = time.perf_counter() - t0
    if b_inline.tobytes() != b_part.tobytes():
        raise AssertionError("runtime: partitioned bins differ from the inline bins")
    rec["binning"] = dict(rows=len(y), inline_s=inline_s, partitioned_s=part_s,
                          executors=RT_WORKERS, tasks=est._runtime_metrics.summary()["tasks_done"],
                          bins_equal=True)
    print("runtime binning: " + json.dumps(rec["binning"]), flush=True)
    del b_inline, b_part

    ckpt = os.path.join(DATA_DIR, "checkpoints")
    saved_root = os.environ.get(runtime.CHECKPOINT_DIR_ENV)
    os.environ[runtime.CHECKPOINT_DIR_ENV] = ckpt
    try:
        # a fit whose binning loses an executor, a result and a task to OOM
        plan = runtime.FaultPlan(seed=RT_FAULT_SEED).kill_random_task(RT_WORKERS)
        (victim, _), = plan._kill
        plan.corrupt_result((victim + 1) % RT_WORKERS)
        plan.oom_task((victim + 2) % RT_WORKERS, kind="host")
        est = LightGBMClassifier(**HIGGS_PARAMS)
        torch.cuda.synchronize()
        _zero_counts(uh, hh)
        t0 = time.perf_counter()
        with runtime.inject_faults(plan), runtime.policy(max_workers=RT_WORKERS,
                                                         result_integrity=True):
            model = est.fit(train_t)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = _counts(uh, hh)
        _need(counts, ("hist_panel", "hist_combined"), "partitioned fit")
        summary = est._runtime_metrics.summary()
        kinds = sorted(k for k, _, _ in plan.fired)
        if kinds != ["corrupt_result", "kill", "oom_host"] or summary["retries_total"] != 3:
            raise AssertionError(f"partitioned fit: fired {plan.fired}, {summary}")
        if model.get_model_string() != want_text:
            raise AssertionError("partitioned fit: the model text differs from phase 5's")
        lines = _journal_lines(os.path.join(ckpt, "binning"))
        if len(lines) != RT_WORKERS:
            raise AssertionError(f"partitioned fit: {len(lines)} journal lines")
        rec["faulted_fit"] = dict(
            fired=plan.fired, retries_total=summary["retries_total"],
            failures={k: summary[k] for k in summary if k.startswith("failures_")},
            binning_s=model.fit_stats.binning_seconds, boosting_s=model.fit_stats.boost_seconds,
            fit_s=fit_s, text_equals_phase5=True, journal_lines=len(lines), launches=counts)
        print("runtime faulted fit: " + json.dumps(rec["faulted_fit"]), flush=True)

        # the durable rerun restores every partition
        est = LightGBMClassifier(numExecutors=RT_WORKERS, **HIGGS_PARAMS)
        t0 = time.perf_counter()
        model = est.fit(train_t)
        torch.cuda.synchronize()
        rerun_s = time.perf_counter() - t0
        recovered = est._runtime_metrics.summary()["tasks_recovered"]
        latest = runtime.ModelStore(os.path.join(ckpt, "models")).latest(name)
        text = model.get_model_string()
        if (_journal_lines(os.path.join(ckpt, "binning")) != lines or recovered != RT_WORKERS
                or text != want_text or latest != (2, text)):
            raise AssertionError(f"durable rerun: {recovered} restored, store {latest and latest[0]}")
        rec["durable_rerun"] = dict(restore_s=model.fit_stats.binning_seconds, fit_s=rerun_s,
                                    tasks_recovered=recovered, journal_lines_added=0,
                                    model_store_version=latest[0], text_equals_phase5=True)
        print("runtime durable rerun: " + json.dumps(rec["durable_rerun"]), flush=True)
    finally:
        if saved_root is None:
            os.environ.pop(runtime.CHECKPOINT_DIR_ENV, None)
        else:
            os.environ[runtime.CHECKPOINT_DIR_ENV] = saved_root

    # numBatches: boosters chained over 4 row batches, merged
    binned = []
    bin_dataset = base.bin_dataset

    def keep_bins(*a, **kw):
        out = bin_dataset(*a, **kw)
        binned.append(out)
        return out

    base.bin_dataset = keep_bins
    _zero_counts(uh, hh)
    try:
        t0 = time.perf_counter()
        model = LightGBMClassifier(numBatches=RT_BATCHES, **HIGGS_PARAMS).fit(train_t)
        torch.cuda.synchronize()
        batches_s = time.perf_counter() - t0
    finally:
        base.bin_dataset = bin_dataset
    counts = _counts(uh, hh)
    _need(counts, ("hist_panel", "hist_combined"), "numBatches fit")
    Xte, yte = higgs["X_test"], higgs["y_test"]
    prob = model.transform(Table({"features": Xte}))["probability"]
    held_out = auc(yte, prob[:, 1], np.ones(len(yte)))
    merged = model.booster
    mapper = binned[0][1]
    em = base._ensemble_margin([merged], binning.apply_bins(Xte, mapper), mapper, "cuda")
    err = float(np.abs(em - merged.raw_margin(Xte, device="cuda")).max())
    if merged.num_trees != RT_BATCHES * FIT_ITERS or not held_out > 0.75 or not err <= 1e-5:
        raise AssertionError(f"numBatches: {merged.num_trees} trees, AUC {held_out}, "
                             f"ensemble margin error {err}")
    rec["num_batches"] = dict(batches=RT_BATCHES, trees=merged.num_trees, fit_s=batches_s,
                              binning_s=model.fit_stats.binning_seconds,
                              boosting_s=model.fit_stats.boost_seconds, held_out_auc=held_out,
                              phase5_auc=phase5_auc, ensemble_margin_max_err=err,
                              launches=counts)
    print("runtime numBatches: " + json.dumps(rec["num_batches"]), flush=True)
    del model, prob, binned, train_t

    # phase 23's ingest through the scheduler path
    paths, mapper, seq_path = ooc["paths"], ooc["mapper"], ooc["bins_path"]
    out = os.path.join(DATA_DIR, "scheduled.u8")
    metrics = runtime.RuntimeMetrics()
    with _RssPeak() as rss:
        t0 = time.perf_counter()
        sharded.ShardedDataset(paths).bin_to_memmap(
            mapper, out_path=out, policy=runtime.SchedulerPolicy(max_workers=RT_WORKERS),
            metrics=metrics, rows_per_task=RT_ROWS_PER_TASK)
        bin_s = time.perf_counter() - t0
        peak = rss.now()
    growth = peak - rss.base
    float64_bytes = ooc["rows"] * N_FEATURES * 8
    tasks = sum(-(-OOC_SHARD_ROWS // RT_ROWS_PER_TASK) for _ in paths)
    if not filecmp.cmp(out, seq_path, shallow=False):
        raise AssertionError("scheduled ingest: the memmap differs from the sequential pass's")
    if not growth < float64_bytes / 4 or metrics.summary()["tasks_done"] != tasks:
        raise AssertionError(f"scheduled ingest: RSS grew {growth} bytes (limit "
                             f"{float64_bytes / 4}), {metrics.summary()['tasks_done']} tasks")
    os.remove(out)
    warn = runtime.RuntimeMetrics()
    prev = runtime.set_pressure_level("memory", runtime.PressureLevel.WARN)
    try:
        t0 = time.perf_counter()
        got, _, _ = sharded.ShardedDataset(paths[:RT_WARN_SHARDS]).bin_to_memmap(
            mapper, out_path=out, policy=runtime.SchedulerPolicy(max_workers=RT_WARN_WORKERS),
            metrics=warn)
        warn_s = time.perf_counter() - t0
    finally:
        runtime.set_pressure_level("memory", prev)
    seq = np.memmap(seq_path, dtype=np.uint8, mode="r", shape=(ooc["rows"], N_FEATURES))
    if (warn.summary()["tasks_done"] != 2 * RT_WARN_SHARDS
            or not np.array_equal(got, seq[:len(got)])):
        raise AssertionError(f"WARN ingest: {warn.summary()['tasks_done']} tasks, or bytes differ")
    del got, seq
    os.remove(out)
    rec["scheduled_ingest"] = dict(
        rows=ooc["rows"], shards=len(paths), executors=RT_WORKERS,
        rows_per_task=RT_ROWS_PER_TASK, tasks=tasks, bin_s=bin_s,
        phase23_sequential_bin_s=ooc["bin_s"], bytes_equal_sequential=True,
        host_rss_base=rss.base, host_rss_growth=growth, host_rss_limit=float64_bytes / 4,
        warn=dict(shards=RT_WARN_SHARDS, executors=RT_WARN_WORKERS,
                  tasks=warn.summary()["tasks_done"], bin_s=warn_s, bytes_equal=True))
    print("runtime scheduled ingest: " + json.dumps(rec["scheduled_ingest"]), flush=True)

    # the card gauge (the profiler's sample_memory: torch.cuda's allocator)
    # against torch.cuda.memory_allocated and mem_get_info's total
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info(0)
    allocated = torch.cuda.memory_allocated(0)
    (dev_name, used, limit), = runtime.sample_hbm()
    if dev_name != "cuda:0" or limit != total or abs(used - allocated) > (1 << 20):
        raise AssertionError(f"sample_hbm {dev_name, used, limit} against memory_allocated "
                             f"{allocated} and mem_get_info {free, total}")
    rec["sample_hbm"] = dict(device=dev_name, bytes_in_use=used, bytes_limit=limit,
                             memory_allocated=allocated, mem_get_info_used=total - free)
    print("runtime sample_hbm: " + json.dumps(rec["sample_hbm"]), flush=True)
    return rec


N_DIRTY_FEATURE = 11_000  # phase 25's rows with a NaN feature
N_DIRTY_LABEL = 1_100  # phase 25's other rows with label -1


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def _sigmoid_grad_hess(torch, margins, y, w):
    """Binary g and h written with ``torch.sigmoid``: the same function
    as the objective's, not its bits (timed against it)."""
    p = torch.sigmoid(margins[:, 0])
    return ((p - y) * w)[:, None], (torch.clamp(p * (1.0 - p), min=1e-16) * w)[:, None]


def _grad_times(torch, objective, y):
    """Median ms of the binary objective's g and h against the
    ``torch.sigmoid`` form at its init score, 20 runs each in turns."""
    dev = torch.device("cuda")
    yd = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    wd = torch.ones_like(yd)
    init = objective.init_score(np.asarray(y, np.float32), 1, np.ones(len(y), np.float32))
    m = torch.as_tensor(init, device=dev)[None, :].expand(len(y), 1).contiguous()
    fns = {"objective": lambda: objective.grad_hess(m, yd, wd),
           "torch_sigmoid": lambda: _sigmoid_grad_hess(torch, m, yd, wd)}
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for _ in range(10):
        for name in ("objective", "torch_sigmoid", "torch_sigmoid", "objective"):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return {f"{k}_ms": statistics.median(v) for k, v in times.items()}


def _dirty(X, y):
    """Phase 25's corrupted copy of (X, y): N_DIRTY_FEATURE seeded rows
    get a NaN feature, N_DIRTY_LABEL others label -1; and the clean rows'
    mask."""
    n = len(y)
    rng = np.random.default_rng(25)
    dirty = rng.choice(n, N_DIRTY_FEATURE + N_DIRTY_LABEL, replace=False)
    nan_rows, label_rows = dirty[:N_DIRTY_FEATURE], dirty[N_DIRTY_FEATURE:]
    Xd, yd = X.copy(), y.copy()
    Xd[nan_rows, rng.integers(0, N_FEATURES, N_DIRTY_FEATURE)] = np.nan
    yd[label_rows] = -1.0
    keep = np.ones(n, dtype=bool)
    keep[dirty] = False
    return Xd, yd, keep


def phase_persistence(torch, uh, hh, rates, base, objectives, train, Table, LightGBMClassifier,
                      LightGBMClassificationModel, Booster, pipeline, guards, events, tracing,
                      higgs):
    """Persistence and the pipeline on phase 5's rows (see the module
    docstring, phase 25). Returns the record, with histogram.cu's entries
    on the fit's bins and iteration-0 stats under "kernels"."""
    X, y = higgs["X"], higgs["y"]
    n = len(y)
    Xd, yd, keep = _dirty(X, y)
    params = dict(HIGGS_PARAMS, numExecutors=RT_WORKERS)
    work = os.path.join(DATA_DIR, "persistence")
    shutil.rmtree(work, ignore_errors=True)  # the event log appends
    os.makedirs(work)
    log_path = os.path.join(work, "events.jsonl")
    tracer = tracing.get_tracer()
    tracer.clear()
    binned = []
    bin_partitioned = base.bin_dataset_partitioned

    def keep_bins(*a, **kw):
        out = bin_partitioned(*a, **kw)
        binned.append(out)
        return out

    guard_s = []
    guard_table = guards.guard_table

    def timed_guard(*a, **kw):
        t = time.perf_counter()
        out = guard_table(*a, **kw)
        guard_s.append(time.perf_counter() - t)
        return out

    rec = {}
    base.bin_dataset_partitioned = keep_bins
    guards.guard_table = timed_guard
    saved_log = os.environ.get("MMLSPARK_TPU_EVENT_LOG")
    os.environ["MMLSPARK_TPU_EVENT_LOG"] = log_path
    try:
        est = LightGBMClassifier(**params)
        pipe = pipeline.Pipeline(stages=[est], invalidDataPolicy="drop")
        _zero_counts(uh, hh)
        t0 = time.perf_counter()
        pm = pipe.fit(Table({"features": Xd, "label": yd}))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = _counts(uh, hh)
    finally:
        base.bin_dataset_partitioned = bin_partitioned
        guards.guard_table = guard_table
        if saved_log is None:
            os.environ.pop("MMLSPARK_TPU_EVENT_LOG", None)
        else:
            os.environ["MMLSPARK_TPU_EVENT_LOG"] = saved_log
        events.get_bus()  # detaches (or re-points) the log sink
    _need(counts, ["hist_panel", "hist_combined"], "persistence pipeline fit")
    if (counts["hist_panel"], counts["hist_combined"]) != (50, 20):
        raise AssertionError(f"persistence: histogram.cu launches {counts}, expected 50 + 20")
    model = pm.getStages()[0]
    st = model.fit_stats
    replayed = events.replay(log_path)
    by_type = {}
    for ev in replayed:
        by_type.setdefault(type(ev).__name__, []).append(ev)
    dead = by_type.get("RecordsDeadLettered", [])
    started = [e for e in by_type.get("StageStarted", []) if e.name == "LightGBMClassifier"]
    completed = [e for e in by_type.get("StageCompleted", [])
                 if e.name == "LightGBMClassifier" and e.status == "ok"]
    committed = [e for e in by_type.get("ModelCommitted", []) if e.model == "PipelineModel"]
    if not (len(dead) == 1 and dead[0].count == N_DIRTY_FEATURE + N_DIRTY_LABEL
            and len(started) == 1 and len(completed) == 1 and len(committed) == 1):
        raise AssertionError(f"persistence: event log {sorted((k, len(v)) for k, v in by_type.items())}")
    spans = {s["name"] for s in tracer.export()}
    if not {"fit:LightGBMClassifier", "lightgbm.binning"} <= spans:
        raise AssertionError(f"persistence: tracer spans {sorted(spans)}")
    text = model.get_model_string()
    t0 = time.perf_counter()
    plain = LightGBMClassifier(**HIGGS_PARAMS).fit(Table({"features": X[keep], "label": y[keep]}))
    plain_fit_s = time.perf_counter() - t0
    if plain.get_model_string() != text:
        raise AssertionError("persistence: the pipeline's model text differs from a plain fit "
                             "of the clean complement")
    del Xd, yd, plain
    if len(guard_s) != 1:
        raise AssertionError(f"persistence: the guard ran {len(guard_s)} times, expected once")
    rec["fit"] = dict(rows=n, rows_dropped=int(dead[0].count), fit_s=fit_s,
                      guard_s=guard_s[0], binning_s=st.binning_seconds, boosting_s=st.boost_seconds,
                      plain_fit_s=plain_fit_s, text_equals_plain_fit=True, launches=counts,
                      events=sorted((k, len(v)) for k, v in by_type.items()),
                      spans=sorted(spans))
    print("persistence pipeline fit: " + json.dumps(rec["fit"]), flush=True)

    # binary g and h at iteration 0: the card's are the CPU's bits
    y_keep = y[keep]
    obj = objectives.get_objective("binary")
    g, h = _iteration0(torch, obj, y_keep, None, torch.device("cuda"))
    g_cpu, h_cpu = _iteration0(torch, obj, y_keep, None, torch.device("cpu"))
    if not (torch.equal(g.cpu(), g_cpu) and torch.equal(h.cpu(), h_cpu)):
        raise AssertionError("persistence: binary g and h on the card differ from the CPU's")
    del g_cpu, h_cpu
    rec["gradient"] = dict(rows=len(y_keep), **_grad_times(torch, obj, y_keep))
    print("persistence gradient: " + json.dumps(rec["gradient"]), flush=True)
    bins, mapper = binned[0]
    bins_t = train.upload_bins(bins, torch.device("cuda"))
    rec["kernels"] = _path_kernels(torch, hh, rates, "pipeline fit bins", bins_t, g, h,
                                   NUM_BINS)
    del bins_t, g, h, bins, binned

    # PipelineModel save, load, transform
    test_t = Table({"features": higgs["X_test"]})
    path = os.path.join(work, "pipeline_model")
    t0 = time.perf_counter()
    pm.save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = pipeline.PipelineModel.load(path)
    load_s = time.perf_counter() - t0
    if loaded.getStages()[0].getDevice() != "cuda":
        raise AssertionError("persistence: a loaded model must predict on the card")
    t0 = time.perf_counter()
    out_loaded = loaded.transform(test_t)
    transform_s = time.perf_counter() - t0
    out = pm.transform(test_t)
    cols = ("rawPrediction", "probability", "prediction")
    if any(out[c].tobytes() != out_loaded[c].tobytes() for c in cols):
        raise AssertionError("persistence: the loaded pipeline's output columns differ")
    # native model text, the JSON dump, importances
    booster = model.booster
    margins = booster.raw_margin(higgs["X_test"])
    native = os.path.join(work, "model.txt")
    model.save_native_model(native)
    # model text folds the init score into tree 0's leaves in float64, so a
    # margin moves by float32 rounding of the leaf sums: held within 1e-6 of
    # the margins' scale (a margin near 0 has no relative accuracy to keep)
    scale = float(np.abs(margins).max())
    text_err = {}
    for label, m in (("load_native_model",
                      LightGBMClassificationModel.load_native_model(native)),
                     ("from_model_string",
                      LightGBMClassificationModel.from_model_string(text))):
        err = float(np.abs(m.booster.raw_margin(higgs["X_test"]) - margins).max())
        text_err[label] = err
        if not err <= 1e-6 * scale:
            raise AssertionError(f"persistence: {label} margins off by {err} "
                                 f"(scale {scale})")
    from_json = Booster.from_string(booster.to_json_string())
    if from_json.raw_margin(higgs["X_test"]).tobytes() != margins.tobytes():
        raise AssertionError("persistence: margins through the JSON dump differ")
    for kind in ("split", "gain"):
        if not np.array_equal(model.get_feature_importances(kind),
                              booster.feature_importances(kind)):
            raise AssertionError(f"persistence: {kind} importances differ")
    rec["persist"] = dict(save_s=save_s, load_s=load_s, bytes_on_disk=_dir_bytes(path),
                          native_text_bytes=os.path.getsize(native),
                          transform_rows=len(higgs["X_test"]), transform_s=transform_s,
                          columns_bit_equal=True, margin_scale=scale,
                          text_margin_max_abs_err=text_err,
                          json_margins_bit_equal=True, importances_equal=True)
    print("persistence save/load: " + json.dumps(rec["persist"]), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return rec


# -- phase 26: observability ---------------------------------------------------

#: the boosting step's regions (``train._region``) phase 26 splits time by
STEP_REGIONS = ("gbdt.gradient", "gbdt.histogram", "gbdt.subtraction", "gbdt.split_search",
                "gbdt.sync", "gbdt.routing", "gbdt.tree_update", "gbdt.margin_update")
N_QUALITY = 2_000_000  # the quality-plane Pipeline fit's rows: phase 25's, cut for the budget
QUALITY_SHIFT_SIGMA = 1.0  # feature 0's shift, in its standard deviations
ROOFLINE_REPS = 10  # profiled histogram.cu calls per entry


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _trace_breakdown(path):
    """From a Chrome trace of a profiled fit: device time by kernel name,
    device time and host time by step region (a kernel belongs to the
    innermost region open on the host when it was launched), the device's
    busy share of the ``gbdt.step`` windows and their five longest idle
    gaps with the host region at each gap's middle. None when the trace
    holds no device activity."""
    import bisect

    with open(path, encoding="utf-8") as fh:
        trace = json.load(fh)
    evs = [e for e in (trace["traceEvents"] if isinstance(trace, dict) else trace)
           if e.get("ph") == "X"]
    dev = [e for e in evs if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        return None
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in evs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    ann = [e for e in evs if e.get("cat") == "user_annotation"
           and e.get("name", "").startswith("gbdt.")]
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in ann if e["name"] == "gbdt.step")
    inner = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ann
                   if e["name"] in STEP_REGIONS)
    starts = [r[0] for r in inner]

    def region_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < inner[i][1]:
            return inner[i][2]
        j = bisect.bisect_right([w[0] for w in steps], t) - 1
        return "gbdt.step (other)" if j >= 0 and t < steps[j][1] else "outside the step"

    by_kernel, by_region = {}, {}
    busy = []
    for e in dev:
        k = by_kernel.setdefault(e["name"][:90], [0, 0.0])
        k[0] += 1
        k[1] += e["dur"]
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        region = region_at(t) if t is not None else "unattributed"
        r = by_region.setdefault(region, {"device_ms": 0.0, "kernels": 0, "host_ms": 0.0})
        r["device_ms"] += e["dur"] / 1e3
        r["kernels"] += 1
        busy.append((e["ts"], e["ts"] + e["dur"]))
    for a, b, name in inner:
        by_region.setdefault(name, {"device_ms": 0.0, "kernels": 0, "host_ms": 0.0})
        by_region[name]["host_ms"] += (b - a) / 1e3
    window = sum(b - a for a, b in steps)
    merged = _union(busy)
    busy_us, gaps = 0.0, []
    for a, b in steps:
        cur = a
        for x, y in merged:
            if y <= a or x >= b:
                continue
            x, y = max(x, a), min(y, b)
            if x > cur:
                gaps.append((x - cur, cur, x))
            busy_us += y - x
            cur = max(cur, y)
        if b > cur:
            gaps.append((b - cur, cur, b))
    gaps.sort(reverse=True)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(
        window_ms=window / 1e3, steps=len(steps),
        device_busy_share=busy_us / window if window else None,
        idle_share=1.0 - busy_us / window if window else None,
        top_kernels=[dict(name=n, launches=c, device_ms=us / 1e3) for n, (c, us) in top],
        regions={k: dict(v) for k, v in sorted(by_region.items())},
        idle_gaps=[dict(ms=d / 1e3, host_region=region_at((a + b) / 2)) for d, a, b in gaps[:5]],
        hist_kernel=[by_kernel.get(n, [0, 0.0]) for n in by_kernel if "hist_kernel" in n],
        hist_finalize=[by_kernel.get(n, [0, 0.0]) for n in by_kernel if "hist_finalize" in n],
    )


def _event_regions(torch, train):
    """Replace the step's regions with CUDA-event pairs (the fallback when
    the profiler's trace has no device activity); returns the booked
    (name, start, end) list and the function that restores the regions."""
    booked, original = [], train._region

    class _Timed:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

        def __exit__(self, *exc):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            booked.append((self.name, self.start, end))

    train._region = lambda on, name: _Timed(name) if on else original(on, name)
    return booked, lambda: setattr(train, "_region", original)


def _profile_fit(torch, uh, hh, train, profiler, profiling, rates, higgs, fit_rec, work):
    """Phase 5's fit on its bins, unprofiled and profiled, with the trace's
    breakdown; then histogram.cu's entries through DeviceProfiler.wrap for
    its roofline rows."""
    bins, mapper, y = higgs["bins"], higgs["mapper"], higgs["y"]
    opts = train.TrainOptions(objective="binary", num_iterations=FIT_ITERS, num_leaves=31,
                              learning_rate=0.1, max_bin=NUM_BINS - 1, leaf_batch=8)
    prof = profiler.get_profiler()
    prof.disable()
    prof.clear()
    quiet = train.train(bins, y, opts, mapper=mapper, device="cuda")
    torch.cuda.synchronize()
    _zero_counts(uh, hh)
    trace_dir = os.path.join(work, "trace")
    prof.enable()
    try:
        with profiling.profile_trace(trace_dir) as tp:
            loud = train.train(bins, y, opts, mapper=mapper, device="cuda")
            torch.cuda.synchronize()
    finally:
        prof.disable()
    counts = _counts(uh, hh)
    if (counts["hist_panel"], counts["hist_combined"]) != (50, 20):
        raise AssertionError(f"observability: profiled fit launches {counts}, expected 50 + 20")
    if loud.booster.model_to_string() != quiet.booster.model_to_string():
        raise AssertionError("observability: the profiled fit's model text differs")
    # device time by name from key_averages(), kernels and ops only (the
    # gbdt.* rows are the regions' device-side spans)
    key_dev = sorted(((e.key[:90], e.count, e.self_device_time_total / 1e3)
                      for e in tp.key_averages()
                      if e.self_device_time_total > 0 and not e.key.startswith("gbdt.")),
                     key=lambda r: -r[2])
    trace_file = max((os.path.join(trace_dir, f) for f in os.listdir(trace_dir)),
                     key=os.path.getmtime)
    breakdown = _trace_breakdown(trace_file) if key_dev else None
    st, lst = quiet.stats, loud.stats
    rec = dict(rows=len(y), quiet_boosting_s=st.boost_seconds, profiled_boosting_s=lst.boost_seconds,
               text_equal=True, launches=counts, host_syncs_per_tree=st.syncs / st.trees,
               trace_mb=os.path.getsize(trace_file) / 1e6,
               key_averages_top10=[dict(name=n, calls=c, device_ms=ms)
                                   for n, c, ms in key_dev[:10]])
    phase5_per_launch = fit_rec["hist_ms"] / (50 + 20)
    if breakdown is not None:
        n_hist = sum(c for c, _ in breakdown["hist_kernel"])
        hist_us = sum(us for _, us in breakdown["hist_kernel"] + breakdown["hist_finalize"])
        if n_hist != 70:
            raise AssertionError(f"observability: the trace holds {n_hist} hist_kernel launches")
        rec.update(device_time_source="torch.profiler", **{
            k: breakdown[k] for k in ("window_ms", "steps", "device_busy_share", "idle_share",
                                      "top_kernels", "regions", "idle_gaps")})
        rec["histogram_cu"] = dict(launches=n_hist, device_ms=hist_us / 1e3,
                                   ms_per_launch=hist_us / 1e3 / n_hist,
                                   phase5_cuda_event_ms_per_launch=phase5_per_launch)
    else:
        # no device activity in the trace: time the regions with CUDA events
        booked, restore = _event_regions(torch, train)
        prof.enable()
        try:
            train.train(bins, y, opts, mapper=mapper, device="cuda")
            torch.cuda.synchronize()
        finally:
            prof.disable()
            restore()
        regions = {}
        for name, a, b in booked:
            r = regions.setdefault(name, {"device_ms": 0.0, "calls": 0})
            r["device_ms"] += a.elapsed_time(b)
            r["calls"] += 1
        rec.update(device_time_source="cuda_events", idle_share=None,
                   idle_share_reason="key_averages() showed no device time", regions=regions,
                   histogram_cu=dict(launches=70, phase5_cuda_event_ms_per_launch=phase5_per_launch))
    print("observability profiled fit: " + json.dumps(rec), flush=True)

    # histogram.cu's entries through DeviceProfiler.wrap: roofline rows
    dev = torch.device("cuda")
    bins_t = train.upload_bins(bins, dev)
    g, h = _iteration0(torch, train.get_objective("binary"), y, None, dev)
    count = torch.ones_like(g)
    gen = torch.Generator(device=dev).manual_seed(26)
    node8 = torch.randint(0, 8, (len(y),), device=dev, dtype=torch.int32, generator=gen)
    prof.enable()
    try:
        for name, fn, node, k in (
                ("histogram.cu panel k=8", hh.build_histograms_cuda, node8, 8),
                ("histogram.cu combined k=1", hh.build_histograms_combined_cuda,
                 torch.zeros_like(node8), 1)):
            wrapped = prof.wrap(fn, name=name, cost=hh.histogram_cost)
            for _ in range(ROOFLINE_REPS + 1):
                wrapped(bins_t, g, h, count, node, k, NUM_BINS)
        snap = prof.snapshot()
    finally:
        prof.disable()
    del bins_t, g, h, count, node8
    torch.cuda.empty_cache()
    rows = [r for r in snap["roofline"] if r["name"].startswith("histogram.cu")]
    if len(rows) != 2 or not all(r["bound"] == "memory" for r in rows):
        raise AssertionError(f"observability: roofline rows {rows}")
    roof = dict(platform=snap["platform"], peak_flops_per_s=snap["peak_flops_per_s"],
                peak_hbm_bytes_per_s=snap["peak_hbm_bytes_per_s"], device=snap["device"],
                rows=snap["roofline"])
    print("observability roofline: " + json.dumps(roof), flush=True)
    rec["roofline"] = roof
    return rec


def _scheduler_events(torch, runtime, events, tracing, Table, LightGBMClassifier, higgs, work):
    """Phase 24's numExecutors=8 fit with one killed executor under an
    event log: the timeline's task counts equal RuntimeMetrics.summary(),
    the failed attempt's span carries its status."""
    log_path = os.path.join(work, "events.jsonl")
    tracer = tracing.get_tracer()
    tracer.clear()
    plan = runtime.FaultPlan(seed=RT_FAULT_SEED).kill_random_task(RT_WORKERS)
    est = LightGBMClassifier(numExecutors=RT_WORKERS, **HIGGS_PARAMS)
    saved_log = os.environ.get("MMLSPARK_TPU_EVENT_LOG")
    os.environ["MMLSPARK_TPU_EVENT_LOG"] = log_path
    try:
        t0 = time.perf_counter()
        with runtime.inject_faults(plan):
            model = est.fit(Table({"features": higgs["X"], "label": higgs["y"]}))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        if saved_log is None:
            os.environ.pop("MMLSPARK_TPU_EVENT_LOG", None)
        else:
            os.environ["MMLSPARK_TPU_EVENT_LOG"] = saved_log
        events.get_bus()  # detaches (or re-points) the log sink
    if model.get_model_string() != higgs["booster"].model_to_string():
        raise AssertionError("observability: the killed-executor fit's text differs from phase 5's")
    summary = est._runtime_metrics.summary()
    tl = events.timeline(events.replay(log_path))
    tasks = tl["tasks"]
    got = (tasks["dispatched"], tasks["retried"], tasks["failed"])
    want = (summary["dispatches"], summary["retries_total"], summary["failures_total"])
    if got != want or [k for k, _, _ in plan.fired] != ["kill"] or want[1] != 1:
        raise AssertionError(f"observability: timeline tasks {got} against metrics {want}, "
                             f"fired {plan.fired}")
    failed = [(tid, a["reason"]) for tid, atts in tasks["attempts"].items() for a in atts]
    spans = [sp for sp in tracer.export() if sp["name"].startswith("task-")]
    span_status = sorted({sp["status"] for sp in spans})
    if len(failed) != 1 or failed[0][1] not in span_status:
        raise AssertionError(f"observability: failed attempts {failed}, span statuses {span_status}")
    text = events.format_timeline(tl)
    print("observability timeline:\n" + text, flush=True)
    rec = dict(fit_s=fit_s, dispatched=got[0], retried=got[1], failed=got[2],
               failed_attempt=dict(task=failed[0][0], reason=failed[0][1]),
               attempt_spans=len(spans), span_statuses=span_status,
               job_spans=sum(sp["name"] == "scheduler.job" for sp in tracer.export()))
    print("observability scheduler: " + json.dumps(rec), flush=True)
    return rec


def _quality_plane(torch, pipeline, quality, runtime, events, Table, LightGBMClassifier, higgs,
                   work):
    """Phase 25's Pipeline fit on N_QUALITY rows under a quality store: the
    reference profile committed and read back through its CRC; 500,000
    held-out rows drift nowhere, the same rows with feature 0 shifted do
    (and the incident recorder writes its bundle); outputs bit-equal with
    the monitor off."""
    X, y = higgs["X"][:N_QUALITY], higgs["y"][:N_QUALITY]
    Xd, yd, _ = _dirty(X, y)
    store_dir = os.path.join(work, "quality")
    incident_dir = os.path.join(work, "incidents")
    saved = {k: os.environ.get(k) for k in ("MMLSPARK_TPU_QUALITY_STORE",
                                           "MMLSPARK_TPU_INCIDENT_DIR")}
    os.environ["MMLSPARK_TPU_QUALITY_STORE"] = store_dir
    os.environ["MMLSPARK_TPU_INCIDENT_DIR"] = incident_dir
    seen = []
    bus = events.get_bus()
    bus.add_listener(seen.append)
    try:
        pipe = pipeline.Pipeline(stages=[LightGBMClassifier(numExecutors=RT_WORKERS,
                                                            **HIGGS_PARAMS)],
                                 invalidDataPolicy="drop")
        t0 = time.perf_counter()
        pm = pipe.fit(Table({"features": Xd, "label": yd}))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        store = runtime.ModelStore(store_dir)
        artifacts = sorted(f for f in os.listdir(store_dir) if f.endswith(".quality.json"))
        if len(artifacts) != 1 or not os.path.exists(os.path.join(store_dir,
                                                                   artifacts[0] + ".crc32")):
            raise AssertionError(f"observability: quality store holds {artifacts}")
        version = int(artifacts[0].split("-")[1].split(".")[0])
        profile = quality.load_profile(store, "model", version)
        if profile is None:
            raise AssertionError("observability: the reference profile failed its CRC read")
        monitor = quality.get_monitor()
        if monitor is None or monitor.version != version:
            raise AssertionError("observability: no monitor on the committed profile")
        Xte = higgs["X_test"]
        shifted = Xte.copy()
        shifted[:, 0] += QUALITY_SHIFT_SIGMA * float(X[:, 0].std())
        drift = {}
        outs = {}
        for label, rows in (("unshifted", Xte), ("shifted", shifted)):
            seen.clear()
            t0 = time.perf_counter()
            outs[label] = pm.transform(Table({"features": rows}))
            drift[label] = dict(
                transform_s=time.perf_counter() - t0,
                detected=sorted(e.feature for e in seen if type(e).__name__ == "DriftDetected"),
                incidents=[e.path for e in seen if type(e).__name__ == "IncidentRecorded"])
        if drift["unshifted"]["detected"] or "features[0]" not in drift["shifted"]["detected"]:
            raise AssertionError(f"observability: drift {drift}")
        inputs = [f for f in drift["shifted"]["detected"] if f.startswith("features[")]
        if inputs != ["features[0]"] or len(drift["shifted"]["incidents"]) != 1:
            raise AssertionError(f"observability: drift {drift}")
        bundle = drift["shifted"]["incidents"][0]
        with open(os.path.join(bundle, "manifest.json"), encoding="utf-8") as fh:
            manifest = json.load(fh)
        if manifest["trigger"] != "drift_detected":
            raise AssertionError(f"observability: incident manifest {manifest}")
    finally:
        bus.remove_listener(seen.append)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        quality.install_monitor(None)
        from mmlspark_tpu_torch.observability import incidents

        incidents.get_recorder()  # uninstalls the recorder
    cols = ("rawPrediction", "probability", "prediction")
    for label, rows in (("unshifted", Xte), ("shifted", shifted)):
        t0 = time.perf_counter()
        off = pm.transform(Table({"features": rows}))
        drift[label]["transform_off_s"] = time.perf_counter() - t0
        if any(off[c].tobytes() != outs[label][c].tobytes() for c in cols):
            raise AssertionError("observability: the monitored transform's outputs differ")
    rec = dict(rows=N_QUALITY, fit_s=fit_s, profile_version=version,
               profile_features=len(profile.features), artifact=artifacts[0],
               transform_rows=len(Xte), drift=drift, incident_files=sorted(os.listdir(bundle)),
               outputs_bit_equal=True)
    print("observability quality: " + json.dumps(rec), flush=True)
    return rec


def _watchdog_memory(torch, runtime, registry):
    """ResourceWatchdog.poll() on the card: the profiler's device-memory
    gauges against torch.cuda's allocator counts."""
    ballast = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")  # a known allocation
    runtime.ResourceWatchdog(checkpoint_dir=None, eventlog_dir=None).poll()
    reg = registry.get_registry()
    in_use = reg.get("profiler_hbm_bytes_in_use").labels(device="cuda:0").value
    peak = reg.get("profiler_hbm_bytes_peak").labels(device="cuda:0").value
    want = (torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated())
    del ballast
    rec = dict(hbm_bytes_in_use=in_use, memory_allocated=want[0], hbm_bytes_peak=peak,
               max_memory_allocated=want[1])
    if abs(in_use - want[0]) > (1 << 20) or abs(peak - want[1]) > (1 << 20):
        raise AssertionError(f"observability: watchdog gauges {rec}")
    print("observability watchdog: " + json.dumps(rec), flush=True)
    return rec


def phase_observability(torch, uh, hh, train, runtime, pipeline, events, tracing, Table,
                        LightGBMClassifier, rates, higgs, fit_rec):
    """Phase 26 (see the module docstring)."""
    from mmlspark_tpu_torch.core import profiling
    from mmlspark_tpu_torch.observability import profiler, quality, registry

    work = os.path.join(DATA_DIR, "observability")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rec = dict(
        fit=_profile_fit(torch, uh, hh, train, profiler, profiling, rates, higgs, fit_rec, work),
        scheduler=_scheduler_events(torch, runtime, events, tracing, Table, LightGBMClassifier,
                                    higgs, work),
        quality=_quality_plane(torch, pipeline, quality, runtime, events, Table,
                               LightGBMClassifier, higgs, work),
        watchdog=_watchdog_memory(torch, runtime, registry))
    shutil.rmtree(work, ignore_errors=True)
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
    from mmlspark_tpu_torch import runtime
    from mmlspark_tpu_torch.data import sharded
    from mmlspark_tpu_torch.data.sparse import CSRMatrix, SparseRows
    from mmlspark_tpu_torch.data.table import Table
    from mmlspark_tpu_torch.kernels import sass_atomics
    from mmlspark_tpu_torch.kernels.build import histogram_extension
    from mmlspark_tpu_torch.lightgbm import (
        LightGBMClassificationModel,
        LightGBMClassifier,
        LightGBMRanker,
        LightGBMRegressor,
        base,
        binning,
        bundling,
        callbacks,
        objectives,
        ranker,
        train,
    )
    from mmlspark_tpu_torch.lightgbm.booster import Booster
    from mmlspark_tpu_torch.lightgbm.objectives import auc
    from mmlspark_tpu_torch.core import pipeline
    from mmlspark_tpu_torch.dataguard import guards
    from mmlspark_tpu_torch.observability import events, profiler, tracing
    from mmlspark_tpu_torch.ops import histogram
    from mmlspark_tpu_torch.ops import hopper_histogram as hh
    from mmlspark_tpu_torch.ops import u_histogram as uh
    from mmlspark_tpu_torch.runtime.lineage import PartitionLostError

    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}",
          flush=True)
    rates = _rates(profiler, kind)

    t0 = time.perf_counter()
    histogram_extension()
    print(f"build: histogram.cu, u_histogram.cu, bin_scatter.cu for sm_90a in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for src, ops in sass_atomics.atomics().items():
        print("sass: " + json.dumps({"source": src, "atomics": ops}), flush=True)
        if any(op.startswith(sass_atomics.CAS_LOOP) for op in ops):
            raise AssertionError(f"{src} compiled an atomic to a compare-and-swap loop: {ops}")

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 matmuls are on: the split search's float32 products "
                             "would round to TF32")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}", flush=True)

    def timed(name, fn, *args):
        t_phase = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t_phase:.3f} s", flush=True)
        return out

    kernel = timed("kernel", phase_kernel, torch, hh, rates)
    timed("parity", phase_parity, torch, hh, histogram, binning, train)
    fit, higgs = timed("fit", phase_fit, torch, hh, histogram, base, Table, LightGBMClassifier,
                       auc, N_FIT)
    packed, entry_launches = timed("packed_kernels", phase_packed_kernels, torch, uh, hh, rates)
    timed("u_parity", phase_u_parity, torch, uh, hh, binning, train)
    u_fit, u_text = timed("u_fit_1m", phase_u_fit, torch, uh, hh, binning, train, auc, N_U)
    u_fit_chunked, _ = timed("u_fit_11m", phase_u_fit, torch, uh, hh, binning, train, auc, N_FIT)
    if u_fit["histogram_path"] != "u" or u_fit_chunked["histogram_path"] != "u_chunked":
        raise AssertionError("the U fits did not take the resident and chunked passes")
    categorical = timed("categorical", phase_categorical, torch, uh, hh, binning, train, Table,
                        LightGBMClassifier, auc)
    timed("bundling", phase_bundling, torch, uh, hh, binning, bundling, train, auc)
    timed("oom", phase_oom, torch, uh, hh, runtime, binning, train, u_text)
    _, es_model, X_es, y_es = timed("early_stopping", phase_early_stopping, torch, uh, hh,
                                    binning, train, callbacks, Table, LightGBMClassifier, auc)
    timed("warm_start", phase_warm_start, torch, uh, hh, Table, LightGBMClassifier, Booster,
          es_model, X_es, y_es)
    del es_model, X_es, y_es
    timed("quant_noise", phase_quant_noise, torch, uh, hh, binning, train)
    _, cover = timed("multiclass", phase_multiclass, torch, uh, hh, binning, train, objectives,
                     Table, LightGBMClassifier)
    types = timed("boosting_types", phase_boosting_types, torch, uh, hh, train, auc, higgs)
    explain_boosters = [("higgs", higgs["booster"], higgs["X_test"]),
                        ("covertype", cover["booster"], cover["X_test"])]
    del cover
    timed("regression", phase_regression, torch, uh, hh, binning, train, objectives, Table,
          LightGBMRegressor)
    timed("insurance", phase_insurance, torch, uh, hh, binning, objectives, Table,
          LightGBMRegressor)
    timed("lambdarank", phase_lambdarank, torch, uh, hh, binning, ranker, Table, LightGBMRanker)
    timed("explain", phase_explain, torch, Table, LightGBMClassificationModel, Booster,
          explain_boosters)
    del explain_boosters
    sparse_fit = timed("sparse_airline", phase_sparse_airline, torch, uh, hh, rates, base, binning,
                       objectives, train, Table, LightGBMClassifier, SparseRows, CSRMatrix, auc,
                       categorical["categorical"]["held_out_auc"])
    try:
        ooc_fit, ooc = timed("out_of_core", phase_out_of_core, torch, uh, hh, rates, objectives,
                             train, sharded, PartitionLostError, Table, LightGBMClassifier, auc)
        timed("runtime", phase_runtime, torch, uh, hh, runtime, binning, base, sharded, Table,
              LightGBMClassifier, auc, higgs, fit["held_out_auc"], ooc)
        persist = timed("persistence", phase_persistence, torch, uh, hh, rates, base, objectives,
                        train, Table, LightGBMClassifier, LightGBMClassificationModel, Booster,
                        pipeline, guards, events, tracing, higgs)
        timed("observability", phase_observability, torch, uh, hh, train, runtime, pipeline,
              events, tracing, Table, LightGBMClassifier, rates, higgs, fit)
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    del higgs

    if entry_launches == 0:
        raise AssertionError("build_histograms_bin_scatter did not launch bin_scatter")
    csrc = "mmlspark_tpu_torch/kernels/csrc/"
    entries = []
    for name, src, replaces, launches, r in (
        ("hist_panel", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:86",
         fit["launches"]["panel"], kernel[8]),
        ("hist_combined", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:177",
         fit["launches"]["combined"], kernel[1]),
        ("u_panel_dot", "u_histogram.cu", "mmlspark_tpu/ops/u_histogram.py:361",
         u_fit["u_pass_launches"], packed[("u_panel_dot", 8, "quant")]),
        ("bin_scatter", "bin_scatter.cu", "mmlspark_tpu/ops/pallas_histogram.py:260",
         u_fit_chunked["bin_scatter_launches"], packed[("bin_scatter_stack", 8, "quant")]),
        # depthwise levels 6 and 7 of the max_depth 8 fit, in node groups
        ("hist_panel_k64_grouped", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:86",
         types["depthwise_8"]["level_launches"][6], kernel[64]),
        ("hist_panel_k128_grouped", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:86",
         types["depthwise_8"]["level_launches"][7], kernel[128]),
        # the sparse one-hot airline fit's packed columns, the out-of-core
        # fit's memmap bins; each on its fit's iteration-0 stats
        ("hist_panel_sparse_airline", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:86",
         sparse_fit["launches"]["hist_panel"], sparse_fit["kernels"][8]),
        ("hist_combined_sparse_airline", "histogram.cu",
         "mmlspark_tpu/ops/pallas_histogram.py:177", sparse_fit["launches"]["hist_combined"],
         sparse_fit["kernels"][1]),
        ("hist_panel_out_of_core", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:86",
         ooc_fit["launches"]["hist_panel"], ooc_fit["kernels"][8]),
        ("hist_combined_out_of_core", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:177",
         ooc_fit["launches"]["hist_combined"], ooc_fit["kernels"][1]),
        # the persistence phase's Pipeline fit, on its bins and iteration-0 stats
        ("hist_panel_pipeline", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:86",
         persist["fit"]["launches"]["hist_panel"], persist["kernels"][8]),
        ("hist_combined_pipeline", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:177",
         persist["fit"]["launches"]["hist_combined"], persist["kernels"][1]),
    ):
        if launches == 0:
            raise AssertionError(f"{name} was not launched on its path")
        entries.append(dict(
            name=name, route="cuda", source=csrc + src, replaces=replaces,
            launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
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
