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
14. Warm start: phase 13's model continued for 5 iterations on the first
   2,000,000 of its training rows (cut from 11,000,000 for the script's
   time) through modelString and through initScoreCol holding the raw
   margins of the model that text holds; the two delta boosters' model
   texts are equal.
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
22. Sparse input: phase 10's first 5,000,000 airline rows one-hot (phase 11's
   674 columns) as a SparseRows features column, built from the codes (the
   dense matrix never exists), through LightGBMClassifier.fit with
   featureBundling: CSR build, mapper, bundle plan, apply-and-pack,
   upload and boosting seconds, peak host RSS and device bytes, held-out
   AUC on 500,000 sparse rows beside phase 10's categorical fit, predict
   rows/s on them and SHAP rows/s on 10,000 CSR rows (SHAP adds up to the
   margin within 1e-5); histogram.cu at k = 1 and 8 on the packed columns
   and the fit's iteration-0 stats, bit-equal to the plain version, timed
   with its bound. Then the first 125,000 of phase 11's rows fitted sparse
   and dense (cut from 1,000,000, then 250,000, for the script's time):
   the same model text.
23. Out of core: 22,000,000 HIGGS-width rows (float32) written by
   ShardedDataset.write_shards as 11 .npz shards of 2,000,000 rows with CRC
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
   11,000,000 rows: numExecutors=8 binning against phase 5's inline
   binning of the same rows (its bins and binning seconds, read again
   rather than binned twice: seconds of each, equal bins); a
   fit binning under an ambient
   runtime.policy(max_workers=8, result_integrity=True) with
   kill_random_task(8), corrupt_result and a host oom_task, under a
   checkpoint root in smoke_data/ (phase 5's model text, 3 retries, the
   histogram.cu launches of the fit); its durable rerun (no journal line
   added, restore seconds, ModelStore.latest holds the text); numBatches=4
   (held-out AUC on phase 5's 500,000 rows, _ensemble_margin on the card
   within 1e-5 of the merged booster's raw_margin). Then phase 23's shards
   through the scheduler path of bin_to_memmap (8 executors, tasks of
   250,000 rows): the sequential pass's bytes, bin seconds, host RSS growth
   below the same limit; a memory-pressure WARN run on 2 shards halves each
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
   Then phase 25's Pipeline fit on its first 1,000,000 rows (cut for the
   phase's budget) under MMLSPARK_TPU_QUALITY_STORE and
   MMLSPARK_TPU_INCIDENT_DIR: the reference profile committed and read back
   through its CRC; a transform of phase 5's 500,000 held-out rows drifts
   nowhere, the same rows with feature 0 shifted by one standard deviation
   drift on features[0] (and on no other input) and the incident recorder
   writes its bundle; transform times with the monitor on and off, outputs
   bit-equal. Then ResourceWatchdog.poll(): the profiler's device-memory
   gauges within 1 MiB of torch.cuda.memory_allocated() and
   max_memory_allocated().
27. Distribution on phase 5's 11,000,000 bins (no second binning; 28
   features, 255 bins, 31 leaves, 10 iterations), after the card's compute
   mode (nvidia-smi; it must be Default: the process group's workers each
   open a CUDA context on the card). Meshes of 4 data slots, every slot on
   the card: train(mesh=...) data-parallel (text within model_texts_close
   of phase 5's), voting-parallel with topK 20, and MeshConfig(data=2,
   model=2) (split features equal phase 5's); per fit the boosting
   seconds, the histogram.cu launches (one per pass and slot) and the
   held-out AUC on phase 5's 500,000 rows. Voting on the first 50,000
   rows (cut from 200,000, then 100,000, for the script's time) on the card
   and on 4 CPU slots: equal text. histogram.cu on the
   first shard's bins and the fit's iteration-0 stats at k = 1 and 8,
   bit-equal to the plain version, timed, with the bound. Then
   LightGBMClassifier(numProcesses=2) on the same rows: 2 worker processes
   share the card, each loading the kernels built in phase 2; the fit
   seconds, each member's allreduce calls and seconds and histogram.cu
   launches; the text within model_texts_close of phase 5's. The same fit
   under FaultPlan(seed=11).kill_process(1, iteration=3): 2 epochs, 3
   recovered iterations, the undisturbed text byte for byte, one
   ProcessLost and one GroupReformed in its event log (under
   smoke_data/). Then a 2-process fit of the first 50,000 rows (cut from
   200,000, then 100,000) on the card and on the CPU port: equal text.
28. Many models (lightgbm.train.train_many, mmlspark_tpu_torch.sweep and
   automl), after the compute-mode check of phase 27. (a) train_many on
   the bins of phase 5's first 1,000,000 rows (cut from 11,000,000, then
   4,000,000 and 2,000,000, for the script's time), K = 4 (learning rate 0.05, 0.1, 0.2, and 0.1 with
   feature and bagging fraction 0.8, bagging every iteration): each
   candidate's text equals its own train() fit's byte for byte; 200 + 80
   histogram.cu launches; the bucket's seconds beside the four train()
   calls'; each candidate's held-out AUC. (b) An inline TrainValidSweep of
   LightGBMClassifier over GridSpace(learningRate 0.05/0.1/0.2 x numLeaves
   15/31) on phase 5's first 1,000,000 rows as a Table (cut from 11,000,000,
   then 4,000,000 and 2,000,000, for the script's time; seed 3, AUC): 6
   candidates in 2 buckets of 3, one batched CandidateBatchFitted each,
   committed under a checkpoint root in smoke_data/; its wall split into
   binning, boosting, scoring and the refit, the leaderboard, the
   committed version, the winner's held-out AUC. (c) TuneHyperparameters
   (3 folds, 4 draws of learningRate in [0.05, 0.3)) on the first 125,000
   rows, batched and on a 2-thread pool: equal metrics; then FindBestModel
   over both tuned models. (d) (b)'s grid on the first 500,000 rows (cut
   from 1,000,000 for the script's time) with numProcesses=2 (workers
   share the card): the inline run's metrics and winner; again under
   FaultPlan(seed=11).kill_process(1, iteration=1): 2 epochs, one
   signal:9 exit, the undisturbed metrics, winner, committed version and
   text, one ProcessLost and one GroupReformed. (e) histogram.cu on the
   bins of (b)'s first bucket at iteration-0 stats, k = 1 and 8, bit-equal
   to the plain version, timed, with the bound; launches from that
   bucket's train_many call.
29. Serving (mmlspark_tpu_torch.serving, resilience, dataguard's request
   guard). A LightGBMClassifier at the estimator's defaults (100
   iterations) with maxBin 255 and 31 leaves, fitted on the card on the
   first 1,000,000 of phase 5's rows and committed as version 1 to a
   ModelStore under smoke_data/serving; a second fit (10 iterations at
   rate 0.3) is version 2. (d)'s replica processes start with the phase
   and wait for version 1; (c), (e) and (d) run first, then (a) and (b),
   and the wall of each part is printed. The histogram kernels' counts are
   set to 0 after the fits and must stay 0 (serving launches no hand
   kernel).
   (a) warm_restart_server(from_model_string) at the server's defaults
   (max_batch_size 64, max_latency_ms 2.0): 16 closed-loop keep-alive
   clients of 500 single-row requests from phase 5's held-out rows;
   every reply 200 and within 1e-6 of one transform of the 8,000 rows,
   with the count of replies that differ in any bit; requests/s, client
   p50/p99/max, mean and largest batch, the median apply ms
   (serving_apply_latency_seconds) and apply's share of the wall. (b) The
   same with watch=True: version 2 commits after 150 of 1,600 replies;
   every reply is v1's or v2's for its row, the last 1,000 are v2's, one
   ModelSwapped, /healthz model_version 2. (c) DistributedServingServer(2
   listeners, 4 executors) under FaultPlan(seed=29).kill_task(0): every
   reply 200 at (a)'s values, the retry in RuntimeMetrics; 80 requests, a
   fault check that reports no rate. (d) A
   RegistrationService (TTL 2 s), a ReplicaSupervisor of 2 replica
   processes on the card (chip_smoke:serving_replica_factory loads the
   committed text) and a least-loaded FleetRouter; 8 clients of 500
   requests with replica 0 SIGKILLed after 400 replies: no 5xx but a
   shed 503/429, every 200 at the model's value, the loss booked, the
   replica respawned and re-registered, the dead lease expired; the
   replicas' ready time after spawn (it holds the v1 fit) and after the
   commit, the respawn's seconds from the kill to its ready file, router
   p50/p99, failovers. (e) A seeded
   FaultPlan.malformed_request flood (json, nan, schema) from one client
   beside a healthy one: 16 structured 400s with X-Trace-Id, then 429s
   from the poison breaker; the healthy client all 200; after reset_s
   the poison client is admitted again, with one PoisonClientReleased; a
   guard check that reports no latency.
30. Streaming (mmlspark_tpu_torch.streaming) on the card. Phase 5's first
   4,000,000 rows as 8 part-NNNNN.npz chunks of 500,000 rows with CRC
   sidecars under smoke_data/stream, published by write-then-rename. The
   undisturbed run in this process: FileStreamSource(max_per_trigger=1)
   into a ModelCommitSink of LightGBMClassifier (phase 5's params, 10
   iterations an epoch, each a warm start from the ensemble so far) under
   AvailableNow: 8 epochs, versions 1-8, histogram.cu's launches of both
   entries, and the two entries on the last epoch's bins at its warm-start
   stats against the plain version. After it, beside the rest of the
   phase, the chaos run: tools/torch_streaming_chaos_smoke.py --chaos-only
   over the same chunks
   (MMLSPARK_TPU_FAULT_SEED 30), its children SIGKILLed at post_wal of
   epoch 2 and at pre_commit of epoch 5 and restarted, loading phase 2's
   kernels: every epoch committed once, one journal record per epoch, and
   the final version and model text the undisturbed run's byte for byte.
   The streamed text equals a manual chain of the same eight warm-start
   fits merged with _merge_boosters; a 2-epoch x 100,000-row stream
   gives the same text on the card and on the CPU port; held-out AUC on phase 5's
   500,000 test rows above 0.75. A ServingServer warm-restarted with hot
   swap on the stream's ModelStore answers 2,000 held-out rows as
   single-row requests (8 clients), each within 1e-6 of one transform by
   the final version; SLOReport.fold over its registry and events (p50,
   p99, availability) and render_report's history page (its bytes).
31. The load campaign: tools/torch_loadgen.py --short --malformed (seed 31)
   as a subprocess: no non-shed 5xx, slo.json and report.html written,
   and every check of its verdict held but steady_p99_within_target,
   which is printed with the steady p99 and its 50 ms target (the tool
   exits 1 on that check alone); its verdict, checks and SLO p50/p99.
32. TrainClassifier and TrainRegressor on szilard/benchm-ml's airline rows
   as its raw CSV gives them (phase 10's generator, 1,000,000 training and
   500,000 held-out rows): Month, DayofMonth and DayOfWeek as "c-N"
   strings, UniqueCarrier as carrier codes, Origin and Dest as three-letter
   airport codes, DepTime and Distance as integers, dep_delayed_15min as
   "Y"/"N". (a) TrainClassifier(LightGBMClassifier(numIterations 10, 31
   leaves, maxBin 255)) as a user calls it: Featurize's plan (four columns
   one-hot, 76 columns; Origin and Dest over its 100-value limit hashed into
   2 x 256 murmur3 buckets; two numerics: 590 float32 columns), the
   featurizer's fit and transform seconds, binning and boosting seconds,
   the launches, every held-out prediction "Y" or "N", and the held-out AUC
   above 0.5 and not below a LightGBMClassifier fit on the same rows as
   integer codes. (b) The first 30,000 rows (cut from 100,000 for the
   script's time) on the card and on the CPU port: equal model text and
   equal decoded predictions on 30,000 held-out rows. (c) The
   TrainedClassifierModel saved, loaded and applied again to the first
   30,000 held-out rows (500,000 cut for time): equal output columns. (d) histogram.cu's two entries on the
   featurized bins at iteration-0 stats against the plain version, timed,
   with the bound. (e) TrainRegressor(LightGBMRegressor) on 250,000 rows of
   a delay-minutes label from the same latent: held-out l2 on 100,000 rows
   below the init-only model's.
33. VW text classification, BASELINE config 4 (benchmarks/vw_text_bench.py's
   corpus generator, copied): 200,000 training and 20,000 held-out
   documents of 30 words from a 5,000-word vocabulary (seed 0), numBits 18
   (262,144 weights), 3 passes of batchSize 64 (9,375 sequential steps).
   One departure from config 4: batchSize 64 is VW's default, while
   benchmarks/vw_text_bench.py fits at batchSize 1024, which (b) runs too.
   No hand kernel runs (the histogram kernels' counts stay 0). (a)
   VowpalWabbitFeaturizer(stringSplit=True) on the host: seconds. (b)
   VowpalWabbitClassifier fitted twice on the card (each minibatch step
   replayed from one captured CUDA graph): bit-identical weights; fit
   seconds, learn_time_s, steps, device launches per step (torch.profiler
   over two short fits that differ by one pass), held-out accuracy above
   the majority class's and log loss below the constant model's. The same
   at batchSize 1024 (588 steps): two fits bit-identical, the same two
   held-out checks. (c) The first 20,000 documents on the card and on the
   CPU port: weights and held-out margins within 1e-4 of the largest
   magnitude (the card sums a run of equal indices before adding it; the
   CPU adds one by one), and within 1e-5 of the CPU running the card's
   scatter form (vw.base._Lanes with its sorted run sums). (d) A K = 4
   "vw" bucket (learning rate, powerT, l1, l2) through fit_bucket on the
   card on the first 50,000 documents: each candidate's held-out accuracy
   within rtol 1e-5 of its own sequential fit's; the bucket's seconds
   against the four fits'. (e) A 4-slot logical mesh on the one card, 1
   pass over the first 20,000 documents, against the CPU port's 4-slot
   fit: weights within 1e-4. (f) VowpalWabbitRegressor --ftrl over
   VowpalWabbitInteractions of each document's first and second 15 words
   (two featurized namespaces), 50,000 rows, 3 passes: held-out l2 on
   5,000 documents below the init-only model's. The wall of each part is
   printed.
34. The other learners on the card against the CPU port; the wall of each
   part is printed. (a) SAR at MovieLens-1M's shape (6,040 users, 3,706
   items, 1,000,209 seeded ratings of Zipf item popularity at its star
   frequencies over three years), jaccard, supportThreshold 4: fit and
   recommend_for_all_users(10) seconds; the first 500 users on the CPU
   port: scores within 1e-6 of the largest, items equal at every rank
   apart from its neighbours and at every exact tie (lax.top_k's order);
   the co-occurrence's first 100 columns equal the host's product. (b)
   IsolationForest, 100 trees of maxSamples 256 on 1,000,000 x 28 rows
   with 1% planted outliers: the packed trees equal the CPU port's bit for
   bit, scores of the first 100,000 rows within 1e-6 of the CPU port's
   (and whether bit-equal), the AUC against the planted labels (above
   0.9), fit and scoring seconds. (c) KNN and ConditionalKNN (k = 5) over
   an embedding index of 100,000 x 512 float32 keys, 10,000 queries, 10
   labels, each query's conditioner 1-3 seeded labels: query seconds, the
   first 1,000 queries against the CPU port (as in (a)), every match's
   label admissible. (a) and (c) also time ops/topk.py's two forms (sort,
   select) at SAR's and KNN's score shapes beside torch.topk; they give
   the same indices. (d) TabularLIME (nSamples 1,000, the reference's
   default) over a LightGBMRegressor fitted on the card (200,000
   HIGGS-shaped rows, 50 trees, its histogram.cu launches): 1,000 rows
   explained, 1,000,000 inner predictions and 1,000 lasso problems of
   1,000 x 28, the inner predict and the lasso timed apart; 20 rows on the
   CPU port within 1e-5 of the largest weight; x0 and x3 (the generator's
   linear and sine terms) carry the most weight; histogram.cu's two
   entries on the regressor's bins at iteration-0 stats (kernel rows
   hist_panel_lime, hist_combined_lime). Only (d) launches hand kernels.
35. The deep models (mmlspark_tpu_torch.dnn, models, image, downloader,
   ops/pipeline_parallel.py, ops/expert_parallel.py) on the card against
   the CPU port; the wall of each part is printed. No hand kernel runs (the
   histogram kernels' counts stay 0); the convolutions are cuDNN's, with
   TF32 off for the transforms (device.float32_exact). (a) ResNet-50 at
   full width (ImageNet stem, 1,000 classes, init_resnet(seed=0)):
   ImageFeaturizer(cutOutputLayers=1, 224 x 224, batchSize 64) over 1,024
   seeded uint8 images, half 256 x 256 and half 240 x 320 (two resize
   groups): 2,048-d float32 features, images/s, the resize's and the
   backbone's seconds, peak
   device bytes, 53 convolution calls and the device kernels of one
   batch's forward (torch.profiler); the first 16 images through the CPU
   port within 2e-5 of the largest feature (TF32 would part by about
   1e-3); the shapes of cut 0 (64 x 1,000) and cut 2 (64 x 2,048 x 7 x 7);
   resnet_apply in bfloat16 within 2e-2 of float32 on one batch. (b) publish_model into a LocalRepo under
   smoke_data/, ModelDownloader and load_zoo_params, then the same
   featurization: its first 64 rows equal (a)'s bit for bit. (c)
   from_torch of a seeded conv/bn/relu/pool/linear module and from_onnx of
   an onnx_proto-encoded conv/bn/relu/maxpool/gemm graph, each through
   DNNModel on the card (512 rows), within 1e-4 of the module's own CPU
   forward. (d) A 4-slot logical mesh on the card against 4 CPU slots:
   pipeline mode (4 stages of 1,024 x 1,024, 4 microbatches, 4,096 rows),
   MoE masked-dense (4 experts, 8,192 rows) through DNNModel and
   moe_apply_a2a (capacity factor 1.25, some rows dropped): within 1e-4,
   the same rows dropped. (e) train_resnet_classifier on resnet18 (small-
   input stem) for 50 steps of 64 over 2,048 seeded 32 x 32 images (the
   brightest quadrant as the class): ms a step, losses, accuracy, finite
   params; 3 steps on the first 256 images on the card and the CPU port:
   the first step's loss (one forward from the same start) within 5e-6
   relative, each step's loss within 1e-2, the trees' L2 gap within 9% of
   the CPU's L2 movement (Adam's first steps move a weight by about the
   learning rate with its gradient's sign, and weights whose gradients lie
   within float32 noise of zero move either way; the random net's loss
   jumps at step 2, which amplifies the gap). The limits lie between the
   largest reading of exact runs and the smallest with TF32 allowed, over
   6 seeds of the task (tools/torch_deep_train_tol.py).
36. One JSON line with every kernel (the grouped wide-level launches and
   phases 22, 23, 24, 25, 27, 28, 30, 32 and 34's cases among them), then
   the card line, then the result line. Each phase prints its wall time;
   TF32 matmuls must be off.

Cuts for the script's time, of depth only (every check still runs): phase
14's warm-start fits 11,000,000 -> 2,000,000 rows; phase 22's sparse fit
10,000,000 -> 5,000,000 rows, its sparse-against-dense rows 1M -> 250,000 ->
125,000; phase 24's WARN run 4 -> 2 shards; phase 26's quality fit 2M -> 1M;
phase 27's card-against-CPU fits 200,000 -> 100,000 -> 50,000 rows; phase
28's train_many and inline sweep 11M -> 4M -> 2M -> 1M rows, gang 1M -> 500,000,
tuner 1M -> 125,000; phase 29 (a) 16 x 1,000 -> 16 x 500 requests; phase
30's stream 8 chunks of 1,000,000 -> 500,000 rows; phase 32's
card-against-CPU fit and reloaded rows 100,000 -> 30,000; the plan sweeps
5 -> 3 launches.
"""

import collections
import dataclasses
import functools
import gc
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
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
PLAN_REPS = 3  # timed launches of each case in the launch-plan sweeps (cut from 5 for time)
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


def _airline_data(n, seed, latent=False):
    """Rows in the shape of szilard/benchm-ml's airline set
    (dep_delayed_15min; LightGBM's docs/Experiments.rst "Expo" categorical
    run): six categorical columns with Zipf-skewed frequencies (Origin and
    Dest have more values than maxBin 255's 254 value bins, so their rarest
    ones share bin 0), then DepTime and Distance. The label carries a random
    effect per category, so a category's code says nothing by its order.
    With ``latent`` the label's logit comes third."""
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
    return (X, y, logit) if latent else (X, y)


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
N_WARM = 2_000_000  # phase 14's rows: phase 13's first, cut from its 11,000,000 for time
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
    """predict_leaf and featuresShapCol on N_EXPLAIN held-out rows of phase 5's
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
N_SPARSE_CHECK = 125_000  # phase 22's sparse-against-dense rows, cut from 1M, then 250,000, for time
N_SPARSE_AIR = 5_000_000  # phase 22's sparse fit: phase 10's first rows, cut from its 10M for time
N_OOC = 22_000_000  # twice HIGGS's 11,000,000 rows, cut from 44M for the script's time
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
    col = _airline_sparse(SparseRows, X[:N_SPARSE_AIR])
    csr_build_s = time.perf_counter() - t0
    test_col = _airline_sparse(SparseRows, X[N_AIR:])
    ytr, yte = y[:N_SPARSE_AIR], y[N_AIR:]
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
    rec = dict(rows=N_SPARSE_AIR, features=col.dim, nnz=col.nnz, csr_bytes=col.indices.nbytes
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
    for name, feats in (("sparse", _airline_sparse(SparseRows, Xa[:N_SPARSE_CHECK])),
                        ("dense", _one_hot_airline(Xa[:N_SPARSE_CHECK]))):
        t0 = time.perf_counter()
        m = LightGBMClassifier(**params).fit(Table({"features": feats,
                                                    "label": ya[:N_SPARSE_CHECK]}))
        texts[name] = (m.get_model_string(), time.perf_counter() - t0, m.fit_stats.binning_seconds)
        del feats, m
    if texts["sparse"][0] != texts["dense"][0]:
        raise AssertionError("the sparse fit's model text differs from the dense fit's")
    rec["check_1m"] = dict(rows=N_SPARSE_CHECK, text_equal=True, sparse_fit_s=texts["sparse"][1],
                           sparse_binning_s=texts["sparse"][2], dense_fit_s=texts["dense"][1],
                           dense_binning_s=texts["dense"][2])
    print("sparse airline check: " + json.dumps(rec["check_1m"]), flush=True)
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
    """HIGGS width out of core: 22,000,000 rows written as 11 .npz shards of
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
RT_WARN_SHARDS = 2  # the memory-pressure run: 2 shards (cut from 4), whole-shard tasks halved
RT_WARN_WORKERS = 2
RT_BATCHES = 4


def _journal_lines(root):
    lines = []
    for d in sorted(os.listdir(root)):
        with open(os.path.join(root, d, "journal.jsonl")) as fh:
            lines += fh.read().splitlines()
    return lines


def phase_runtime(torch, uh, hh, runtime, binning, base, sharded, Table, LightGBMClassifier,
                  auc, higgs, phase5, ooc):
    """The partition runtime on phase 5's 11,000,000 rows and phase 23's
    shards: numExecutors=8 binning against phase 5's inline binning of the
    same rows (its bins and seconds: equal bins); a
    fit binning under an ambient runtime.policy(max_workers=8,
    result_integrity=True) with kill_random_task(8), corrupt_result and a
    host oom_task, under a checkpoint root (phase 5's model text, the
    retries counted, histogram.cu launches); its durable rerun (no journal
    line added, restore seconds, ModelStore.latest); numBatches=4 (held-out
    AUC, _ensemble_margin against the merged booster's raw_margin); the
    22,000,000-row ingest through the scheduler path (the sequential
    pass's bytes, bin seconds, host RSS growth) and a memory-pressure WARN
    run (task count doubled); sample_hbm against torch.cuda's allocator."""
    import filecmp

    X, y = higgs["X"], higgs["y"]
    train_t = Table({"features": X, "label": y})
    want_text = higgs["booster"].model_to_string()
    name = "lightgbmclassificationmodel"
    rec = {}

    # numExecutors=8 binning against phase 5's inline binning of the same
    # rows (the estimator's binning_dataset call, timed by its FitStats)
    est = LightGBMClassifier(numExecutors=RT_WORKERS, **HIGGS_PARAMS)
    opts = est._make_options()
    t0 = time.perf_counter()
    b_part, _ = est._bin_dataset(X, opts, set())
    part_s = time.perf_counter() - t0
    if higgs["bins"].tobytes() != b_part.tobytes():
        raise AssertionError("runtime: partitioned bins differ from the inline bins")
    rec["binning"] = dict(rows=len(y), inline_s=phase5["binning_s"], partitioned_s=part_s,
                          executors=RT_WORKERS, tasks=est._runtime_metrics.summary()["tasks_done"],
                          bins_equal=True)
    print("runtime binning: " + json.dumps(rec["binning"]), flush=True)
    del b_part

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
                              phase5_auc=phase5["held_out_auc"], ensemble_margin_max_err=err,
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
N_QUALITY = 1_000_000  # the quality-plane Pipeline fit's rows: phase 25's, cut for the budget
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


# phase 27's rows fitted on the card and on the CPU port: equal text (cut from 200,000)
N_DIST_CPU = 50_000  # phase 27's card-against-CPU rows, cut from 200,000, then 100,000
DIST_SLOTS = 4  # the mesh's data slots, every one on the card
DIST_TOP_K = 20
DIST_PROCS = 2
DIST_PROC_ROWS = N_FIT  # the process-group fits' rows (cut to no fewer than 2,000,000 if needed)
DIST_KILL = (1, 3)  # the SIGKILLed member and its iteration
DIST_FAULT_SEED = 11


def _compute_mode():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _mesh_fits(torch, uh, hh, train, parallel, procfit, auc, higgs, opts, names, phase5_text,
               card):
    """Phase 27's three meshed fits of phase 5's bins on the card; returns
    their records and the data-parallel fit's launch counts."""
    bins, mapper, y = higgs["bins"], higgs["mapper"], higgs["y"]
    Xte, yte = higgs["X_test"], higgs["y_test"]
    dev = torch.device("cuda", 0)
    voting = dataclasses.replace(opts, tree_learner="voting_parallel", top_k=DIST_TOP_K)
    recs = {}
    for name, cfg, o in (("data_parallel", parallel.MeshConfig(data=DIST_SLOTS), opts),
                         ("voting_parallel", parallel.MeshConfig(data=DIST_SLOTS), voting),
                         ("feature_parallel", parallel.MeshConfig(data=2, model=2), opts)):
        slots = cfg.data * cfg.model
        mesh = parallel.make_mesh(cfg, devices=[dev] * slots)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(uh, hh)
        res = train.train(bins, y, o, mapper=mapper, feature_names=names, mesh=mesh)
        torch.cuda.synchronize()
        counts = _counts(uh, hh)
        st = res.stats
        launched = counts["hist_panel"] + counts["hist_combined"]
        if launched != slots * st.passes:
            raise AssertionError(f"{name}: {launched} histogram.cu launches for {st.passes} "
                                 f"passes on {slots} slots")
        margin = res.booster.raw_margin(Xte, device="cuda")[:, 0]
        test_auc = auc(yte, margin, np.ones(len(yte)))
        text = res.booster.model_to_string()
        rec = dict(fit=name, mesh=mesh.shape, rows=len(y), boosting_s=st.boost_seconds,
                   trees=st.trees, passes=st.passes, launches=counts,
                   launches_per_pass_and_slot=launched / (st.passes * slots),
                   held_out_auc=test_auc, peak_device_bytes=torch.cuda.max_memory_allocated(),
                   card=card)
        if name == "data_parallel":
            rec["text_close_to_phase5"] = procfit.model_texts_close(text, phase5_text)
        if name == "feature_parallel":
            rec["split_features_equal_phase5"] = bool(np.array_equal(
                res.booster.split_feature, higgs["booster"].split_feature))
        print("distribution mesh fit: " + json.dumps(rec), flush=True)
        if not test_auc > 0.75:
            raise AssertionError(f"{name}: held-out AUC {test_auc} is too low for this data")
        if rec.get("text_close_to_phase5") is False:
            raise AssertionError("data_parallel: the 4-slot text is not within "
                                 "model_texts_close of phase 5's")
        if rec.get("split_features_equal_phase5") is False:
            raise AssertionError("feature_parallel: split features differ from phase 5's fit")
        recs[name] = rec

    # voting on N_DIST_CPU rows: the card's 4 slots against 4 CPU slots
    texts, secs = [], []
    for d in (dev, torch.device("cpu")):
        mesh = parallel.make_mesh(parallel.MeshConfig(data=DIST_SLOTS), devices=[d] * DIST_SLOTS)
        t0 = time.perf_counter()
        texts.append(train.train(bins[:N_DIST_CPU], y[:N_DIST_CPU], voting, mapper=mapper,
                                 feature_names=names, mesh=mesh).booster.model_to_string())
        secs.append(time.perf_counter() - t0)
    if texts[0] != texts[1]:
        raise AssertionError(f"voting_parallel: the card's text on {N_DIST_CPU} rows differs "
                             "from the CPU port's")
    recs["voting_cpu_text"] = dict(rows=N_DIST_CPU, text_equal=True, card_fit_s=secs[0],
                                   cpu_fit_s=secs[1], card=card)
    print("distribution voting card against CPU: " + json.dumps(recs["voting_cpu_text"]),
          flush=True)
    return recs


def _shard_kernels(torch, hh, rates, train, parallel, objectives, higgs):
    """histogram.cu's two entries on the first data shard of the 4-slot
    mesh: its bins and the fit's iteration-0 stats (the global init
    score), bit-equal to the plain version, timed, with the bound."""
    bins, y = higgs["bins"], higgs["y"]
    mesh = parallel.make_mesh(parallel.MeshConfig(data=DIST_SLOTS),
                              devices=[torch.device("cuda", 0)] * DIST_SLOTS)
    rows = parallel.data_sharding(mesh, len(y))[0]
    dev = torch.device("cuda", 0)
    obj = objectives.get_objective("binary")
    init = obj.init_score(np.asarray(y, np.float32), 1, np.ones(len(y), np.float32))
    yd = torch.as_tensor(np.asarray(y[rows], np.float32), device=dev)
    margins = torch.as_tensor(init, device=dev)[None, :].expand(len(yd), 1).contiguous()
    g, h = obj.grad_hess(margins, yd, torch.ones_like(yd))
    bins_t = train.upload_bins(bins[rows], dev)
    recs = _path_kernels(torch, hh, rates, "mesh_shard", bins_t, g[:, 0], h[:, 0], NUM_BINS)
    del bins_t, g, h, yd, margins
    torch.cuda.empty_cache()
    return recs


def _gang_fits(torch, base, train, procfit, runtime, events, Table, LightGBMClassifier, higgs,
               opts, phase5_text, card, work):
    """Phase 27's process-group fits (2 workers sharing the card)."""
    bins, mapper, X, y = higgs["bins"], higgs["mapper"], higgs["X"], higgs["y"]
    rows = DIST_PROC_ROWS
    train_t = Table({"features": X[:rows], "label": y[:rows]})
    bin_dataset = base.bin_dataset
    # phase 5's bins of these rows go to the estimators: no second binning
    base.bin_dataset = lambda Xb, **kw: (bins[:len(Xb)], mapper)
    log_path = os.path.join(work, "events.jsonl")
    recs = {}
    try:
        for name, plan in (("undisturbed", None),
                           ("killed", runtime.FaultPlan(seed=DIST_FAULT_SEED).kill_process(
                               DIST_KILL[0], iteration=DIST_KILL[1]))):
            est = LightGBMClassifier(numProcesses=DIST_PROCS, **HIGGS_PARAMS)
            saved_log = os.environ.get("MMLSPARK_TPU_EVENT_LOG")
            if plan is not None:
                os.environ["MMLSPARK_TPU_EVENT_LOG"] = log_path
            t0 = time.perf_counter()
            try:
                if plan is None:
                    model = est.fit(train_t)
                else:
                    with runtime.inject_faults(plan):
                        model = est.fit(train_t)
            finally:
                if plan is not None:
                    if saved_log is None:
                        del os.environ["MMLSPARK_TPU_EVENT_LOG"]
                    else:
                        os.environ["MMLSPARK_TPU_EVENT_LOG"] = saved_log
                    events._sync_env_sink()
            fit_s = time.perf_counter() - t0
            pf = est._process_fit
            members = {}
            for m, res in sorted(pf.worker_results.items()):
                prof = res["profile"]
                members[str(m)] = dict(rows=res["rows"], device=res["device"],
                                       allreduce_calls=prof["allreduce_calls"],
                                       allreduce_s=prof["allreduce_seconds"],
                                       launches=prof["launches"])
                if res["device"] != "cuda" or not sum(prof["launches"].values()):
                    raise AssertionError(f"gang {name}: member {m} did not launch histogram.cu "
                                         f"on the card ({res['device']}, {prof['launches']})")
            text = model.get_model_string()
            rec = dict(fit=name, processes=DIST_PROCS, rows=rows, fit_s=fit_s, epochs=pf.epochs,
                       recovered_iterations=pf.recovered_iterations, members=members, card=card)
            if plan is None:
                rec["text_close_to_phase5"] = procfit.model_texts_close(text, phase5_text)
                if not rec["text_close_to_phase5"]:
                    raise AssertionError("gang: the 2-process text is not within "
                                         "model_texts_close of phase 5's")
                undisturbed = text
            else:
                names = [type(e).__name__ for e in events.replay(log_path)]
                rec.update(text_equal_undisturbed=text == undisturbed, fired=plan.fired,
                           process_lost=names.count("ProcessLost"),
                           group_reformed=names.count("GroupReformed"))
                if not (pf.epochs == 2 and pf.recovered_iterations == DIST_KILL[1]
                        and rec["text_equal_undisturbed"] and rec["process_lost"] == 1
                        and rec["group_reformed"] == 1):
                    raise AssertionError(f"gang killed: {json.dumps(rec)}")
            print("distribution gang fit: " + json.dumps(rec), flush=True)
            recs[name] = rec
    finally:
        base.bin_dataset = bin_dataset

    # N_DIST_CPU rows in a 2-process gang on the card and on the CPU port
    texts, secs = [], []
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res = procfit.fit_process_group(
            None, y[:N_DIST_CPU], opts, num_processes=DIST_PROCS, bins=bins[:N_DIST_CPU],
            mapper=mapper, feature_names=[f"f{i}" for i in range(N_FEATURES)], device=dev,
            workdir=os.path.join(work, f"gang_{dev}"))
        secs.append(time.perf_counter() - t0)
        texts.append(res.model_text)
    if texts[0] != texts[1]:
        raise AssertionError(f"gang: the card's text on {N_DIST_CPU} rows differs from the "
                             "CPU port's")
    recs["cpu_text"] = dict(rows=N_DIST_CPU, text_equal=True, card_fit_s=secs[0],
                            cpu_fit_s=secs[1], card=card)
    print("distribution gang card against CPU: " + json.dumps(recs["cpu_text"]), flush=True)
    return recs


def phase_distribution(torch, uh, hh, rates, base, train, parallel, procfit, runtime, events,
                       objectives, Table, LightGBMClassifier, auc, higgs):
    """Phase 27 (see the module docstring). Returns the record, with the
    4-slot data-parallel fit's launches under "launches" and histogram.cu's
    entries on a shard under "kernels"."""
    card = _card_line()
    mode = _compute_mode()
    print(f"distribution: {card} | compute mode {mode}", flush=True)
    if mode != "Default":
        raise AssertionError(f"the card's compute mode is {mode!r}: the process group's "
                             "workers each open a CUDA context on it, which needs 'Default'")
    work = os.path.join(DATA_DIR, "distribution")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.cuda.empty_cache()  # the gang's workers take their memory from the same card
    est = LightGBMClassifier(**HIGGS_PARAMS)
    opts = est._make_options(est._num_classes(higgs["y"]))
    names = [f"f{i}" for i in range(N_FEATURES)]
    phase5_text = higgs["booster"].model_to_string()
    mesh = _mesh_fits(torch, uh, hh, train, parallel, procfit, auc, higgs, opts, names,
                      phase5_text, card)
    kernels = _shard_kernels(torch, hh, rates, train, parallel, objectives, higgs)
    gang = _gang_fits(torch, base, train, procfit, runtime, events, Table, LightGBMClassifier,
                      higgs, opts, phase5_text, card, work)
    shutil.rmtree(work, ignore_errors=True)
    return dict(mesh=mesh, gang=gang, kernels=kernels,
                launches=mesh["data_parallel"]["launches"])


N_MANY_SWEEP = 1_000_000  # phase 28's train_many and sweep rows, cut from 11M (5.5M, 4M, 2M) for time
N_MANY_GANG = 500_000  # phase 28's gang rows: the first of phase 5's (cut from 1,000,000)
N_MANY_TUNE = 125_000  # phase 28's tuner rows, cut from 1M, then 250,000, for the script's time
MANY_GRID = {"learningRate": [0.05, 0.1, 0.2], "numLeaves": [15, 31]}
MANY_TUNE_FOLDS = 3
MANY_TUNE_RUNS = 4
MANY_KILL = (1, 1)  # the SIGKILLed gang member and the bucket index it dies at
MANY_FAULT_SEED = 11


def _many_train_many(torch, uh, hh, train, auc, higgs, card):
    """Phase 28 (a): train_many on phase 5's first N_MANY_SWEEP rows' bins,
    K = 4, against four
    train() calls; returns the record and the bucket's launch counts."""
    bins, mapper = higgs["bins"][:N_MANY_SWEEP], higgs["mapper"]
    y = higgs["y"][:N_MANY_SWEEP]
    est = higgs["estimator"]
    o = est._make_options(est._num_classes(y))
    opts = [dataclasses.replace(o, learning_rate=0.05), dataclasses.replace(o, learning_rate=0.1),
            dataclasses.replace(o, learning_rate=0.2),
            dataclasses.replace(o, learning_rate=0.1, feature_fraction=0.8,
                                bagging_fraction=0.8, bagging_freq=1)]
    names = [f"f{i}" for i in range(bins.shape[1])]
    torch.cuda.synchronize()
    _zero_counts(uh, hh)
    t0 = time.perf_counter()
    many = train.train_many(bins, y, opts, mapper=mapper, feature_names=names)
    torch.cuda.synchronize()
    bucket_s = time.perf_counter() - t0
    counts = _counts(uh, hh)
    _need(counts, ("hist_panel", "hist_combined"), "train_many")
    single = []
    for opt in opts:
        t1 = time.perf_counter()
        res = train.train(bins, y, opt, mapper=mapper, feature_names=names)
        torch.cuda.synchronize()
        single.append((time.perf_counter() - t1, res))
    Xte, yte = higgs["X_test"], higgs["y_test"]
    cands = []
    for opt, r, (one_s, one) in zip(opts, many, single):
        if r.booster.model_to_string() != one.booster.model_to_string():
            raise AssertionError(f"train_many: candidate {opt.learning_rate}/"
                                 f"{opt.feature_fraction} differs from its train() text")
        margin = r.booster.raw_margin(Xte, device="cuda")[:, 0]
        cands.append(dict(learning_rate=opt.learning_rate, feature_fraction=opt.feature_fraction,
                          bagging_fraction=opt.bagging_fraction, text_equal_train=True,
                          step_s=r.stats.boost_seconds, train_boosting_s=one.stats.boost_seconds,
                          train_s=one_s, passes=r.stats.passes,
                          held_out_auc=auc(yte, margin, np.ones(len(yte)))))
    # phase 5's 50 + 20 a fit: 5 panel and 2 combined passes a tree at 31
    # leaves and leaf batch 8, K times
    k, iters = len(opts), o.num_iterations
    want = (k * 5 * iters, k * 2 * iters)
    if (counts["hist_panel"], counts["hist_combined"]) != want or \
            counts["u_panel_dot"] or counts["bin_scatter"]:
        raise AssertionError(f"train_many: launches {counts}, want {want} on histogram.cu "
                             "and none on the U path")
    rec = dict(rows=len(y), candidates=k, bucket_s=bucket_s,
               bucket_steps_s=sum(c["step_s"] for c in cands),
               train_calls_s=sum(c["train_s"] for c in cands),
               train_boosting_s=sum(c["train_boosting_s"] for c in cands),
               upload_s=many[0].stats.upload_seconds, launches=counts, candidates_detail=cands,
               card=card)
    print("many models train_many: " + json.dumps(rec), flush=True)
    if not min(c["held_out_auc"] for c in cands) > 0.75:
        raise AssertionError("train_many: a candidate's held-out AUC is too low for this data")
    return rec, counts


def _many_inline_sweep(torch, uh, hh, rates, base, train, objectives, batched, tsweep, automl,
                       events, Table, LightGBMClassifier, auc, higgs, card, work):
    """Phase 28 (b) and (e): the inline TrainValidSweep on phase 5's rows;
    histogram.cu on its first bucket's bins. Returns the record, the
    kernel entries and the first bucket's launches."""
    X, y = higgs["X"][:N_MANY_SWEEP], higgs["y"][:N_MANY_SWEEP]
    table = Table({"features": X, "label": y})
    seconds = {}
    calls = []
    train_many = train.train_many

    def counted_train_many(bins, yb, opts_list, **kw):
        _zero_counts(uh, hh)
        out = train_many(bins, yb, opts_list, **kw)
        torch.cuda.synchronize()
        calls.append(dict(bins=bins, y=yb, counts=_counts(uh, hh), size=len(opts_list)))
        return out

    train.train_many = counted_train_many
    saved_b = _timed_calls(base, ["bin_dataset"], seconds)
    saved_t = _timed_calls(train, ["train_many"], seconds)
    saved_s = _timed_calls(batched, ["_score"], seconds)
    seen = []
    bus = events.get_bus()
    bus.add_listener(seen.append)
    ckpt = os.path.join(work, "inline")
    saved_env = os.environ.get("MMLSPARK_TPU_CHECKPOINT_DIR")
    os.environ["MMLSPARK_TPU_CHECKPOINT_DIR"] = ckpt
    try:
        sweep = tsweep.TrainValidSweep(
            estimator=LightGBMClassifier(**HIGGS_PARAMS),
            paramSpace=automl.GridSpace(MANY_GRID), evaluationMetric="AUC", seed=3)
        t0 = time.perf_counter()
        model = sweep.fit(table)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        bus.remove_listener(seen.append)
        for module, saved in ((base, saved_b), (train, saved_t), (batched, saved_s)):
            for name, fn in saved.items():
                setattr(module, name, fn)
        train.train_many = train_many
        if saved_env is None:
            del os.environ["MMLSPARK_TPU_CHECKPOINT_DIR"]
        else:
            os.environ["MMLSPARK_TPU_CHECKPOINT_DIR"] = saved_env
    fitted = [e for e in seen if type(e).__name__ == "CandidateBatchFitted"]
    metrics = model.getAllMetrics()
    if not (len(metrics) == 6 and [(e.size, e.batched) for e in fitted] == [(3, True)] * 2
            and [c["size"] for c in calls] == [3, 3]):
        raise AssertionError(f"sweep: {len(metrics)} candidates, buckets "
                             f"{[(e.size, e.batched) for e in fitted]}, train_many calls "
                             f"{[c['size'] for c in calls]}; want 6 in 2 batched buckets of 3")
    version, text = _sweep_commit(ckpt)
    best = model.getBestModel()
    if version != model.getModelVersion() or version != 1 or text != best.get_model_string():
        raise AssertionError(f"sweep: committed version {version} / {model.getModelVersion()}, "
                             "or its text is not the refit winner's")
    st = best.fit_stats
    board = model.leaderboard()
    prob = best.transform(Table({"features": higgs["X_test"]}))["probability"][:, 1]
    rec = dict(
        rows=len(y), candidates=len(metrics), buckets=len(fitted), wall_s=wall,
        binning_s=seconds["bin_dataset"] - st.binning_seconds,
        boosting_s=seconds["train_many"], scoring_s=seconds["_score"],
        refit_binning_s=st.binning_seconds, refit_boosting_s=st.boost_seconds,
        bucket_s=[e.seconds for e in fitted],
        leaderboard=[dict(candidate=int(c), metric=float(m)) for c, m in
                     zip(board["candidate"], board["metric"])],
        best_params=model.getBestParams(), committed_version=version,
        winner_held_out_auc=auc(higgs["y_test"], prob, np.ones(len(prob))),
        first_bucket_launches=calls[0]["counts"], card=card)
    rec["binning_share"] = (seconds["bin_dataset"]) / wall
    print("many models inline sweep: " + json.dumps(rec), flush=True)
    _need(calls[0]["counts"], ("hist_panel", "hist_combined"), "sweep bucket 0")

    # (e) histogram.cu on the first bucket's bins at iteration-0 stats
    dev = torch.device("cuda", 0)
    yb = np.asarray(calls[0]["y"], np.float32)
    obj = objectives.get_objective("binary")
    init = obj.init_score(yb, 1, np.ones(len(yb), np.float32))
    yd = torch.as_tensor(yb, device=dev)
    margins = torch.as_tensor(init, device=dev)[None, :].expand(len(yd), 1).contiguous()
    g, h = obj.grad_hess(margins, yd, torch.ones_like(yd))
    bins_t = train.upload_bins(calls[0]["bins"], dev)
    kernels = _path_kernels(torch, hh, rates, "sweep_bucket0", bins_t, g[:, 0], h[:, 0],
                            NUM_BINS)
    del bins_t, g, h, yd, margins
    torch.cuda.empty_cache()
    return rec, kernels, calls[0]["counts"]


def _sweep_commit(ckpt):
    """(version, text) of the sweep's commit under the checkpoint root."""
    from mmlspark_tpu_torch.runtime.journal import ModelStore

    return ModelStore(os.path.join(ckpt, "models")).latest("sweep-lightgbmclassificationmodel")


def _many_tune(torch, automl, Table, LightGBMClassifier, auc, higgs, card):
    """Phase 28 (c): TuneHyperparameters batched and on a 2-thread pool;
    FindBestModel over both tuned models."""
    n = min(N_MANY_TUNE, len(higgs["y"]))
    table = Table({"features": higgs["X"][:n], "label": higgs["y"][:n]})
    kwargs = dict(models=LightGBMClassifier(**HIGGS_PARAMS),
                  paramSpace={"learningRate": automl.DoubleRangeHyperParam(0.05, 0.3)},
                  evaluationMetric="AUC", numFolds=MANY_TUNE_FOLDS, numRuns=MANY_TUNE_RUNS,
                  seed=7)
    tuned, secs = {}, {}
    for mode, extra in (("batched", {}), ("threadpool", {"parallelism": 2})):
        t0 = time.perf_counter()
        tuned[mode] = automl.TuneHyperparameters(sweepMode=mode, **kwargs, **extra).fit(table)
        torch.cuda.synchronize()
        secs[mode] = time.perf_counter() - t0
    b, t = tuned["batched"], tuned["threadpool"]
    if b.getAllMetrics() != t.getAllMetrics() or b.getBestParams() != t.getBestParams():
        raise AssertionError(f"tune: batched {b.getAllMetrics()} against threadpool "
                             f"{t.getAllMetrics()}")
    test = Table({"features": higgs["X_test"], "label": higgs["y_test"]})
    t0 = time.perf_counter()
    best = automl.FindBestModel(models=[b.getBestModel(), t.getBestModel()],
                                evaluationMetric="AUC").fit(test)
    find_s = time.perf_counter() - t0
    evald = best.get_evaluated_models()
    if best.getBestModelMetrics() != evald["metric"].max():
        raise AssertionError("FindBestModel did not keep the best model")
    rec = dict(rows=n, folds=MANY_TUNE_FOLDS, runs=MANY_TUNE_RUNS, batched_s=secs["batched"],
               threadpool_s=secs["threadpool"], threads=2, metrics=b.getAllMetrics(),
               metrics_equal=True, best_params=b.getBestParams(), find_best_s=find_s,
               find_best_auc=float(best.getBestModelMetrics()), card=card)
    print("many models tune: " + json.dumps(rec), flush=True)
    return rec


def _many_gang(torch, tsweep, automl, runtime, events, Table, LightGBMClassifier, higgs, card,
               work):
    """Phase 28 (d): the grid of (b) on N_MANY_GANG rows inline, in a
    2-process gang, and in a gang with a SIGKILLed member."""
    n = min(N_MANY_GANG, len(higgs["y"]))
    table = Table({"features": higgs["X"][:n], "label": higgs["y"][:n]})
    want_dev = LightGBMClassifier(**HIGGS_PARAMS).getDevice()
    log_path = os.path.join(work, "gang_events.jsonl")
    runs = {}
    saved_env = {k: os.environ.get(k) for k in ("MMLSPARK_TPU_CHECKPOINT_DIR",
                                                "MMLSPARK_TPU_EVENT_LOG")}
    try:
        for name, procs, plan in (
                ("inline", 0, None), ("gang", DIST_PROCS, None),
                ("killed", DIST_PROCS, runtime.FaultPlan(seed=MANY_FAULT_SEED).kill_process(
                    MANY_KILL[0], iteration=MANY_KILL[1]))):
            ckpt = os.path.join(work, f"gang_{name}")
            os.environ["MMLSPARK_TPU_CHECKPOINT_DIR"] = ckpt
            if plan is not None:
                os.environ["MMLSPARK_TPU_EVENT_LOG"] = log_path
            sweep = tsweep.TrainValidSweep(
                estimator=LightGBMClassifier(**HIGGS_PARAMS),
                paramSpace=automl.GridSpace(MANY_GRID), evaluationMetric="AUC", seed=3,
                numProcesses=procs)
            if plan is not None:
                sweep._group_options = {"faults": plan}
            t0 = time.perf_counter()
            try:
                model = sweep.fit(table)
            finally:
                if plan is not None:
                    if saved_env["MMLSPARK_TPU_EVENT_LOG"] is None:
                        del os.environ["MMLSPARK_TPU_EVENT_LOG"]
                    else:
                        os.environ["MMLSPARK_TPU_EVENT_LOG"] = saved_env["MMLSPARK_TPU_EVENT_LOG"]
                    events._sync_env_sink()
            fit_s = time.perf_counter() - t0
            version, text = _sweep_commit(ckpt)
            rec = dict(run=name, processes=procs, rows=n, fit_s=fit_s,
                       metrics=model.getAllMetrics(), best_params=model.getBestParams(),
                       committed_version=version, card=card)
            if procs:
                info = sweep._process_sweep
                rec.update(epochs=info["epochs"], spec_s=info["spec_seconds"],
                           exits=[s.reason for s in info["exit_statuses"]],
                           members={str(m): dict(device=r["device"], fitted=r["fitted"],
                                                 recovered=r["recovered"],
                                                 launches=r["launches"],
                                                 load_s=r["load_seconds"],
                                                 fit_s=r["fit_seconds"])
                                    for m, r in sorted(info["worker_results"].items())})
                for m, r in rec["members"].items():
                    # a member that fitted a bucket on the card launched histogram.cu
                    if r["device"] != want_dev or (want_dev == "cuda" and r["fitted"]
                                                   and not sum(r["launches"].values())):
                        raise AssertionError(f"gang {name}: member {m} did not run histogram.cu"
                                             f" on {want_dev}: {r}")
            runs[name] = dict(rec=rec, text=text, plan=plan)
            print(f"many models gang {name}: " + json.dumps(rec), flush=True)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    inline, gang, killed = (runs[k]["rec"] for k in ("inline", "gang", "killed"))
    if gang["metrics"] != inline["metrics"] or gang["best_params"] != inline["best_params"] \
            or gang["epochs"] != 1:
        raise AssertionError("gang: metrics or winner differ from the inline sweep's")
    names = [type(e).__name__ for e in events.replay(log_path)]
    killed.update(fired=runs["killed"]["plan"].fired, process_lost=names.count("ProcessLost"),
                  group_reformed=names.count("GroupReformed"),
                  text_equal_gang=runs["killed"]["text"] == runs["gang"]["text"])
    if not (killed["epochs"] == 2 and killed["exits"].count("signal:9") == 1
            and killed["metrics"] == gang["metrics"]
            and killed["best_params"] == gang["best_params"]
            and killed["committed_version"] == gang["committed_version"] == 1
            and killed["text_equal_gang"] and killed["process_lost"] == 1
            and killed["group_reformed"] == 1):
        raise AssertionError(f"gang killed: {json.dumps(killed)}")
    print("many models gang killed checks: " + json.dumps(
        {k: killed[k] for k in ("epochs", "exits", "fired", "process_lost", "group_reformed",
                                "text_equal_gang")}), flush=True)
    return dict(inline=inline, gang=gang, killed=killed)


def phase_many_models(torch, uh, hh, rates, base, train, objectives, batched, tsweep, automl,
                      runtime, events, Table, LightGBMClassifier, auc, higgs):
    """Phase 28 (see the module docstring). Returns the record, with the
    first inline bucket's launches under "launches" and histogram.cu's
    entries on its bins under "kernels"."""
    card = _card_line()
    mode = _compute_mode()
    print(f"many models: {card} | compute mode {mode}", flush=True)
    if mode != "Default":
        raise AssertionError(f"the card's compute mode is {mode!r}: the sweep's gang workers "
                             "each open a CUDA context on it, which needs 'Default'")
    work = os.path.join(DATA_DIR, "many_models")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.cuda.empty_cache()
    higgs = dict(higgs, estimator=LightGBMClassifier(**HIGGS_PARAMS))
    many, _ = _many_train_many(torch, uh, hh, train, auc, higgs, card)
    sweep, kernels, launches = _many_inline_sweep(
        torch, uh, hh, rates, base, train, objectives, batched, tsweep, automl, events, Table,
        LightGBMClassifier, auc, higgs, card, work)
    tune = _many_tune(torch, automl, Table, LightGBMClassifier, auc, higgs, card)
    gang = _many_gang(torch, tsweep, automl, runtime, events, Table, LightGBMClassifier, higgs,
                      card, work)
    shutil.rmtree(work, ignore_errors=True)
    return dict(train_many=many, sweep=sweep, tune=tune, gang=gang, kernels=kernels,
                launches=launches)


N_SERVE_FIT = 1_000_000  # phase 29's training rows: the first of phase 5's
SERVE_PARAMS = dict(maxBin=NUM_BINS - 1, numLeaves=31)  # numIterations at its default, 100
SERVE_V2 = dict(numIterations=10, learningRate=0.3)  # the hot swap's second version
SERVE_CLIENTS, SERVE_REQS = 16, 500  # 500 cut from 1,000 for the script's time
# (b): version 2 commits after SWAP_AT replies; the last SWAP_TAIL must be its
SWAP_CLIENTS, SWAP_REQS, SWAP_AT, SWAP_TAIL = 8, 200, 150, 1000
# (c) and (e) are fault and guard checks, too short to give a rate: (c) splits
# each micro-batch into up to 4 executor tasks, each a whole transform
DISPATCH_CLIENTS, DISPATCH_REQS = 8, 10
# (d): replica 0 dies early in the load, so that its respawn lands within it
FLEET_CLIENTS, FLEET_REQS, FLEET_KILL_AT = 8, 500, 400
FLEET_TTL_S = 2.0
GUARD_FLOOD = (("json", 8), ("nan", 8), ("schema", 8))  # 24 poison requests, threshold 16
GUARD_KINDS = {"json": "invalid-json", "nan": "non-finite-value", "schema": "shape-mismatch"}
GUARD_HEALTHY = 50
GUARD_RESET_S = 0.5
FLEET_MODEL_WAIT_S = 300.0  # a replica waits this long for the first committed model
SERVE_TOL = 1e-6


def _load_main():
    """Phase 29's load generator, run by :class:`_LoadGen` as a process of
    its own so that its threads do not share the server's interpreter lock.
    Each line on stdin is one load as JSON (per client a URL, headers and
    bodies); one thread per client posts its bodies in order on one
    keep-alive connection (a reset reconnects and counts as status 0), then
    one line on stdout holds, per client, one record per request."""
    import http.client
    from urllib.parse import urlsplit

    def client(url, headers, bodies, out):
        url = urlsplit(url)
        conn = http.client.HTTPConnection(url.hostname, url.port, timeout=60)
        hdrs = dict(headers, **{"Content-Type": "application/json"})
        for body in bodies:
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/", body=body.encode(), headers=hdrs)
                resp = conn.getresponse()
                data = resp.read().decode()
                status, trace = resp.status, resp.getheader("X-Trace-Id") or ""
            except (OSError, http.client.HTTPException):
                conn.close()
                conn = http.client.HTTPConnection(url.hostname, url.port, timeout=60)
                status, data, trace = 0, "null", ""
            t1 = time.perf_counter()
            out.append(dict(status=status, body=data, seconds=t1 - t0, end=t1,
                            trace_id=trace))
        conn.close()

    for line in sys.stdin:
        spec = json.loads(line)
        out = [[] for _ in spec["bodies"]]
        threads = [threading.Thread(target=client, args=(*args, out[c]))
                   for c, args in enumerate(zip(spec["urls"], spec["headers"], spec["bodies"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        print(json.dumps(out), flush=True)


def serving_replica_factory(spec):
    """Replica factory of phase 29 (resolved as ``chip_smoke:serving_replica_factory``
    inside each replica process): the LightGBM model committed last under
    ``$SMOKE_SERVING_ROOT`` (waiting for the first commit, so replicas can
    start while the model is fitted), on ``$SMOKE_SERVING_DEVICE``, warmed
    by one transform so that the device is ready before the replica
    reports."""
    from mmlspark_tpu_torch.data.table import Table
    from mmlspark_tpu_torch.lightgbm import LightGBMClassificationModel
    from mmlspark_tpu_torch.serving import recover_model

    device = os.environ["SMOKE_SERVING_DEVICE"]
    deadline = time.monotonic() + FLEET_MODEL_WAIT_S
    while (got := recover_model(
            lambda text: LightGBMClassificationModel.from_model_string(text, device=device),
            root=os.environ["SMOKE_SERVING_ROOT"])) is None:
        if time.monotonic() > deadline:
            raise TimeoutError("no model was committed")
        time.sleep(0.1)
    _, model = got
    model.transform(Table({"features": np.zeros((1, model.booster.num_features))}))
    return model


def _row_body(row):
    return json.dumps({"features": [float(v) for v in row]})


#: One request of phase 29's load: its status (0 for a reset), its parsed
#: reply, its seconds, its end on the client's clock and its X-Trace-Id.
_Reply = collections.namedtuple("_Reply", "status body seconds end trace_id")


class _LoadGen:
    """One :func:`_load_main` process for the whole phase (started once,
    beside the v1 fit); :meth:`run` hands it one load and waits for it."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke._load_main()"], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def run(self, urls, bodies, headers=None):
        """Post ``bodies[c]`` in order to ``urls[c]`` (or to ``urls`` for
        every client) and return, per client, a :data:`_Reply` per
        request in order."""
        if isinstance(urls, str):
            urls = [urls] * len(bodies)
        self.proc.stdin.write(json.dumps({"urls": urls, "bodies": bodies,
                                          "headers": headers or [{} for _ in bodies]}) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise AssertionError(f"serving: the load generator exited with {self.proc.poll()}")
        got = json.loads(line)
        return [[_Reply(**dict(r, body=json.loads(r["body"]))) for r in c] for c in got]

    def close(self):
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _when(count, n, action, stop):
    """A thread that runs ``action`` once ``count()`` reaches ``n``."""
    def watch():
        while not stop.is_set():
            if count() >= n:
                action()
                return
            time.sleep(0.001)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    return t


def _latency_ms(replies):
    lat = np.sort(np.array([r.seconds for r in replies])) * 1e3
    return dict(p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)),
                max_ms=float(lat[-1]))


def _prob(reply):
    return np.asarray(reply["probability"], np.float64)


def _serve_one(torch, registry, events, serving, loader, root, rows, want, card, load):
    """(a): warm_restart_server at its defaults, 16 closed-loop keep-alive
    clients of SERVE_REQS single-row requests each."""
    reg = registry.MetricsRegistry()
    sizes = []

    def on_event(e):
        if isinstance(e, events.BatchFormed):
            sizes.append(e.size)

    bus = events.get_bus()
    bus.add_listener(on_event)
    srv = serving.warm_restart_server(loader, root=root, input_col="features",
                                      output_col="probability", registry=reg)
    try:
        if srv.model_version != 1:
            raise AssertionError(f"serving: warm restart served version {srv.model_version}")
        srv.start()
        bodies = [[_row_body(rows[c * SERVE_REQS + i]) for i in range(SERVE_REQS)]
                  for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        out = load.run(srv.info.url, bodies)
        wall = time.perf_counter() - t0
    finally:
        srv.stop()
        bus.remove_listener(on_event)
    replies = [r for c in out for r in c]
    bad = [r.status for r in replies if r.status != 200]
    if bad:
        raise AssertionError(f"serving (a): {len(bad)} replies were not 200: {sorted(set(bad))}")
    got = np.stack([_prob(r.body) for r in replies])
    err = np.abs(got - want)
    if not err.max() <= SERVE_TOL:
        raise AssertionError(f"serving (a): replies differ from transform by {err.max()}")
    bits = int(np.sum(np.any(got.astype(np.float32) != want.astype(np.float32), axis=1)))
    apply_h = reg.histogram("serving_apply_latency_seconds")
    size_h = reg.histogram("serving_batch_size")
    wait_h = reg.histogram("serving_queue_wait_seconds")
    rec = dict(card=card, clients=SERVE_CLIENTS, requests=len(replies), wall_s=wall,
               requests_per_s=len(replies) / wall, **_latency_ms(replies),
               batches=size_h.count, mean_batch=size_h.sum / size_h.count,
               max_batch=max(sizes), median_apply_ms=apply_h.percentile(0.5) * 1e3,
               mean_apply_ms=apply_h.sum / apply_h.count * 1e3,
               apply_share_of_wall=apply_h.sum / wall,
               mean_queue_wait_ms=wait_h.sum / wait_h.count * 1e3,
               max_abs_err=float(err.max()), replies_differing_in_any_bit=bits)
    print("serving (a) one server: " + json.dumps(rec), flush=True)
    return rec


def _hot_swap(torch, registry, events, serving, loader, store, text2, root, rows, want1, want2,
              card, load):
    """(b): the same server with watch=True; version 2 commits once the
    server has answered SWAP_AT requests."""
    swaps = []

    def on_event(e):
        if isinstance(e, events.ModelSwapped):
            swaps.append(e)

    bus = events.get_bus()
    bus.add_listener(on_event)
    reg = registry.MetricsRegistry()
    srv = serving.warm_restart_server(loader, root=root, watch=True, input_col="features",
                                      output_col="probability", registry=reg)
    answered = reg.counter("serving_requests_total")
    stop = threading.Event()
    n = SWAP_CLIENTS * SWAP_REQS
    try:
        srv.start()
        _when(lambda: answered.value, SWAP_AT, lambda: store.commit(text2, name="model"), stop)
        bodies = [[_row_body(rows[c * SWAP_REQS + i]) for i in range(SWAP_REQS)]
                  for c in range(SWAP_CLIENTS)]
        t0 = time.perf_counter()
        out = load.run(srv.info.url, bodies)
        wall = time.perf_counter() - t0
        health = json.loads(urllib.request.urlopen(srv.info.url + "healthz", timeout=10).read())
    finally:
        stop.set()
        srv.stop()
        bus.remove_listener(on_event)
    order = []
    for c in range(SWAP_CLIENTS):
        for i, r in enumerate(out[c]):
            if r.status != 200:
                raise AssertionError(f"serving (b): a reply was {r.status}")
            k = c * SWAP_REQS + i
            p = _prob(r.body)
            e1, e2 = np.abs(p - want1[k]).max(), np.abs(p - want2[k]).max()
            if min(e1, e2) > SERVE_TOL:
                raise AssertionError(f"serving (b): a reply is neither v1's nor v2's ({e1}, {e2})")
            order.append((r.end, 2 if e2 < e1 else 1))
    order.sort()
    versions = [v for _, v in order]
    tail = versions[-SWAP_TAIL:]
    if any(v != 2 for v in tail):
        raise AssertionError(f"serving (b): {tail.count(1)} of the last {SWAP_TAIL} replies "
                             "are version 1's")
    if len(swaps) != 1 or swaps[0].version != 2:
        raise AssertionError(f"serving (b): ModelSwapped events {swaps}")
    if health.get("model_version") != 2:
        raise AssertionError(f"serving (b): /healthz reports {health}")
    rec = dict(card=card, requests=n, wall_s=wall, requests_per_s=n / wall,
               committed_after=SWAP_AT, v1_replies=versions.count(1),
               first_v2_reply=versions.index(2), swaps=len(swaps),
               healthz_model_version=health["model_version"],
               **_latency_ms([r for c in out for r in c]))
    print("serving (b) hot swap: " + json.dumps(rec), flush=True)
    return rec


def _dispatch(torch, runtime, serving, model, rows, want, card, load):
    """(c): DistributedServingServer over 2 listeners and 4 executors, one
    executor killed by the FaultPlan: a fault check, its wall too short
    for a rate."""
    plan = runtime.FaultPlan(seed=29).kill_task(0)
    with runtime.inject_faults(plan):
        srv = serving.DistributedServingServer(model, num_servers=2, num_executors=4,
                                               input_col="features", output_col="probability")
        with srv:
            # client c posts to listener c % 2, each on its own connection
            urls = [srv.service_info[c % 2].url for c in range(DISPATCH_CLIENTS)]
            bodies = [[_row_body(rows[c * DISPATCH_REQS + i]) for i in range(DISPATCH_REQS)]
                      for c in range(DISPATCH_CLIENTS)]
            t0 = time.perf_counter()
            out = load.run(urls, bodies)
            wall = time.perf_counter() - t0
        summary = srv.scheduler.metrics.summary()
    n, worst = 0, 0.0
    for c, replies in enumerate(out):
        for i, r in enumerate(replies):
            if r.status != 200:
                raise AssertionError(f"serving (c): a reply was {r.status}")
            worst = max(worst, float(np.abs(_prob(r.body) - want[c * DISPATCH_REQS + i]).max()))
            n += 1
    if worst > SERVE_TOL:
        raise AssertionError(f"serving (c): replies differ from (a)'s values by {worst}")
    if plan.fired != [("kill", 0, 0)]:
        raise AssertionError(f"serving (c): the executor kill fired as {plan.fired}")
    if summary["failures_executor_death"] != 1 or summary["retries_total"] < 1:
        raise AssertionError(f"serving (c): RuntimeMetrics booked {summary['retries_total']} "
                             f"retries, {summary['failures_executor_death']} deaths")
    rec = dict(card=card, requests=n, wall_s=wall, max_abs_err=worst,
               retries_total=summary["retries_total"],
               failures_executor_death=summary["failures_executor_death"],
               tasks_done=summary["tasks_done"])
    print("serving (c) scheduler-backed dispatch: " + json.dumps(rec), flush=True)
    return rec


class _Fleet:
    """(d)'s registry and replica processes, started in the background so
    that the replicas' start overlaps (c) and (e)."""

    def __init__(self, serving, root, device, work):
        self.reg_svc = serving.RegistrationService(ttl_s=FLEET_TTL_S).start()
        self.wd = os.path.join(work, "replicas")
        env = dict(os.environ, SMOKE_SERVING_ROOT=root, SMOKE_SERVING_DEVICE=device)
        self.sup = serving.ReplicaSupervisor(
            "chip_smoke:serving_replica_factory", num_replicas=2, workdir=self.wd, env=env,
            seed=29, ready_timeout_s=120.0, registry_url=self.reg_svc.info.url,
            registry_heartbeat_s=0.25,
            server_options={"input_col": "features", "output_col": "probability"})
        self.error = None
        self.start_s = None
        self.ready_at = None
        self.committed_at = None
        self.stopped = False

        def start():
            t0 = time.perf_counter()
            try:
                self.sup.start()
                self.ready_at = time.perf_counter()
                self.start_s = self.ready_at - t0
            except Exception as e:  # re-raised by ready()
                self.error = e

        self._thread = threading.Thread(target=start, daemon=True)
        self._thread.start()

    def ready(self):
        self._thread.join(timeout=180.0)
        if self.error is not None:
            raise self.error
        if self.start_s is None:
            raise AssertionError("serving (d): the replicas did not start")

    def replica(self, index):
        try:
            with open(os.path.join(self.wd, f"ready-{index}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def stop(self):
        """Stop the replicas and the registry (once; later calls return [])."""
        if self.stopped:
            return []
        self.stopped = True
        self._thread.join(timeout=180.0)
        final = self.sup.stop()
        self.reg_svc.stop()
        return final


def _fleet(torch, registry, serving, fleet, rows, want, card, load):
    """(d): a TTL'd RegistrationService, 2 replica processes serving the
    committed text, a least-loaded FleetRouter; replica 0 SIGKILLed once
    the router has answered FLEET_KILL_AT requests, respawned by the
    supervisor (respawn_s: from the kill to the new replica's ready file),
    its dead lease expired."""
    reg_svc, sup = fleet.reg_svc, fleet.sup
    router_requests = registry.get_registry().counter("router_requests_total")
    failovers = registry.get_registry().counter("router_failovers_total")
    failovers0, requests0 = failovers.value, router_requests.value
    marks, losses = {}, []
    stop = threading.Event()
    router = None
    try:
        fleet.ready()
        deadline = time.monotonic() + 30.0
        while len(reg_svc.services) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        if len(reg_svc.services) != 2:
            raise AssertionError(f"serving (d): {len(reg_svc.services)} replicas registered")
        router = serving.FleetRouter(registry_url=reg_svc.info.url, policy="least_loaded",
                                     discovery_interval_s=0.25).start()
        victim = fleet.replica(0)

        def kill():
            os.kill(victim["pid"], signal.SIGKILL)
            marks["killed"] = time.perf_counter()

        def supervise():
            # the supervision loop: book the loss and respawn, and note when
            # the dead lease leaves discovery and the new one joins it
            while not stop.is_set():
                got = sup.poll()
                now = time.perf_counter()
                if got:
                    losses.extend(got)
                    marks.setdefault("loss_booked", now)
                ports = {s.port for s in reg_svc.services}
                if "killed" in marks and victim["port"] not in ports:
                    marks.setdefault("lease_gone", now)
                new = fleet.replica(0)
                if new is not None and new["pid"] != victim["pid"]:
                    marks.setdefault("respawned_ready", now)
                    if new["port"] in ports:
                        marks.setdefault("new_lease", now)
                time.sleep(0.05)

        watcher = threading.Thread(target=supervise, daemon=True)
        watcher.start()
        _when(lambda: router_requests.value - requests0, FLEET_KILL_AT, kill, stop)
        bodies = [[_row_body(rows[c * FLEET_REQS + i]) for i in range(FLEET_REQS)]
                  for c in range(FLEET_CLIENTS)]
        t_load = time.perf_counter()
        out = load.run(router.url, bodies)
        load_s = time.perf_counter() - t_load
        deadline = time.monotonic() + 60.0
        while (not {"lease_gone", "new_lease"} <= set(marks)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        stop.set()
        watcher.join(timeout=10.0)
        services = {s.port for s in reg_svc.services}
        new = fleet.replica(0)
    finally:
        stop.set()
        if router is not None:
            router.stop()
        final = fleet.stop()
    replies = [r for c in out for r in c]
    statuses, worst = {}, 0.0
    for c in range(FLEET_CLIENTS):
        for i, r in enumerate(out[c]):
            statuses[r.status] = statuses.get(r.status, 0) + 1
            if r.status == 200:
                worst = max(worst, float(np.abs(_prob(r.body) - want[c * FLEET_REQS + i]).max()))
    if set(statuses) - {200, 429, 503}:
        raise AssertionError(f"serving (d): clients saw {statuses}")
    if worst > SERVE_TOL:
        raise AssertionError(f"serving (d): a 200 differs from the model's value by {worst}")
    if "killed" not in marks:
        raise AssertionError("serving (d): replica 0 was never killed")
    if [(x.member, x.reason) for x in losses] != [(0, "signal:9")]:
        raise AssertionError(f"serving (d): the supervisor booked {losses}")
    if not {"lease_gone", "new_lease"} <= set(marks) or new["port"] not in services:
        raise AssertionError(f"serving (d): respawn and lease expiry not both seen: {marks}")
    if victim["port"] in services:
        raise AssertionError("serving (d): the dead replica's lease is still listed")
    lat = _latency_ms(replies)
    # a replica's own start is respawn_s: the first two spawn before the v1
    # fit and wait for its commit, so ready_after_spawn_s holds the fit
    rec = dict(card=card, replicas=2, ready_after_spawn_s=fleet.start_s,
               ready_after_commit_s=fleet.ready_at - fleet.committed_at, requests=len(replies),
               load_s=load_s, requests_per_s=len(replies) / load_s,
               statuses={str(k): v for k, v in sorted(statuses.items())},
               router_p50_ms=lat["p50_ms"], router_p99_ms=lat["p99_ms"],
               router_max_ms=lat["max_ms"], failovers=int(failovers.value - failovers0),
               loss_booked_after_kill_s=marks["loss_booked"] - marks["killed"],
               respawn_s=marks["respawned_ready"] - marks["killed"],
               lease_expired_after_kill_s=marks["lease_gone"] - marks["killed"],
               new_lease_after_kill_s=marks["new_lease"] - marks["killed"],
               ttl_s=FLEET_TTL_S, max_abs_err=worst,
               exit_statuses=[[x.member, x.reason] for x in sup.exit_statuses + final])
    print("serving (d) fleet: " + json.dumps(rec), flush=True)
    return rec


def _guard(torch, runtime, events, serving, model, rows, card, load):
    """(e): one client floods seeded malformed requests while a healthy
    client sends rows on its own connection: a guard check, no rate."""
    plan = runtime.FaultPlan(seed=29)
    for kind, n in GUARD_FLOOD:
        plan.malformed_request(count=n, kind=kind)
    poison = []
    while (kind := plan.take_malformed()) is not None:
        row = [float(v) for v in rows[len(poison)]]
        if kind == "json":
            poison.append((kind, '{"features": [0.25, broken'))
        elif kind == "nan":
            row[3] = float("nan")
            poison.append((kind, json.dumps({"features": row})))
        else:
            poison.append((kind, json.dumps({"features": row[:-5]})))
    released = []

    def on_event(e):
        if isinstance(e, events.PoisonClientReleased):
            released.append(e)

    bus = events.get_bus()
    bus.add_listener(on_event)
    srv = serving.ServingServer(model, input_col="features", output_col="probability",
                                malformed_reset_s=GUARD_RESET_S).start()
    try:
        healthy, flood = load.run(
            srv.info.url, [[_row_body(r) for r in rows[:GUARD_HEALTHY]], [b for _, b in poison]],
            headers=[{"X-Client-Id": "healthy"}, {"X-Client-Id": "poison"}])
        t_shed = time.perf_counter()
        time.sleep(GUARD_RESET_S)
        after = load.run(srv.info.url, [[_row_body(rows[0])]],
                         headers=[{"X-Client-Id": "poison"}])[0]
    finally:
        srv.stop()
        bus.remove_listener(on_event)
    threshold = srv.malformed_breaker.threshold
    statuses = [r.status for r in flood]
    if statuses != [400] * threshold + [429] * (len(poison) - threshold):
        raise AssertionError(f"serving (e): the flood's statuses were {statuses}")
    for (kind, _), r in zip(poison, flood):
        if not r.trace_id:
            raise AssertionError("serving (e): a reply lacks X-Trace-Id")
        got = r.body["error"]["kind"]
        if got != (GUARD_KINDS[kind] if r.status == 400 else "malformed-rate"):
            raise AssertionError(f"serving (e): a {kind} request got {r.status} {got}")
    if [r.status for r in healthy] != [200] * len(healthy):
        raise AssertionError("serving (e): the healthy client was refused")
    if [r.status for r in after] != [200] or len(released) != 1:
        raise AssertionError(f"serving (e): after reset_s the poison client got "
                             f"{[r.status for r in after]}, {len(released)} releases")
    rec = dict(card=card, poison_requests=len(poison), rejected_400=threshold,
               shed_429=len(poison) - threshold, healthy_requests=len(healthy),
               released_after_s=released[0].blocked_s, reset_s=GUARD_RESET_S,
               readmitted_after_s=time.perf_counter() - t_shed)
    print("serving (e) request guard: " + json.dumps(rec), flush=True)
    return rec


def _timed_part(parts, name, fn, *args):
    """``fn(*args)``, its wall in seconds booked as ``parts[name]``."""
    t0 = time.perf_counter()
    out = fn(*args)
    parts[name] = time.perf_counter() - t0
    return out


def phase_serving(torch, uh, hh, runtime, registry, events, serving, journal, Table,
                  LightGBMClassifier, LightGBMClassificationModel, higgs):
    """Phase 29 (see the module docstring). Runs (c), (e) and (d) first,
    while (d)'s replicas start, then (a) and (b) with no other process on
    the card."""
    # the earlier phases' objects move out of the collector's reach, so that
    # serving's short-lived garbage does not rescan them
    gc.collect()
    gc.freeze()
    try:
        return _serving(torch, uh, hh, runtime, registry, events, serving, journal, Table,
                        LightGBMClassifier, LightGBMClassificationModel, higgs)
    finally:
        gc.unfreeze()


def _serving(torch, uh, hh, runtime, registry, events, serving, journal, Table,
             LightGBMClassifier, LightGBMClassificationModel, higgs):
    from mmlspark_tpu_torch.device import resolve_device

    card = _card_line()
    device = HIGGS_PARAMS["device"]
    work = os.path.join(DATA_DIR, "serving")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "ckpt")
    fleet_root = os.path.join(work, "fleet_ckpt")
    train_t = Table({"features": higgs["X"][:N_SERVE_FIT], "label": higgs["y"][:N_SERVE_FIT]})
    # (d)'s replicas and the load generator start now, beside the fits
    fleet = _Fleet(serving, fleet_root, device, work)
    load = _LoadGen()
    try:
        t0 = time.perf_counter()
        v1 = LightGBMClassifier(**dict(SERVE_PARAMS, device=device)).fit(train_t)
        t1 = time.perf_counter()
        if resolve_device(v1.getDevice()).type != resolve_device(device).type:
            raise AssertionError(f"serving: the model resolves to {v1.getDevice()}")
        text1 = v1.get_model_string()
        store = journal.ModelStore(os.path.join(root, "models"))
        if store.commit(text1, name="model") != 1:
            raise AssertionError("serving: version 1 did not commit as 1")
        journal.ModelStore(os.path.join(fleet_root, "models")).commit(text1, name="model")
        fleet.committed_at = time.perf_counter()
        t2 = time.perf_counter()
        v2 = LightGBMClassifier(**dict(SERVE_PARAMS, device=device, **SERVE_V2)).fit(train_t)
        t3 = time.perf_counter()
        text2 = v2.get_model_string()
        loader = functools.partial(LightGBMClassificationModel.from_model_string, device=device)
        served = loader(text1)
        if resolve_device(served.getDevice()).type != resolve_device(device).type:
            raise AssertionError(f"serving: the served model resolves to {served.getDevice()}")
        rows = higgs["X_test"][:SERVE_CLIENTS * SERVE_REQS]
        want1 = np.asarray(served.transform(Table({"features": rows})).column("probability"))
        want2 = np.asarray(loader(text2).transform(Table({"features": rows}))
                           .column("probability"))
        fits = dict(card=card, rows=N_SERVE_FIT, v1_fit_s=t1 - t0, v2_fit_s=t3 - t2,
                    v1_trees=v1.booster.num_trees, v2_trees=v2.booster.num_trees,
                    v1_max_depth=served.booster.max_depth,
                    v1_v2_max_prob_diff=float(np.abs(want1 - want2).max()))
        print("serving fits: " + json.dumps(fits), flush=True)
        torch.cuda.synchronize()
        _zero_counts(uh, hh)
        parts = dict(fits_s=time.perf_counter() - t0)
        dispatch = _timed_part(parts, "c_s", _dispatch, torch, runtime, serving, served, rows,
                               want1, card, load)
        guard = _timed_part(parts, "e_s", _guard, torch, runtime, events, serving, served, rows,
                            card, load)
        fleet_rec = _timed_part(parts, "d_s", _fleet, torch, registry, serving, fleet, rows,
                                want1, card, load)
        one = _timed_part(parts, "a_s", _serve_one, torch, registry, events, serving, loader,
                          root, rows, want1, card, load)
        swap = _timed_part(parts, "b_s", _hot_swap, torch, registry, events, serving, loader,
                           store, text2, root, rows, want1, want2, card, load)
    finally:
        load.close()
        fleet.stop()
    print("serving parts: " + json.dumps(dict(card=card, **parts)), flush=True)
    counts = _counts(uh, hh)
    if any(counts.values()):
        raise AssertionError(f"serving launched a histogram kernel: {counts}")
    shutil.rmtree(work, ignore_errors=True)
    return dict(fits=fits, one=one, swap=swap, dispatch=dispatch, fleet=fleet_rec, guard=guard,
                parts=parts, kernel_launches=counts)


N_STREAM = 4_000_000  # phase 30's streamed rows: the first of phase 5's (cut from 8M for time)
STREAM_CHUNK = 500_000  # rows a part-NNNNN.npz, one epoch each (max_per_trigger=1; cut from 1M)
STREAM_KILLS = ((2, "post_wal"), (5, "pre_commit"))  # the chaos run's SIGKILLs
STREAM_FAULT_SEED = 30
N_STREAM_CPU = 100_000  # rows of each of the 2 epochs on the card and the CPU port
N_STREAM_SERVE, STREAM_SERVE_CLIENTS = 2_000, 8
STREAM_MODEL = "stream"
CAMPAIGN_SEED = 31  # phase 31's MMLSPARK_TPU_FAULT_SEED
CAMPAIGN_TIMEOUT_S = 300
CAMPAIGN_REPORTED_CHECK = "steady_p99_within_target"  # printed, not held


def _write_stream_chunks(sharded, X, y, incoming, rows, chunk):
    """``X[:rows]`` and ``y[:rows]`` as part-NNNNN.npz chunks of ``chunk``
    rows, each with its CRC sidecar, published by write-then-rename (a
    dotfile until its sidecar exists)."""
    os.makedirs(incoming, exist_ok=True)
    for i, lo in enumerate(range(0, rows, chunk)):
        hi = min(lo + chunk, rows)
        final = os.path.join(incoming, f"part-{i:05d}.npz")
        tmp = os.path.join(incoming, f".part-{i:05d}.tmp.npz")
        np.savez(tmp, features=X[lo:hi], label=y[lo:hi])
        sidecar = sharded.write_shard_sidecar(tmp)
        os.replace(sidecar, final + ".crc32")
        os.replace(tmp, final)


def _stream_query(streaming, LightGBMClassifier, params, incoming, root, registry=None):
    """An AvailableNow query over ``incoming`` (one chunk an epoch) into a
    ModelCommitSink under ``root``; returns the sink after the drain."""
    sink = streaming.ModelCommitSink(lambda: LightGBMClassifier(**params), name=STREAM_MODEL,
                                     root=root, registry=registry)
    query = streaming.StreamingQuery(
        streaming.FileStreamSource(incoming, pattern="part-*.npz", max_per_trigger=1), sink,
        trigger=streaming.AvailableNow(), name=STREAM_MODEL,
        checkpoint_dir=os.path.join(root, "streaming", STREAM_MODEL), registry=registry)
    query.start()
    query.await_termination()
    sink.close()
    if query.exception is not None:
        raise query.exception
    return sink, query


def _manual_chain(Table, LightGBMClassifier, Booster, merge, params, incoming):
    """The streamed fits by hand: each chunk a warm-start fit from the
    ensemble so far (modelString), its delta merged on; the final text."""
    text = None
    for name in sorted(n for n in os.listdir(incoming) if n.endswith(".npz")
                       and not n.startswith(".")):
        with np.load(os.path.join(incoming, name)) as npz:
            chunk = {"features": npz["features"], "label": npz["label"]}
        est = LightGBMClassifier(**params)
        if text:
            est.set("modelString", text)
        delta = est.fit(Table(chunk)).booster
        text = (merge([Booster.from_string(text), delta]) if text else delta).model_to_string()
    return text


def _stream_serving(torch, registry, events, serving, slo, history, Table,
                    LightGBMClassificationModel, root, X_test, work, card):
    """A ServingServer with hot swap on the stream's ModelStore (warm restart
    from the last committed version, watching CURRENT): N_STREAM_SERVE
    held-out rows as single-row requests from STREAM_SERVE_CLIENTS clients,
    each reply within SERVE_TOL of one transform by that version; then the
    SLO fold over the server's registry and events, and the history page."""
    device = HIGGS_PARAMS["device"]
    loader = functools.partial(LightGBMClassificationModel.from_model_string, device=device)
    reg = registry.MetricsRegistry()
    seen = []
    bus = events.get_bus()
    bus.add_listener(seen.append)
    load = _LoadGen()
    try:
        srv = serving.warm_restart_server(loader, root=root, name=STREAM_MODEL, watch=True,
                                          input_col="features", output_col="probability",
                                          registry=reg)
        version = srv.model_version
        last, model = serving.recover_model(loader, root=root, name=STREAM_MODEL)
        if last != version:
            raise AssertionError(f"streaming serve: serves v{version}, store holds v{last}")
        rows = X_test[:N_STREAM_SERVE]
        want = np.asarray(model.transform(Table({"features": rows})).column("probability"))
        per = N_STREAM_SERVE // STREAM_SERVE_CLIENTS
        bodies = [[_row_body(rows[c * per + i]) for i in range(per)]
                  for c in range(STREAM_SERVE_CLIENTS)]
        try:
            srv.start()
            t0 = time.perf_counter()
            out = load.run(srv.info.url, bodies)
            wall = time.perf_counter() - t0
        finally:
            srv.stop()
    finally:
        load.close()
        bus.remove_listener(seen.append)
    replies = [r for c in out for r in c]
    bad = [r.status for r in replies if r.status != 200]
    if bad:
        raise AssertionError(f"streaming serve: {len(bad)} replies were not 200")
    got = np.stack([_prob(r.body) for r in replies])
    err = float(np.abs(got - want).max())
    if not err <= SERVE_TOL:
        raise AssertionError(f"streaming serve: replies differ from transform by {err}")
    report = slo.SLOReport.fold(reg, events=seen)
    html_path = os.path.join(work, "report.html")
    with open(html_path, "w") as fh:
        fh.write(history.render_report(seen, metrics=reg.summary(),
                                       title="streamed LightGBM, served"))
    rec = dict(card=card, version=version, requests=len(replies), wall_s=wall,
               requests_per_s=len(replies) / wall, max_abs_err=err,
               slo_apply_p50_ms=report.apply_p50_ms, slo_apply_p99_ms=report.apply_p99_ms,
               slo_e2e_p50_ms=report.e2e["p50"] * 1e3, slo_e2e_p99_ms=report.e2e["p99"] * 1e3,
               slo_availability=1.0 - report.error_rate, slo_ok=report.ok(),
               history_html_bytes=os.path.getsize(html_path))
    print("streaming serve and SLO: " + json.dumps(rec), flush=True)
    return rec


def phase_streaming(torch, uh, hh, rates, base, train, objectives, sharded, streaming, serving,
                    registry, events, slo, history, Table, LightGBMClassifier,
                    LightGBMClassificationModel, Booster, auc, higgs):
    """Phase 30 (see the module docstring). The undisturbed run has the
    card and the host to itself, so that its epoch split is an epoch's;
    the chaos run's children start after it and run beside the manual
    chain, the CPU check, the AUC and the serving in this process."""
    card = _card_line()
    work = os.path.join(DATA_DIR, "stream")
    shutil.rmtree(work, ignore_errors=True)
    incoming, small = os.path.join(work, "incoming"), os.path.join(work, "incoming_small")
    parts = {}
    t0 = time.perf_counter()
    _write_stream_chunks(sharded, higgs["X"], higgs["y"], incoming, N_STREAM, STREAM_CHUNK)
    _write_stream_chunks(sharded, higgs["X"], higgs["y"], small, 2 * N_STREAM_CPU,
                         N_STREAM_CPU)
    parts["write_s"] = time.perf_counter() - t0
    params = dict(HIGGS_PARAMS)
    chaos_cmd = [sys.executable, os.path.join(ROOT, "tools", "torch_streaming_chaos_smoke.py"),
                 "--incoming", incoming, "--work", os.path.join(work, "chaos_work"),
                 "--params", json.dumps(params), "--chaos-only"]
    if params["device"] != "cpu":
        # the children load phase 2's build: a child SIGKILLed while building
        # would hold the build lock
        from mmlspark_tpu_torch.kernels.build import histogram_extension

        chaos_cmd += ["--kernel-library", histogram_extension().__file__]
    for epoch, point in STREAM_KILLS:
        chaos_cmd += ["--kill", f"{epoch}:{point}"]
    # the undisturbed run, in this process: launches counted, the last
    # epoch's bins kept for the kernel check, and an epoch's fit split
    # into binning, the warm start's margins and train() (upload and
    # boosting)
    root = os.path.join(work, "undisturbed")
    reg = registry.MetricsRegistry()
    binned, split = [], {}
    saved = _timed_calls(base, ("bin_dataset", "train"), split)
    saved_margin = _timed_calls(Booster, ("raw_margin",), split)
    timed_bins = base.bin_dataset

    def keep_bins(*a, **kw):
        out = timed_bins(*a, **kw)
        binned[:] = [out]
        return out

    base.bin_dataset = keep_bins
    torch.cuda.synchronize()
    _zero_counts(uh, hh)
    try:
        t1 = time.perf_counter()
        sink, query = _stream_query(streaming, LightGBMClassifier, params, incoming, root,
                                    registry=reg)
        torch.cuda.synchronize()
        parts["undisturbed_s"] = time.perf_counter() - t1
    finally:
        for name, fn in saved.items():
            setattr(base, name, fn)
        Booster.raw_margin = saved_margin["raw_margin"]
    counts = _counts(uh, hh)
    _need(counts, ("hist_panel", "hist_combined"), "streaming undisturbed run")
    epochs = N_STREAM // STREAM_CHUNK
    text = sink.latest_text()
    version = sink.store.latest(STREAM_MODEL)[0]
    if sink.committed_epochs != list(range(epochs)) or query.committed_epochs != list(
            range(epochs)) or version != epochs:
        raise AssertionError(f"streaming: epochs {sink.committed_epochs}, commits "
                             f"{query.committed_epochs}, version {version}")
    fit_h = reg.histogram("streaming_fit_seconds")
    epoch_h = reg.histogram("streaming_epoch_seconds").labels(query=STREAM_MODEL)
    undisturbed = dict(card=card, rows=N_STREAM, epochs=epochs, version=version,
                       seconds=parts["undisturbed_s"],
                       mean_epoch_s=epoch_h.sum / epoch_h.count,
                       mean_fit_s=fit_h.sum / fit_h.count,
                       mean_binning_s=split["bin_dataset"] / epochs,
                       mean_warm_start_margin_s=split["raw_margin"] / epochs,
                       mean_train_s=split["train"] / epochs,
                       trees=Booster.from_string(text).num_trees, launches=counts)

    # the kernels on the last epoch's bins and its iteration-0 stats:
    # the gradient at the ensemble-so-far's margins (the warm start)
    bins, _ = binned[0]
    binned.clear()
    dev = torch.device("cuda")
    lo = (epochs - 1) * STREAM_CHUNK
    prev = Booster.from_string(sink._committed[epochs - 2])
    margins = torch.as_tensor(prev.raw_margin(higgs["X"][lo:lo + STREAM_CHUNK], device=dev),
                              device=dev)
    yd = torch.as_tensor(higgs["y"][lo:lo + STREAM_CHUNK].astype(np.float32), device=dev)
    g, h = objectives.get_objective("binary").grad_hess(margins, yd, torch.ones_like(yd))
    bins_t = train.upload_bins(bins, dev)
    kernels = _path_kernels(torch, hh, rates, "stream last epoch bins", bins_t, g[:, 0],
                            h[:, 0], NUM_BINS)
    del bins, bins_t, g, h, margins, yd

    # the chaos run, in child processes beside the rest of the phase
    t_chaos = time.perf_counter()
    chaos = subprocess.Popen(chaos_cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True,
                             env=dict(os.environ, MMLSPARK_TPU_FAULT_SEED=str(STREAM_FAULT_SEED)))
    try:
        # the manual chain of the same eight warm-start fits
        t1 = time.perf_counter()
        chained = _manual_chain(Table, LightGBMClassifier, Booster, base._merge_boosters, params,
                                incoming)
        parts["manual_chain_s"] = time.perf_counter() - t1
        if chained != text:
            raise AssertionError("streaming: the streamed text differs from the manual chain")

        # card against the CPU port: 2 epochs of N_STREAM_CPU rows
        t1 = time.perf_counter()
        card_small, _ = _stream_query(streaming, LightGBMClassifier, params, small,
                                      os.path.join(work, "small_card"))
        cpu_small, _ = _stream_query(streaming, LightGBMClassifier, dict(params, device="cpu"),
                                     small, os.path.join(work, "small_cpu"))
        parts["card_vs_cpu_s"] = time.perf_counter() - t1
        if card_small.latest_text() != cpu_small.latest_text():
            raise AssertionError("streaming: the card's 2-epoch text differs from the CPU port's")

        # held-out AUC of the final version
        t1 = time.perf_counter()
        final = LightGBMClassificationModel.from_model_string(text, device=params["device"])
        prob = np.asarray(final.transform(Table({"features": higgs["X_test"]}))
                          .column("probability"))
        test_auc = auc(higgs["y_test"], prob[:, 1], np.ones(len(prob)))
        parts["auc_s"] = time.perf_counter() - t1
        if not test_auc > 0.75:
            raise AssertionError(f"streaming: held-out AUC {test_auc} is too low")
        served = _timed_part(parts, "serve_s", _stream_serving, torch, registry, events,
                             serving, slo, history, Table, LightGBMClassificationModel, root,
                             higgs["X_test"], work, card)

        # the chaos run: same version, same text, each epoch once
        t1 = time.perf_counter()
        out, _ = chaos.communicate(timeout=600)
        parts["chaos_wait_s"] = time.perf_counter() - t1
        parts["chaos_s"] = time.perf_counter() - t_chaos
    finally:
        if chaos.poll() is None:
            chaos.kill()
            chaos.wait()
    if chaos.returncode != 0:
        raise AssertionError(f"streaming chaos run exited {chaos.returncode}: {out[-2000:]}")
    chaos_rec = json.loads(out.strip().splitlines()[-1])
    from mmlspark_tpu_torch.runtime.journal import ModelStore

    chaos_version, chaos_text = ModelStore(os.path.join(chaos_rec["chaos_root"], "models")
                                           ).latest("chaos")
    if (chaos_version, chaos_text) != (version, text):
        raise AssertionError(f"streaming chaos: v{chaos_version} differs from the undisturbed "
                             f"v{version} (text equal: {chaos_text == text})")
    if chaos_rec["commits"] != list(range(epochs)) or chaos_rec["journal"] != list(range(epochs)):
        raise AssertionError(f"streaming chaos: commits {chaos_rec['commits']}, journal "
                             f"{chaos_rec['journal']}")
    chaos_rec = dict(card=card, kills=chaos_rec["kills"], version=chaos_version,
                     text_equal=True, commits=chaos_rec["commits"],
                     journal=chaos_rec["journal"], children=chaos_rec["children"],
                     seconds=parts["chaos_s"])
    rec = dict(undisturbed=undisturbed, chaos=chaos_rec, chain_text_equal=True,
               card_cpu=dict(rows_per_epoch=N_STREAM_CPU, epochs=2, text_equal=True),
               held_out_auc=test_auc, serve=served, parts=dict(card=card, **parts),
               kernels=kernels, launches=counts)
    print("streaming: " + json.dumps({k: v for k, v in rec.items() if k != "kernels"}),
          flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return rec


N_TRAINERS = 1_000_000  # benchm-ml's 1M training size
N_TRAINERS_CPU = 30_000  # phase 32's card-against-CPU rows (equal text), cut from 100,000
N_TRAINERS_REG = 250_000  # phase 32's regression rows
N_TRAINERS_REG_TEST = 100_000
TRAINERS_PARAMS = dict(numIterations=FIT_ITERS, numLeaves=31, maxBin=NUM_BINS - 1)
# benchm-ml's 22 UniqueCarrier codes (the 2005-2007 airline rows)
AIR_CARRIERS = ("AA", "AQ", "AS", "B6", "CO", "DH", "DL", "EV", "F9", "FL", "HA", "HP", "MQ",
                "NW", "OH", "OO", "TZ", "UA", "US", "WN", "XE", "YV")
TRAINERS_PLAN = {"Month": "categorical", "DayofMonth": "categorical",
                 "DayOfWeek": "categorical", "UniqueCarrier": "categorical", "Origin": "text",
                 "Dest": "text", "DepTime": "numeric", "Distance": "numeric"}
TRAINERS_WIDTH = 13 + 32 + 8 + 23 + 2 * 256 + 2  # one-hot levels + unknown, hashed, numeric


def _airport_codes(n, seed):
    """``n`` distinct three-letter codes, drawn from a seed."""
    picks = np.random.default_rng(seed).choice(26 ** 3, size=n, replace=False)
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    return [letters[p // 676] + letters[p // 26 % 26] + letters[p % 26] for p in picks]


def _raw_airline(X, y):
    """Phase 10's airline rows as benchm-ml's raw CSV gives them: Month,
    DayofMonth and DayOfWeek as "c-N" strings, UniqueCarrier as carrier
    codes, Origin and Dest as three-letter airport codes, DepTime and
    Distance as integers, dep_delayed_15min as "Y"/"N"."""
    airports = _airport_codes(AIR_CATEGORICAL[4][1], seed=32)
    cols = {}
    for j, (name, card) in enumerate(AIR_CATEGORICAL):
        values = (AIR_CARRIERS if name == "UniqueCarrier" else
                  airports if name in ("Origin", "Dest") else
                  [f"c-{v}" for v in range(1, card + 1)])
        cols[name] = np.array(values, dtype=object)[X[:, j].astype(np.int64) - 1]
    cols["DepTime"] = X[:, -2].astype(np.int64)
    cols["Distance"] = X[:, -1].astype(np.int64)
    cols["dep_delayed_15min"] = np.array(["N", "Y"], dtype=object)[(y > 0).astype(np.int64)]
    return cols


def _rows(cols, lo, hi, Table, drop=()):
    return Table({k: v[lo:hi] for k, v in cols.items() if k not in drop})


def phase_trainers(torch, uh, hh, rates, base, objectives, train, featurize, Table, PipelineStage,
                   LightGBMClassifier, LightGBMRegressor, TrainClassifier, TrainRegressor, auc,
                   card):
    """benchm-ml's raw airline rows through TrainClassifier and
    TrainRegressor as a user calls them: (a) Featurize's plan, fit and
    transform of 1,000,000 rows against phase 10's numeric-code fit; (b) the
    first N_TRAINERS_CPU rows on the card and on the CPU port; (c) save and load;
    (d) histogram.cu on the featurized bins; (e) a regression."""
    n, n_test = N_TRAINERS, N_TEST
    X, y, latent = _airline_data(n + n_test, seed=7, latent=True)
    cols = _raw_airline(X, y)
    label = "dep_delayed_15min"
    rec = {"card": card}

    # (a) fit and transform, the featurizer and the learner's parts timed apart
    seconds = {}
    saved = {cls: _timed_calls(cls, (name,), seconds)
             for cls, name in ((featurize.Featurize, "_fit"),
                               (featurize.FeaturizeModel, "transform"))}
    binned = []
    bin_dataset = base.bin_dataset

    def keep_bins(*a, **kw):
        out = bin_dataset(*a, **kw)
        binned.append(out)
        return out

    base.bin_dataset = keep_bins
    trainer = TrainClassifier(model=LightGBMClassifier(**TRAINERS_PARAMS, device="cuda"),
                              labelCol=label)
    try:
        torch.cuda.synchronize()
        _zero_counts(uh, hh)
        t0 = time.perf_counter()
        model = trainer.fit(_rows(cols, 0, n, Table))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = _counts(uh, hh)
        fit_seconds = dict(seconds)
        seconds.clear()
        t1 = time.perf_counter()
        out = model.transform(_rows(cols, n, n + n_test, Table, drop=(label,)))
        transform_s = time.perf_counter() - t1
    finally:
        base.bin_dataset = bin_dataset
        for cls, fns in saved.items():
            for name, fn in fns.items():
                setattr(cls, name, fn)
    _need(counts, ("hist_panel", "hist_combined"), "trainers fit")
    plans = {p["col"]: p["kind"] for p in model.getFeaturizerModel().getPlans()}
    if plans != TRAINERS_PLAN:
        raise AssertionError(f"Featurize planned {plans}, expected {TRAINERS_PLAN}")
    bins, _ = binned[0]
    if bins.shape != (n, TRAINERS_WIDTH):
        raise AssertionError(f"featurized bins {bins.shape}, expected ({n}, {TRAINERS_WIDTH})")
    pred = out["prediction"]
    if not set(np.unique(pred.astype(str))) <= {"N", "Y"} or len(pred) != n_test:
        raise AssertionError(f"predictions outside Y/N: {np.unique(pred.astype(str))[:5]}")
    y_test = y[n:]
    prob = out["probability"][:, 1]
    st = model.getFittedModel().fit_stats
    numeric = LightGBMClassifier(**TRAINERS_PARAMS, device="cuda").fit(
        Table({"features": X[:n], "label": y[:n]}))
    numeric_auc = auc(y_test, numeric.transform(Table({"features": X[n:]}))["probability"][:, 1],
                      np.ones(n_test))
    held_out = auc(y_test, prob, np.ones(n_test))
    rec["fit"] = dict(
        rows=n, test_rows=n_test, columns=TRAINERS_WIDTH, plans=plans, fit_s=fit_s,
        featurize_fit_s=fit_seconds["_fit"], featurize_transform_s=fit_seconds["transform"],
        binning_s=st.binning_seconds, boosting_s=st.boost_seconds, trees=st.trees,
        passes=st.passes, transform_s=transform_s,
        test_featurize_transform_s=seconds["transform"], held_out_auc=held_out,
        numeric_codes_auc=numeric_auc, predictions_y=int((pred == "Y").sum()), launches=counts)
    print("trainers fit: " + json.dumps(rec["fit"]), flush=True)
    del numeric

    # (b) the card against the CPU port on the first N_TRAINERS_CPU rows
    m = N_TRAINERS_CPU
    fits = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        fitted = TrainClassifier(model=LightGBMClassifier(**TRAINERS_PARAMS, device=dev),
                                 labelCol=label).fit(_rows(cols, 0, m, Table))
        fits[dev] = (fitted, time.perf_counter() - t0)
    texts = {dev: f.getFittedModel().get_model_string() for dev, (f, _) in fits.items()}
    test_m = _rows(cols, n, n + m, Table, drop=(label,))
    preds = {dev: f.transform(test_m)["prediction"] for dev, (f, _) in fits.items()}
    rec["card_cpu"] = dict(rows=m, text_equal=texts["cuda"] == texts["cpu"],
                           predictions_equal=bool(np.array_equal(preds["cuda"], preds["cpu"])),
                           card_fit_s=fits["cuda"][1], cpu_fit_s=fits["cpu"][1], card=card)
    print("trainers card against CPU: " + json.dumps(rec["card_cpu"]), flush=True)
    if not (rec["card_cpu"]["text_equal"] and rec["card_cpu"]["predictions_equal"]):
        raise AssertionError(f"trainers card against CPU: {rec['card_cpu']}")
    del fits, texts, preds

    # (c) save, load, transform the first N_TRAINERS_CPU held-out rows again
    path = os.path.join(DATA_DIR, "trainers", "model")
    t0 = time.perf_counter()
    model.save(path)
    save_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    loaded = PipelineStage.load(path)
    load_s = time.perf_counter() - t1
    again = loaded.transform(_rows(cols, n, n + m, Table, drop=(label,)))
    equal = {c: bool(np.array_equal(out[c][:m], again[c])) for c in out.columns}
    rec["save_load"] = dict(save_s=save_s, load_s=load_s, bytes_on_disk=_dir_bytes(path),
                            rows=m, columns_equal=equal)
    print("trainers save/load: " + json.dumps(rec["save_load"]), flush=True)
    if not all(equal.values()) or type(loaded).__name__ != "TrainedClassifierModel":
        raise AssertionError(f"trainers save/load: {rec['save_load']}")
    del loaded, again, out

    # (d) histogram.cu on the featurized bins at iteration 0's stats
    dev = torch.device("cuda")
    bins_t = train.upload_bins(bins, dev)
    del binned, bins
    g, h = _iteration0(torch, objectives.get_objective("binary"), y[:n], None, dev)
    rec["kernels"] = _path_kernels(torch, hh, rates, "trainers featurized bins", bins_t, g, h,
                                   NUM_BINS)
    del bins_t, g, h

    # (e) a regression on a delay-minutes label from the same latent
    r, r_test = N_TRAINERS_REG, N_TRAINERS_REG_TEST
    minutes = np.round(15.0 * (latent + np.random.default_rng(32).logistic(size=len(latent))))
    reg_cols = {k: v for k, v in cols.items() if k != label}
    reg_cols["delay_minutes"] = minutes
    t0 = time.perf_counter()
    reg = TrainRegressor(model=LightGBMRegressor(**TRAINERS_PARAMS, device="cuda"),
                         labelCol="delay_minutes").fit(_rows(reg_cols, 0, r, Table))
    reg_fit_s = time.perf_counter() - t0
    got = reg.transform(_rows(reg_cols, n, n + r_test, Table, drop=("delay_minutes",)))
    want = minutes[n:n + r_test]
    l2 = float(np.mean((got["prediction"] - want) ** 2))
    l2_init = float(np.mean((minutes[:r].mean() - want) ** 2))
    rec["regression"] = dict(rows=r, test_rows=r_test, fit_s=reg_fit_s, held_out_l2=l2,
                             init_only_l2=l2_init)
    print("trainers regression: " + json.dumps(rec["regression"]), flush=True)
    if not l2 < l2_init:
        raise AssertionError(f"trainers regression l2 {l2} is not below the init-only {l2_init}")
    rec["launches"] = counts
    torch.cuda.empty_cache()
    # held last, so that a miss still prints every other part's numbers
    if not (held_out > 0.5 and held_out >= numeric_auc):
        raise AssertionError(f"trainers AUC {held_out} against the numeric codes' {numeric_auc}")
    return rec


# phase 33: BASELINE config 4, VW text classification (benchmarks/vw_text_bench.py's shape)
N_VW = 200_000  # training documents
N_VW_TEST = 20_000
VW_VOCAB = 5000
VW_DOC_LEN = 30
VW_BITS = 18  # 262,144 weights
VW_PASSES = 3
VW_BATCH = 64  # VW's default
VW_SOURCE_BATCH = 1024  # benchmarks/vw_text_bench.py's batchSize, fitted in (b) too
N_VW_CPU = 20_000  # (c) and (e): the first documents fitted on the card and the CPU port
N_VW_MANY = 50_000  # (d): the K = 4 bucket's rows
N_VW_FTRL = 50_000  # (f): the FTRL regressor's rows over the crossed namespaces
VW_TOL = 1e-4  # card against CPU, weights and margins, of the largest magnitude: CARD_TOL
VW_SORTED_TOL = 1e-5  # card against the CPU running the card's scatter form: TOL
VW_MESH_SLOTS = 4
VW_MANY_MAPS = ({"learningRate": 0.5, "powerT": 0.5}, {"learningRate": 0.25, "powerT": 0.5},
                {"learningRate": 1.0, "powerT": 0.0, "l2": 1e-6},
                {"learningRate": 0.5, "powerT": 0.5, "l1": 1e-6})
VW_PROFILE_BATCHES = 40  # batches of the two profiled fits that count launches per step


def _vw_corpus(n, seed=0):
    """benchmarks/vw_text_bench.py's generator (copied, not imported; its
    documents joined from one gather instead of a row loop, the same
    strings): a Zipf-ish vocabulary tilted per class, DOC_LEN words a
    document."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(VW_VOCAB)])
    base = 1.0 / np.arange(1, VW_VOCAB + 1)
    tilt = rng.normal(size=VW_VOCAB) * 0.7
    p_pos = base * np.exp(tilt)
    p_neg = base * np.exp(-tilt)
    p_pos /= p_pos.sum()
    p_neg /= p_neg.sum()
    y = rng.integers(0, 2, size=n).astype(np.float64)
    pos_draw = rng.choice(VW_VOCAB, size=(n, VW_DOC_LEN), p=p_pos)
    neg_draw = rng.choice(VW_VOCAB, size=(n, VW_DOC_LEN), p=p_neg)
    draw = np.where((y > 0)[:, None], pos_draw, neg_draw)
    docs = np.empty(n, dtype=object)
    docs[:] = [" ".join(row) for row in words[draw].tolist()]
    return docs, y


def _vw_rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _vw_lanes_fit(torch, vwbase, batch, y, w, const_idx, device, sorted_scatter,
                  eager=False):
    """train_linear's unmeshed fit at the classifier's defaults (logistic,
    learningRate 0.5, powerT 0.5), built from vw.base._Lanes with the
    scatter form chosen, where train_linear takes the platform's: the CPU
    running the card's sorted run sums, or the card running index_add_'s
    float atomics. With ``eager`` the card launches each step op by op
    instead of replaying its CUDA graph. Returns the weights."""
    dev = torch.device(device)
    hp = vwbase._Hyper(loss="logistic", optimizer="adagrad", quantile_tau=0.5,
                       ftrl_alpha=0.005, ftrl_beta=0.1, l1=0.0, l2=0.0, many=False)
    idx, val, yp, wp, k, nb = vwbase._prep_rows(batch, y, w, const_idx, VW_BATCH, 1)
    steps = vwbase._step_sizes([0.5], [0.5], VW_PASSES * nb)
    lanes = vwbase._Lanes(idx.reshape(nb, 1, VW_BATCH, k), val.reshape(nb, 1, VW_BATCH, k),
                          yp.reshape(nb, 1, VW_BATCH), wp.reshape(nb, 1, VW_BATCH), 1,
                          batch.dim, dev, hp, sorted_scatter,
                          np.zeros(batch.dim, np.float32), steps)
    if eager:
        for p in range(VW_PASSES):
            for b in range(nb):
                lanes.run_step(b, p * nb + b)
        return lanes.fitted()[0].cpu().numpy()
    return vwbase._run_lanes([lanes], VW_PASSES, average=False)[0].cpu().numpy()


def _vw_launches_per_step(torch, vwbase, batch, y, w, const_idx):
    """Device launches (kernels, copies, fills) per minibatch step, from
    torch.profiler over two fits of VW_PROFILE_BATCHES batches that differ
    by one pass: their difference over the steps it adds (the kernels of
    the replayed CUDA graph count one by one). None when the profile holds
    no device events."""
    from torch.profiler import ProfilerActivity, profile

    rows = VW_PROFILE_BATCHES * VW_BATCH
    sub = type(batch)(batch.indices[:rows], batch.values[:rows], batch.dim)
    counts = []
    for passes in (1, 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            vwbase.train_linear(sub, y[:rows], w[:rows], loss="logistic", num_passes=passes,
                                learning_rate=0.5, power_t=0.5, l1=0.0, l2=0.0,
                                batch_size=VW_BATCH, constant_index=const_idx, device="cuda")
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if str(e.device_type).endswith("CUDA")))
    if counts[1] <= counts[0]:
        return None
    return (counts[1] - counts[0]) / VW_PROFILE_BATCHES


def phase_vw(torch, uh, hh, Table, vw, vwbase, parallel, tsweep, card):
    """Phase 33 (see the module docstring): BASELINE config 4 through the
    VW learners on the card. No hand kernel runs: the histogram kernels'
    counts stay 0."""
    from mmlspark_tpu_torch.sweep import batched

    dev = "cuda"
    rec = {"card": card}
    parts = {}
    _zero_counts(uh, hh)

    # (a) featurize on the host
    t0 = time.perf_counter()
    docs, y = _vw_corpus(N_VW + N_VW_TEST, seed=0)
    gen_s = time.perf_counter() - t0
    feat = vw.VowpalWabbitFeaturizer(inputCols=["text"], outputCol="features",
                                     numBits=VW_BITS, stringSplit=True)
    t0 = time.perf_counter()
    table = feat.transform(Table({"text": docs, "label": y}))
    featurize_s = time.perf_counter() - t0
    train, test = table.slice(0, N_VW), table.slice(N_VW, N_VW + N_VW_TEST)
    y_test = y[N_VW:]
    rec["featurize"] = dict(documents=N_VW + N_VW_TEST, generate_s=gen_s,
                            featurize_s=featurize_s, nnz=int(table.column("features").nnz))
    print("vw featurize: " + json.dumps(rec["featurize"]), flush=True)
    parts["a"] = gen_s + featurize_s

    # (b) the classifier on the card: fit twice (bit-identical), score held-out rows
    t_b = time.perf_counter()
    est = vw.VowpalWabbitClassifier(numPasses=VW_PASSES, batchSize=VW_BATCH, device=dev)
    fits = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = est.fit(train)
        torch.cuda.synchronize()
        fits.append((model, time.perf_counter() - t0))
    model = fits[0][0]
    identical = fits[0][0].getModelWeights().tobytes() == fits[1][0].getModelWeights().tobytes()
    out = model.transform(test)
    p1 = np.clip(out["probability"][:, 1].astype(np.float64), 1e-15, 1 - 1e-15)
    acc = float((out["prediction"] == y_test).mean())
    logloss = float(-np.mean(y_test * np.log(p1) + (1 - y_test) * np.log(1 - p1)))
    prior = float(y[:N_VW].mean())
    const_logloss = float(-np.mean(y_test * np.log(prior) + (1 - y_test) * np.log(1 - prior)))
    majority = float(max(y_test.mean(), 1 - y_test.mean()))
    args, batch, yb, wb, const_idx, _ = est._train_setup(train)
    launches = _vw_launches_per_step(torch, vwbase, batch, yb, wb, const_idx)
    st = model.getTrainingStats()
    rec["fit"] = dict(rows=N_VW, passes=VW_PASSES, batch=VW_BATCH, weights=1 << VW_BITS,
                      features_per_row=int(batch.max_active) + 1, fit_s=[f[1] for f in fits],
                      learn_time_s=st["learn_time_s"], steps=st["steps"],
                      launches_per_step=launches, bit_identical=identical,
                      held_out_accuracy=acc, majority_accuracy=majority,
                      held_out_logloss=logloss, constant_logloss=const_logloss, card=card)
    print("vw fit: " + json.dumps(rec["fit"]), flush=True)
    if not identical:
        raise AssertionError("two VW fits on the card gave different weights")
    if not (acc > majority and logloss < const_logloss):
        raise AssertionError(f"vw held-out accuracy {acc} (majority {majority}), log loss "
                             f"{logloss} (constant {const_logloss})")
    # at benchmarks/vw_text_bench.py's own batchSize
    est_src = est.copy({"batchSize": VW_SOURCE_BATCH})
    src_fits = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_src = est_src.fit(train)
        torch.cuda.synchronize()
        src_fits.append((m_src.getModelWeights(), time.perf_counter() - t0))
    out = m_src.transform(test)
    p1 = np.clip(out["probability"][:, 1].astype(np.float64), 1e-15, 1 - 1e-15)
    acc_src = float((out["prediction"] == y_test).mean())
    logloss_src = float(-np.mean(y_test * np.log(p1) + (1 - y_test) * np.log(1 - p1)))
    rec["fit_source_batch"] = dict(
        rows=N_VW, passes=VW_PASSES, batch=VW_SOURCE_BATCH, fit_s=[f[1] for f in src_fits],
        learn_time_s=m_src.getTrainingStats()["learn_time_s"],
        steps=m_src.getTrainingStats()["steps"],
        bit_identical=src_fits[0][0].tobytes() == src_fits[1][0].tobytes(),
        held_out_accuracy=acc_src, held_out_logloss=logloss_src, card=card)
    print("vw fit at the source's batch: " + json.dumps(rec["fit_source_batch"]), flush=True)
    if not rec["fit_source_batch"]["bit_identical"]:
        raise AssertionError("two VW fits on the card at batchSize 1024 gave different weights")
    if not (acc_src > majority and logloss_src < const_logloss):
        raise AssertionError(f"vw at batchSize {VW_SOURCE_BATCH}: held-out accuracy {acc_src} "
                             f"(majority {majority}), log loss {logloss_src} "
                             f"(constant {const_logloss})")
    parts["b"] = time.perf_counter() - t_b
    del fits, src_fits, out

    # (c) the first documents on the card and on the CPU port
    t_c = time.perf_counter()
    head = train.slice(0, N_VW_CPU)
    cpu_est = est.copy({"device": "cpu"})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_card = est.fit(head)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_cpu = cpu_est.fit(head)
    cpu_s = time.perf_counter() - t0
    margins = {}
    for name, m in (("card", m_card), ("cpu", m_cpu)):
        margins[name] = m.transform(test)["rawPrediction"][:, 1]
    # the CPU running the card's scatter form: what is left is not the scatter
    _, h_batch, h_y, h_w, h_const, _ = est._train_setup(head)
    t0 = time.perf_counter()
    w_sorted = _vw_lanes_fit(torch, vwbase, h_batch, h_y, h_w, h_const, "cpu", True)
    sorted_s = time.perf_counter() - t0
    m_sorted = m_cpu.copy({"modelWeights": w_sorted})
    margins["cpu_sorted"] = m_sorted.transform(test)["rawPrediction"][:, 1]
    rec["card_cpu"] = dict(rows=N_VW_CPU, card_fit_s=card_s, cpu_fit_s=cpu_s,
                           weights_err=_vw_rel_err(m_card.getModelWeights(),
                                                   m_cpu.getModelWeights()),
                           margins_err=_vw_rel_err(margins["card"], margins["cpu"]),
                           tolerance=VW_TOL, cpu_sorted_fit_s=sorted_s,
                           sorted_weights_err=_vw_rel_err(m_card.getModelWeights(), w_sorted),
                           sorted_margins_err=_vw_rel_err(margins["card"],
                                                          margins["cpu_sorted"]),
                           sorted_tolerance=VW_SORTED_TOL)
    print("vw card against CPU: " + json.dumps(rec["card_cpu"]), flush=True)
    if (max(rec["card_cpu"]["weights_err"], rec["card_cpu"]["margins_err"]) > VW_TOL
            or max(rec["card_cpu"]["sorted_weights_err"],
                   rec["card_cpu"]["sorted_margins_err"]) > VW_SORTED_TOL):
        raise AssertionError(f"vw card against CPU: {rec['card_cpu']}")
    parts["c"] = time.perf_counter() - t_c

    # (d) a K = 4 "vw" bucket through fit_bucket against the four sequential fits
    t_d = time.perf_counter()
    rows_d, valid_d = train.slice(0, N_VW_MANY), test
    (bucket,) = tsweep.bucket_candidates([(est, dict(m)) for m in VW_MANY_MAPS])
    if bucket.kind != "vw" or bucket.size != len(VW_MANY_MAPS):
        raise AssertionError(f"vw bucket {bucket.kind} of {bucket.size}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scored = batched.fit_bucket(bucket, rows_d, valid_d, "label", "accuracy")
    bucket_s = time.perf_counter() - t0
    seq_metrics, seq_s = [], 0.0
    for m in VW_MANY_MAPS:
        t0 = time.perf_counter()
        seq = est.copy(dict(m)).fit(rows_d)
        seq_s += time.perf_counter() - t0
        seq_metrics.append(batched._score(seq, valid_d, "label", "accuracy"))
    metrics = [float(s[0]) for s in scored]
    rec["many"] = dict(rows=N_VW_MANY, k=len(VW_MANY_MAPS), bucket_s=bucket_s,
                       sequential_s=seq_s, metrics=metrics, sequential_metrics=seq_metrics)
    print("vw bucket: " + json.dumps(rec["many"]), flush=True)
    if not all(np.isclose(a, b, rtol=1e-5) for a, b in zip(metrics, seq_metrics)):
        raise AssertionError(f"vw bucket against its sequential fits: {rec['many']}")
    parts["d"] = time.perf_counter() - t_d

    # (e) a 4-slot logical mesh on the one card, one pass, against the CPU port's
    t_e = time.perf_counter()
    meshes = {"card": parallel.make_mesh(parallel.MeshConfig(data=VW_MESH_SLOTS),
                                         devices=["cuda"] * VW_MESH_SLOTS),
              "cpu": parallel.make_mesh(parallel.MeshConfig(data=VW_MESH_SLOTS),
                                        devices=["cpu"] * VW_MESH_SLOTS)}
    mesh_fits, mesh_s = {}, {}
    for name, e in (("card", est), ("cpu", cpu_est)):
        e1 = e.copy({"numPasses": 1})
        e1._select_mesh = lambda device=None, _m=meshes[name]: _m
        t0 = time.perf_counter()
        mesh_fits[name] = e1.fit(head)
        mesh_s[name] = time.perf_counter() - t0
    rec["mesh"] = dict(rows=N_VW_CPU, slots=VW_MESH_SLOTS, passes=1,
                       shards=mesh_fits["card"].getTrainingStats()["shards"],
                       card_fit_s=mesh_s["card"], cpu_fit_s=mesh_s["cpu"],
                       weights_err=_vw_rel_err(mesh_fits["card"].getModelWeights(),
                                               mesh_fits["cpu"].getModelWeights()),
                       tolerance=VW_TOL)
    print("vw mesh: " + json.dumps(rec["mesh"]), flush=True)
    if rec["mesh"]["shards"] != VW_MESH_SLOTS or rec["mesh"]["weights_err"] > VW_TOL:
        raise AssertionError(f"vw mesh: {rec['mesh']}")
    parts["e"] = time.perf_counter() - t_e

    # (f) FTRL over two crossed namespaces: each document's first and second half
    t_f = time.perf_counter()
    n_f, n_f_test = N_VW_FTRL, N_VW_TEST // 4
    rows_f = np.concatenate([np.arange(n_f), np.arange(N_VW, N_VW + n_f_test)])
    words_f = [docs[i].split() for i in rows_f]
    half = VW_DOC_LEN // 2
    t_ns = Table({"a": np.array([" ".join(w[:half]) for w in words_f], dtype=object),
                  "b": np.array([" ".join(w[half:]) for w in words_f], dtype=object),
                  "label": y[rows_f]})
    t0 = time.perf_counter()
    for name in ("a", "b"):
        t_ns = vw.VowpalWabbitFeaturizer(inputCols=[name], outputCol="f_" + name,
                                         numBits=VW_BITS, stringSplit=True).transform(t_ns)
    t_ns = vw.VowpalWabbitInteractions(inputCols=["f_a", "f_b"], outputCol="features",
                                       numBits=VW_BITS).transform(t_ns)
    cross_s = time.perf_counter() - t0
    tr_f, te_f = t_ns.slice(0, n_f), t_ns.slice(n_f, t_ns.num_rows)
    reg = vw.VowpalWabbitRegressor(numPasses=VW_PASSES, batchSize=VW_BATCH, device=dev,
                                   passThroughArgs="--ftrl")
    t0 = time.perf_counter()
    m_f = reg.fit(tr_f)
    ftrl_s = time.perf_counter() - t0
    y_f = te_f.column("label")
    l2 = float(np.mean((m_f.transform(te_f)["prediction"] - y_f) ** 2))
    l2_init = float(np.mean((y[:n_f].mean() - y_f) ** 2))
    rec["ftrl"] = dict(rows=n_f, test_rows=te_f.num_rows, cross_s=cross_s, fit_s=ftrl_s,
                       crossed_per_row=float(te_f.column("features").nnz / te_f.num_rows),
                       held_out_l2=l2, init_only_l2=l2_init)
    print("vw ftrl: " + json.dumps(rec["ftrl"]), flush=True)
    if not l2 < l2_init:
        raise AssertionError(f"vw FTRL held-out l2 {l2} is not below the init-only {l2_init}")
    parts["f"] = time.perf_counter() - t_f

    counts = _counts(uh, hh)
    if any(counts.values()):
        raise AssertionError(f"the VW phase launched a hand kernel: {counts}")
    rec["parts_s"] = parts
    print("vw parts: " + json.dumps(parts), flush=True)
    return rec


# phase 34: the other learners (isolation forest, KNN, SAR, LIME)
SAR_USERS = 6040  # MovieLens-1M's users, items and ratings
SAR_ITEMS = 3706
SAR_EVENTS = 1_000_209
SAR_K = 10
N_SAR_CPU = 500  # users recommended for on the card and on the CPU port
SAR_RATING_SHARES = (0.056, 0.108, 0.261, 0.349, 0.226)  # MovieLens-1M's 1-5 stars
N_IF = 1_000_000
IF_TREES = 100
IF_SAMPLES = 256
IF_OUTLIERS = 0.01
N_IF_CPU = 100_000  # rows scored on the card and on the CPU port
N_KNN_INDEX = 100_000
KNN_DIM = 512
N_KNN_QUERIES = 10_000
KNN_K = 5
KNN_LABELS = 10
N_KNN_CPU = 1_000
N_LIME_FIT = 200_000
LIME_TREES = 50
N_LIME_ROWS = 1_000
LIME_SAMPLES = 1_000  # the reference's default nSamples
N_LIME_CPU = 20
LIME_REG = 0.001
OTHER_TOL = 1e-6  # card against CPU: float32 scores, of the largest
LIME_TOL = 1e-5  # card against CPU: lasso weights, of the largest magnitude


def _apart(scores, tol):
    """(rows, k) mask of ranks whose score stands more than ``tol`` of the
    largest apart from both neighbours in its row."""
    scores = np.asarray(scores, np.float64)
    gap = tol * max(np.abs(scores).max(), 1e-30)
    pad = np.full((len(scores), 1), np.inf)
    d = np.abs(np.diff(np.hstack([pad, scores, pad]), axis=1))
    return np.minimum(d[:, :-1], d[:, 1:]) > gap


def _ranked_agree(idx, scores, cpu_idx, cpu_scores, tol):
    """Card against CPU top-k: scores within ``tol`` of the largest, and
    equal indices at every rank apart from its neighbours and at every
    rank where the two scores are exactly equal (ties in item order)."""
    err = float(np.abs(np.asarray(scores, np.float64) - cpu_scores).max()
                / max(np.abs(cpu_scores).max(), 1e-30))
    held = _apart(cpu_scores, tol) | (np.asarray(scores) == np.asarray(cpu_scores))
    mismatched = int((np.asarray(idx)[held] != np.asarray(cpu_idx)[held]).sum())
    return dict(max_rel_err=err, ranks_held=int(held.sum()), ranks=int(held.size),
                mismatched=mismatched, ok=err <= tol and mismatched == 0)


def _movielens_events(seed=34):
    """MovieLens-1M's shape: 6,040 users of lognormal activity, 3,706
    items of Zipf popularity, 1,000,209 ratings at its star frequencies
    over three years (seconds)."""
    rng = np.random.default_rng(seed)
    activity = rng.lognormal(0.0, 1.0, SAR_USERS)
    users = rng.choice(SAR_USERS, SAR_EVENTS, p=activity / activity.sum())
    pop = 1.0 / np.arange(1, SAR_ITEMS + 1) ** 0.9
    items = rng.permutation(SAR_ITEMS)[rng.choice(SAR_ITEMS, SAR_EVENTS, p=pop / pop.sum())]
    ratings = rng.choice(5, SAR_EVENTS, p=SAR_RATING_SHARES) + 1.0
    times = 956_703_932 + rng.uniform(0, 3 * 365 * 86_400, SAR_EVENTS)
    users[:SAR_USERS] = np.arange(SAR_USERS)  # every user id present
    items[:SAR_ITEMS] = np.arange(SAR_ITEMS)
    return {"user": users.astype(np.int64), "item": items.astype(np.int64),
            "rating": ratings, "timestamp": times}


def _topk_forms(torch, topk, label, scores, k):
    """``ops.topk``'s two forms on one score matrix on the card: the same
    indices, each timed, beside one ``torch.topk`` call (no tie order)."""
    sv, si = topk.topk_ordered(scores, k, method="sort")
    lv, li = topk.topk_ordered(scores, k, method="select")
    if not (torch.equal(si, li) and torch.equal(sv, lv)):
        raise AssertionError(f"{label}: the sort and select forms of topk_ordered differ")
    rec = dict(shape=list(scores.shape), k=k,
               sort_ms=_time_ms(torch, lambda: topk.topk_ordered(scores, k, method="sort"), 5),
               select_ms=_time_ms(torch, lambda: topk.topk_ordered(scores, k, method="select"),
                                  5),
               torch_topk_ms=_time_ms(torch, lambda: torch.topk(scores, k, dim=1), 5),
               default="sort" if scores.shape[1] <= topk.SORT_MAX_WIDTH else "select")
    print(f"topk forms {label}: " + json.dumps(rec), flush=True)
    return rec


def _other_sar(torch, Table, recommendation, topk, rec):
    """Phase 34 (a): SAR at MovieLens-1M's shape on the card."""
    from mmlspark_tpu_torch.recommendation import sar as tsar

    cols = _movielens_events()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = recommendation.SAR(supportThreshold=4, device="cuda").fit(Table(cols))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs = model.recommend_for_all_users(SAR_K)
    recommend_s = time.perf_counter() - t0
    idx, scores = recs["recommendations"], recs["ratings"]
    # the CPU port on the first users; the co-occurrence's first 100 columns
    # against the host's float32 product (integer counts: exact)
    cpu = model.copy({"device": "cpu"})
    cpu_idx, cpu_scores = cpu._recommend(model.getUserAffinity()[:N_SAR_CPU], SAR_K)
    agree = _ranked_agree(idx[:N_SAR_CPU], scores[:N_SAR_CPU], cpu_idx, cpu_scores, OTHER_TOL)
    U = np.zeros((SAR_USERS, SAR_ITEMS), np.float32)
    U[cols["user"], cols["item"]] = 1.0
    cooc_equal = bool(np.array_equal(tsar._cooccurrence(U, "cuda")[:, :100],
                                     U.T @ U[:, :100]))
    sim = model.getItemSimilarity()
    zero_users = int(np.all(scores == 0.0, axis=1).sum())
    rec["sar"] = dict(users=SAR_USERS, items=SAR_ITEMS, events=SAR_EVENTS, fit_s=fit_s,
                      recommend_s=recommend_s, k=SAR_K, nonzero_similarities=int((sim > 0).sum()),
                      all_zero_users=zero_users, finite=bool(np.isfinite(scores).all()),
                      cpu_users=N_SAR_CPU, card_cpu=agree, cooccurrence_equal=cooc_equal)
    print("other sar: " + json.dumps(rec["sar"]), flush=True)
    dev = torch.device("cuda")
    A = torch.as_tensor(model.getUserAffinity().astype(np.float32), device=dev)
    S = torch.as_tensor(sim.astype(np.float32), device=dev)
    rec["topk_sar"] = _topk_forms(torch, topk, "sar", A @ S, SAR_K)
    del A, S
    if not (agree["ok"] and cooc_equal and rec["sar"]["finite"]
            and idx.shape == (SAR_USERS, SAR_K)):
        raise AssertionError(f"other sar: {rec['sar']}")


def _other_iforest(torch, Table, isolationforest, auc, rec):
    """Phase 34 (b): IsolationForest on 1,000,000 x 28 rows, 1% planted."""
    rng = np.random.default_rng(35)
    X = rng.normal(size=(N_IF, N_FEATURES)).astype(np.float32)
    n_out = int(N_IF * IF_OUTLIERS)
    planted = rng.choice(N_IF, n_out, replace=False)
    X[planted] = rng.uniform(-6.0, 6.0, size=(n_out, N_FEATURES)).astype(np.float32)
    truth = np.zeros(N_IF)
    truth[planted] = 1.0
    params = dict(numEstimators=IF_TREES, maxSamples=float(IF_SAMPLES))
    t0 = time.perf_counter()
    model = isolationforest.IsolationForest(device="cuda", **params).fit(Table({"features": X}))
    fit_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.transform(Table({"features": X}))
    score_s = time.perf_counter() - t0
    scores = out["outlierScore"]
    cpu_model = isolationforest.IsolationForest(device="cpu", **params).fit(
        Table({"features": X}))
    trees_equal = all(np.asarray(model.getTrees()[k]).tobytes()
                      == np.asarray(cpu_model.getTrees()[k]).tobytes()
                      for k in ("feature", "threshold", "left", "right", "path_adjust"))
    t0 = time.perf_counter()
    cpu = cpu_model._scores(X[:N_IF_CPU])
    cpu_score_s = time.perf_counter() - t0
    err = float(np.abs(scores[:N_IF_CPU] - cpu).max() / np.abs(cpu).max())
    rec["iforest"] = dict(rows=N_IF, features=N_FEATURES, trees=IF_TREES, samples=IF_SAMPLES,
                          max_depth=model.getMaxDepth(), fit_s=fit_s, score_s=score_s,
                          auc=auc(truth, scores, np.ones(N_IF)), trees_equal=trees_equal,
                          cpu_rows=N_IF_CPU, cpu_score_s=cpu_score_s, max_rel_err=err,
                          bit_equal=bool(scores[:N_IF_CPU].tobytes() == cpu.tobytes()),
                          finite=bool(np.isfinite(scores).all()))
    print("other iforest: " + json.dumps(rec["iforest"]), flush=True)
    if not (trees_equal and err <= OTHER_TOL and rec["iforest"]["finite"]
            and rec["iforest"]["auc"] > 0.9):
        raise AssertionError(f"other iforest: {rec['iforest']}")


def _knn_rows(out):
    vals = np.array([[m["value"] for m in r] for r in out], dtype=np.int64)
    dist = np.array([[m["distance"] for m in r] for r in out], dtype=np.float64)
    return vals, dist


def _other_knn(torch, Table, nn, topk, rec):
    """Phase 34 (c): KNN and ConditionalKNN over a 100,000 x 512 index."""
    rng = np.random.default_rng(36)
    t0 = time.perf_counter()
    normal = functools.partial(rng.standard_normal, dtype=np.float32)
    centers = normal((256, KNN_DIM))
    keys = centers[rng.integers(0, 256, N_KNN_INDEX)] + np.float32(0.5) * normal(
        (N_KNN_INDEX, KNN_DIM))
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    queries = keys[rng.integers(0, N_KNN_INDEX, N_KNN_QUERIES)] + np.float32(0.1) * normal(
        (N_KNN_QUERIES, KNN_DIM))
    labels = rng.integers(0, KNN_LABELS, N_KNN_INDEX)
    conds = np.empty(N_KNN_QUERIES, dtype=object)
    for i in range(N_KNN_QUERIES):
        conds[i] = set(rng.choice(KNN_LABELS, rng.integers(1, 4), replace=False).tolist())
    index = Table({"features": keys, "values": np.arange(N_KNN_INDEX),
                   "labels": labels})
    parts = {"generate_s": time.perf_counter() - t0}
    for name, est, q in (
            ("knn", nn.KNN(k=KNN_K, outputCol="m", device="cuda"), {"features": queries}),
            ("conditional", nn.ConditionalKNN(k=KNN_K, labelCol="labels", outputCol="m",
                                              device="cuda"),
             {"features": queries, "conditioner": conds})):
        model = est.fit(index)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.transform(Table(q))["m"]
        query_s = time.perf_counter() - t0
        cpu_q = {k: v[:N_KNN_CPU] for k, v in q.items()}
        t0 = time.perf_counter()
        cpu = model.copy({"device": "cpu"}).transform(Table(cpu_q))["m"]
        cpu_s = time.perf_counter() - t0
        vals, dist = _knn_rows(out[:N_KNN_CPU])
        cvals, cdist = _knn_rows(cpu)
        agree = _ranked_agree(vals, dist, cvals, cdist, OTHER_TOL)
        allowed = all(labels[m["value"]] in conds[i] for i in range(N_KNN_CPU)
                      for m in out[i]) if name == "conditional" else True
        parts[name] = dict(queries=N_KNN_QUERIES, query_s=query_s, cpu_queries=N_KNN_CPU,
                           cpu_s=cpu_s, card_cpu=agree, labels_allowed=allowed,
                           groups=len({frozenset(c) for c in conds}) if name == "conditional"
                           else 1)
        if not (agree["ok"] and allowed and len(out) == N_KNN_QUERIES):
            raise AssertionError(f"other {name}: {parts[name]}")
    rec["knn"] = dict(index=N_KNN_INDEX, dim=KNN_DIM, k=KNN_K, labels=KNN_LABELS, **parts)
    print("other knn: " + json.dumps(rec["knn"]), flush=True)
    dev = torch.device("cuda")
    K = torch.as_tensor(keys, device=dev)
    Q = torch.as_tensor(queries[:4096], device=dev)
    rec["topk_knn"] = _topk_forms(torch, topk, "knn", Q @ K.T, KNN_K)
    del K, Q


def _other_lime(torch, uh, hh, rates, objectives, train, base, Table, lime, LightGBMRegressor,
                rec):
    """Phase 34 (d): TabularLIME over a LightGBMRegressor fitted on the card."""
    from mmlspark_tpu_torch.lightgbm import LightGBMRegressionModel
    from mmlspark_tpu_torch.lime import lime as tlime

    X, _ = _make_data(N_LIME_FIT, N_FEATURES, seed=37)
    y = X[:, 0] * 1.5 + X[:, 1] * X[:, 2] + 0.8 * np.sin(X[:, 3])
    binned = []
    bin_dataset = base.bin_dataset

    def keep_bins(*a, **kw):
        out = bin_dataset(*a, **kw)
        binned.append(out)
        return out

    base.bin_dataset = keep_bins
    try:
        torch.cuda.synchronize()
        _zero_counts(uh, hh)
        t0 = time.perf_counter()
        reg = LightGBMRegressor(numIterations=LIME_TREES, numLeaves=31, maxBin=NUM_BINS - 1,
                                device="cuda").fit(Table({"features": X, "label": y}))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = _counts(uh, hh)
    finally:
        base.bin_dataset = bin_dataset
    _need(counts, ("hist_panel", "hist_combined"), "lime regressor fit")
    seconds = {}
    saved_lasso = _timed_calls(tlime, ("fit_lasso_batch",), seconds)
    saved_predict = _timed_calls(LightGBMRegressionModel, ("transform",), seconds)
    try:
        explainer = lime.TabularLIME(model=reg, inputCol="features", outputCol="weights",
                                     nSamples=LIME_SAMPLES, regularization=LIME_REG, seed=34,
                                     device="cuda").fit(Table({"features": X}))
        rows = Table({"features": X[:N_LIME_ROWS]})
        t0 = time.perf_counter()
        W = np.stack(explainer.transform(rows)["weights"])
        explain_s = time.perf_counter() - t0
        card = dict(seconds)
        cpu_model = explainer.copy({"device": "cpu", "model": reg.copy({"device": "cpu"})})
        cpu_W = np.stack(cpu_model.transform(Table({"features": X[:N_LIME_CPU]}))["weights"])
    finally:
        for cls, fns in ((tlime, saved_lasso), (LightGBMRegressionModel, saved_predict)):
            for name, fn in fns.items():
                setattr(cls, name, fn)
    err = float(np.abs(W[:N_LIME_CPU] - cpu_W).max() / np.abs(cpu_W).max())
    imp = np.abs(W).mean(axis=0)
    rec["lime"] = dict(fit_rows=N_LIME_FIT, trees=LIME_TREES, fit_s=fit_s, launches=counts,
                       rows=N_LIME_ROWS, samples=LIME_SAMPLES,
                       inner_predictions=N_LIME_ROWS * LIME_SAMPLES, explain_s=explain_s,
                       inner_predict_s=card["transform"], lasso_s=card["fit_lasso_batch"],
                       cpu_rows=N_LIME_CPU, max_rel_err=err,
                       top_features=[int(i) for i in np.argsort(-imp)[:4]],
                       finite=bool(np.isfinite(W).all()))
    print("other lime: " + json.dumps(rec["lime"]), flush=True)
    bins, _ = binned[0]
    dev = torch.device("cuda")
    bins_t = train.upload_bins(bins, dev)
    g, h = _iteration0(torch, objectives.get_objective("regression"), y, None, dev)
    rec["kernels"] = _path_kernels(torch, hh, rates, "lime regressor bins", bins_t, g, h,
                                   NUM_BINS)
    rec["launches"] = counts
    del bins_t, g, h
    # perturbations are drawn around the column means (the reference's
    # TabularLIME), so each row's weights near the global linear fit of
    # 1.5 x0 + x1 x2 + 0.8 sin(x3): x0 (1.5) and x3 (0.8 E[cos]) lead
    if not (err <= LIME_TOL and rec["lime"]["finite"] and W.shape == (N_LIME_ROWS, N_FEATURES)
            and set(rec["lime"]["top_features"][:2]) == {0, 3}):
        raise AssertionError(f"other lime: {rec['lime']}")


def phase_other_learners(torch, uh, hh, rates, objectives, train, base, Table, LightGBMRegressor,
                         card):
    """Phase 34 (see the module docstring): SAR, the isolation forest, KNN
    and TabularLIME on the card against the CPU port. Only (d)'s regressor
    fit launches hand kernels."""
    from mmlspark_tpu_torch import isolationforest, lime, nn, recommendation
    from mmlspark_tpu_torch.lightgbm.objectives import auc
    from mmlspark_tpu_torch.ops import topk

    rec = {"card": card}
    parts = {}
    _zero_counts(uh, hh)
    t0 = time.perf_counter()
    _other_sar(torch, Table, recommendation, topk, rec)
    parts["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _other_iforest(torch, Table, isolationforest, auc, rec)
    parts["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _other_knn(torch, Table, nn, topk, rec)
    parts["c"] = time.perf_counter() - t0
    counts = _counts(uh, hh)
    if any(counts.values()):
        raise AssertionError(f"SAR, the isolation forest or KNN launched a hand kernel: {counts}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _other_lime(torch, uh, hh, rates, objectives, train, base, Table, lime, LightGBMRegressor,
                rec)
    parts["d"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    rec["parts_s"] = parts
    print("other parts: " + json.dumps(parts), flush=True)
    return rec


# phase 35: the deep models (ResNet-50 features, the zoo, imports, pipeline and MoE, training)
N_DEEP = 1_024  # images featurized: half 256 x 256, half 240 x 320 (two resize groups)
DEEP_SHAPES = ((256, 256), (240, 320))
DEEP_HW = 224  # ResNet-50's ImageNet input
DEEP_BATCH = 64
N_DEEP_CPU = 16  # of them through the CPU port too
N_DEEP_ZOO = 64  # (b): the first rows that must equal (a)'s bit for bit
DEEP_TOL = 2e-5  # card against the CPU port, float32 features, of the largest (TF32: ~1e-3)
DEEP_BF16_TOL = 2e-2  # bf16 features against float32 on the card, of the largest magnitude
N_DEEP_IMPORT = 512  # (c): rows through the imported networks
DEEP_IMPORT_TOL = 1e-4  # (c), (d): card against the CPU, of the largest magnitude
DEEP_PIPE_STAGES, DEEP_PIPE_MICRO, DEEP_WIDTH, N_DEEP_PIPE = 4, 4, 1024, 4096
DEEP_EXPERTS, N_DEEP_MOE, DEEP_CAPACITY = 4, 8192, 1.25
N_DEEP_TRAIN, DEEP_TRAIN_STEPS, DEEP_TRAIN_BATCH = 2048, 50, 64
N_DEEP_TRAIN_CPU, DEEP_TRAIN_CPU_STEPS = 256, 3  # (e)'s card-against-CPU steps and rows
# (e)'s limits, from tools/torch_deep_train_tol.py over 6 seeds of the task on
# an NVIDIA H100 80GB HBM3 (700.00 W): exact runs against the control with
# TF32 allowed
DEEP_TRAIN_TOL = 0.09  # the trees' L2 gap over the CPU's L2 movement: exact <= 8.05%, TF32 >= 9.38%
DEEP_FIRST_LOSS_TOL = 5e-6  # the first step's loss, relative: exact <= 9.7e-7, TF32 >= 2.1e-5
DEEP_LOSS_TOL = 1e-2  # each step's loss, relative (gross errors only): exact <= 3.8e-3


def _rel_err(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _deep_images():
    """N_DEEP seeded uint8 images, the first half of each shape."""
    rng = np.random.default_rng(35)
    col = np.empty(N_DEEP, dtype=object)
    for i in range(N_DEEP):
        h, w = DEEP_SHAPES[i * len(DEEP_SHAPES) // N_DEEP]
        col[i] = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return col


def _conv_launches(torch, net, x):
    """One forward of ``net`` on ``x`` under torch.profiler: the convolution
    ops called, and the device kernels launched (None when the trace holds
    no device events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        net(x, cut=1)
        torch.cuda.synchronize()
    convs = sum(e.count for e in prof.key_averages() if e.key == "aten::convolution")
    kernels = sum(e.count for e in prof.key_averages()
                  if getattr(e, "device_type", None) is not None
                  and str(e.device_type).endswith("CUDA"))
    return convs, (kernels or None)


def _deep_featurize(torch, dev, Table, image, resnet, dnn_model, rec):
    """Phase 35 (a): ResNet-50 features of N_DEEP images on the card."""
    params = resnet.init_resnet(seed=0, variant="resnet50", num_classes=1000)
    col = _deep_images()
    table = Table({"image": col})
    feat = image.ImageFeaturizer(inputCol="image", outputCol="features", modelParams=params,
                                 cutOutputLayers=1, inputHeight=DEEP_HW, inputWidth=DEEP_HW,
                                 batchSize=DEEP_BATCH, device=dev)
    feat.transform(Table({"image": col[:DEEP_BATCH]}))  # cuDNN's first calls, untimed
    seconds = {image.ImageTransformer: {}, dnn_model.DNNModel: {}}
    saved = [(cls, _timed_calls(cls, ("transform",), seconds[cls])) for cls in seconds]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        feats = feat.transform(table)["features"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for cls, fns in saved:
            for name, fn in fns.items():
                setattr(cls, name, fn)
    peak = torch.cuda.max_memory_allocated()
    cpu = feat.copy({"device": "cpu"}).transform(Table({"image": col[:N_DEEP_CPU]}))["features"]
    err = _rel_err(feats[:N_DEEP_CPU], cpu)
    head = {cut: feat.copy({"cutOutputLayers": cut}).transform(
        Table({"image": col[:DEEP_BATCH]}))["features"] for cut in (0, 2)}
    # bf16 through resnet_apply, against float32, on one batch of resized images
    from mmlspark_tpu_torch.device import float32_exact

    resized = image.ImageTransformer(inputCol="image", outputCol="r", toFloat=True,
                                     device=dev).resize(DEEP_HW, DEEP_HW).transform(
        Table({"image": col[:DEEP_BATCH]}))["r"]
    x = torch.from_numpy(np.stack(resized)).to(dev).permute(0, 3, 1, 2) * (1.0 / 255.0)
    net = resnet.ResNet(params, device=dev)
    with torch.no_grad(), float32_exact():
        f32 = net(x, cut=1)
        bf16 = resnet.resnet_apply(net, x, cut=1, dtype=torch.bfloat16).float()
        convs, kernels = _conv_launches(torch, net, x)
    bf16_err = _rel_err(bf16.cpu().numpy(), f32.cpu().numpy())
    rec["featurize"] = dict(
        images=N_DEEP, shapes=[list(s) for s in DEEP_SHAPES], input_hw=DEEP_HW,
        batch=DEEP_BATCH, wall_s=wall, images_per_s=N_DEEP / wall,
        resize_s=seconds[image.ImageTransformer]["transform"],
        backbone_s=seconds[dnn_model.DNNModel]["transform"], peak_device_bytes=peak,
        conv_calls_per_batch=convs, device_kernels_per_batch=kernels,
        features_shape=list(feats.shape), cpu_images=N_DEEP_CPU, cpu_max_rel_err=err,
        cut0_shape=list(np.shape(head[0])), cut2_shape=list(np.shape(np.stack(head[2]))),
        bf16_max_rel_err=bf16_err, finite=bool(np.isfinite(feats).all()))
    print("deep featurize: " + json.dumps(rec["featurize"]), flush=True)
    if not (feats.shape == (N_DEEP, 2048) and rec["featurize"]["finite"] and err <= DEEP_TOL
            and rec["featurize"]["cut0_shape"] == [DEEP_BATCH, 1000]
            and rec["featurize"]["cut2_shape"] == [DEEP_BATCH, 2048, DEEP_HW // 32, DEEP_HW // 32]
            and convs == 53 and bf16_err <= DEEP_BF16_TOL):
        raise AssertionError(f"deep featurize: {rec['featurize']}")
    return params, table, feat, feats


def _deep_zoo(zoo, downloader, params, table, feat, feats, rec):
    """Phase 35 (b): the weights through a LocalRepo and the downloader."""
    root = os.path.join(DATA_DIR, "zoo")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    schema = zoo.publish_model(os.path.join(root, "repo"), "resnet50-imagenet", params,
                               (DEEP_HW, DEEP_HW))
    publish_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dl = downloader.ModelDownloader(os.path.join(root, "cache"),
                                    downloader.LocalRepo(os.path.join(root, "repo")))
    loaded = zoo.load_zoo_params(dl, "resnet50-imagenet")
    load_s = time.perf_counter() - t0
    again = feat.copy({"modelParams": loaded}).transform(table)["features"]
    rec["zoo"] = dict(payload_bytes=schema.size, layers=schema.numLayers, publish_s=publish_s,
                      download_and_load_s=load_s,
                      first_rows_bit_equal=bool(np.array_equal(again[:N_DEEP_ZOO],
                                                               feats[:N_DEEP_ZOO])),
                      all_rows_bit_equal=bool(np.array_equal(again, feats)))
    shutil.rmtree(root, ignore_errors=True)
    print("deep zoo: " + json.dumps(rec["zoo"]), flush=True)
    if not rec["zoo"]["first_rows_bit_equal"]:
        raise AssertionError(f"deep zoo: {rec['zoo']}")


def _deep_imports(torch, dev, Table, dnn, onnx_proto, rec):
    """Phase 35 (c): from_torch and from_onnx networks through DNNModel on
    the card, against the module's own CPU forward."""
    nn = torch.nn
    torch.manual_seed(35)
    net = nn.Sequential(nn.Conv2d(3, 32, 3, padding=1), nn.BatchNorm2d(32), nn.ReLU(),
                        nn.MaxPool2d(2), nn.Conv2d(32, 64, 3, stride=2, padding=1),
                        nn.BatchNorm2d(64), nn.ReLU(), nn.AdaptiveAvgPool2d((1, 1)),
                        nn.Flatten(), nn.Linear(64, 10)).eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    rng = np.random.default_rng(36)
    X = rng.standard_normal((N_DEEP_IMPORT, 3, 64, 64)).astype(np.float32)
    fn, params = dnn.from_torch(net)
    t0 = time.perf_counter()
    got = dnn.DNNModel(applyFn=fn, modelParams=params, feedDict={"input": "x"},
                       fetchDict={"y": "output"}, batchSize=128,
                       device=dev).transform(Table({"x": X}))["y"]
    torch_s = time.perf_counter() - t0
    with torch.no_grad():
        want = net(torch.from_numpy(X)).numpy()
    torch_err = _rel_err(got, want)

    wc = (rng.standard_normal((16, 3, 3, 3)) * 0.2).astype(np.float32)
    bc = rng.standard_normal(16).astype(np.float32)
    scale = (rng.random(16) + 0.5).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    mean = (rng.standard_normal(16) * 0.1).astype(np.float32)
    var = (rng.random(16) + 0.5).astype(np.float32)
    wl = (rng.standard_normal((10, 16 * 16 * 16)) * 0.05).astype(np.float32)
    bl = rng.standard_normal(10).astype(np.float32)
    enc = onnx_proto.encode_node
    buf = onnx_proto.encode_model([
        enc("Conv", ["x", "wc", "bc"], ["c"], attrs={"pads": [1, 1, 1, 1],
                                                    "kernel_shape": [3, 3]}),
        enc("BatchNormalization", ["c", "scale", "bias", "mean", "var"], ["bn"],
            attrs={"epsilon": 1e-5}),
        enc("Relu", ["bn"], ["r"]),
        enc("MaxPool", ["r"], ["p"], attrs={"kernel_shape": [2, 2], "strides": [2, 2]}),
        enc("Flatten", ["p"], ["fl"], attrs={"axis": 1}),
        enc("Gemm", ["fl", "wl", "bl"], ["y"], attrs={"transB": 1}),
    ], dict(wc=wc, bc=bc, scale=scale, bias=bias, mean=mean, var=var, wl=wl, bl=bl),
        ["x"], ["y"])
    ref_net = nn.Sequential(nn.Conv2d(3, 16, 3, padding=1), nn.BatchNorm2d(16), nn.ReLU(),
                            nn.MaxPool2d(2), nn.Flatten(), nn.Linear(16 * 16 * 16, 10)).eval()
    with torch.no_grad():
        for p, v in ((ref_net[0].weight, wc), (ref_net[0].bias, bc), (ref_net[1].weight, scale),
                     (ref_net[1].bias, bias), (ref_net[1].running_mean, mean),
                     (ref_net[1].running_var, var), (ref_net[5].weight, wl),
                     (ref_net[5].bias, bl)):
            p.copy_(torch.from_numpy(v))
    Xo = rng.standard_normal((N_DEEP_IMPORT, 3, 32, 32)).astype(np.float32)
    ofn, oparams = dnn.from_onnx(buf)
    t0 = time.perf_counter()
    ogot = dnn.DNNModel(applyFn=ofn, modelParams=oparams, feedDict={"x": "x"},
                        fetchDict={"y": "y"}, batchSize=128,
                        device=dev).transform(Table({"x": Xo}))["y"]
    onnx_s = time.perf_counter() - t0
    with torch.no_grad():
        owant = ref_net(torch.from_numpy(Xo)).numpy()
    onnx_err = _rel_err(ogot, owant)
    rec["imports"] = dict(rows=N_DEEP_IMPORT, from_torch_s=torch_s, from_torch_max_rel_err=torch_err,
                          from_onnx_s=onnx_s, from_onnx_max_rel_err=onnx_err)
    print("deep imports: " + json.dumps(rec["imports"]), flush=True)
    if not (torch_err <= DEEP_IMPORT_TOL and onnx_err <= DEEP_IMPORT_TOL):
        raise AssertionError(f"deep imports: {rec['imports']}")


def _deep_parallel(torch, dev, Table, dnn, parallel, rec):
    """Phase 35 (d): pipeline mode, MoE masked-dense and MoE a2a on 4-slot
    logical meshes on the card, against the CPU port's 4-slot meshes."""
    from mmlspark_tpu_torch.ops.expert_parallel import moe_apply_a2a

    rng = np.random.default_rng(37)
    d = DEEP_WIDTH
    stages = ((rng.standard_normal((DEEP_PIPE_STAGES, d, d)) / np.sqrt(d)).astype(np.float32),
              (rng.standard_normal((DEEP_PIPE_STAGES, d)) * 0.1).astype(np.float32))
    X = rng.standard_normal((N_DEEP_PIPE, d)).astype(np.float32)

    def stage_fn(p, h):
        return torch.tanh(h @ p[0] + p[1])

    def mesh4(device, **axes):
        return parallel.make_mesh(parallel.MeshConfig(data=1, **axes), devices=[device] * 4)

    out = {}
    for side, device in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        y = dnn.DNNModel(pipelineStageFn=stage_fn, modelParams=stages, feedDict={"x": "x"},
                         fetchDict={"y": "output"}, batchSize=1024,
                         numMicrobatches=DEEP_PIPE_MICRO,
                         meshConfig=mesh4(device, pipe=DEEP_PIPE_STAGES),
                         device=device).transform(Table({"x": X}))["y"]
        out[("pipe", side)] = (y, time.perf_counter() - t0)
    experts = ((rng.standard_normal((DEEP_EXPERTS, d, d)) / np.sqrt(d)).astype(np.float32),
               (rng.standard_normal((DEEP_EXPERTS, d)) * 0.1).astype(np.float32))
    gate = rng.standard_normal((d, DEEP_EXPERTS)).astype(np.float32)
    Xm = rng.standard_normal((N_DEEP_MOE, d)).astype(np.float32)
    # the a2a call routes by the gate logits plus a skew toward expert 0, so
    # that its capacity overflows and rows drop
    skew = np.zeros(DEEP_EXPERTS, np.float32)
    skew[0] = 0.5 * np.sqrt(d)
    # a row whose two best logits lie within 1e-2 could route to either
    # expert on the card and the CPU (float32 products in other orders): it
    # is moved along its best expert's gate column, which widens the gap
    for bias in (0.0, skew):
        logits = Xm.astype(np.float64) @ gate + bias
        top2 = np.sort(logits, axis=1)[:, -2:]
        near = np.nonzero(top2[:, 1] - top2[:, 0] < 1e-2)[0]
        best = gate[:, logits[near].argmax(axis=1)].T
        Xm[near] += (0.05 * best / np.linalg.norm(best, axis=1, keepdims=True)).astype(np.float32)

    def expert_fn(p, x):
        return torch.tanh(x @ p[0] + p[1])

    for side, device in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        y = dnn.DNNModel(expertFn=expert_fn, modelParams={"experts": experts, "gate": gate},
                         feedDict={"x": "x"}, fetchDict={"y": "output"}, batchSize=2048,
                         meshConfig=mesh4(device, expert=DEEP_EXPERTS),
                         device=device).transform(Table({"x": Xm}))["y"]
        out[("moe", side)] = (y, time.perf_counter() - t0)
        xt = torch.from_numpy(Xm).to(device)
        with torch.no_grad():
            t0 = time.perf_counter()
            y = moe_apply_a2a(expert_fn, tuple(torch.from_numpy(a).to(device) for a in experts),
                              xt, xt @ torch.from_numpy(gate).to(device)
                              + torch.from_numpy(skew).to(device),
                              mesh4(device, expert=DEEP_EXPERTS), DEEP_CAPACITY).cpu().numpy()
        out[("a2a", side)] = (y, time.perf_counter() - t0)
    errs = {k: _rel_err(out[(k, "card")][0], out[(k, "cpu")][0]) for k in ("pipe", "moe", "a2a")}
    dropped = {side: int((out[("a2a", side)][0] == 0).all(axis=1).sum()) for side in ("card", "cpu")}
    same_drops = bool(np.array_equal((out[("a2a", "card")][0] == 0).all(axis=1),
                                     (out[("a2a", "cpu")][0] == 0).all(axis=1)))
    rec["parallel"] = dict(
        width=d, pipe_rows=N_DEEP_PIPE, stages=DEEP_PIPE_STAGES, microbatches=DEEP_PIPE_MICRO,
        moe_rows=N_DEEP_MOE, experts=DEEP_EXPERTS, capacity_factor=DEEP_CAPACITY,
        seconds={f"{k}_{side}": out[(k, side)][1] for k, side in out}, max_rel_err=errs,
        a2a_dropped=dropped["card"], a2a_same_drops=same_drops)
    print("deep parallel: " + json.dumps(rec["parallel"]), flush=True)
    if not (all(e <= DEEP_IMPORT_TOL for e in errs.values()) and same_drops
            and 0 < dropped["card"] < N_DEEP_MOE):
        raise AssertionError(f"deep parallel: {rec['parallel']}")


def _train_gap(got, want, start):
    """The L2 norm of two trained trees' difference over the L2 norm of the
    second's movement from ``start`` (Adam's first steps are sign-like, so
    weights with near-zero gradients move either way)."""
    from mmlspark_tpu_torch.models.zoo import _flatten

    a, b, p = _flatten(got), _flatten(want), _flatten(start)
    diff = np.concatenate([(a[k] - b[k]).ravel() for k in b])
    moved = np.concatenate([(b[k] - p[k]).ravel() for k in b])
    return float(np.linalg.norm(diff) / np.linalg.norm(moved))


def _deep_train_case(resnet, data_seed=38, init_seed=1):
    """(e)'s task: N_DEEP_TRAIN seeded 32 x 32 images labelled by the
    brightest quadrant of their first channel, and a resnet18 (small-input
    stem) with four classes."""
    rng = np.random.default_rng(data_seed)
    X = rng.uniform(size=(N_DEEP_TRAIN, 3, 32, 32)).astype(np.float32)
    quads = X[:, 0].reshape(N_DEEP_TRAIN, 2, 16, 2, 16).mean(axis=(2, 4)).reshape(-1, 4)
    p0 = resnet.init_resnet(seed=init_seed, variant="resnet18", num_classes=4, small_inputs=True)
    return X, quads.argmax(axis=1), p0


def _deep_train(torch, dev, resnet, zoo, rec):
    """Phase 35 (e): train_resnet_classifier on resnet18 (small-input stem)
    on the card; its first steps against the CPU port."""
    X, y, p0 = _deep_train_case(resnet)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained, acc = zoo.train_resnet_classifier(p0, X, y, num_steps=DEEP_TRAIN_STEPS,
                                               batch_size=DEEP_TRAIN_BATCH, device=dev,
                                               losses=losses)
    wall = time.perf_counter() - t0
    finite = all(np.isfinite(np.asarray(v)).all() for v in zoo._flatten(trained).values())
    steps, step_losses = {}, {}
    for side, device in (("card", dev), ("cpu", "cpu")):
        step_losses[side] = []
        steps[side], _ = zoo.train_resnet_classifier(
            p0, X[:N_DEEP_TRAIN_CPU], y[:N_DEEP_TRAIN_CPU], num_steps=DEEP_TRAIN_CPU_STEPS,
            batch_size=DEEP_TRAIN_BATCH, device=device, losses=step_losses[side])
    gap = _train_gap(steps["card"], steps["cpu"], p0)
    loss_errs = (np.abs(np.subtract(step_losses["card"], step_losses["cpu"]))
                 / np.abs(step_losses["cpu"]))
    loss_err, first_loss_err = float(loss_errs.max()), float(loss_errs[0])
    rec["train"] = dict(images=N_DEEP_TRAIN, steps=DEEP_TRAIN_STEPS, batch=DEEP_TRAIN_BATCH,
                        wall_s=wall, ms_per_step=wall / DEEP_TRAIN_STEPS * 1e3,
                        first_loss=losses[0], last_loss=losses[-1], train_accuracy=acc,
                        finite=bool(finite), cpu_steps=DEEP_TRAIN_CPU_STEPS,
                        cpu_step_losses=step_losses["cpu"],
                        card_step_losses=step_losses["card"], cpu_loss_max_rel_err=loss_err,
                        first_loss_rel_err=first_loss_err, cpu_trajectory_gap=gap)
    print("deep train: " + json.dumps(rec["train"]), flush=True)
    if not (finite and np.isfinite(losses).all() and gap <= DEEP_TRAIN_TOL
            and first_loss_err <= DEEP_FIRST_LOSS_TOL and loss_err <= DEEP_LOSS_TOL):
        raise AssertionError(f"deep train: {rec['train']}")


def phase_deep_models(torch, uh, hh, Table, card):
    """Phase 35 (see the module docstring): the deep models on the card
    against the CPU port. No hand kernel runs: the histogram kernels'
    counts must stay 0."""
    from mmlspark_tpu_torch import dnn, downloader, image, parallel
    from mmlspark_tpu_torch.dnn import model as dnn_model
    from mmlspark_tpu_torch.dnn import onnx_proto
    from mmlspark_tpu_torch.models import resnet, zoo

    rec = {"card": card}
    parts = {}
    dev = str(torch.device("cuda"))  # the card, named as the entry points take it
    _zero_counts(uh, hh)
    t0 = time.perf_counter()
    params, table, feat, feats = _deep_featurize(torch, dev, Table, image, resnet, dnn_model, rec)
    parts["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _deep_zoo(zoo, downloader, params, table, feat, feats, rec)
    parts["b"] = time.perf_counter() - t0
    del params, table, feat, feats
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _deep_imports(torch, dev, Table, dnn, onnx_proto, rec)
    parts["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _deep_parallel(torch, dev, Table, dnn, parallel, rec)
    parts["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _deep_train(torch, dev, resnet, zoo, rec)
    parts["e"] = time.perf_counter() - t0
    counts = _counts(uh, hh)
    if any(counts.values()):
        raise AssertionError(f"the deep models launched a hand kernel: {counts}")
    torch.cuda.empty_cache()
    rec["parts_s"] = parts
    print("deep parts: " + json.dumps(parts), flush=True)
    return rec


def phase_campaign(card):
    """Phase 31 (see the module docstring): tools/torch_loadgen.py --short
    --malformed as a subprocess with a fixed seed."""
    out_dir = os.path.join(DATA_DIR, "fleet-campaign")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_loadgen.py"), "--short",
         "--malformed", "--out", out_dir], cwd=ROOT, capture_output=True, text=True,
        timeout=CAMPAIGN_TIMEOUT_S, env=dict(os.environ, MMLSPARK_TPU_FAULT_SEED=str(CAMPAIGN_SEED)))
    wall = time.perf_counter() - t0
    missing = [n for n in ("slo.json", "report.html") if not os.path.exists(
        os.path.join(out_dir, n))]
    if proc.returncode not in (0, 1) or missing:
        raise AssertionError(f"campaign exited {proc.returncode}, missing {missing}: "
                             f"{proc.stdout[-3000:]} {proc.stderr[-2000:]}")
    with open(os.path.join(out_dir, "slo.json")) as fh:
        doc = json.load(fh)
    campaign, report = doc["campaign"], doc["slo"]
    failed = sorted(k for k, v in campaign["checks"].items() if v is False)
    # every check holds but the steady p99 target, which is reported: beside
    # an NVIDIA H100 80GB HBM3 (700.00 W) its host's campaigns read 25.9-89.5
    # ms against 50 (PERF.md); the tool exits 1 on any failed check, else 0
    held = [k for k in failed if k != CAMPAIGN_REPORTED_CHECK]
    if held or campaign["non_shed_5xx"] != 0 or proc.returncode != (1 if failed else 0):
        raise AssertionError(f"campaign exited {proc.returncode}: {campaign['non_shed_5xx']} "
                             f"non-shed 5xx, failed checks {failed}")
    # where a routed request's time goes: the router's span, its hop, the
    # replica's own request span (the merged fleet log's spans, ms)
    spans = collections.defaultdict(list)
    with open(os.path.join(out_dir, "fleet-events.jsonl")) as fh:
        for line in fh:
            ev = json.loads(line)
            if ev["event"] == "SpanRecorded":
                spans[ev["name"]].append(ev["duration"] * 1e3)
    span_ms = {name: dict(p50=float(np.percentile(spans[name], 50)),
                          p99=float(np.percentile(spans[name], 99)))
               for name in ("router.request", "router.hop", "serving.request") if spans[name]}
    rec = dict(card=card, seed=CAMPAIGN_SEED, wall_s=wall, exit_code=proc.returncode,
               ok=campaign["ok"], failed_checks=failed, checks=campaign["checks"],
               non_shed_5xx=campaign["non_shed_5xx"],
               span_ms=span_ms, requests_routed=campaign["requests_routed"],
               campaign_process_cpu_ms_per_request=(campaign["campaign_process_cpu_s"] * 1e3
                                                    / max(campaign["requests_routed"], 1)),
               max_live=campaign["max_live"], steady_p99_ms=campaign["steady_p99_ms"],
               steady_p99_target_ms=campaign["p99_target_ms"],
               requests=report["requests"], shed=report["shed"],
               slo_e2e_p50_ms=report["e2e"]["p50"] * 1e3,
               slo_e2e_p99_ms=report["e2e"]["p99"] * 1e3, slo_ok=report["ok"],
               phases={k: {f: v[f] for f in ("requests", "ok", "shed", "errors_5xx", "p50_ms",
                                             "p99_ms")}
                       for k, v in campaign["phases"].items()},
               report_html_bytes=os.path.getsize(os.path.join(out_dir, "report.html")))
    print("campaign: " + json.dumps(rec), flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
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
    from mmlspark_tpu_torch import automl, featurize, parallel, runtime, serving, streaming
    from mmlspark_tpu_torch import sweep as tsweep
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
        procfit,
        ranker,
        train,
    )
    from mmlspark_tpu_torch.lightgbm.booster import Booster
    from mmlspark_tpu_torch.lightgbm.objectives import auc
    from mmlspark_tpu_torch.core import pipeline
    from mmlspark_tpu_torch.dataguard import guards
    from mmlspark_tpu_torch.observability import (events, history, profiler, registry, slo,
                                                  tracing)
    from mmlspark_tpu_torch.ops import histogram
    from mmlspark_tpu_torch.ops import hopper_histogram as hh
    from mmlspark_tpu_torch.ops import u_histogram as uh
    from mmlspark_tpu_torch.runtime import journal
    from mmlspark_tpu_torch.runtime.lineage import PartitionLostError
    from mmlspark_tpu_torch.sweep import batched
    from mmlspark_tpu_torch.train import TrainClassifier, TrainRegressor
    from mmlspark_tpu_torch import vw
    from mmlspark_tpu_torch.vw import base as vwbase

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
          es_model, X_es[:N_WARM], y_es[:N_WARM])
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
              LightGBMClassifier, auc, higgs, fit, ooc)
        persist = timed("persistence", phase_persistence, torch, uh, hh, rates, base, objectives,
                        train, Table, LightGBMClassifier, LightGBMClassificationModel, Booster,
                        pipeline, guards, events, tracing, higgs)
        timed("observability", phase_observability, torch, uh, hh, train, runtime, pipeline,
              events, tracing, Table, LightGBMClassifier, rates, higgs, fit)
        dist = timed("distribution", phase_distribution, torch, uh, hh, rates, base, train,
                     parallel, procfit, runtime, events, objectives, Table, LightGBMClassifier,
                     auc, higgs)
        many = timed("many_models", phase_many_models, torch, uh, hh, rates, base, train,
                     objectives, batched, tsweep, automl, runtime, events, Table,
                     LightGBMClassifier, auc, higgs)
        timed("serving", phase_serving, torch, uh, hh, runtime, registry, events, serving,
              journal, Table, LightGBMClassifier, LightGBMClassificationModel, higgs)
        stream = timed("streaming", phase_streaming, torch, uh, hh, rates, base, train,
                       objectives, sharded, streaming, serving, registry, events, slo, history,
                       Table, LightGBMClassifier, LightGBMClassificationModel, Booster, auc,
                       higgs)
        timed("campaign", phase_campaign, card)
        trainers = timed("trainers", phase_trainers, torch, uh, hh, rates, base, objectives,
                         train, featurize, Table, pipeline.PipelineStage, LightGBMClassifier,
                         LightGBMRegressor, TrainClassifier, TrainRegressor, auc, card)
        timed("vw_text", phase_vw, torch, uh, hh, Table, vw, vwbase, parallel, tsweep, card)
        other = timed("other_learners", phase_other_learners, torch, uh, hh, rates, objectives,
                      train, base, Table, LightGBMRegressor, card)
        timed("deep_models", phase_deep_models, torch, uh, hh, Table, card)
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
        # one data shard of the 4-slot mesh; launches of the data-parallel mesh fit
        ("hist_panel_mesh_shard", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:86",
         dist["launches"]["hist_panel"], dist["kernels"][8]),
        ("hist_combined_mesh_shard", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:177",
         dist["launches"]["hist_combined"], dist["kernels"][1]),
        # the inline sweep's first bucket: its bins, its train_many call's launches
        ("hist_panel_sweep", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:86",
         many["launches"]["hist_panel"], many["kernels"][8]),
        ("hist_combined_sweep", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:177",
         many["launches"]["hist_combined"], many["kernels"][1]),
        # the streamed fits: the undisturbed run's launches over its 8 epochs;
        # the last epoch's bins at its warm-start stats
        ("hist_panel_stream", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:86",
         stream["launches"]["hist_panel"], stream["kernels"][8]),
        ("hist_combined_stream", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:177",
         stream["launches"]["hist_combined"], stream["kernels"][1]),
        # TrainClassifier's fit of benchm-ml's raw airline rows: the
        # featurized bins (590 columns) at iteration-0 stats
        ("hist_panel_trainers", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:86",
         trainers["launches"]["hist_panel"], trainers["kernels"][8]),
        ("hist_combined_trainers", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:177",
         trainers["launches"]["hist_combined"], trainers["kernels"][1]),
        # the LightGBMRegressor that TabularLIME explains: its bins at
        # iteration-0 stats
        ("hist_panel_lime", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:86",
         other["launches"]["hist_panel"], other["kernels"][8]),
        ("hist_combined_lime", "histogram.cu", "mmlspark_tpu/ops/pallas_histogram.py:177",
         other["launches"]["hist_combined"], other["kernels"][1]),
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
