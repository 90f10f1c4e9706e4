"""Gang-sharded sweeps: candidate buckets across a supervised ProcessGroup.

The port's copy of ``mmlspark_tpu/sweep/distributed.py``. With
``numProcesses`` > 1, :class:`TrainValidSweep` hands its shape-buckets to
a worker gang: the same
:class:`~mmlspark_tpu_torch.runtime.procgroup.ProcessGroup` that
``lightgbm/procfit.py`` uses (gloo rendezvous, heartbeats, gang recovery,
fault injection). The unit of work is one BUCKET (task-per-bucket): worker
``rank`` owns bucket ``bi`` iff ``bi % world == rank``, and each finished
bucket commits its scores to a per-bucket
:class:`~mmlspark_tpu_torch.runtime.journal.FitJournal` (one journal per
bucket: single writer, no cross-process append races).

The members share the driver's card: each fits on the estimator's
``device``, and loads the kernel library the driver built (a member never
compiles, so none can die holding the build directory's lock); a member
whose CUDA init or kernel load fails reports ``failed``.

Fault model: a worker SIGKILL'd mid-bucket takes down the epoch; the gang
re-forms and every already-journaled bucket is SKIPPED (``TaskRecovered``
per restored bucket, zero re-execution). Selection is driver-side and
reads ONLY the journals (worker return values never decide the model),
so the final leaderboard and committed ``ModelStore`` version are
identical to an undisturbed run.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

logger = logging.getLogger("mmlspark_tpu_torch.sweep.distributed")


def _bucket_journal_key(journal_key: str, bi: int) -> str:
    return f"{journal_key}-bucket{bi}"


# -- worker side --------------------------------------------------------------


def sweep_worker_entry(ctx) -> Dict[str, Any]:
    """Per-member sweep entry, invoked by ``procgroup.worker_main`` inside
    a formed epoch. Walks the bucket list in index order: journaled
    buckets are skipped (recovery), owned un-journaled buckets are fitted
    and their scores journaled. Returns a JSON-safe summary; scores ride
    the journals."""
    import torch

    from mmlspark_tpu_torch.device import resolve_device
    from mmlspark_tpu_torch.kernels import build
    from mmlspark_tpu_torch.observability import TaskRecovered, get_bus
    from mmlspark_tpu_torch.ops import hopper_histogram as hh
    from mmlspark_tpu_torch.runtime.journal import FitJournal
    from mmlspark_tpu_torch.sweep.batched import fit_bucket
    from mmlspark_tpu_torch.sweep.bucketing import CandidateBucket

    payload = ctx.payload
    dev = resolve_device(payload.get("device"))
    if payload.get("kernel_library"):
        build.use_prebuilt(payload["kernel_library"])
    if dev.type == "cuda":
        torch.cuda.init()
        build.histogram_extension()  # a failed load fails the member, before any work
    t0 = time.perf_counter()
    with open(payload["spec"], "rb") as fh:
        spec = pickle.load(fh)
    journal_root = payload["journal_root"]
    journal_key = payload["journal_key"]
    table = spec["table"]
    mask = np.asarray(spec["train_mask"], dtype=bool)
    train, valid = table.filter(mask), table.filter(~mask)
    load_seconds = time.perf_counter() - t0
    fit_seconds: Dict[int, float] = {}
    kinds = spec["kinds"]
    bus = get_bus()

    fitted: List[int] = []
    recovered: List[int] = []
    launched = (hh.build_histograms_cuda.launches, hh.build_histograms_combined_cuda.launches)
    for bi in range(len(kinds)):
        # the designated death point for kill_process chaos: every member
        # walks every bucket index (rank assignment is rendezvous-order,
        # so a member-targeted directive must not depend on ownership),
        # and a directive keyed (member, iteration=bi, epoch) SIGKILLs
        # here — mid-sweep, with earlier buckets already journaled
        ctx.maybe_die(bi)
        owned = bi % ctx.world == ctx.rank
        journal = FitJournal(
            journal_root, key=_bucket_journal_key(journal_key, bi),
            num_tasks=1,
        )
        try:
            if 0 in journal.restore():
                # committed before this epoch — zero re-execution; the
                # owner books the scheduler's checkpoint-recovery event
                if owned:
                    recovered.append(bi)
                    if bus.active:
                        bus.publish(TaskRecovered(job_id=0, task_id=bi))
                continue
            if not owned:
                continue
            bucket = CandidateBucket(
                estimator=spec["estimator"], kind=kinds[bi],
                param_maps=spec["param_maps"][bi],
                indices=spec["indices"][bi],
            )
            t_fit = time.perf_counter()
            scored = fit_bucket(
                bucket, train, valid, spec["label_col"], spec["metric"],
                bucket_index=bi,
            )
            fit_seconds[bi] = time.perf_counter() - t_fit
            journal.record(0, {
                "indices": [int(i) for i in bucket.indices],
                "scores": [float(s) for s, _ in scored],
            })
            fitted.append(bi)
        finally:
            journal.close()
    if fitted or recovered:
        logger.info(
            "sweep member %d (rank %d/%d, epoch %d): fit %s, recovered %s",
            ctx.member, ctx.rank, ctx.world, ctx.epoch, fitted, recovered,
        )
    return {
        "rank": ctx.rank, "world": ctx.world, "epoch": ctx.epoch,
        "fitted": fitted, "recovered": recovered, "device": str(dev),
        "load_seconds": load_seconds,
        "fit_seconds": {str(bi): s for bi, s in fit_seconds.items()},
        "launches": {"hist_panel": hh.build_histograms_cuda.launches - launched[0],
                     "hist_combined": hh.build_histograms_combined_cuda.launches - launched[1]},
    }


# -- driver side --------------------------------------------------------------


def run_sweep_process_group(
    estimator,
    buckets,
    table,
    train_mask: np.ndarray,
    label_col: str,
    metric: str,
    num_processes: int,
    *,
    num_candidates: int,
    seed: int = 0,
    workdir: Optional[str] = None,
    journal_root: Optional[str] = None,
    journal_key: str = "sweep",
    group_options: Optional[Dict[str, Any]] = None,
    owner=None,
) -> List[float]:
    """Shard ``buckets`` across ``num_processes`` worker processes and
    return the per-candidate validation metrics in candidate order.

    The driver parks the candidate spec (estimator + bucket descriptors +
    table + split mask, with the standard :mod:`pickle`) in the group
    workdir, pre-creates every bucket journal (so worker constructors stay
    read-only), builds the kernels once when the estimator's device is the
    card, runs the gang, then assembles scores from the journals (never
    from worker return values, so a chaotic run selects exactly like an
    undisturbed one).
    """
    from mmlspark_tpu_torch.device import resolve_device
    from mmlspark_tpu_torch.kernels.build import histogram_extension
    from mmlspark_tpu_torch.runtime.journal import FitJournal
    from mmlspark_tpu_torch.runtime.procgroup import ProcessGroup

    if workdir is None:
        import tempfile

        workdir = tempfile.mkdtemp(prefix="mmlspark-torch-sweep-")
    wd = Path(workdir)
    wd.mkdir(parents=True, exist_ok=True)
    if journal_root is None:
        journal_root = str(wd / "journal")

    spec = {
        "estimator": estimator,
        "kinds": [b.kind for b in buckets],
        "param_maps": [b.param_maps for b in buckets],
        "indices": [b.indices for b in buckets],
        "table": table,
        "train_mask": np.asarray(train_mask, dtype=bool),
        "label_col": label_col,
        "metric": metric,
    }
    spec_path = wd / "spec.pkl"
    t_spec = time.perf_counter()
    with open(spec_path, "wb") as fh:
        pickle.dump(spec, fh, protocol=4)
    spec_seconds = time.perf_counter() - t_spec
    for bi in range(len(buckets)):
        FitJournal(journal_root, key=_bucket_journal_key(journal_key, bi),
                   num_tasks=1).close()

    dev = resolve_device(estimator.getDevice())
    payload = {
        "spec": str(spec_path),
        "journal_root": journal_root,
        "journal_key": journal_key,
        "device": str(dev),
    }
    if dev.type == "cuda":
        payload["kernel_library"] = os.path.abspath(histogram_extension().__file__)
    gkw = dict(group_options or {})
    gkw.setdefault("seed", seed)
    pg = ProcessGroup(
        num_processes, "mmlspark_tpu_torch.sweep.distributed:sweep_worker_entry",
        payload=payload, workdir=str(wd / "group"), rendezvous="gloo", **gkw,
    )
    try:
        worker_results = pg.run()
    finally:
        exit_statuses = pg.exit_statuses + pg.shutdown()

    metrics: List[float] = [float("nan")] * num_candidates
    for bi in range(len(buckets)):
        journal = FitJournal(
            journal_root, key=_bucket_journal_key(journal_key, bi),
            num_tasks=1,
        )
        rec = journal.restore().get(0)
        journal.close()
        if rec is None:
            raise RuntimeError(
                f"sweep bucket {bi} never committed; worker results: "
                f"{worker_results}"
            )
        for idx, score in zip(rec["indices"], rec["scores"]):
            metrics[int(idx)] = float(score)
    if owner is not None:
        owner._process_sweep = {
            "epochs": pg.epoch + 1,
            "spec_seconds": spec_seconds,
            "worker_results": worker_results,
            "exit_statuses": exit_statuses,
        }
    return metrics
