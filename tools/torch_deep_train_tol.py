"""Reads the margins of ``chip_smoke.py`` phase 35 (e)'s training check.

Phase 35 (e) trains the port's ``train_resnet_classifier`` (resnet18 with
the small-input stem, batch 64, three Adam steps on 256 images) on the card
and on the CPU, and holds the card to the CPU: the L2 gap of the two trained
trees over the CPU's L2 movement from the start, and each step's loss. This
script reads both over several seeds of the same task (``data_seed`` 38 + k,
``init_seed`` 1 + k; k = 0 is the phase's own), in three forms:

- ``exact``: as the port runs, float32 convolutions and matmuls with TF32 off
  (``device.float32_exact``), twice, to see whether the card repeats itself;
- ``tf32``: the control, with cuDNN's and cuBLAS's TF32 allowed for the
  steps, the arithmetic a check of this kind has to refuse.

Needs a CUDA card. Run from the repository's root:

    python tools/torch_deep_train_tol.py [--seeds 6]

Prints one JSON line per seed, then a summary line with the largest reading
of the exact runs and the smallest of the control, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def _tf32_allowed(torch):
    """TF32 allowed for cuDNN and cuBLAS for the block, the previous
    settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _steps(zoo, X, y, p0, device, steps, batch):
    losses = []
    tree, _ = zoo.train_resnet_classifier(p0, X, y, num_steps=steps, batch_size=batch,
                                          device=device, losses=losses)
    return tree, losses


def _loss_errs(got, want):
    return [abs(g - w) / abs(w) for g, w in zip(got, want)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mmlspark_tpu_torch.models import resnet, zoo

    n, steps, batch = cs.N_DEEP_TRAIN_CPU, cs.DEEP_TRAIN_CPU_STEPS, cs.DEEP_TRAIN_BATCH
    exact_fn = zoo.float32_exact
    rows = []
    for k in range(args.seeds):
        X, y, p0 = cs._deep_train_case(resnet, data_seed=38 + k, init_seed=1 + k)
        X, y = X[:n], y[:n]
        cpu, cpu_losses = _steps(zoo, X, y, p0, "cpu", steps, batch)
        row = dict(seed=k, data_seed=38 + k, init_seed=1 + k, cpu_losses=cpu_losses)
        for form in ("exact", "exact_again", "tf32"):
            if form == "tf32":
                zoo.float32_exact = lambda: _tf32_allowed(torch)
            try:
                card, card_losses = _steps(zoo, X, y, p0, "cuda", steps, batch)
            finally:
                zoo.float32_exact = exact_fn
            errs = _loss_errs(card_losses, cpu_losses)
            row[form] = dict(gap=cs._train_gap(card, cpu, p0), loss_rel_errs=errs,
                             first_loss_rel_err=errs[0], max_loss_rel_err=max(errs))
        print(json.dumps(row), flush=True)
        rows.append(row)

    def reading(form, key, pick):
        return pick(r[form][key] for r in rows)

    summary = dict(
        seeds=args.seeds, rows=n, steps=steps, batch=batch,
        exact_max_gap=reading("exact", "gap", max),
        exact_again_max_gap=reading("exact_again", "gap", max),
        tf32_min_gap=reading("tf32", "gap", min),
        exact_max_first_loss_rel_err=reading("exact", "first_loss_rel_err", max),
        tf32_min_first_loss_rel_err=reading("tf32", "first_loss_rel_err", min),
        exact_max_loss_rel_err=reading("exact", "max_loss_rel_err", max),
        tf32_min_loss_rel_err=reading("tf32", "max_loss_rel_err", min),
        card_repeats=all(r["exact"]["gap"] == r["exact_again"]["gap"] for r in rows),
    )
    print("summary: " + json.dumps(summary), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no reading")
    return 0


if __name__ == "__main__":
    sys.exit(main())
