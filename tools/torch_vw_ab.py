#!/usr/bin/env python3
"""A/B of the VW learner's minibatch step on one CUDA card, and a float64
witness of its scatter forms.

    python tools/torch_vw_ab.py [--docs 200000] [--reps 2] [--witness-docs 20000 200000]

Fits ``chip_smoke.py``'s phase-33 corpus (30-word documents, numBits 18,
3 passes of batchSize 64) on the card four ways, in turns (the order, then
its mirror): the step replayed from a CUDA graph or launched op by op, and
the scatter as sorted run sums or as ``index_add_``'s float atomics.
``vw.base.train_linear`` runs the first form (graph, sorted); the others are
built from ``vw.base._Lanes`` (``chip_smoke._vw_lanes_fit``). Prints one JSON
line per form: fit seconds of each run, whether its runs gave the same bits,
their largest weight difference, and the largest difference from the
``train_linear`` form over its largest weight.

Then, for the first documents of each ``--witness-docs`` count, one JSON
line: the card's ``train_linear`` weights, the CPU port's (one-by-one adds
in flat order) and the CPU running the card's sorted run sums, each held
against a plain float64 fit of the same rows and step sizes (its largest
difference over the float64 fit's largest weight, and at the constant
feature), and the card against each CPU form. Then the card's name and
power limit. Exits 2 without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, eager, sorted run sums)
FORMS = (("graph_sorted", False, True), ("eager_sorted", True, True),
         ("eager_atomics", True, False), ("graph_atomics", False, False))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _fit_f64(torch, vwbase, batch, y, w, const_idx, batch_size, passes):
    """The classifier's default fit (logistic, adagrad, learningRate 0.5,
    powerT 0.5) in float64 on the CPU, plain torch: the same rows, order and
    step rule, one-by-one adds in flat order."""
    idx, val, yp, wp, k, nb = vwbase._prep_rows(batch, y, w, const_idx, batch_size, 1)
    f64 = torch.float64
    gidx = torch.as_tensor(idx.astype(np.int64)).view(nb, -1)
    vals = torch.as_tensor(val, dtype=f64).view(nb, batch_size, k)
    ys = torch.as_tensor(yp, dtype=f64).view(nb, batch_size)
    ws = torch.as_tensor(wp, dtype=f64).view(nb, batch_size)
    W = torch.zeros(batch.dim, dtype=f64)
    A = torch.zeros_like(W)
    for p in range(passes):
        for b in range(nb):
            t = p * nb + b
            gi = gidx[b]
            margin = (W[gi].view(batch_size, k) * vals[b]).sum(-1)
            g_row = -ys[b] * torch.sigmoid(-ys[b] * margin) * ws[b]
            g = (g_row.unsqueeze(-1) * vals[b]).reshape(-1)
            A.index_add_(0, gi, g * g)
            W.index_add_(0, gi, -0.5 / (1.0 + t) ** 0.5 * g / (torch.sqrt(A[gi]) + 1e-6))
    return W.numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=2, help="runs of each form (in turns)")
    ap.add_argument("--witness-docs", type=int, nargs="*", default=[20_000, 200_000])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_vw_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import VW_BATCH, VW_BITS, VW_PASSES, _vw_corpus, _vw_lanes_fit
    from mmlspark_tpu_torch.data.table import Table
    from mmlspark_tpu_torch.vw import VowpalWabbitClassifier, VowpalWabbitFeaturizer
    from mmlspark_tpu_torch.vw import base as vwbase

    n_docs = max([args.docs] + args.witness_docs)
    docs, y = _vw_corpus(n_docs, seed=0)
    table = VowpalWabbitFeaturizer(inputCols=["text"], outputCol="features", numBits=VW_BITS,
                                   stringSplit=True).transform(Table({"text": docs, "label": y}))
    est = VowpalWabbitClassifier(numPasses=VW_PASSES, batchSize=VW_BATCH, device="cuda")

    def setup(n):
        _, batch, yb, wb, const_idx, _ = est._train_setup(table.slice(0, n))
        return batch, yb, wb, const_idx

    def train_linear(batch, yb, wb, const_idx, device):
        return vwbase.train_linear(batch, yb, wb, loss="logistic", num_passes=VW_PASSES,
                                   learning_rate=0.5, power_t=0.5, l1=0.0, l2=0.0,
                                   batch_size=VW_BATCH, constant_index=const_idx,
                                   device=device)

    batch, yb, wb, const_idx = setup(args.docs)
    runs = {name: [] for name, _, _ in FORMS}
    for rep in range(args.reps):
        for name, eager, sorted_scatter in (FORMS if rep % 2 == 0 else FORMS[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "graph_sorted":
                wts = train_linear(batch, yb, wb, const_idx, "cuda").weights
            else:
                wts = _vw_lanes_fit(torch, vwbase, batch, yb, wb, const_idx, "cuda",
                                    sorted_scatter, eager=eager)
            runs[name].append((time.perf_counter() - t0, wts))
    ref = runs["graph_sorted"][0][1]
    for name, rs in runs.items():
        w = [r[1] for r in rs]
        print(json.dumps(dict(
            form=name, docs=args.docs, steps=VW_PASSES * -(-args.docs // VW_BATCH),
            fit_s=[r[0] for r in rs],
            runs_identical=all(x.tobytes() == w[0].tobytes() for x in w),
            runs_max_diff=float(max(np.abs(x - w[0]).max() for x in w)),
            rel_to_graph_sorted=_rel(w[0], ref))), flush=True)

    for n in args.witness_docs:
        batch, yb, wb, const_idx = setup(n)
        fits = {"card": train_linear(batch, yb, wb, const_idx, "cuda").weights,
                "cpu_flat": train_linear(batch, yb, wb, const_idx, "cpu").weights,
                "cpu_sorted": _vw_lanes_fit(torch, vwbase, batch, yb, wb, const_idx, "cpu",
                                            True)}
        t0 = time.perf_counter()
        w64 = _fit_f64(torch, vwbase, batch, yb, wb, const_idx, VW_BATCH, VW_PASSES)
        f64_s = time.perf_counter() - t0
        scale = float(np.abs(w64).max())
        print(json.dumps(dict(
            witness_docs=n, float64_fit_s=f64_s, float64_max_abs=scale,
            float64_constant=float(w64[const_idx]),
            rel_to_float64={k: _rel(v, w64) for k, v in fits.items()},
            constant_err_to_float64={k: abs(float(v[const_idx]) - float(w64[const_idx])) / scale
                                     for k, v in fits.items()},
            card_to_cpu_flat=_rel(fits["card"], fits["cpu_flat"]),
            card_to_cpu_sorted=_rel(fits["card"], fits["cpu_sorted"]))), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
