"""Shared VW learner machinery: params and the adagrad-SGD / FTRL train loop.

The port's counterpart of ``mmlspark_tpu/vw/base.py``, a re-design of
``vw/VowpalWabbitBase.scala:238-442``. The native per-example ``learn()``
loop becomes a loop over padded minibatches, each step the reference's:
gather the weights, the margin, the loss gradient, the ``acc`` scatter-add,
``acc`` read back after the batch's adds, then the weight scatter-add per
occurrence. The row layout (the (num_batches, B, K) index and value tensors,
labels and weights) is uploaded to the estimator's ``device`` once per fit,
and a pass runs without a host sync.

Several fits share one step routine over a leading lane axis: the K
candidates of :func:`train_linear_many` (one minibatch stream, K states) and
the S shards of a mesh fit (each shard its own rows and state). The state of
L lanes is one flat tensor of ``L * dim + 1`` floats (lane l's weight j at
``l * dim + j``; the last slot is a sink that padding writes add zero to).
A mesh fit averages (weights, acc), or (z, n) under FTRL, over its shards
at each pass end, summed in shard order: the reference's per-pass
``lax.pmean`` over the ``data`` axis (VW's ``endPass`` allreduce).

Arithmetic, per device:

- on the CPU each scatter-add adds the batch's duplicate indices one by one
  in flat order (``index_add_``, as XLA's CPU scatter does), and the
  logistic loss's sigmoid takes XLA's CPU ``exp`` (``objectives.xla_exp``);
- on the card ``index_add_`` would add duplicates with float atomics in no
  fixed order. So each batch's flat indices are sorted once, at upload; a
  step sums each run of equal indices in position order
  (``torch.segment_reduce``) and adds the sums at the unique indices, so
  that two fits give the same bits. The sigmoid is ``torch.sigmoid`` (one
  launch). A step is a few dozen small launches, so the first one is
  captured as a CUDA graph, reading its batch and step through device
  counters, and every later step replays it.

A run's sum keeps updates that one-by-one adds lose: an update below half
an ulp of the weight (the constant feature takes B of them a step) vanishes
when added alone. So the card's weights part from the CPU's, and the
reference's, by more than rounding; the tests state the tolerance.

On both, the step size is ``lr * powf(1 + t, -power_t)`` with the C
library's ``powf`` and FTRL divides by alpha as a product with its float32
reciprocal, as the reference's compiled program does. The reference's
compiler contracts some products into fused multiply-adds inside its scanned
loop and the port does not, so weights agree with the reference's within a
tolerance (the tests state it), not bit for bit.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasWeightCol,
    Param,
    Params,
    ge,
    gt,
    in_range,
    to_bool,
    to_float,
    to_int,
    to_str,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.core.utils import StopWatch
from mmlspark_tpu_torch.data.sparse import SparseBatch, column_to_batch, dense_to_batch
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.lightgbm.objectives import xla_exp
from mmlspark_tpu_torch.ops.hashing import mask_bits, murmur32_bytes
from mmlspark_tpu_torch.parallel.mesh import AXIS_DATA, Mesh, best_mesh, get_topology

#: VW's implicit constant (bias) feature, hashed from the literal "Constant".
CONSTANT_FEATURE = b"Constant"


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + xla_exp(-x))


def _loss_grad(loss: str, margin, y, quantile_tau: float):
    """d loss / d margin. Labels: classifier y in {-1, +1}; regressor real."""
    if loss == "logistic":
        ny = -y
        return ny * _sigmoid(ny * margin)
    if loss == "squared":
        return margin - y
    if loss == "hinge":
        return torch.where(y * margin < 1.0, -y, torch.zeros_like(y))
    if loss == "quantile":
        return torch.where(margin > y, 1.0 - quantile_tau, -quantile_tau).to(margin.dtype)
    raise ValueError(f"unknown loss {loss!r}")


@dataclasses.dataclass
class VWTrainResult:
    weights: np.ndarray
    stats: dict


class VowpalWabbitBaseParams(
    HasFeaturesCol, HasLabelCol, HasPredictionCol, HasWeightCol, Params
):
    numPasses = Param("Training passes over the data", default=1, converter=to_int, validator=gt(0))
    learningRate = Param("Base learning rate", default=0.5, converter=to_float, validator=gt(0))
    powerT = Param("Learning-rate decay exponent", default=0.5, converter=to_float, validator=ge(0))
    l1 = Param("L1 regularization (lazy, applied at pass end)", default=0.0, converter=to_float, validator=ge(0))
    l2 = Param("L2 regularization", default=0.0, converter=to_float, validator=ge(0))
    numBits = Param("log2 feature-space size (when features are dense)", default=18, converter=to_int, validator=in_range(1, 30))
    batchSize = Param("Rows per SGD minibatch", default=64, converter=to_int, validator=gt(0))
    hashSeed = Param("Hash seed for the constant feature", default=0, converter=to_int)
    passThroughArgs = Param("VW-style CLI arg string (parsed for known flags)", default="", converter=to_str)
    useBarrierExecutionMode = Param("Accepted for API parity (SPMD is always synchronous)", default=True, converter=to_bool)
    initialModel = Param("Warm-start weights", is_complex=True)
    interactions = Param("Namespace interaction pairs (handled by VowpalWabbitInteractions)", default=[], is_complex=False)
    device = Param("Torch device the fit runs on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)

    # flag -> (out key, converter); None converter = boolean switch
    _ARG_SPEC = {
        "--loss_function": ("loss", str),
        "--learning_rate": ("learning_rate", float),
        "-l": ("learning_rate", float),
        "--passes": ("passes", int),
        "--l1": ("l1", float),
        "--l2": ("l2", float),
        "--power_t": ("power_t", float),
        "-b": ("num_bits", int),
        "--bit_precision": ("num_bits", int),
        "--quantile_tau": ("quantile_tau", float),
        "--ftrl": ("ftrl", None),
        "--ftrl_alpha": ("ftrl_alpha", float),
        "--ftrl_beta": ("ftrl_beta", float),
        "--link": ("link", str),
        "--noconstant": ("noconstant", None),
        # hashing happens in the (separate) VowpalWabbitFeaturizer stage, so
        # --hash_seed here governs LEARNER-side hashing only (the constant
        # feature / un-featurized spaces). To move the whole feature space,
        # set hashSeed on the featurizer — unlike native VW, where the
        # learner owns all hashing.
        "--hash_seed": ("hash_seed", int),
    }

    #: Diagnostic / IO flags that do not change the trained model: accepted
    #: for pipeline compatibility and skipped with a warning. Maps flag ->
    #: True if it consumes a value token.
    _NOOP_ARGS = {
        "--quiet": False,
        "--no_stdin": False,
        "--holdout_off": False,
        "-p": True,
        "--predictions": True,
        "--progress": True,
        "-P": True,
        "--cache": False,
        "-c": False,
        "--cache_file": True,
        "-k": False,
        "--kill_cache": False,
        "--save_resume": False,
        "--preserve_performance_counters": False,
        "--readable_model": True,
        "--invert_hash": True,
        "--audit": False,
        "-a": False,
    }

    def _parse_args(self) -> dict:
        """Parse the VW CLI flags this runtime implements
        (``appendParamIfNotThere`` analogue, VowpalWabbitBase.scala:140-159).
        Unknown MODEL-CHANGING flags raise: silently dropping one would train
        a different model than the user asked for. Known diagnostic/IO flags
        (``_NOOP_ARGS``) are skipped with a warning."""
        from mmlspark_tpu_torch.core.profiling import get_logger

        out = {}
        toks = self.getPassThroughArgs().split()
        i = 0
        while i < len(toks):
            t = toks[i]
            inline = None
            if t.startswith("--") and "=" in t:
                t, _, inline = t.partition("=")
            if t in self._NOOP_ARGS:
                get_logger("mmlspark_tpu_torch.vw").warning(
                    "passThroughArgs: ignoring diagnostic VW flag %r "
                    "(no effect on the trained model in this runtime)", t
                )
                i += 1 + (1 if self._NOOP_ARGS[t] and inline is None else 0)
                continue
            if t not in self._ARG_SPEC:
                raise ValueError(
                    f"passThroughArgs: unsupported VW flag {t!r}. This "
                    "runtime implements: "
                    + " ".join(sorted(self._ARG_SPEC))
                    + ". Other VW reductions/flags are not silently ignored "
                    "— they would change the trained model."
                )
            key, conv = self._ARG_SPEC[t]
            if conv is None:  # boolean switch
                if inline is not None:
                    raise ValueError(f"passThroughArgs flag {t!r} takes no value")
                out[key] = True
                i += 1
                continue
            if inline is None:
                if i + 1 >= len(toks):
                    raise ValueError(f"passThroughArgs flag {t!r} expects a value")
                inline = toks[i + 1]
                i += 2
            else:
                i += 1
            out[key] = conv(inline)
        if out.get("link") not in (None, "identity", "logistic"):
            raise ValueError(
                f"--link {out['link']!r} not supported (identity | logistic)"
            )
        return out


class VowpalWabbitBase(VowpalWabbitBaseParams, Estimator):
    _default_loss = "squared"

    def _label_transform(self, y: np.ndarray) -> np.ndarray:
        return y.astype(np.float32)

    def _get_batch(self, table: Table, num_bits=None) -> Tuple[SparseBatch, bool]:
        """Returns (batch, is_hashed_space). ``num_bits`` overrides the
        param (the ``-b``/``--bit_precision`` pass-through flag); a
        pre-featurized column's ``sparse_dim`` metadata wins over both
        (the space was fixed upstream by VowpalWabbitFeaturizer)."""
        col = table.column(self.getFeaturesCol())
        if col.dtype == object:
            dim = table.metadata(self.getFeaturesCol()).get("sparse_dim")
            if dim is None:
                dim = 1 << (num_bits or self.getNumBits())
            return column_to_batch(col, dim), True
        # dense vector column: positions are the features; slot f is the bias
        dense = np.asarray(col, dtype=np.float32)
        return dense_to_batch(dense, dense.shape[1] + 1), False

    def _train_setup(self, table: Table):
        """Everything ``_fit`` resolves before the numeric train loop:
        (args, batch, y, w, const_idx, init). The many-models plane
        (``sweep/batched.py``) prepares rows once per bucket through it and
        routes K candidates through :func:`train_linear_many`."""
        args = self._parse_args()
        batch, is_hashed = self._get_batch(table, num_bits=args.get("num_bits"))
        y = self._label_transform(
            np.asarray(table.column(self.getLabelCol()), dtype=np.float64)
        )
        w = (
            np.asarray(table.column(self.getWeightCol()), dtype=np.float32)
            if self.isSet("weightCol")
            else np.ones(batch.num_rows, dtype=np.float32)
        )
        hash_seed = args.get("hash_seed", self.getHashSeed())
        if args.get("noconstant"):
            const_idx = -1  # --noconstant: no bias feature anywhere
        elif is_hashed:
            # hashed feature space: the constant feature hashes like any other
            const_idx = int(
                mask_bits(
                    np.asarray([murmur32_bytes(CONSTANT_FEATURE, hash_seed)], dtype=np.uint32),
                    int(np.log2(batch.dim)),
                )[0]
            )
        else:
            # dense feature space: the reserved last slot is the bias
            const_idx = batch.dim - 1

        init = None
        if self.isSet("initialModel"):
            init = np.asarray(self.getInitialModel(), dtype=np.float32)
        return args, batch, y, w, const_idx, init

    def _fit(self, table: Table) -> "VowpalWabbitModelBase":
        args, batch, y, w, const_idx, init = self._train_setup(table)

        result = train_linear(
            batch,
            y,
            w,
            loss=args.get("loss", self._default_loss),
            num_passes=args.get("passes", self.getNumPasses()),
            learning_rate=args.get("learning_rate", self.getLearningRate()),
            power_t=args.get("power_t", self.getPowerT()),
            l1=args.get("l1", self.getL1()),
            l2=args.get("l2", self.getL2()),
            batch_size=self.getBatchSize(),
            constant_index=const_idx,
            initial_weights=init,
            quantile_tau=args.get("quantile_tau", 0.5),
            optimizer="ftrl" if args.get("ftrl") else "adagrad",
            ftrl_alpha=args.get("ftrl_alpha", 0.005),
            ftrl_beta=args.get("ftrl_beta", 0.1),
            mesh=self._select_mesh(),
            device=self.getDevice(),
        )
        self._link = args.get("link", "identity")
        model = self._make_model(result, batch.dim, const_idx)
        model.set("linkFunction", self._link)
        model.parent = self
        return model

    def _select_mesh(self, device: DeviceLike = None) -> Optional[Mesh]:
        """Every device of the fit's platform (``device``, else the
        estimator's) on the data axis, as ``lightgbm/base.py``'s; None for
        one."""
        platform = resolve_device(self.getDevice() if device is None else device).type
        n = get_topology(platform).num_devices
        if n <= 1:
            return None
        return best_mesh(n, platform)

    def _make_model(self, result: VWTrainResult, dim: int, const_idx: int):
        raise NotImplementedError


def _prep_rows(
    batch: SparseBatch,
    y: np.ndarray,
    sample_weight: np.ndarray,
    constant_index: int,
    batch_size: int,
    n_shards: int,
):
    """Row layout shared by the single-fit and many-models paths: append
    the constant feature, pad rows to ``n_shards * num_batches *
    batch_size``. Padding rides with zero value/weight so it never moves
    the weights. Returns (idx, val, y, sample_weight, k, num_batches)."""
    n, k = batch.indices.shape

    if constant_index >= 0:
        # append the constant feature to every row
        idx = np.concatenate(
            [batch.indices, np.full((n, 1), constant_index, dtype=np.int32)], axis=1
        )
        val = np.concatenate([batch.values, np.ones((n, 1), dtype=np.float32)], axis=1)
        k += 1
    else:
        idx, val = batch.indices, batch.values

    rows_per_shard = -(-n // n_shards)  # ceil
    num_batches = -(-rows_per_shard // batch_size)
    padded = n_shards * num_batches * batch_size
    pad = padded - n
    if pad:
        idx = np.concatenate([idx, np.zeros((pad, k), dtype=np.int32)])
        val = np.concatenate([val, np.zeros((pad, k), dtype=np.float32)])
        y = np.concatenate([y.astype(np.float32), np.zeros(pad, dtype=np.float32)])
        sample_weight = np.concatenate(
            [sample_weight, np.zeros(pad, dtype=np.float32)]
        )
    else:
        y = y.astype(np.float32)
    return idx, val, y, sample_weight, k, num_batches


_POWF = None
_POWF_LOCK = threading.Lock()


def _powf():
    """The C library's float32 ``powf`` (XLA's CPU ``pow`` calls it), or
    None where no C math library loads."""
    global _POWF
    with _POWF_LOCK:
        if _POWF is None:
            try:
                lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
                fn = lib.powf
                fn.restype = ctypes.c_float
                fn.argtypes = [ctypes.c_float, ctypes.c_float]
                _POWF = fn
            except (OSError, AttributeError):
                _POWF = False
    return _POWF or None


def _step_sizes(learning_rates: Sequence[float], power_ts: Sequence[float],
                num_steps: int) -> np.ndarray:
    """(num_steps, L) float32 negated step sizes: ``-(lr / (1 + t) **
    power_t)`` at step t of each lane, as the reference's program computes
    it (XLA rewrites the quotient to ``lr * pow(1 + t, -power_t)``; ``t``
    is a float32 step count, exact to 2**24)."""
    out = np.empty((num_steps, len(learning_rates)), dtype=np.float32)
    powf = _powf()
    for j, (lr, pt) in enumerate(zip(learning_rates, power_ts)):
        lr32 = np.float32(lr)
        e = -float(np.float32(pt))
        if e == 0.0:
            out[:, j] = lr32
            continue
        base = np.arange(1, num_steps + 1, dtype=np.float32)
        if powf is not None:
            p = np.fromiter((powf(float(x), e) for x in base), dtype=np.float32,
                            count=num_steps)
        else:
            p = np.power(base, np.float32(e))
        out[:, j] = lr32 * p
    return -out


@dataclasses.dataclass
class _Hyper:
    """A fit's hyperparameters. In the sequential form (the reference's
    ``train_linear``) they are Python floats and a zero ``l1``/``l2`` skips
    its term; in the many form (``_make_fit_many``) they are per-lane
    float32 tensors of shape (L, 1, 1), every term applied."""

    loss: str
    optimizer: str
    quantile_tau: float
    ftrl_alpha: float
    ftrl_beta: float
    l1: Any
    l2: Any
    many: bool

    def has_l1(self) -> bool:
        return self.many or bool(self.l1)

    def has_l2(self) -> bool:
        return self.many or bool(self.l2)


class _Lanes:
    """L fits in lockstep on one device: their minibatch stream (one shared
    stream, or one per lane) uploaded once, their state in flat tensors of
    ``L * dim + 1`` floats (``W``, and ``A``: adagrad's acc, or FTRL's z in
    ``W`` and n in ``A``). A step reads its batch either through a Python
    index or, on the card, through device counters (``cur``: the batch,
    ``step``: the step), so that one captured step replays for every batch;
    neither path syncs with the host."""

    def __init__(self, idx: np.ndarray, val: np.ndarray, y: np.ndarray, w: np.ndarray,
                 num_lanes: int, dim: int, dev: torch.device, hp: _Hyper,
                 sorted_scatter: bool, w0: np.ndarray, neg_steps: np.ndarray):
        # idx/val (num_batches, Ls, B, K), y/w (num_batches, Ls, B); Ls is
        # num_lanes (a stream per lane) or 1 (one stream for every lane)
        nb, ls, b, k = idx.shape
        self.L, self.dim, self.dev, self.hp = num_lanes, dim, dev, hp
        self.num_batches = nb
        self.shape = (num_lanes, b, k)
        self.sink = num_lanes * dim
        lane_off = (np.arange(num_lanes, dtype=np.int64) * dim)[None, :, None, None]
        gidx = idx.astype(np.int64) + lane_off  # (nb, L, B, K)
        self.gidx = torch.as_tensor(gidx.reshape(nb, -1), device=dev)
        self.val, self.y, self.w = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                                    for a in (val, y, w))
        self.inv_alpha = float(np.float32(1.0) / np.float32(hp.ftrl_alpha))
        self.mask = self.val != 0 if hp.has_l2() and hp.optimizer == "adagrad" else None
        self.plan = self._sort_plan() if sorted_scatter else None
        self.neg_steps = torch.as_tensor(neg_steps, device=dev)
        self.W = torch.zeros(self.sink + 1, dtype=torch.float32, device=dev)
        self.A = torch.zeros_like(self.W)
        Wv = self.lanes(self.W)
        Wv.copy_(torch.as_tensor(w0, device=dev))
        if hp.optimizer == "ftrl":
            # warm start: invert the closed form at n = 0 (ignoring l1)
            Wv.copy_(-Wv * (hp.ftrl_beta / hp.ftrl_alpha + self.lane_param(hp.l2)))
        self.cur = torch.zeros(1, dtype=torch.int64, device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.graph = None

    def lanes(self, state: torch.Tensor) -> torch.Tensor:
        """The (L, dim) view of a flat state."""
        return state[:self.sink].view(self.L, self.dim)

    def lane_param(self, v):
        """A hyperparameter against (L, dim) states: per-lane (L, 1) in the
        many form, the Python float otherwise."""
        return v.view(-1, 1) if self.hp.many else v

    def _sort_plan(self):
        """Per batch: the stable order of its flat indices, each run's start
        (padded with the batch's length) and each run's index (padded with
        the sink). Built once on the device."""
        sk, perm = torch.sort(self.gidx, dim=1, stable=True)
        nb, m = sk.shape
        start = torch.ones_like(sk, dtype=torch.bool)
        start[:, 1:] = sk[:, 1:] != sk[:, :-1]
        run = torch.cumsum(start.to(torch.int64), dim=1) - 1
        dump = torch.where(start, run, torch.full_like(run, m))
        pos = torch.arange(m, device=self.dev).expand(nb, m)
        offsets = torch.full((nb, m + 2), m, dtype=torch.int64, device=self.dev)
        offsets.scatter_(1, dump, pos)  # non-starts land in the dropped column m
        uniq = torch.full((nb, m + 1), self.sink, dtype=torch.int64, device=self.dev)
        uniq.scatter_(1, dump, sk)
        offsets[:, m] = m
        return perm, offsets[:, :m + 1].contiguous(), uniq[:, :m].contiguous()

    def _at(self, t: torch.Tensor, b: Optional[int]) -> torch.Tensor:
        """Batch b's slice of a per-batch tensor; with b None, the slice of
        the batch the device counter holds."""
        return t[b] if b is not None else t.index_select(0, self.cur)[0]

    def _add(self, state: torch.Tensor, b: Optional[int], upd: torch.Tensor) -> None:
        """``state.at[flat index].add(upd)`` for batch b: in flat order on
        the CPU; on the card each run of equal indices summed in position
        order, the sums added at the unique indices."""
        upd = upd.reshape(-1)
        if self.plan is None:
            state.index_add_(0, self._at(self.gidx, b), upd)
            return
        perm, offsets, uniq = (self._at(t, b) for t in self.plan)
        runs = torch.segment_reduce(upd.index_select(0, perm), "sum", offsets=offsets,
                                    unsafe=True, initial=0.0)
        state.index_add_(0, uniq, runs)

    def ftrl_w(self, z: torch.Tensor, n: torch.Tensor, l1, l2) -> torch.Tensor:
        """FTRL-Proximal's closed-form weights from its (z, n) accumulators
        (XLA divides by alpha as a product with its reciprocal)."""
        den = torch.sqrt(n) + self.hp.ftrl_beta
        if self.dev.type == "cpu":
            # the reference's compiler fuses this product and sum
            den = (den.double() * self.inv_alpha + l2).to(torch.float32)
        else:
            den = den * self.inv_alpha + l2
        w = -(z - torch.sign(z) * l1) / den
        return torch.where(torch.abs(z) > l1, w, torch.zeros_like(w))

    def run_step(self, b: Optional[int], s: Optional[int]) -> None:
        """Minibatch b at step s on every lane (both None: the counters')."""
        hp = self.hp
        gi = self._at(self.gidx, b)
        bv = self._at(self.val, b)
        y, w = self._at(self.y, b), self._at(self.w, b)
        if hp.optimizer == "ftrl":
            zi = self.W.index_select(0, gi).view(self.shape)
            ni = self.A.index_select(0, gi).view(self.shape)
            wi = self.ftrl_w(zi, ni, hp.l1, hp.l2)
            g_row = _loss_grad(hp.loss, (wi * bv).sum(-1), y, hp.quantile_tau) * w
            g = g_row.unsqueeze(-1) * bv
            sigma = (torch.sqrt(ni + g * g) - torch.sqrt(ni)) * self.inv_alpha
            self._add(self.W, b, g - sigma * wi)
            self._add(self.A, b, g * g)
        else:
            wi = self.W.index_select(0, gi).view(self.shape)
            g_row = _loss_grad(hp.loss, (wi * bv).sum(-1), y, hp.quantile_tau) * w
            g = g_row.unsqueeze(-1) * bv
            if self.mask is not None:
                g = g + torch.where(self._at(self.mask, b), wi * hp.l2, torch.zeros_like(wi))
            g = g.reshape(self.L, -1)
            self._add(self.A, b, g * g)
            denom = torch.sqrt(self.A.index_select(0, gi)).view(self.L, -1) + 1e-6
            neg_step = (self.neg_steps[s] if s is not None
                        else self.neg_steps.index_select(0, self.step)[0]).view(-1, 1)
            self._add(self.W, b, neg_step * g / denom)
        if b is None:
            self.cur += 1
            self.step += 1

    def run_pass(self, p: int) -> None:
        """One pass over every minibatch. On the CPU a step reads its batch
        through a Python index. On the card the first pass's first step runs
        as the warm-up on the device counters and is then captured as a CUDA
        graph, which every later step replays."""
        if self.dev.type != "cuda":
            for b in range(self.num_batches):
                self.run_step(b, p * self.num_batches + b)
            return
        self.cur.zero_()
        first = 0
        if self.graph is None:
            side = torch.cuda.Stream(self.dev)
            side.wait_stream(torch.cuda.current_stream(self.dev))
            with torch.cuda.stream(side):
                self.run_step(None, None)
            torch.cuda.current_stream(self.dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.run_step(None, None)
            first = 1
        for _ in range(first, self.num_batches):
            self.graph.replay()

    def fitted(self) -> torch.Tensor:
        """The lanes' weights (L, dim) after the last pass."""
        hp = self.hp
        Wv, Av = self.lanes(self.W), self.lanes(self.A)
        if hp.optimizer == "ftrl":
            # l1 lives inside the closed form — no extra lazy shrink
            return self.ftrl_w(Wv, Av, self.lane_param(hp.l1), self.lane_param(hp.l2))
        if hp.has_l1():
            l1 = self.lane_param(hp.l1)
            return torch.sign(Wv) * torch.clamp_min(torch.abs(Wv) - l1, 0.0)
        return Wv


def _lane_mean(views: List[torch.Tensor]) -> torch.Tensor:
    """The mean of the lanes' states, summed in lane (shard) order, on the
    first lane's device: the reference's ``lax.pmean``."""
    acc = views[0].clone()
    for v in views[1:]:
        acc += v.to(acc.device)
    return acc * float(np.float32(1.0) / np.float32(len(views)))


def _run_lanes(groups: List[_Lanes], num_passes: int, average: bool) -> torch.Tensor:
    """Every pass of every lane group; with ``average`` the lanes' states
    are averaged in lane order after each pass. Returns the fitted weights
    (L, dim) of the lanes, on the first group's device."""
    for p in range(num_passes):
        for g in groups:
            g.run_pass(p)
        if average:
            for name in ("W", "A"):
                views = [g.lanes(getattr(g, name))[i] for g in groups for i in range(g.L)]
                mean = _lane_mean(views)
                for g in groups:
                    g.lanes(getattr(g, name)).copy_(mean.to(g.dev).expand(g.L, g.dim))
    return torch.cat([g.fitted().to(groups[0].dev) for g in groups])


def _mesh_lane_devices(mesh: Optional[Mesh]) -> List[torch.device]:
    if mesh is None:
        return []
    return [mesh.slot(data=s) for s in range(int(mesh.shape[AXIS_DATA]))]


def _groups_by_device(devs: List[torch.device]) -> List[Tuple[torch.device, List[int]]]:
    """Consecutive lanes on one device form one group."""
    out: List[Tuple[torch.device, List[int]]] = []
    for i, d in enumerate(devs):
        if out and out[-1][0] == d:
            out[-1][1].append(i)
        else:
            out.append((d, [i]))
    return out


def train_linear(
    batch: SparseBatch,
    y: np.ndarray,
    sample_weight: np.ndarray,
    *,
    loss: str,
    num_passes: int,
    learning_rate: float,
    power_t: float,
    l1: float,
    l2: float,
    batch_size: int,
    constant_index: int,
    initial_weights: Optional[np.ndarray] = None,
    quantile_tau: float = 0.5,
    optimizer: str = "adagrad",
    ftrl_alpha: float = 0.005,
    ftrl_beta: float = 0.1,
    mesh: Optional[Mesh] = None,
    device: DeviceLike = None,
) -> VWTrainResult:
    """Adagrad SGD (or FTRL-Proximal, VW ``--ftrl``) over padded
    minibatches on ``device`` (CUDA unless ``device='cpu'``); with a
    ``mesh``, its data slots each fit a contiguous block of the rows and the
    state is averaged over them at each pass end (VW's endPass allreduce).
    ``constant_index < 0`` = ``--noconstant``."""
    dev = resolve_device(device)
    sw = StopWatch()
    dim = batch.dim
    n = batch.num_rows
    slots = _mesh_lane_devices(mesh)
    if any(s.type != dev.type for s in slots):
        raise ValueError(f"mesh slots {sorted({str(s) for s in slots})} are not on the fit's "
                         f"device {dev}")
    n_shards = max(1, len(slots))
    idx, val, y, sample_weight, k, num_batches = _prep_rows(
        batch, y, sample_weight, constant_index, batch_size, n_shards
    )
    w0 = (
        np.asarray(initial_weights, dtype=np.float32).copy()
        if initial_weights is not None
        else np.zeros(dim, dtype=np.float32)
    )
    hp = _Hyper(loss=loss, optimizer=optimizer, quantile_tau=float(quantile_tau),
                ftrl_alpha=float(ftrl_alpha), ftrl_beta=float(ftrl_beta), l1=float(l1),
                l2=float(l2), many=False)
    neg_steps = _step_sizes([learning_rate], [power_t], num_passes * num_batches)

    # shard s holds rows [s, s + 1) * rows_per_shard, as P("data") cuts them
    def lanes(arr, trailing):
        return arr.reshape((n_shards, num_batches, batch_size) + trailing).swapaxes(0, 1)

    with sw.measure():
        groups = []
        for gdev, ids in _groups_by_device(slots or [dev]):
            sl = slice(ids[0], ids[-1] + 1)
            groups.append(_Lanes(
                lanes(idx, (k,))[:, sl], lanes(val, (k,))[:, sl], lanes(y, ())[:, sl],
                lanes(sample_weight, ())[:, sl], len(ids), dim, gdev, hp,
                gdev.type == "cuda", w0, neg_steps))
        fitted = _run_lanes(groups, num_passes, average=n_shards > 1)[0].cpu().numpy()

    stats = {
        "rows": int(n),
        "passes": int(num_passes),
        "learn_time_s": sw.elapsed_s,
        "shards": n_shards,
        "ipass_loss": None,
        "steps": int(num_passes * num_batches),
    }
    return VWTrainResult(weights=fitted, stats=stats)


#: ``vw.fit_many`` signatures this process has run: a new one books as the
#: reference's first call (its compile), the rest as cache hits.
_FIT_MANY_SEEN: set = set()
_FIT_MANY_LOCK = threading.Lock()


def train_linear_many(
    batch: SparseBatch,
    y: np.ndarray,
    sample_weight: np.ndarray,
    *,
    loss: str,
    num_passes: int,
    learning_rates,
    power_ts,
    l1s,
    l2s,
    batch_size: int,
    constant_index: int,
    initial_weights: Optional[np.ndarray] = None,
    quantile_tau: float = 0.5,
    optimizer: str = "adagrad",
    ftrl_alpha: float = 0.005,
    ftrl_beta: float = 0.1,
    device: DeviceLike = None,
) -> "list[VWTrainResult]":
    """Train K VW candidates in lockstep from one upload of the rows (the
    many-models plane). Candidates share the data, loss, pass count, batch
    size and optimizer (the shape-bucket statics) and differ in their
    (learning_rate, power_t, l1, l2) lanes. As in the reference's vmapped
    program every regularization term is applied (at 0.0 each is the
    identity), so a candidate matches its :func:`train_linear` fit. One
    device; the sweep's gang mode shards buckets across processes instead.
    Under the profiler the call books one ``vw.fit_many`` execution on the
    host clock (a signature's first call as its compile)."""
    from mmlspark_tpu_torch.observability.profiler import get_profiler

    K = len(learning_rates)
    if not (K == len(power_ts) == len(l1s) == len(l2s)):
        raise ValueError("per-candidate hyperparameter stacks disagree on K")
    dev = resolve_device(device)
    sw = StopWatch()
    dim = batch.dim
    n = batch.num_rows
    idx, val, y, sample_weight, k, num_batches = _prep_rows(
        batch, y, sample_weight, constant_index, batch_size, 1
    )
    w0 = (
        np.asarray(initial_weights, dtype=np.float32).copy()
        if initial_weights is not None
        else np.zeros(dim, dtype=np.float32)
    )

    def lane(vals):
        return torch.as_tensor(np.asarray(vals, dtype=np.float32), device=dev).view(K, 1, 1)

    hp = _Hyper(loss=loss, optimizer=optimizer, quantile_tau=float(quantile_tau),
                ftrl_alpha=float(ftrl_alpha), ftrl_beta=float(ftrl_beta), l1=lane(l1s),
                l2=lane(l2s), many=True)
    neg_steps = _step_sizes(learning_rates, power_ts, num_passes * num_batches)

    prof = get_profiler()
    prof_on = prof.active
    with sw.measure():
        t0 = time.perf_counter()
        group = _Lanes(idx.reshape(num_batches, 1, batch_size, k),
                       val.reshape(num_batches, 1, batch_size, k),
                       y.reshape(num_batches, 1, batch_size),
                       sample_weight.reshape(num_batches, 1, batch_size), K, dim, dev, hp,
                       dev.type == "cuda", w0, neg_steps)
        fitted = _run_lanes([group], num_passes, average=False).cpu().numpy()
        if prof_on:
            dt = time.perf_counter() - t0
            sig = (f"vw.fit_many(K={K},rows={idx.shape[0]},k={k},dim={dim},"
                   f"passes={num_passes},loss={loss},opt={optimizer},dev={dev.type})")
            with _FIT_MANY_LOCK:
                first = sig not in _FIT_MANY_SEEN
                _FIT_MANY_SEEN.add(sig)
            if first:
                prof.note_compile("vw.fit_many", dt, signature=sig)
            else:
                prof.note_cache_hit("vw.fit_many")
            prof.note_execute("vw.fit_many", dt)

    results = []
    for ki in range(K):
        stats = {
            "rows": int(n),
            "passes": int(num_passes),
            "learn_time_s": sw.elapsed_s,
            "shards": 1,
            "ipass_loss": None,
            "steps": int(num_passes * num_batches),
        }
        results.append(VWTrainResult(weights=fitted[ki], stats=stats))
    return results


class VowpalWabbitModelBase(HasFeaturesCol, HasPredictionCol, Model):
    """Shared model: weights + raw margin computation
    (``VowpalWabbitBaseModel.scala``). Margins are computed on ``device``:
    on the CPU with the reference's numpy arithmetic, on the card with
    torch gathers."""

    modelWeights = Param("Fitted weight vector", is_complex=True)
    sparseDim = Param("Feature-space size", default=0, converter=to_int)
    constantIndex = Param("Bias feature index (-1 = trained --noconstant)", default=0, converter=to_int)
    numBits = Param("log2 feature-space size for dense inputs", default=18, converter=to_int)
    linkFunction = Param("Prediction link (--link): identity or logistic", default="identity", converter=to_str)
    device = Param("Torch device predict runs on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)

    def _margins(self, table: Table) -> np.ndarray:
        col = table.column(self.getFeaturesCol())
        w = np.asarray(self.getModelWeights())
        if col.dtype == object:
            batch = column_to_batch(col, len(w))
        else:
            batch = dense_to_batch(np.asarray(col, dtype=np.float32), len(w))
        ci = self.getConstantIndex()
        dev = resolve_device(self.getDevice())
        if dev.type == "cpu":
            m = (w[batch.indices] * batch.values).sum(axis=1)
            return m if ci < 0 else m + w[ci]
        wt = torch.as_tensor(w, device=dev)
        idx = torch.as_tensor(batch.indices, device=dev).long()
        m = (wt[idx] * torch.as_tensor(batch.values, device=dev)).sum(dim=1)
        if ci >= 0:
            m = m + wt[ci]
        return m.cpu().numpy()

    def _apply_link(self, m: np.ndarray) -> np.ndarray:
        if self.getLinkFunction() == "logistic":
            return 1.0 / (1.0 + np.exp(-m))
        return m

    def get_performance_statistics(self) -> Table:
        """Diagnostics DataFrame analogue (VowpalWabbitBase.scala:367-391)."""
        stats = self.getTrainingStats() if self.isSet("trainingStats") else {}
        return Table({k: [v] for k, v in stats.items() if v is not None})

    trainingStats = Param("Training diagnostics", is_complex=True)
