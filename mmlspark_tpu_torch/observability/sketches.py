"""Deterministic, mergeable streaming sketches for model-quality data —
the port's copy of ``mmlspark_tpu/observability/sketches.py``. A numeric
numpy column takes a vectorized path (:meth:`QuantileCompactor.extend`,
:meth:`ColumnSketch.observe_many`) whose state equals the value-by-value
path's exactly: the same compactions in the same order, and exact integer
sums behind the Fraction moments.

The quality plane (``docs/observability.md`` § Model quality) watches
what the fleet *predicts*, and the fleet is many processes — so the
distribution summaries it keeps must federate the way the metrics plane
does: merge per-replica state into one fleet view with the SAME bytes no
matter which replica folded first. Floating-point summation is not
associative, so the mergeable state here is exact by construction:

- **histogram counts** are integers over FIXED bin edges (placed once,
  at reference-capture time, by the :class:`QuantileCompactor`);
- **moments** (sum, sum of squares) are :class:`fractions.Fraction` —
  every float converts to a Fraction exactly, and Fraction addition is
  exact and associative, so any merge order reproduces the identical
  state and therefore the identical serialization;
- **min/max/counts** are order-free by nature.

``merge(a, merge(b, c)) == merge(merge(a, b), c)`` byte-for-byte is
pinned by the reference's ``tests/test_quality.py``; a sketch folded across N replica
processes equals the single-process sketch over the concatenated stream
exactly. Drift statistics (PSI over the shared bins, KS over the bin
CDFs) are derived at read time and never feed back into sketch state.
"""

from __future__ import annotations

import bisect
import json
import math
from fractions import Fraction
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ColumnSketch",
    "DEFAULT_BINS",
    "QuantileCompactor",
    "ks_statistic",
    "merge_all",
    "psi",
]

#: default number of (near-equidepth) bins a reference profile places —
#: the classic PSI bin count.
DEFAULT_BINS = 10

#: smoothing mass added to every bin before a PSI log-ratio, so an empty
#: bin on either side stays finite.
PSI_EPS = 1e-6


def _is_missing(value: Any) -> bool:
    if value is None:
        return True
    try:
        v = float(value)
    except (TypeError, ValueError):
        return True
    return math.isnan(v)


def _float_array(values: Any) -> Optional[np.ndarray]:
    """``values`` as a 1-D float64 array when they are a numeric numpy
    column (the vectorized path), else None. ``astype`` rounds integers as
    ``float()`` does."""
    if isinstance(values, np.ndarray) and values.ndim == 1 and values.dtype.kind in "fiub":
        return values.astype(np.float64, copy=False)
    return None


def _stream_min(cur: float, x: np.ndarray) -> float:
    """``min(cur, v)`` folded over ``x`` in order: on a tie the earlier
    value stays (which tells -0.0 from 0.0)."""
    m = x.min()
    if not m < cur:
        return cur
    return float(x[np.argmax(x == m)])


def _stream_max(cur: float, x: np.ndarray) -> float:
    m = x.max()
    if not m > cur:
        return cur
    return float(x[np.argmax(x == m)])


#: rows per pass of :func:`_exact_sums`: a bin's float64 sum of limbs
#: below 2**27 stays an exact integer below 2**53
_SUM_ROWS = 1 << 26


def _exact_sums(x: np.ndarray) -> Tuple[Fraction, Fraction]:
    """The exact sum and sum of squares of finite float64 ``x``, as
    Fractions: each value is ``m * 2**e`` with an integer ``|m| < 2**53``;
    the mantissas (and the limbs of their squares) are cut into pieces
    below 2**27 and summed per exponent by ``bincount``, whose float64
    partial sums stay exact integers (at most ``_SUM_ROWS`` rows a pass)."""
    total = totsq = 0
    e0 = None
    for lo_row in range(0, len(x), _SUM_ROWS):
        mant, exp = np.frexp(x[lo_row:lo_row + _SUM_ROWS])
        m = (mant * float(1 << 53)).astype(np.int64)
        keep = m != 0
        m, e = m[keep], exp[keep].astype(np.int64) - 53
        if not len(m):
            continue
        emin = int(e.min())
        idx = e - emin
        a = np.abs(m)
        mask27 = (1 << 27) - 1
        hi, lo = a >> 27, a & mask27  # |m| = hi * 2**27 + lo

        def sums(t):
            return [int(v) for v in np.bincount(idx, weights=t.astype(np.float64))]

        sign = np.sign(m)
        s_hi, s_lo = sums(sign * (a >> 26)), sums(sign * (a & ((1 << 26) - 1)))
        limbs = [(sums(t >> 27), sums(t & mask27)) for t in (hi * hi, 2 * hi * lo, lo * lo)]
        part = partsq = 0
        for g in range(len(s_hi)):
            part += ((s_hi[g] << 26) + s_lo[g]) << g
            sq = 0
            for shift, (t_hi, t_lo) in zip((54, 27, 0), limbs):
                sq += ((t_hi[g] << 27) + t_lo[g]) << shift
            partsq += sq << (2 * g)
        if e0 is None:
            e0 = emin
        elif emin < e0:
            total <<= e0 - emin
            totsq <<= 2 * (e0 - emin)
            e0 = emin
        total += part << (emin - e0)
        totsq += partsq << (2 * (emin - e0))
    if e0 is None:
        return Fraction(0), Fraction(0)

    def scaled(num: int, e2: int) -> Fraction:
        return Fraction(num << e2) if e2 >= 0 else Fraction(num, 1 << -e2)

    return scaled(total, e0), scaled(totsq, 2 * e0)


class QuantileCompactor:
    """Deterministic KLL-style quantile compactor for bin-edge placement.

    Fit time streams a column through this to place near-equidepth bin
    edges without holding the column; live sketches then count into those
    FIXED edges forever after. The classic KLL sketch flips a coin per
    compaction; this one alternates the survivor parity deterministically
    (compaction counter, not RNG), so the same stream always yields the
    same edges — which is what replay-based tests and journal recovery
    want. Weighted rank error stays O(1/k) per level, ample for placing
    ``DEFAULT_BINS`` edges.
    """

    def __init__(self, k: int = 256) -> None:
        if k < 8:
            raise ValueError("compactor capacity k must be >= 8")
        self.k = int(k)
        #: level -> buffer of values; an item at level L weighs 2**L
        self._levels: List[List[float]] = [[]]
        self._compactions = 0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    @property
    def count(self) -> int:
        return self._count

    def update(self, value: Any) -> None:
        if _is_missing(value):
            return
        v = float(value)
        self._count += 1
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        self._levels[0].append(v)
        level = 0
        while len(self._levels[level]) >= self.k:
            buf = sorted(self._levels[level])
            offset = self._compactions % 2
            self._compactions += 1
            self._levels[level] = []
            if level + 1 == len(self._levels):
                self._levels.append([])
            self._levels[level + 1].extend(buf[offset::2])
            level += 1

    def extend(self, values: Iterable[Any]) -> None:
        arr = _float_array(values)
        if arr is None or self.k % 2:
            for v in values:
                self.update(v)
            return
        self._extend_array(arr[~np.isnan(arr)])

    def _extend_array(self, x: np.ndarray) -> None:
        """:meth:`update` over every value of ``x`` (no NaN), vectorized:
        with ``k`` even every compaction takes exactly ``k`` items and
        promotes ``k / 2``, so which compactions happen, and in which
        order (the survivor parity), depends only on the counts. That
        order is replayed on integers first; then each level's
        compactions are one row-wise stable sort of its input stream."""
        if not len(x):
            return
        k, half = self.k, self.k // 2
        self._count += len(x)
        self._min = _stream_min(self._min, x)
        self._max = _stream_max(self._max, x)
        lens = [len(buf) for buf in self._levels]
        lens[0] += len(x)
        offsets: List[List[int]] = [[] for _ in lens]
        counter = self._compactions
        while lens[0] >= k:
            lens[0] -= k
            offsets[0].append(counter % 2)
            counter += 1
            level = 1
            while True:
                if level == len(lens):
                    lens.append(0)
                    offsets.append([])
                lens[level] += half
                if lens[level] < k:
                    break
                lens[level] = 0
                offsets[level].append(counter % 2)
                counter += 1
                level += 1
        self._compactions = counter
        # equal floats are interchangeable in a sort, except -0.0 against
        # 0.0: only then must ties keep their arrival order
        sort_kind = "stable" if bool((np.signbit(x) & (x == 0)).any()) else None
        incoming = x
        for level, offs in enumerate(offsets):
            if level == len(self._levels):
                self._levels.append([])
            stream = np.concatenate([np.asarray(self._levels[level], np.float64), incoming])
            c = len(offs)
            chunks = np.sort(stream[:c * k].reshape(c, k), axis=1, kind=sort_kind)
            odd = np.asarray(offs, bool)
            out = np.empty((c, half), np.float64)
            out[~odd] = chunks[~odd, 0::2]
            out[odd] = chunks[odd, 1::2]
            self._levels[level] = stream[c * k:].tolist()
            incoming = out.reshape(-1)

    def _weighted_items(self) -> List[Tuple[float, int]]:
        items: List[Tuple[float, int]] = []
        for level, buf in enumerate(self._levels):
            weight = 1 << level
            items.extend((v, weight) for v in buf)
        items.sort(key=lambda vw: vw[0])
        return items

    def edges(self, bins: int = DEFAULT_BINS) -> List[float]:
        """Strictly-increasing bin edges (length <= bins + 1) placing
        near-equidepth interior cuts; degenerate streams (constant column,
        empty column) collapse to a single unit-wide bin."""
        if bins < 1:
            raise ValueError("bins must be >= 1")
        if self._count == 0:
            return [0.0, 1.0]
        if self._min == self._max:
            return [self._min - 0.5, self._min + 0.5]
        items = self._weighted_items()
        total = sum(w for _, w in items)
        edges = [self._min]
        cum = 0
        target_idx = 1
        for v, w in items:
            cum += w
            while target_idx < bins and cum >= target_idx * total / bins:
                if v > edges[-1]:
                    edges.append(v)
                target_idx += 1
        if self._max > edges[-1]:
            edges.append(self._max)
        else:
            edges.append(math.nextafter(edges[-1], math.inf))
        return edges


class ColumnSketch:
    """Mergeable distribution sketch of one feature (or score) column.

    State: integer counts over fixed ``edges`` (values clamp into the
    first/last bin, so out-of-reference-range live traffic is visible as
    edge-bin mass), exact Fraction sum/sumsq, min/max, and a missing
    counter (None/NaN/unparseable). All of it merges associatively;
    :meth:`to_json` is canonical (sorted keys, fixed separators), so
    equal state means equal bytes.
    """

    def __init__(self, edges: Sequence[float]) -> None:
        edges = [float(e) for e in edges]
        if len(edges) < 2 or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"edges must be strictly increasing, got {edges}")
        self.edges: Tuple[float, ...] = tuple(edges)
        self.counts: List[int] = [0] * (len(edges) - 1)
        self.n = 0
        self.missing = 0
        self.sum = Fraction(0)
        self.sumsq = Fraction(0)
        self.min = math.inf
        self.max = -math.inf

    # -- ingest --------------------------------------------------------------

    def observe(self, value: Any) -> None:
        if _is_missing(value):
            self.missing += 1
            return
        v = float(value)
        # interior edges only: left of edges[1] -> bin 0, right of
        # edges[-2] -> last bin (the clamp that keeps shifted traffic
        # countable against the reference bins)
        idx = bisect.bisect_right(self.edges, v, 1, len(self.edges) - 1) - 1
        self.counts[idx] += 1
        self.n += 1
        f = Fraction(v)
        self.sum += f
        self.sumsq += f * f
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def observe_many(self, values: Iterable[Any]) -> None:
        arr = _float_array(values)
        if arr is not None:
            missing = np.isnan(arr)
            x = arr[~missing]
            if np.isfinite(x).all():
                self._observe_array(x, int(missing.sum()))
                return
        for v in values:
            self.observe(v)

    def _observe_array(self, x: np.ndarray, missing: int) -> None:
        """:meth:`observe` over finite ``x`` plus ``missing`` NaNs,
        vectorized; the state is the value-by-value state exactly."""
        self.missing += missing
        if not len(x):
            return
        idx = np.searchsorted(np.asarray(self.edges[1:-1]), x, side="right")
        added = np.bincount(idx, minlength=len(self.counts)).tolist()
        self.counts = [c + a for c, a in zip(self.counts, added)]
        self.n += len(x)
        s, sq = _exact_sums(x)
        self.sum += s
        self.sumsq += sq
        self.min = _stream_min(self.min, x)
        self.max = _stream_max(self.max, x)

    # -- merge ---------------------------------------------------------------

    def merge(self, other: "ColumnSketch") -> "ColumnSketch":
        """Pure associative merge: a new sketch whose state is the exact
        sum of both operands (edges must match)."""
        if self.edges != other.edges:
            raise ValueError("cannot merge sketches with different edges")
        out = ColumnSketch(self.edges)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.n = self.n + other.n
        out.missing = self.missing + other.missing
        out.sum = self.sum + other.sum
        out.sumsq = self.sumsq + other.sumsq
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        return out

    # -- derived -------------------------------------------------------------

    def mean(self) -> float:
        return float(self.sum / self.n) if self.n else 0.0

    def variance(self) -> float:
        if self.n < 2:
            return 0.0
        mean = self.sum / self.n
        return float(self.sumsq / self.n - mean * mean)

    def missing_rate(self) -> float:
        total = self.n + self.missing
        return self.missing / total if total else 0.0

    def probabilities(self, eps: float = 0.0) -> List[float]:
        """Per-bin mass fractions, optionally eps-smoothed (every bin gets
        ``eps`` extra mass before normalizing)."""
        total = self.n + eps * len(self.counts)
        if total <= 0:
            return [1.0 / len(self.counts)] * len(self.counts)
        return [(c + eps) / total for c in self.counts]

    def cdf(self) -> List[float]:
        """Cumulative mass at each interior edge + the upper edge."""
        out: List[float] = []
        cum = 0
        for c in self.counts:
            cum += c
            out.append(cum / self.n if self.n else 0.0)
        return out

    def quantile(self, q: float) -> float:
        """Quantile estimate by linear interpolation inside the owning
        bin (the registry histogram's ``percentile`` posture)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        if self.n == 0:
            return 0.0
        rank = q * self.n
        cum = 0
        for i, c in enumerate(self.counts):
            prev, cum = cum, cum + c
            if cum >= rank and c > 0:
                lo, hi = self.edges[i], self.edges[i + 1]
                return lo + (hi - lo) * (rank - prev) / c
        return self.edges[-1]

    # -- serialization (canonical; byte-stable across merge orders) ----------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "edges": list(self.edges),
            "counts": list(self.counts),
            "n": self.n,
            "missing": self.missing,
            # Fractions serialize exactly as "numerator/denominator"
            "sum": f"{self.sum.numerator}/{self.sum.denominator}",
            "sumsq": f"{self.sumsq.numerator}/{self.sumsq.denominator}",
            "min": None if self.n == 0 else self.min,
            "max": None if self.n == 0 else self.max,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ColumnSketch":
        out = cls(d["edges"])
        counts = [int(c) for c in d["counts"]]
        if len(counts) != len(out.counts):
            raise ValueError("counts length does not match edges")
        out.counts = counts
        out.n = int(d["n"])
        out.missing = int(d["missing"])
        out.sum = Fraction(d["sum"])
        out.sumsq = Fraction(d["sumsq"])
        out.min = math.inf if d.get("min") is None else float(d["min"])
        out.max = -math.inf if d.get("max") is None else float(d["max"])
        return out


# -- drift statistics (reference vs live, shared edges) ----------------------


def psi(
    reference: ColumnSketch,
    live: ColumnSketch,
    eps: float = PSI_EPS,
) -> float:
    """Population Stability Index over the shared bins:
    ``sum((q_i - p_i) * ln(q_i / p_i))`` with eps-smoothed masses so an
    empty bin on either side stays finite. Conventional reading: < 0.1
    stable, 0.1-0.2 moderate shift, > 0.2 significant shift."""
    if reference.edges != live.edges:
        raise ValueError("PSI requires sketches over the same edges")
    p = reference.probabilities(eps=eps)
    q = live.probabilities(eps=eps)
    return float(sum((qi - pi) * math.log(qi / pi) for pi, qi in zip(p, q)))


def ks_statistic(reference: ColumnSketch, live: ColumnSketch) -> float:
    """Two-sample Kolmogorov-Smirnov statistic evaluated at the bin
    edges: ``max_i |CDF_ref(e_i) - CDF_live(e_i)|``. A lower bound on the
    exact-sample KS (the CDFs are only compared where the bins cut), which
    is the right bias for an alerting statistic over fixed bins."""
    if reference.edges != live.edges:
        raise ValueError("KS requires sketches over the same edges")
    return float(
        max(
            (abs(a - b) for a, b in zip(reference.cdf(), live.cdf())),
            default=0.0,
        )
    )


def merge_all(sketches: Sequence[ColumnSketch]) -> Optional[ColumnSketch]:
    """Left fold of :meth:`ColumnSketch.merge` (associative, so any fold
    shape gives the same bytes); None for an empty sequence."""
    if not sketches:
        return None
    out = sketches[0]
    for s in sketches[1:]:
        out = out.merge(s)
    return out
