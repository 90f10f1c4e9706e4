"""Exclusive Feature Bundling (EFB): pack (near-)mutually-exclusive
features into shared columns at binning time.

The port's copy of ``mmlspark_tpu/lightgbm/bundling.py`` (host numpy, with
torch's threaded CPU transpose to lay bins out feature-major; kept as a
copy so the port never imports the JAX package), byte-identical in what it
computes. Features that are rarely non-default at the same time
(one-hot blocks, sparse indicators) merge into one packed column whose bin
ranges are offset per member, LightGBM's ``FeatureGroup`` layout. Each
member feature f has a default bin d_f (its most frequent bin in the
binning sample). Packed value 0 means "every member at its default";
member f's non-default bins occupy ``[lo_f, lo_f + w_f - 1)`` via

    packed = lo_f + b - (b > d_f)          for b != d_f

and routing inverts it with

    b = q + (q >= d_f)    where q = packed - lo_f,  q in [0, w_f - 1).

A member's own default bin has no packed slot; the trainer recovers its
histogram entry as the node totals less the member's other bins (native
LightGBM's most-frequent-bin trick). Everything after the histogram (split
search, trees, model text, predict) stays in original feature space.

The spec is a frozen all-tuple dataclass, so it hashes as a cache key.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

# Packed columns stay uint8 + inside the precomputed-U ``num_bins <= 256``
# gate: a bundle's bin count (1 shared default slot + member ranges) never
# exceeds this.
MAX_BUNDLE_BINS = 256

# route_maps sentinel for identity columns: packed bin == original bin, so
# the unpack step (q >= skip) must never fire and the range check must
# always pass. 256 > any uint8 bin id.
_IDENTITY = 256


@dataclasses.dataclass(frozen=True)
class BundleSpec:
    """Static description of one fitted bundling. All-tuple fields: hashable
    (cache key material) and pickle-stable (rides the BinMapper).

    Per ORIGINAL feature f:
      - ``column_of[f]``: packed column holding f
      - ``lo_of[f]``: first packed bin of f's non-default range (0 for
        identity columns)
      - ``span_of[f]``: width of that range (w_f - 1 for bundled members;
        the sentinel 256 for identity columns so every packed bin is "in
        range")
      - ``skip_of[f]``: the unpack step threshold (= d_f for members; 256
        for identity columns so no step is ever added)
      - ``default_of[f]``: f's default (most frequent) bin d_f — the
        original bin an out-of-range packed value decodes to
      - ``identity[f]``: True when f's column holds f alone with packed
        bin == original bin

    Per PACKED column c: ``widths[c]`` (bin count incl. the shared default
    slot 0) and ``members[c]`` (original feature ids, packing order)."""

    column_of: Tuple[int, ...]
    lo_of: Tuple[int, ...]
    span_of: Tuple[int, ...]
    skip_of: Tuple[int, ...]
    default_of: Tuple[int, ...]
    identity: Tuple[bool, ...]
    widths: Tuple[int, ...]
    members: Tuple[Tuple[int, ...], ...]
    # fit metadata (bench/report material, not behavior)
    conflict_count: int = 0
    sample_rows: int = 0
    k_original: int = 0  # Σ_f w_f before bundling

    @property
    def num_features(self) -> int:
        return len(self.column_of)

    @property
    def num_columns(self) -> int:
        return len(self.widths)

    @property
    def num_bins(self) -> int:
        """Bundle-space dense histogram width B_b (max column bin count)."""
        return max(self.widths) if self.widths else 1

    @property
    def k_packed(self) -> int:
        """Σ_c widths[c] — the K the histogram pass actually streams."""
        return int(sum(self.widths))


def fit_feature_bundles(
    bins_sample: np.ndarray,
    num_bins: np.ndarray,
    max_conflict_rate: float = 0.0,
    categorical_slots=(),
    max_bundle_bins: int = MAX_BUNDLE_BINS,
) -> Optional[BundleSpec]:
    """Greedy graph-coloring over a binned row sample — LightGBM's
    ``BundleFeatures``/greedy bundling (EFB paper Alg. 1/2 with the
    conflict budget of Alg. 1's K): features ordered by non-default count
    descending; each joins the first bundle whose accumulated conflict
    count (rows where the feature AND the bundle are both non-default)
    stays within ``max_conflict_rate * n_sample`` and whose packed bin
    count stays within ``max_bundle_bins``. Returns None when no bundle
    gets a second member (bundling would be a no-op, so callers skip the
    whole machinery and the fit is bit-identical to an unbundled one).

    Categorical features never bundle (their split search and value-set
    masks address original bins directly), nor do features already at the
    column cap. Constant features (w <= 1) bundle for free: they have no
    non-default bins, so they cost 0 packed slots and 0 conflicts."""
    n, f = bins_sample.shape
    if n == 0 or f == 0:
        return None
    budget = int(max_conflict_rate * n)
    cat_set = set(int(c) for c in categorical_slots)
    w = np.asarray(
        [int(min(max(int(x), 1), max_bundle_bins)) for x in num_bins], np.int64
    )

    # Feature-major, so that every per-feature read below is contiguous.
    fm = _feature_major(bins_sample)
    # Default bin per feature = most frequent bin in the sample.
    defaults = np.zeros(f, np.int64)
    for j in range(f):
        counts = np.bincount(fm[j], minlength=1)
        defaults[j] = int(np.argmax(counts))
    nz = fm != defaults[:, None].astype(fm.dtype)  # non-default indicator (f, n)
    nz_count = nz.sum(axis=1)

    # Most-frequently-non-default first (EFB's degree order), original
    # index as the deterministic tie-break.
    order = sorted(
        (j for j in range(f) if j not in cat_set),
        key=lambda j: (-int(nz_count[j]), j),
    )
    bundles = []  # dicts: members, ind (n,) bool, conflicts, width
    for j in order:
        span = max(0, int(w[j]) - 1)
        placed = False
        for bd in bundles:
            if bd["width"] + span > max_bundle_bins:
                continue
            c = int(np.count_nonzero(nz[j] & bd["ind"]))
            if bd["conflicts"] + c > budget:
                continue
            bd["members"].append(j)
            bd["ind"] = bd["ind"] | nz[j]
            bd["conflicts"] += c
            bd["width"] += span
            placed = True
            break
        if not placed:
            bundles.append(
                {
                    "members": [j],
                    "ind": nz[j].copy(),
                    "conflicts": 0,
                    "width": 1 + span,
                }
            )
    if all(len(bd["members"]) <= 1 for bd in bundles):
        return None

    # Assemble columns: multi-member bundles pack; singletons (and every
    # categorical feature) stay identity. Column order = min member id, so
    # column layout tracks the original feature order deterministically.
    cols = [bd["members"] for bd in bundles]
    cols += [[j] for j in sorted(cat_set) if j < f]
    cols.sort(key=lambda m: min(m))

    column_of = np.zeros(f, np.int64)
    lo_of = np.zeros(f, np.int64)
    span_of = np.zeros(f, np.int64)
    skip_of = np.zeros(f, np.int64)
    widths = []
    members = []
    for c, mem in enumerate(cols):
        if len(mem) == 1:
            j = mem[0]
            column_of[j] = c
            lo_of[j] = 0
            span_of[j] = _IDENTITY
            skip_of[j] = _IDENTITY
            widths.append(int(w[j]))
            members.append((j,))
            continue
        lo = 1  # packed bin 0 = every member at its default
        for j in mem:
            column_of[j] = c
            lo_of[j] = lo
            span_of[j] = max(0, int(w[j]) - 1)
            skip_of[j] = int(defaults[j])
            lo += max(0, int(w[j]) - 1)
        widths.append(lo)
        members.append(tuple(mem))

    identity = tuple(bool(span_of[j] == _IDENTITY) for j in range(f))
    total_conflicts = int(sum(bd["conflicts"] for bd in bundles))
    return BundleSpec(
        column_of=tuple(int(x) for x in column_of),
        lo_of=tuple(int(x) for x in lo_of),
        span_of=tuple(int(x) for x in span_of),
        skip_of=tuple(int(x) for x in skip_of),
        default_of=tuple(int(x) for x in defaults),
        identity=identity,
        widths=tuple(widths),
        members=tuple(members),
        conflict_count=total_conflicts,
        sample_rows=int(n),
        k_original=int(w.sum()),
    )


def pack_bundles(bins: np.ndarray, spec: BundleSpec) -> np.ndarray:
    """(N, F) original bins -> (N, C) packed bins (uint8). Identity columns
    copy through; bundled columns start at 0 ("all default") and each
    member scatters its non-default rows into its offset range. On the
    (budgeted-rare) conflict rows where two members are simultaneously
    non-default, the later member in packing order wins — the same
    last-writer rule as the sample the spec was fitted on, so packing is
    deterministic."""
    # Feature-major in, column-major out: every read and write below walks
    # contiguous memory (torch's threaded transpose lays the input out).
    cols = _feature_major(bins)
    out = np.zeros((spec.num_columns, bins.shape[0]), dtype=np.uint8)
    for c, mem in enumerate(spec.members):
        if len(mem) == 1 and spec.identity[mem[0]]:
            out[c] = cols[mem[0]]
            continue
        for j in mem:
            d = spec.default_of[j]
            col = cols[j]
            rows = np.flatnonzero(col != d)
            if not rows.size:
                continue
            v = col[rows].astype(np.int64)
            out[c, rows] = (spec.lo_of[j] + v - (v > d)).astype(np.uint8)
    return np.ascontiguousarray(out.T)


def _feature_major(bins: np.ndarray) -> np.ndarray:
    """(N, F) uint8 bins as a C-contiguous (F, N) array."""
    return torch.from_numpy(np.ascontiguousarray(bins, dtype=np.uint8)).t().contiguous().numpy()


@lru_cache(maxsize=32)
def route_maps(
    spec: BundleSpec,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-ORIGINAL-feature routing arrays (host numpy, lru-cached per
    spec): (col, lo, span, skip, dflt), each (F,)
    int32. A row's original bin for feature f given its packed column
    value xb is

        q = xb - lo[f]
        orig = q + (q >= skip[f])   if 0 <= q < span[f]   else dflt[f]

    Identity columns encode lo=0, span=skip=256 => orig == xb always."""
    return (
        np.asarray(spec.column_of, np.int32),
        np.asarray(spec.lo_of, np.int32),
        np.asarray(spec.span_of, np.int32),
        np.asarray(spec.skip_of, np.int32),
        np.asarray(spec.default_of, np.int32),
    )


@lru_cache(maxsize=32)
def expand_maps(
    spec: BundleSpec, num_bins: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static maps expanding the bundle-space histogram
    (k, C, B_b, 3) to the dense original-space (k, F, num_bins, 3) the
    split search consumes: ``cidx[f, b]`` indexes the flattened (C * B_b)
    bundle plane, ``gmask[f, b]`` keeps only real packed slots, and
    ``dmask[f, b]`` marks each bundled member's default bin — filled by
    subtraction from the node totals (module docstring)."""
    f = spec.num_features
    bb = spec.num_bins
    cidx = np.zeros((f, num_bins), np.int32)
    gmask = np.zeros((f, num_bins), np.float32)
    dmask = np.zeros((f, num_bins), np.float32)
    for j in range(f):
        c = spec.column_of[j]
        if spec.identity[j]:
            wj = min(spec.widths[c], num_bins)
            cidx[j, :wj] = c * bb + np.arange(wj)
            gmask[j, :wj] = 1.0
            continue
        d = spec.default_of[j]
        span = spec.span_of[j]
        lo = spec.lo_of[j]
        wj = span + 1  # original width w_f
        for b in range(min(wj, num_bins)):
            if b == d:
                dmask[j, b] = 1.0
                continue
            cidx[j, b] = c * bb + lo + b - (b > d)
            gmask[j, b] = 1.0
    return cidx, gmask, dmask


def unpack_bins(packed: np.ndarray, spec: BundleSpec) -> np.ndarray:
    """(N, C) packed -> (N, F) original bins — the host-side inverse of
    :func:`pack_bundles` (exact wherever packing was conflict-free; a
    conflict row decodes the surviving writer and the overwritten member's
    default). Test/diagnostic utility; training routes on device via
    :func:`route_maps` instead."""
    col, lo, span, skip, dflt = route_maps(spec)
    xb = packed[:, col].astype(np.int64)  # (N, F)
    q = xb - lo[None, :]
    inb = (q >= 0) & (q < span[None, :])
    orig = q + (q >= skip[None, :])
    return np.where(inb, orig, dflt[None, :]).astype(np.uint8)


def cat_row_maps_bundled(
    u_spec, spec: BundleSpec, cat_slots
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bundle-aware :func:`mmlspark_tpu_torch.ops.u_histogram.cat_row_maps`:
    ``u_spec`` is laid out over PACKED columns, but the membership matmul
    matches split features in ORIGINAL ids — categorical features are
    always identity columns, so their packed rows are their original bins
    and only the column lookup changes."""
    rows, feats, locals_ = [], [], []
    for f_ in sorted(int(s) for s in cat_slots):
        c = spec.column_of[f_]
        w = u_spec.widths[c]
        o = u_spec.offsets[c]
        rows.extend(range(o, o + w))
        feats.extend([f_] * w)
        locals_.extend(range(w))
    return (
        np.asarray(rows, np.int32),
        np.asarray(feats, np.int32),
        np.asarray(locals_, np.int32),
    )
