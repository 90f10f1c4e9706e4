"""VowpalWabbitFeaturizer — typed columns → hashed sparse features.

The port's copy of ``mmlspark_tpu/vw/featurizer.py``, a re-design of
``vw/VowpalWabbitFeaturizer.scala`` (+ the per-type featurizers under
``vw/featurizer/*.scala``): numeric, boolean, string, string-array, map,
and dense-vector columns are hashed into one sparse feature space of
``2^numBits`` dims with murmur3, namespace prefix seeding, and
``sumCollisions`` semantics.

The pipeline is column-vectorized end to end: each column is tokenized in
one byte-level pass (flat token spans over a packed utf-8 buffer), recurring
tokens dedup through ``np.unique(return_inverse=True)`` so each distinct
token hashes once, the whole column hashes in ONE ``murmur32_bytes_batch``
call, and rows assemble as flat CSR — no per-token Python and no per-row
list building. The reference splits and hashes a string column in one call
of its host C++ library when it is loaded; the port has no host library and
always takes the reference's numpy path (``_SUSPECT_LUT``, ``_split_spans``,
``_hash_spans``), whose columns equal the library's bit for bit. The output
column is a :class:`SparseRows` CSR column (``tests/fixtures/
golden_matrix_vw.csv`` pins it).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core.params import (
    HasInputCols,
    HasOutputCol,
    Param,
    ge,
    in_range,
    to_bool,
    to_int,
)
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.data.sparse import SparseRows, combine_csr
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.ops.hashing import (
    mask_bits,
    murmur32_bytes_batch,
    murmur32_ints,
    namespace_seed,
)

#: ASCII code points ``str.split()`` treats as whitespace (chr(c).isspace()),
#: as a 256-entry lookup table (one gather per buffer byte beats np.isin).
_WS_LUT = np.zeros(256, dtype=bool)
_WS_LUT[[9, 10, 11, 12, 13, 28, 29, 30, 31, 32]] = True

#: utf-8 lead bytes that can start a NON-ASCII whitespace code point
#: (U+0085/U+00A0 -> C2, U+1680 -> E1, U+2000..U+205F -> E2, U+3000 -> E3).
#: Rows containing any of these fall back to Python ``str.split`` so the
#: byte-level splitter never has to decode utf-8; everything else splits on
#: ASCII whitespace bytes, which is exact because utf-8 continuation bytes
#: are all >= 0x80.
_SUSPECT_LUT = np.zeros(256, dtype=bool)
_SUSPECT_LUT[[0xC2, 0xE1, 0xE2, 0xE3]] = True

#: dedup via the fixed-width token matrix only up to this token length —
#: beyond it the (T, L) gather outweighs re-hashing duplicates.
_DEDUP_MAX_TOKEN_BYTES = 64


def _pack_bytes(parts: List[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate byte strings into (buf uint8, starts int64, lens int64)."""
    lens = np.fromiter(map(len, parts), dtype=np.int64, count=len(parts))
    starts = np.zeros(len(parts), dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    buf = np.frombuffer(b"".join(parts), dtype=np.uint8)
    return buf, starts, lens


def _hash_token_list(
    tokens: List[str], seed: int, prefix: bytes
) -> np.ndarray:
    """Hash a Python token list: dedup distinct tokens with
    ``np.unique(return_inverse=True)`` over a fixed-width unicode view, hash
    each distinct token once through one batch murmur call, broadcast back.
    The 'U' dtype cannot represent trailing NULs, so token lists containing
    them skip dedup and batch-hash directly (still one murmur call)."""
    if not tokens:
        return np.zeros(0, dtype=np.uint32)
    ua = np.asarray(tokens, dtype=str)
    actual = np.fromiter(map(len, tokens), dtype=np.int64, count=len(tokens))
    if bool((np.char.str_len(ua) == actual).all()):
        uniq, inv = np.unique(ua, return_inverse=True)
        buf, starts, lens = _pack_bytes([s.encode("utf-8") for s in uniq.tolist()])
        return murmur32_bytes_batch(buf, starts, lens, seed, prefix)[inv]
    buf, starts, lens = _pack_bytes([t.encode("utf-8") for t in tokens])
    return murmur32_bytes_batch(buf, starts, lens, seed, prefix)


def _split_spans(
    buf: np.ndarray, row_starts: np.ndarray, row_lens: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Whitespace-split every row of a packed byte buffer in one pass.
    Returns (token starts, token lens), tokens ordered row-major. Rows are
    independent: boundaries act as whitespace. Per-token row ids are NOT
    produced here — callers that need them derive them lazily (per-row
    counts only need an n-sized searchsorted over the row boundaries)."""
    if buf.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    ws = _WS_LUT[buf]
    prev_ws = np.empty_like(ws)
    prev_ws[0] = True
    prev_ws[1:] = ws[:-1]
    next_ws = np.empty_like(ws)
    next_ws[-1] = True
    next_ws[:-1] = ws[1:]
    nonempty = row_lens > 0
    prev_ws[row_starts[nonempty]] = True
    next_ws[(row_starts + row_lens - 1)[nonempty]] = True
    tok_starts = np.flatnonzero(~ws & prev_ws)
    tok_ends = np.flatnonzero(~ws & next_ws)
    return tok_starts, tok_ends - tok_starts + 1


def _hash_spans(
    buf: np.ndarray,
    starts: np.ndarray,
    lens: np.ndarray,
    seed: int,
    prefix: bytes,
) -> np.ndarray:
    """Hash token spans over a shared buffer. Per-token block mixing is the
    dominant cost, so distinct (bytes, length) keys are found first via
    ``np.unique(return_inverse=True)`` — over a packed uint64 key for short
    tokens, a fixed-width void view otherwise — so recurring tokens hash
    once."""
    T = len(starts)
    if T == 0:
        return np.zeros(0, dtype=np.uint32)
    L = int(lens.max())
    if 0 < L <= 6 and T > 256:
        # token bytes + length packed into one uint64 (length rides in the
        # top byte so "a" and "a\x00" stay distinct) — integer unique sorts
        # radix-fast, unlike void comparisons
        pos = starts[:, None] + np.arange(L, dtype=np.int64)
        mat = buf[np.minimum(pos, buf.size - 1)].astype(np.uint64)
        mat[np.arange(L)[None, :] >= lens[:, None]] = 0
        key = (lens.astype(np.uint64) << np.uint64(56))
        for j in range(L):
            key |= mat[:, j] << np.uint64(8 * j)
        _, uidx, inv = np.unique(key, return_index=True, return_inverse=True)
        return murmur32_bytes_batch(buf, starts[uidx], lens[uidx], seed, prefix)[inv]
    if 0 < L <= _DEDUP_MAX_TOKEN_BYTES and T > 256:
        pos = starts[:, None] + np.arange(L, dtype=np.int64)
        mat = buf[np.minimum(pos, buf.size - 1)]
        mat[np.arange(L)[None, :] >= lens[:, None]] = 0
        key = np.zeros((T, L + 2), dtype=np.uint8)
        key[:, :L] = mat
        key[:, L] = lens & 0xFF
        key[:, L + 1] = (lens >> 8) & 0xFF
        void = np.ascontiguousarray(key).view(np.dtype((np.void, L + 2))).ravel()
        _, uidx, inv = np.unique(void, return_index=True, return_inverse=True)
        return murmur32_bytes_batch(buf, starts[uidx], lens[uidx], seed, prefix)[inv]
    return murmur32_bytes_batch(buf, starts, lens, seed, prefix)


class VowpalWabbitFeaturizer(HasInputCols, HasOutputCol, Transformer):
    numBits = Param("log2 of feature-space size", default=18, converter=to_int, validator=in_range(1, 30))
    hashSeed = Param("Murmur hash seed", default=0, converter=to_int)
    sumCollisions = Param("Sum values on hash collisions (vs keep first)", default=True, converter=to_bool)
    stringSplit = Param("Split string columns on whitespace into tokens", default=False, converter=to_bool)
    prefixStringsWithColumnName = Param("Prefix hashed tokens with the column name", default=True, converter=to_bool)

    def _string_column(
        self, col: np.ndarray, ns_seed: int, num_bits: int, prefix: bytes
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """String / string-array column -> (indices, ones, per-row counts).
        Plain-string rows split byte-level in one pass; rows that might
        contain non-ASCII whitespace, unsplit strings, and sequence rows go
        through a per-row token stream (still hashed in one batch call)."""
        n = len(col)
        split = self.getStringSplit()
        counts_p = np.zeros(n, dtype=np.int64)
        enc: List[bytes] = []
        enc_rows: Optional[List[int]] = []
        py_specs: List[Tuple[int, object]] = []  # (row, value) for Python path
        if split:
            try:
                # all-plain-str fast path: one comprehension, no per-row
                # type dispatch (None/sequence rows raise AttributeError)
                enc = [v.encode("utf-8") for v in col]
                enc_rows = None  # identity: enc index == table row
            except AttributeError:
                enc = []
        if enc_rows is not None and not enc:
            for i in range(n):
                v = col[i]
                if v is None:
                    continue
                if isinstance(v, str):
                    if split:
                        enc.append(v.encode("utf-8"))
                        enc_rows.append(i)
                    else:
                        py_specs.append((i, (v,)))  # whole string, even ""
                else:
                    toks = tuple(str(t) for t in v)
                    if toks:
                        py_specs.append((i, toks))

        counts_b = np.zeros(n, dtype=np.int64)
        hb = np.zeros(0, dtype=np.int32)
        trow_b = np.zeros(0, dtype=np.int64)
        tok_enc: Optional[np.ndarray] = None
        counts_enc = np.zeros(0, dtype=np.int64)
        if enc:
            buf, row_starts, row_lens = _pack_bytes(enc)
            # rows whose bytes could start a non-ASCII whitespace char fall
            # back to Python str.split for exactness
            suspect = _SUSPECT_LUT[buf]
            sus = np.zeros(len(enc), dtype=np.int64)
            if suspect.any():
                byte_row = np.repeat(np.arange(len(enc), dtype=np.int64), row_lens)
                sus = np.bincount(byte_row[suspect], minlength=len(enc))
            sus_rows = np.flatnonzero(sus)
            tok_starts, tok_lens = _split_spans(buf, row_starts, row_lens)
            if len(sus_rows):
                tok_enc = np.searchsorted(row_starts, tok_starts, side="right") - 1
                keep = sus[tok_enc] == 0
                tok_starts, tok_lens, tok_enc = (
                    tok_starts[keep], tok_lens[keep], tok_enc[keep]
                )
                counts_enc = np.bincount(tok_enc, minlength=len(enc)).astype(np.int64)
            else:
                # per-enc-row token counts without a per-token searchsorted:
                # token starts are sorted, so each row's first token index is
                # an n-sized binary search over the row boundaries
                first = np.searchsorted(tok_starts, row_starts)
                counts_enc = np.diff(np.append(first, len(tok_starts)))
            hashes = _hash_spans(buf, tok_starts, tok_lens, ns_seed, prefix)
            for j in sus_rows:
                row = int(enc_rows[j]) if enc_rows is not None else int(j)
                toks = tuple(col[row].split())
                if toks:
                    py_specs.append((row, toks))
            if enc_rows is None:
                counts_b = counts_enc
            else:
                counts_b = np.zeros(n, dtype=np.int64)
                counts_b[np.asarray(enc_rows, dtype=np.int64)] = counts_enc
            hb = mask_bits(hashes, num_bits)

        py_specs.sort(key=lambda s: s[0])
        py_tokens: List[str] = []
        for i, toks in py_specs:
            py_tokens.extend(toks)
            counts_p[i] = len(toks)
        if not py_tokens:
            # byte stream only — already row-major, nothing to interleave
            return hb, np.ones(len(hb), dtype=np.float32), counts_b
        if len(hb):
            if tok_enc is None:
                tok_enc = np.repeat(
                    np.arange(len(enc), dtype=np.int64), counts_enc
                )
            trow_b = (
                tok_enc
                if enc_rows is None
                else np.asarray(enc_rows, dtype=np.int64)[tok_enc]
            )
        hp = mask_bits(_hash_token_list(py_tokens, ns_seed, prefix), num_bits)

        # merge the two streams row-major (each row belongs to exactly one)
        counts = counts_b + counts_p
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        out = np.empty(int(indptr[-1]), dtype=np.int64)
        if len(hb):
            bptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts_b, out=bptr[1:])
            rank = np.arange(len(hb), dtype=np.int64) - bptr[trow_b]
            out[indptr[trow_b] + rank] = hb
        if len(hp):
            prow = np.repeat(np.arange(n, dtype=np.int64), counts_p)
            pptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts_p, out=pptr[1:])
            rank = np.arange(len(hp), dtype=np.int64) - pptr[prow]
            out[indptr[prow] + rank] = hp
        return out, np.ones(len(out), dtype=np.float32), counts

    def _map_column(
        self, col: np.ndarray, ns_seed: int, num_bits: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Map column: keys hash (dict order, no prefix), values pass through."""
        n = len(col)
        counts = np.zeros(n, dtype=np.int64)
        keys: List[str] = []
        vals: List[float] = []
        for i in range(n):
            d = col[i] or {}
            if not d:
                continue
            counts[i] = len(d)
            keys.extend(str(k) for k in d.keys())
            vals.extend(float(x) for x in d.values())
        idx = mask_bits(_hash_token_list(keys, ns_seed, b""), num_bits).astype(np.int64)
        return idx, np.asarray(vals, dtype=np.float32), counts

    def transform(self, table: Table) -> Table:
        num_bits = self.getNumBits()
        seed = self.getHashSeed()
        dim = 1 << num_bits
        n = table.num_rows

        # (indices int64, values f32, per-row counts int64) per input column
        parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for col_name in self.getInputCols():
            col = table.column(col_name)
            ns_seed = namespace_seed(col_name, seed)
            if col.dtype != object and col.ndim == 2:
                # dense vector column: feature j hashed from its index
                f = col.shape[1]
                idx = mask_bits(murmur32_ints(np.arange(f), ns_seed), num_bits)
                parts.append(
                    (
                        np.tile(idx.astype(np.int64), n),
                        np.ascontiguousarray(col, dtype=np.float32).reshape(-1),
                        np.full(n, f, dtype=np.int64),
                    )
                )
            elif col.dtype != object and col.dtype != bool:
                # numeric column: one feature named after the column
                h = int(mask_bits(murmur32_ints(np.zeros(1, dtype=np.uint32), ns_seed), num_bits)[0])
                parts.append(
                    (
                        np.full(n, h, dtype=np.int64),
                        col.astype(np.float32),
                        np.ones(n, dtype=np.int64),
                    )
                )
            elif col.dtype == bool:
                h = int(mask_bits(murmur32_ints(np.zeros(1, dtype=np.uint32), ns_seed), num_bits)[0])
                truthy = col.astype(np.int64)
                parts.append(
                    (
                        np.full(int(truthy.sum()), h, dtype=np.int64),
                        np.ones(int(truthy.sum()), dtype=np.float32),
                        truthy,
                    )
                )
            else:
                first = next((v for v in col if v is not None), None)
                if isinstance(first, dict):
                    parts.append(self._map_column(col, ns_seed, num_bits))
                else:
                    prefix = (
                        col_name.encode("utf-8")
                        if self.getPrefixStringsWithColumnName()
                        else b""
                    )
                    parts.append(
                        self._string_column(col, ns_seed, num_bits, prefix)
                    )

        # row-major merge of per-column CSR streams, columns in input order
        if len(parts) == 1:
            # single column: its stream IS already row-major
            cidx, cval, ccounts = parts[0]
            indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(ccounts, out=indptr[1:])
            flat_idx, flat_val = np.asarray(cidx), cval
        else:
            total = np.zeros(n, dtype=np.int64)
            for _, _, c in parts:
                total += c
            indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(total, out=indptr[1:])
            flat_idx = np.empty(int(indptr[-1]), dtype=np.int64)
            flat_val = np.empty(int(indptr[-1]), dtype=np.float32)
            prev = np.zeros(n, dtype=np.int64)
            for cidx, cval, ccounts in parts:
                if len(cidx):
                    rows_c = np.repeat(np.arange(n, dtype=np.int64), ccounts)
                    cptr = np.zeros(n + 1, dtype=np.int64)
                    np.cumsum(ccounts, out=cptr[1:])
                    dest = indptr[rows_c] + prev[rows_c] + (
                        np.arange(len(cidx), dtype=np.int64) - cptr[rows_c]
                    )
                    flat_idx[dest] = cidx
                    flat_val[dest] = cval
                prev += ccounts

        ci, cv, cp = combine_csr(flat_idx, flat_val, indptr, self.getSumCollisions())
        return table.with_column(
            self.getOutputCol(),
            SparseRows(ci, cv, cp, dim),
            metadata={"sparse_dim": dim},
        )
