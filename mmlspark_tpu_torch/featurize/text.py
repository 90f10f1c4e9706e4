"""Text featurization, the port's copy of ``mmlspark_tpu/featurize/text.py``
(``featurize/text/``).

``TextFeaturizer`` runs tokenize -> n-grams -> hashingTF -> IDF as
``TextFeaturizer.scala:181``'s inner pipeline does. Hashing is murmur3 on the
host (:mod:`mmlspark_tpu_torch.ops.hashing`); :func:`hashing_tf` hashes every
document's tokens in one call and adds all counts in one scatter-add.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np

from mmlspark_tpu_torch.core.params import (
    HasInputCol,
    HasOutputCol,
    Param,
    gt,
    to_bool,
    to_int,
    to_str,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.core.schema import ColType, add_column, require_column
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.ops.hashing import mask_bits, murmur32_strings


def _ragged_out_schema(stage: Any, schema: Dict[str, Any]) -> Dict[str, Any]:
    """The input column exists; the output is a ragged (object) list column."""
    name = type(stage).__name__
    src = stage.getInputCol()
    require_column(schema, src, name)
    out = stage.getOutputCol()
    return add_column(schema, out, ColType(np.dtype(object)), name, replace=out == src)


def _tf_out_schema(stage: Any, schema: Dict[str, Any]) -> Dict[str, Any]:
    """The input column exists; the output is a (numFeatures,) float32 vector."""
    name = type(stage).__name__
    src = stage.getInputCol()
    require_column(schema, src, name)
    out = stage.getOutputCol()
    return add_column(schema, out, ColType(np.dtype(np.float32), (stage.getNumFeatures(),)),
                      name, replace=out == src)


def _tokenize(text: str, pattern: str, to_lower: bool, min_len: int) -> List[str]:
    if to_lower:
        text = text.lower()
    return [t for t in re.split(pattern, text) if len(t) >= min_len]


def _ngrams(tokens: List[str], n: int) -> List[str]:
    if n <= 1:
        return list(tokens)
    return [" ".join(tokens[i : i + n]) for i in range(len(tokens) - n + 1)]


def hashing_tf(docs: List[List[str]], num_features: int, binary: bool = False) -> np.ndarray:
    """Token lists -> the (n_docs, num_features) float32 term counts of
    their murmur3 buckets (HashingTF's role). All documents' tokens hash in
    one call and their counts add in one ``np.add.at``; the counts are
    integers, so the order of the adds changes no value."""
    num_bits = int(np.log2(num_features))
    if 2 ** num_bits != num_features:
        raise ValueError(f"numFeatures must be a power of two, got {num_features}")
    out = np.zeros((len(docs), num_features), dtype=np.float32)
    lens = np.fromiter(map(len, docs), dtype=np.int64, count=len(docs))
    if lens.sum():
        buckets = mask_bits(murmur32_strings([t for d in docs for t in d]), num_bits)
        np.add.at(out, (np.repeat(np.arange(len(docs)), lens), buckets), 1.0)
    if binary:
        out = (out > 0).astype(np.float32)
    return out


class PageSplitter(HasInputCol, HasOutputCol, Transformer):
    """Split documents into pages of at most ``maximumPageLength``
    characters, cut at the last soft boundary past ``minimumPageLength``
    (``featurize/text/PageSplitter.scala:20``). The output is a ragged
    column of page lists."""

    maximumPageLength = Param("Max characters per page", default=5000, converter=to_int,
                              validator=gt(0))
    minimumPageLength = Param("Min characters before a soft boundary split", default=4500,
                              converter=to_int, validator=gt(0))
    boundaryRegex = Param("Soft boundary", default=r"\s", converter=to_str)

    def transform(self, table: Table) -> Table:
        col = table.column(self.getInputCol())
        max_len = self.getMaximumPageLength()
        min_len = self.getMinimumPageLength()
        boundary = re.compile(self.getBoundaryRegex())
        out = np.empty(len(col), dtype=object)
        for i, doc in enumerate(col):
            text = "" if doc is None else str(doc)
            pages: List[str] = []
            pos = 0
            while pos < len(text):
                window = text[pos : pos + max_len]
                if len(window) < max_len:
                    pages.append(window)
                    break
                cut = max_len  # the last soft boundary in [min_len, max_len)
                for m in boundary.finditer(window, min_len):
                    cut = m.start() + 1
                pages.append(window[:cut])
                pos += cut
            out[i] = pages
        return table.with_column(self.getOutputCol(), out)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _ragged_out_schema(self, schema)


class MultiNGram(HasInputCol, HasOutputCol, Transformer):
    """The n-grams of several lengths at once (``MultiNGram.scala:24``) of a
    token-list column."""

    lengths = Param("N-gram lengths", default=[1, 2, 3])

    def transform(self, table: Table) -> Table:
        col = table.column(self.getInputCol())
        lengths = [int(n) for n in self.getLengths()]
        out = np.empty(len(col), dtype=object)
        for i, tokens in enumerate(col):
            tokens = list(tokens)
            out[i] = [g for n in lengths for g in _ngrams(tokens, n)]
        return table.with_column(self.getOutputCol(), out)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _ragged_out_schema(self, schema)


class TextFeaturizer(HasInputCol, HasOutputCol, Estimator):
    """tokenize -> n-grams -> hashingTF -> IDF as one estimator
    (``TextFeaturizer.scala:181``)."""

    useTokenizer = Param("Tokenize the input", default=True, converter=to_bool)
    tokenizerPattern = Param("Token split regex", default=r"\s+", converter=to_str)
    toLowercase = Param("Lowercase before tokenizing", default=True, converter=to_bool)
    minTokenLength = Param("Drop shorter tokens", default=0, converter=to_int)
    useNGram = Param("Add n-grams", default=False, converter=to_bool)
    nGramLength = Param("N-gram length", default=2, converter=to_int, validator=gt(0))
    numFeatures = Param(
        "Hash space size (power of two). TF blocks are dense 2-D columns, so "
        "memory is n_docs x numFeatures x 4 bytes — size accordingly",
        default=1 << 12, converter=to_int, validator=gt(0))
    binary = Param("Binary term frequencies", default=False, converter=to_bool)
    useIDF = Param("Rescale by inverse document frequency", default=True, converter=to_bool)
    minDocFreq = Param("Min documents for IDF terms", default=0, converter=to_int)

    def _docs(self, col: np.ndarray) -> List[List[str]]:
        docs: List[List[str]] = []
        for v in col:
            if isinstance(v, (list, np.ndarray)):
                tokens = [str(t) for t in v]
            elif self.getUseTokenizer():
                tokens = _tokenize("" if v is None else str(v), self.getTokenizerPattern(),
                                   self.getToLowercase(), self.getMinTokenLength())
            else:
                tokens = [] if v is None else [str(v)]
            if self.getUseNGram():
                tokens = tokens + _ngrams(tokens, self.getNGramLength())
            docs.append(tokens)
        return docs

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _tf_out_schema(self, schema)

    def _fit(self, table: Table) -> "TextFeaturizerModel":
        docs = self._docs(table.column(self.getInputCol()))
        tf = hashing_tf(docs, self.getNumFeatures(), self.getBinary())
        idf = None
        if self.getUseIDF():
            df = (tf > 0).sum(axis=0).astype(np.float64)
            if self.getMinDocFreq() > 0:
                df = np.where(df >= self.getMinDocFreq(), df, 0.0)
            # Spark's IDF: log((m + 1) / (df + 1))
            idf = np.log((len(docs) + 1.0) / (df + 1.0)) * (df > 0)
        model = TextFeaturizerModel(
            inputCol=self.getInputCol(), outputCol=self.getOutputCol(),
            useTokenizer=self.getUseTokenizer(), tokenizerPattern=self.getTokenizerPattern(),
            toLowercase=self.getToLowercase(), minTokenLength=self.getMinTokenLength(),
            useNGram=self.getUseNGram(), nGramLength=self.getNGramLength(),
            numFeatures=self.getNumFeatures(), binary=self.getBinary(), idfVector=idf)
        model.parent = self
        return model


class TextFeaturizerModel(HasInputCol, HasOutputCol, Model):
    useTokenizer = Param("Tokenize the input", default=True, converter=to_bool)
    tokenizerPattern = Param("Token split regex", default=r"\s+", converter=to_str)
    toLowercase = Param("Lowercase before tokenizing", default=True, converter=to_bool)
    minTokenLength = Param("Drop shorter tokens", default=0, converter=to_int)
    useNGram = Param("Add n-grams", default=False, converter=to_bool)
    nGramLength = Param("N-gram length", default=2, converter=to_int)
    numFeatures = Param("Hash space size", default=1 << 12, converter=to_int)
    binary = Param("Binary term frequencies", default=False, converter=to_bool)
    idfVector = Param("IDF weights (None = raw TF)", default=None, is_complex=True)

    _docs = TextFeaturizer._docs

    def transform(self, table: Table) -> Table:
        docs = self._docs(table.column(self.getInputCol()))
        tf = hashing_tf(docs, self.getNumFeatures(), self.getBinary())
        idf = self.getIdfVector()
        if idf is not None:
            tf = tf * np.asarray(idf, dtype=np.float32)
        return table.with_column(self.getOutputCol(), tf)

    def transform_schema(self, schema: Dict[str, Any]) -> Dict[str, Any]:
        return _tf_out_schema(self, schema)
