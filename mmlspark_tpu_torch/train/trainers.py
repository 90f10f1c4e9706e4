"""TrainClassifier and TrainRegressor: featurize, then fit any learner; the
port's copy of ``mmlspark_tpu/train/trainers.py`` (``TrainClassifier.scala:53``,
``TrainRegressor.scala:24``).

Columns other than the label are featurized by
:class:`~mmlspark_tpu_torch.featurize.Featurize` unless they are already one
vector column; string labels are reindexed to 0..n-1 in code-point order and
the fitted model decodes its predictions back to them. The wrapped learner
(``LightGBMClassifier``, ``LightGBMRegressor`` or any port ``Estimator``) fits
on its own device: the card, unless its ``device`` says the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.params import HasFeaturesCol, HasLabelCol, Param, gt, to_bool, to_int, to_str
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.data.table import Table, find_unused_column_name
from mmlspark_tpu_torch.featurize.featurize import Featurize
from mmlspark_tpu_torch.featurize.indexers import decode_levels


def _reindex(labels: np.ndarray):
    """(levels or None, float64 label indices): the reference's
    ``TrainClassifier._fit`` reindexing. Object labels index their
    ``str()``s in code-point order; numeric labels their sorted distinct
    values, unless those are already 0..n-1."""
    if labels.dtype == object:
        index: Dict[str, int] = {}
        codes = np.fromiter((index.setdefault(str(v), len(index)) for v in labels),
                            dtype=np.int64, count=len(labels))
        levels = sorted(index)
        rank = np.empty(len(levels), dtype=np.int64)
        rank[[index[v] for v in levels]] = np.arange(len(levels))
        return levels, rank[codes].astype(np.float64)
    uniq = np.unique(labels)
    if np.array_equal(uniq, np.arange(len(uniq))):
        return None, labels.astype(np.float64)
    levels = [v.item() for v in uniq]
    lookup = {v: i for i, v in enumerate(levels)}
    return levels, np.array([lookup[v.item()] for v in labels], dtype=np.float64)


class _TrainBase(HasLabelCol, HasFeaturesCol, Estimator):
    model = Param("The learner to fit", is_complex=True)
    featuresCol = Param("Assembled features column", default="TrainedFeatures", converter=to_str)
    numFeatures = Param("Text hash dimensions during featurization", default=1 << 8,
                        converter=to_int, validator=gt(0))

    def _prepare(self, table: Table):
        """(featurized table, fitted featurizer or None, features column)."""
        cols = [c for c in table.columns if c != self.getLabelCol()]
        if len(cols) == 1 and table.column(cols[0]).ndim == 2:
            return table, None, cols[0]  # already one assembled vector column
        feat_col = find_unused_column_name(self.getFeaturesCol(), table)
        featurizer = Featurize(inputCols=cols, outputCol=feat_col,
                               numberOfFeatures=self.getNumFeatures()).fit(table)
        return featurizer.transform(table), featurizer, feat_col

    def _fit_learner(self, work: Table, feat_col: str):
        learner = self.getModel().copy({"featuresCol": feat_col, "labelCol": self.getLabelCol()})
        return learner.fit(work)


class TrainClassifier(_TrainBase):
    """Featurize, reindex the labels, fit a classifier."""

    reindexLabel = Param("Index string/sparse labels", default=True, converter=to_bool)

    def _fit(self, table: Table) -> "TrainedClassifierModel":
        work, featurizer, feat_col = self._prepare(table)
        label_col = self.getLabelCol()
        levels: Optional[List[Any]] = None
        if self.getReindexLabel():
            levels, y = _reindex(work.column(label_col))
            work = work.with_column(label_col, y)
        model = TrainedClassifierModel(fittedModel=self._fit_learner(work, feat_col),
                                       featurizerModel=featurizer, labelCol=label_col,
                                       featuresCol=feat_col, labelLevels=levels)
        model.parent = self
        return model


class TrainRegressor(_TrainBase):
    """Featurize, fit a regressor on the float64 label."""

    def _fit(self, table: Table) -> "TrainedRegressorModel":
        work, featurizer, feat_col = self._prepare(table)
        label_col = self.getLabelCol()
        work = work.with_column(label_col, work.column(label_col).astype(np.float64))
        model = TrainedRegressorModel(fittedModel=self._fit_learner(work, feat_col),
                                      featurizerModel=featurizer, labelCol=label_col,
                                      featuresCol=feat_col)
        model.parent = self
        return model


class _TrainedBase(HasLabelCol, HasFeaturesCol, Model):
    fittedModel = Param("The fitted learner", is_complex=True)
    featurizerModel = Param("The fitted featurizer (None = passthrough)", default=None,
                            is_complex=True)

    def _featurize(self, table: Table) -> Table:
        featurizer = self.getFeaturizerModel()
        return table if featurizer is None else featurizer.transform(table)


class TrainedClassifierModel(_TrainedBase):
    labelLevels = Param("Original label values (None = already indexed)", default=None)

    def transform(self, table: Table) -> Table:
        fitted = self.getFittedModel()
        out = fitted.transform(self._featurize(table))
        levels = self.getLabelLevels()
        pred_col = fitted.getPredictionCol() if fitted.hasParam("predictionCol") else "prediction"
        if levels is not None and pred_col in out:
            out = out.with_column(pred_col, decode_levels(out.column(pred_col), levels))
        return out


class TrainedRegressorModel(_TrainedBase):
    def transform(self, table: Table) -> Table:
        return self.getFittedModel().transform(self._featurize(table))
