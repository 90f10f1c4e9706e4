"""LIME — model-agnostic local interpretability.

Reference: ``lime/LIME.scala:164-249`` (``TabularLIME``/``TabularLIMEModel``)
and ``:251+`` (``ImageLIME``): perturb each instance, run the inner model on
the perturbed copies, then fit a per-row (weighted-free) lasso of the
predictions against the perturbations; image version perturbs by switching
SLIC superpixels off (``lime/Superpixel.scala``).

All rows' perturbations are flattened into ONE inner-model transform
(instead of the reference's explode + per-partition UDFs; the inner model
runs on its own device), and the per-row lasso fits run as one batched
solve on the LIME stage's ``device`` (:mod:`mmlspark_tpu_torch.lime.lasso`).
Perturbations are drawn on the host from numpy's ``default_rng(seed)``, the
reference's stream.

The port's copy of ``mmlspark_tpu/lime/lime.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mmlspark_tpu_torch.core.params import (
    HasInputCol,
    HasOutputCol,
    HasPredictionCol,
    Param,
    gt,
    to_float,
    to_int,
    to_str,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.data.table import Table
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.lime.lasso import fit_lasso_batch
from mmlspark_tpu_torch.lime.superpixel import SuperpixelTransformer, mask_image


class _LIMEParams(HasInputCol, HasOutputCol, HasPredictionCol):
    """Shared params (``lime/LIME.scala:110-135``)."""

    model = Param("Model to locally approximate", is_complex=True, default=None)
    nSamples = Param("Number of perturbed samples per row", default=1000,
                     converter=to_int, validator=gt(0))
    samplingFraction = Param("Fraction of superpixels kept on", default=0.3,
                             converter=to_float)
    regularization = Param("Lasso lambda (0 = least squares)", default=0.0,
                           converter=to_float)
    seed = Param("Perturbation RNG seed", default=0, converter=to_int)
    device = Param("Torch device the lasso fits run on: 'cuda' (default) or 'cpu'",
                   default="cuda", converter=to_str, port_only=True)


class TabularLIME(_LIMEParams, Estimator):
    """fit() records per-column mean/std used for gaussian perturbations
    (``TabularLIME.fit`` runs a StandardScaler, ``lime/LIME.scala:173-185``)."""

    def _fit(self, table: Table) -> "TabularLIMEModel":
        resolve_device(self.getDevice())
        X = np.asarray(table.column(self.getInputCol()), dtype=np.float64)
        model = TabularLIMEModel(
            inputCol=self.getInputCol(),
            outputCol=self.getOutputCol(),
            predictionCol=self.getPredictionCol(),
            model=self.getModel(),
            nSamples=self.getNSamples(),
            samplingFraction=self.getSamplingFraction(),
            regularization=self.getRegularization(),
            seed=self.getSeed(),
            columnMeans=X.mean(axis=0),
            columnSTDs=X.std(axis=0),
            device=self.getDevice(),
        )
        model.parent = self
        return model


class TabularLIMEModel(_LIMEParams, Model):
    """Per row: ``nSamples`` gaussian draws ``N(columnMeans, columnSTDs)``
    (``TabularLIMEModel.perturbedDenseVectors``, ``lime/LIME.scala:215-221``),
    inner-model predictions, then lasso weights as the explanation."""

    columnMeans = Param("Feature means for perturbation", is_complex=True,
                        default=None)
    columnSTDs = Param("Feature stds for perturbation", is_complex=True,
                       default=None)

    def transform(self, table: Table) -> Table:
        resolve_device(self.getDevice())
        n_rows = table.num_rows
        n_samp = self.getNSamples()
        means = np.asarray(self.getColumnMeans(), dtype=np.float64)
        stds = np.asarray(self.getColumnSTDs(), dtype=np.float64)
        d = len(means)
        rng = np.random.default_rng(self.getSeed())
        # (n_rows, n_samples, d) gaussian perturbations around column stats
        perturbed = rng.normal(size=(n_rows, n_samp, d)) * stds + means
        # ONE batched inner-model run over every perturbation of every row
        inner_in = Table({self.getInputCol(): perturbed.reshape(-1, d)})
        preds = (
            self.getModel()
            .transform(inner_in)
            .column(self.getPredictionCol())
            .astype(np.float64)
            .reshape(n_rows, n_samp)
        )
        weights = fit_lasso_batch(perturbed, preds, self.getRegularization(),
                                  device=self.getDevice())
        return table.with_column(self.getOutputCol(), weights)


class ImageLIME(_LIMEParams, Transformer):
    """Superpixel-mask perturbation explanation for images
    (``lime/LIME.scala:251+``): output weight i = importance of superpixel i."""

    superpixelCol = Param("Superpixel decomposition column",
                          default="superpixels", converter=str)
    cellSize = Param("Superpixel grid size", default=16, converter=to_int,
                     validator=gt(1))
    modifier = Param("SLIC compactness", default=130.0, converter=to_float)

    def __init__(self, **kwargs):
        kwargs.setdefault("nSamples", 900)
        kwargs.setdefault("samplingFraction", 0.3)
        super().__init__(**kwargs)

    def transform(self, table: Table) -> Table:
        resolve_device(self.getDevice())
        spt = SuperpixelTransformer(
            inputCol=self.getInputCol(),
            outputCol=self.getSuperpixelCol(),
            cellSize=self.getCellSize(),
            modifier=self.getModifier(),
        )
        with_sp = spt.transform(table)
        images = with_sp.column(self.getInputCol())
        sps = with_sp.column(self.getSuperpixelCol())
        n_samp = self.getNSamples()
        rng = np.random.default_rng(self.getSeed())
        frac = self.getSamplingFraction()

        all_masked = []
        all_states = []
        for img, sp in zip(images, sps):
            # reference randomMasks: keep superpixel iff U > decInclude
            # (``lime/LIME.scala:30-41`` with decInclude = samplingFraction)
            states = rng.random(size=(n_samp, sp.num_clusters)) > frac
            all_states.append(states)
            for s in states:
                all_masked.append(mask_image(img, sp, s))
        inner_in = Table({self.getInputCol(): np.stack(all_masked)})
        preds = (
            self.getModel()
            .transform(inner_in)
            .column(self.getPredictionCol())
            .astype(np.float64)
            .reshape(len(images), n_samp)
        )
        # per-row lasso: states (n_samp, n_clusters_i) may vary in width;
        # fit row-by-row batches grouped by cluster count
        weights = np.empty(len(images), dtype=object)
        by_width = {}
        for i, st in enumerate(all_states):
            by_width.setdefault(st.shape[1], []).append(i)
        for width, rows in by_width.items():
            X = np.stack([all_states[i].astype(np.float64) for i in rows])
            y = np.stack([preds[i] for i in rows])
            W = fit_lasso_batch(X, y, self.getRegularization(), device=self.getDevice())
            for n, i in enumerate(rows):
                weights[i] = W[n]
        return with_sp.with_column(self.getOutputCol(), weights)
