"""Pipeline stage contracts — the port's trimmed copy of
``mmlspark_tpu/core/pipeline.py``: Transformer, Estimator and Model over
:class:`~mmlspark_tpu_torch.data.table.Table`. Persistence, Pipeline and
the observability hooks are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from mmlspark_tpu_torch.core.params import Params
from mmlspark_tpu_torch.data.table import Table


class Transformer(Params):
    def transform(self, table: Table) -> Table:
        raise NotImplementedError

    def __call__(self, table: Table) -> Table:
        return self.transform(table)


class Estimator(Params):
    def fit(self, table: Table, params: Optional[Dict[str, Any]] = None) -> "Model":
        if params:
            return self.copy(params)._fit(table)
        return self._fit(table)

    def _fit(self, table: Table) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""

    parent: Optional[Estimator] = None
