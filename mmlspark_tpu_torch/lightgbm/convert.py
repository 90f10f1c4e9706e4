"""Carry fitted state from the JAX package into the port.

Both take plain numpy state — ``mmlspark_tpu`` ``Booster.to_dict()`` and a
``BinMapper``'s arrays — so this module imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from mmlspark_tpu_torch.lightgbm.binning import BinMapper
from mmlspark_tpu_torch.lightgbm.booster import Booster


def booster_from_jax(d: Dict[str, Any]) -> Booster:
    """The port's :class:`Booster` from a JAX ``Booster.to_dict()``. The two
    dataclasses share their fields; values arrive as numpy arrays."""
    fields = {f.name for f in Booster.__dataclass_fields__.values()}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"JAX booster fields unknown to the port: {sorted(unknown)}")
    return Booster.from_dict({k: v for k, v in d.items() if k in fields})


def bin_mapper_from_jax(edges, num_bins, max_bin: int, cat_values=None,
                        bundles=None) -> BinMapper:
    """The port's :class:`BinMapper` from a JAX mapper's ``edges``,
    ``num_bins`` and ``max_bin``. Categorical and bundled mappers are not
    ported yet and raise."""
    if cat_values or bundles is not None:
        raise NotImplementedError("categorical and bundled bin mappers are not ported yet")
    return BinMapper(
        edges=np.array(edges, dtype=np.float64),
        num_bins=np.array(num_bins, dtype=np.int32),
        max_bin=int(max_bin),
    )
