"""Carry fitted state from the JAX package into the port.

Both take plain numpy state — ``mmlspark_tpu`` ``Booster.to_dict()`` and a
``BinMapper``'s arrays — so this module imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from mmlspark_tpu_torch.lightgbm.binning import BinMapper
from mmlspark_tpu_torch.lightgbm.booster import Booster
from mmlspark_tpu_torch.lightgbm.bundling import BundleSpec


def booster_from_jax(d: Dict[str, Any]) -> Booster:
    """The port's :class:`Booster` from a JAX ``Booster.to_dict()``. The two
    dataclasses share their fields; values arrive as numpy arrays, a
    categorical booster brings its split sets and category values, and a
    linear-tree booster its leaf models. Boosters of every objective carry
    over (the objective is a name in the booster)."""
    fields = {f.name for f in Booster.__dataclass_fields__.values()}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"JAX booster fields unknown to the port: {sorted(unknown)}")
    return Booster.from_dict({k: v for k, v in d.items() if k in fields})


def bin_mapper_from_jax(edges, num_bins, max_bin: int, cat_values=None,
                        bundles=None) -> BinMapper:
    """The port's :class:`BinMapper` from a JAX mapper's ``edges``,
    ``num_bins``, ``max_bin``, ``cat_values`` (feature -> raw category
    values) and ``bundles`` (a JAX ``BundleSpec``, or the dict of its
    fields); the bundle spec is rebuilt field for field from its tuples."""
    if bundles is not None:
        fields = (bundles if isinstance(bundles, dict)
                  else {k: getattr(bundles, k) for k in BundleSpec.__dataclass_fields__})
        bundles = BundleSpec(**{
            k: (tuple(tuple(int(j) for j in m) for m in v) if k == "members"
                else tuple(bool(x) for x in v) if k == "identity"
                else tuple(int(x) for x in v) if isinstance(v, (tuple, list)) else int(v))
            for k, v in fields.items()
        })
    return BinMapper(
        edges=np.array(edges, dtype=np.float64),
        num_bins=np.array(num_bins, dtype=np.int32),
        max_bin=int(max_bin),
        cat_values=({int(j): np.array(v, dtype=np.float64) for j, v in cat_values.items()}
                    if cat_values else None),
        bundles=bundles,
    )
