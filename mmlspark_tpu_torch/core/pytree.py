"""Nested containers of tensors: the few pytree helpers the deep-model modules
need (``jax.tree.map`` and ``jax.tree.leaves`` in the reference).

A tree is a dict, list or tuple of trees, or a leaf (a tensor, an array or
a scalar). Dicts keep their key order, as the reference's pytrees of
``init_resnet`` and ``from_torch`` do.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def to_tensor(value: Any, device: torch.device) -> torch.Tensor:
    """A leaf as a tensor on ``device``: a tensor is moved (a no-op where it
    lies already), numpy arrays and scalars are copied in their dtype; None
    stays None."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value.to(device)
    array = np.asarray(value)
    if not array.flags.writeable:  # a loaded payload's arrays are read-only
        array = array.copy()
    return torch.as_tensor(array, device=device)


def to_device(tree: Any, device: torch.device) -> Any:
    """Every leaf of ``tree`` as a tensor on ``device``."""
    return tree_map(lambda v: to_tensor(v, device), tree)


def to_numpy(tree: Any) -> Any:
    """Every tensor leaf of ``tree`` as a numpy array on the host."""
    return tree_map(lambda v: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v), tree)
