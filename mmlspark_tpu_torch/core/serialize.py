"""Stage persistence with a per-type complex-value serializer registry —
the port's copy of ``mmlspark_tpu/core/serialize.py``, writing the
reference's on-disk layout so that each package loads the other's stages:

- ``<path>/metadata.json``: format version, class, uid, the JSON-simple
  params and the names of the complex ones. The class is the reference's
  name for a class of the port (:func:`~.params.persisted_class_name`), and
  a ``port_only`` param is not written;
- ``<path>/params/<name>/_type``: the tag of a complex value, beside the
  files its writer made: ``stage``, ``stage_list``, ``table``, ``ndarray``,
  ``json`` or ``pickle``.

Where the two packages part:

- the ``pickle`` tag is written with the standard :mod:`pickle` (the
  reference uses ``cloudpickle``; both read it with ``pickle.load``), and
  ``cloudpickle`` is imported only for a value the standard one refuses,
  such as a closure;
- pickles are read through an unpickler that maps a global of the
  reference (``mmlspark_tpu.<path>``) onto the port's counterpart and
  refuses one without a counterpart, or one of jax: the JAX package is
  never imported;
- a dict or list of arrays takes the ``pickle`` tag, which the reference
  reads; the reference's ``pytree`` tag pickles a jax tree structure beside
  its leaves. A structure of dicts, lists, tuples and None (an isolation
  forest's packed trees) is rebuilt from that pickle's state without jax;
  any other (a named tuple, a registered node) raises.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import pickle
import shutil
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core.params import lookup_class, persisted_class_name
from mmlspark_tpu_torch.data.table import Table

FORMAT_VERSION = 1

_JSON_SIMPLE = (type(None), bool, int, float, str)


def _is_json_simple(v: Any) -> bool:
    if isinstance(v, _JSON_SIMPLE):
        return True
    if isinstance(v, (list, tuple)):
        return all(_is_json_simple(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _is_json_simple(x) for k, x in v.items())
    return False


# -- pickles -------------------------------------------------------------------

#: module prefixes whose globals a pickle may not name: the JAX package's
#: have a port counterpart or none; jax's own cannot be read without jax
_REFUSED_MODULES = ("jax", "jaxlib")


class _PortUnpickler(pickle.Unpickler):
    """Reads a pickle written by either package: a global of the reference
    is looked up under the port's module of the same path."""

    def find_class(self, module: str, name: str) -> Any:
        if module.split(".")[0] in _REFUSED_MODULES:
            raise pickle.UnpicklingError(f"pickle names {module}.{name}, which cannot be "
                                         "read without jax")
        if module == "mmlspark_tpu" or module.startswith("mmlspark_tpu."):
            try:
                obj: Any = importlib.import_module("mmlspark_tpu_torch" + module[12:])
                for part in name.split("."):
                    obj = getattr(obj, part)
                return obj
            except (ImportError, AttributeError) as err:
                raise pickle.UnpicklingError(
                    f"pickle names {module}.{name}, which has no counterpart in the "
                    "port") from err
        return super().find_class(module, name)


def load_pickle(fh) -> Any:
    """Unpickle from an open binary file, written by either package."""
    return _PortUnpickler(fh).load()


def _to_host(value: Any) -> Any:
    """Torch tensors in ``value`` (itself, or in a dict, list or tuple) as
    numpy arrays, so that a reader without torch loads the pickle."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    return value


def _write_pickle(value: Any, path: str) -> None:
    value = _to_host(value)
    buf = io.BytesIO()
    try:
        pickle.dump(value, buf)
    except (pickle.PicklingError, AttributeError, TypeError):
        # closures and lambdas (the UDFParam case)
        import cloudpickle

        buf = io.BytesIO()
        cloudpickle.dump(value, buf)
    with open(os.path.join(path, "value.pkl"), "wb") as f:
        f.write(buf.getvalue())


def _read_pickle(path: str) -> Any:
    with open(os.path.join(path, "value.pkl"), "rb") as f:
        return load_pickle(f)


class _TreeDefState:
    """A pickled jax ``PyTreeDef``: its state is (registry, nodes), each node
    (kind, arity, node data, custom, leaves, nodes) in post-order."""

    def __setstate__(self, state) -> None:
        self.nodes = list(state[1])


#: jax's tree-node kinds that a plain structure holds
_LEAF, _NONE, _TUPLE, _LIST, _DICT = 0, 1, 2, 4, 5


class _TreeDefUnpickler(pickle.Unpickler):
    """Reads a pickled ``PyTreeDef`` into :class:`_TreeDefState`; refuses
    every other global."""

    def find_class(self, module: str, name: str) -> Any:
        if module.startswith("jaxlib") and name == "PyTreeDef":
            return _TreeDefState
        if module == "jax._src.tree_util" and name == "default_registry":
            return None
        raise pickle.UnpicklingError(f"{module}.{name}")


def _unflatten(nodes: List[tuple], leaves: List[Any]) -> Any:
    leaves = iter(leaves)
    stack: List[Any] = []
    for kind, arity, data, *_ in nodes:
        kids = stack[len(stack) - arity:] if arity else []
        del stack[len(stack) - arity:]
        if kind == _LEAF:
            stack.append(next(leaves))
        elif kind == _NONE:
            stack.append(None)
        elif kind == _TUPLE:
            stack.append(tuple(kids))
        elif kind == _LIST:
            stack.append(list(kids))
        elif kind == _DICT:
            stack.append(dict(zip(data, kids)))
        else:
            raise ValueError(f"tree node kind {kind}")
    if len(stack) != 1:
        raise ValueError("malformed tree structure")
    return stack[0]


def _read_pytree(path: str) -> Any:
    """A value of the reference's ``pytree`` tag whose structure is plain
    dicts, lists, tuples and None; its leaves from ``leaves.npz``."""
    try:
        with open(os.path.join(path, "treedef.pkl"), "rb") as f:
            nodes = _TreeDefUnpickler(f).load().nodes
        with np.load(os.path.join(path, "leaves.npz"), allow_pickle=True) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
        return _unflatten(nodes, leaves)
    except (OSError, pickle.UnpicklingError, ValueError, AttributeError, TypeError) as err:
        raise ValueError(
            f"{path}: a value saved under the 'pytree' tag holds a jax tree structure "
            f"the port cannot rebuild without jax ({err}); save it from the JAX package "
            "as a dict or list of numpy arrays (the 'pickle' tag)") from err


# -- value writers and readers -------------------------------------------------


def _write_ndarray(value: np.ndarray, path: str) -> None:
    np.save(os.path.join(path, "value.npy"), value, allow_pickle=value.dtype == object)


def _read_ndarray(path: str) -> np.ndarray:
    return np.load(os.path.join(path, "value.npy"), allow_pickle=True)


def _write_table(value: Table, path: str) -> None:
    cols = value.to_dict()
    np.savez(os.path.join(path, "columns.npz"),
             **{k: v for k, v in cols.items() if v.dtype != object})
    obj_cols = {k: v for k, v in cols.items() if v.dtype == object}
    with open(os.path.join(path, "object_columns.pkl"), "wb") as f:
        pickle.dump(obj_cols, f)
    with open(os.path.join(path, "table_meta.json"), "w") as f:
        json.dump({
            "num_partitions": value.num_partitions,
            "order": value.columns,
            "metadata": {k: value.metadata(k) for k in value.columns if value.metadata(k)},
        }, f)


def _read_table(path: str) -> Table:
    with open(os.path.join(path, "table_meta.json")) as f:
        meta = json.load(f)
    cols: Dict[str, np.ndarray] = {}
    with np.load(os.path.join(path, "columns.npz")) as z:
        for k in z.files:
            cols[k] = z[k]
    with open(os.path.join(path, "object_columns.pkl"), "rb") as f:
        cols.update(load_pickle(f))
    ordered = {k: cols[k] for k in meta["order"]}
    return Table(ordered, metadata=meta.get("metadata") or {},
                 num_partitions=meta["num_partitions"])


def _write_stage(value: Any, path: str) -> None:
    save_stage(value, os.path.join(path, "stage"), overwrite=True)


def _read_stage(path: str) -> Any:
    return load_stage(os.path.join(path, "stage"))


def _write_stage_list(value: List[Any], path: str) -> None:
    with open(os.path.join(path, "count.json"), "w") as f:
        json.dump(len(value), f)
    for i, stage in enumerate(value):
        save_stage(stage, os.path.join(path, f"stage_{i}"), overwrite=True)


def _read_stage_list(path: str) -> List[Any]:
    with open(os.path.join(path, "count.json")) as f:
        n = json.load(f)
    return [load_stage(os.path.join(path, f"stage_{i}")) for i in range(n)]


def _write_json_value(v: Any, path: str) -> None:
    with open(os.path.join(path, "value.json"), "w") as f:
        json.dump(v, f)


def _read_json_value(path: str) -> Any:
    with open(os.path.join(path, "value.json")) as f:
        return json.load(f)


def _is_stage(v: Any) -> bool:
    from mmlspark_tpu_torch.core.pipeline import PipelineStage

    return isinstance(v, PipelineStage)


# type tag -> (predicate, writer); checked in order
_SERIALIZERS: List[Tuple[str, Callable[[Any], bool], Callable]] = [
    ("stage", _is_stage, _write_stage),
    ("stage_list",
     lambda v: isinstance(v, (list, tuple)) and len(v) > 0 and all(_is_stage(x) for x in v),
     _write_stage_list),
    ("table", lambda v: isinstance(v, Table), _write_table),
    ("ndarray", lambda v: isinstance(v, np.ndarray), _write_ndarray),
    ("ndarray", lambda v: isinstance(v, torch.Tensor),
     lambda v, p: _write_ndarray(v.detach().cpu().numpy(), p)),
    ("json", _is_json_simple, _write_json_value),
    ("pickle", lambda v: True, _write_pickle),
]

_READERS = {
    "stage": _read_stage,
    "stage_list": _read_stage_list,
    "table": _read_table,
    "ndarray": _read_ndarray,
    "json": _read_json_value,
    "pytree": _read_pytree,
    "pickle": _read_pickle,
}


def save_value(value: Any, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    for tag, pred, writer in _SERIALIZERS:
        if pred(value):
            with open(os.path.join(path, "_type"), "w") as f:
                f.write(tag)
            writer(value, path)
            return
    raise TypeError(f"no serializer for {type(value)}")  # pragma: no cover


def load_value(path: str) -> Any:
    with open(os.path.join(path, "_type")) as f:
        tag = f.read().strip()
    if tag not in _READERS:
        raise ValueError(f"{path}: unknown value tag {tag!r}")
    return _READERS[tag](path)


# -- stage save and load ---------------------------------------------------------


def save_stage(stage: Any, path: str, overwrite: bool = True) -> None:
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.makedirs(path)

    simple: Dict[str, Any] = {}
    complex_names: List[str] = []
    for name, spec in stage.params.items():
        if spec.port_only or not stage.isSet(name):
            continue
        value = stage.get(name)
        if not spec.is_complex and _is_json_simple(value):
            simple[name] = list(value) if isinstance(value, tuple) else value
        else:
            complex_names.append(name)
            save_value(value, os.path.join(path, "params", name))

    meta = {
        "format_version": FORMAT_VERSION,
        "class": persisted_class_name(type(stage)),
        "uid": stage.uid,
        "params": simple,
        "complex_params": complex_names,
    }
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    stage._save_extra(path)


def load_stage(path: str) -> Any:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls = lookup_class(meta["class"])
    stage = cls.__new__(cls)
    stage.uid = meta["uid"]
    stage._paramMap = {}
    for k, v in meta["params"].items():
        stage.set(k, v)
    for name in meta["complex_params"]:
        stage._paramMap[name] = load_value(os.path.join(path, "params", name))
    stage._load_extra(path)
    return stage
