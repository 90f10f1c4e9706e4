"""Typed parameter system for pipeline stages — the port's copy of
``mmlspark_tpu/core/params.py``: :class:`Param` descriptors with defaults,
converters and validators, generated ``setX``/``getX`` accessors, keyword
construction, and the stage registry that loads a saved stage by class name.

Saved stages name the reference's class (:func:`persisted_class_name`), so
either package loads the other's; :func:`lookup_class` maps both prefixes
onto the port's classes, by name, without importing the JAX package. A
``port_only`` param (``device``) has no counterpart in the reference's
class and is never written to disk.
"""

from __future__ import annotations

import copy as _copy
import importlib
import uuid
from typing import Any, Callable, Dict, Optional

#: the package prefixes of a saved class name: the reference's, which saved
#: stages carry, and the port's own
REFERENCE_PREFIX = "mmlspark_tpu."
PORT_PREFIX = "mmlspark_tpu_torch."


class _NoDefault:
    def __repr__(self) -> str:  # pragma: no cover
        return "<no default>"


NO_DEFAULT = _NoDefault()


def gen_uid(cls_name: str) -> str:
    """A unique, readable stage uid like ``LightGBMClassifier_a1b2c3d4``."""
    return f"{cls_name}_{uuid.uuid4().hex[:8]}"


class Param:
    """A typed parameter declared on a :class:`Params` subclass.
    ``is_complex`` values go through the serializer registry on save;
    ``port_only`` params (absent from the reference's class) are not saved
    and take their default on load."""

    __slots__ = ("name", "doc", "default", "validator", "converter", "is_complex", "port_only")

    def __init__(
        self,
        doc: str = "",
        default: Any = NO_DEFAULT,
        validator: Optional[Callable[[Any], bool]] = None,
        converter: Optional[Callable[[Any], Any]] = None,
        is_complex: bool = False,
        port_only: bool = False,
    ):
        self.name = ""
        self.doc = doc
        self.default = default
        self.validator = validator
        self.converter = converter
        self.is_complex = is_complex
        self.port_only = port_only

    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name

    def __get__(self, instance: Any, owner: Optional[type] = None) -> Any:
        if instance is None:
            return self
        return instance.getOrDefault(self.name)

    def __set__(self, instance: Any, value: Any) -> None:
        instance.set(self.name, value)

    def __repr__(self) -> str:
        return f"Param({self.name!r})"


def to_int(v: Any) -> int:
    if isinstance(v, bool):
        raise TypeError(f"expected int, got bool {v!r}")
    return int(v)


def to_float(v: Any) -> float:
    return float(v)


def to_str(v: Any) -> str:
    if not isinstance(v, str):
        raise TypeError(f"expected str, got {type(v).__name__}")
    return v


def to_bool(v: Any) -> bool:
    if not isinstance(v, bool):
        raise TypeError(f"expected bool, got {type(v).__name__}")
    return v


def to_list_str(v: Any) -> list:
    return [to_str(x) for x in v]


def to_list_int(v: Any) -> list:
    return [to_int(x) for x in v]


def in_range(lo: float, hi: float) -> Callable[[Any], bool]:
    return lambda v: lo <= v <= hi


def gt(lo: float) -> Callable[[Any], bool]:
    return lambda v: v > lo


def ge(lo: float) -> Callable[[Any], bool]:
    return lambda v: v >= lo


def one_of(*allowed: Any) -> Callable[[Any], bool]:
    allowed_set = set(allowed)
    return lambda v: v in allowed_set


def _accessor_suffix(name: str) -> str:
    return name[0].upper() + name[1:]


class Params:
    """Base class for anything carrying :class:`Param` declarations."""

    _param_specs: Dict[str, Param] = {}

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        specs: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    specs[k] = v
        cls._param_specs = specs
        for name in specs:
            suffix = _accessor_suffix(name)
            if not hasattr(cls, f"get{suffix}"):
                setattr(cls, f"get{suffix}", _make_getter(name))
            if not hasattr(cls, f"set{suffix}"):
                setattr(cls, f"set{suffix}", _make_setter(name))
        _STAGE_REGISTRY[f"{cls.__module__}.{cls.__qualname__}"] = cls

    def __init__(self, **kwargs: Any):
        self.uid = kwargs.pop("uid", None) or gen_uid(type(self).__name__)
        self._paramMap: Dict[str, Any] = {}
        self.setParams(**kwargs)

    @property
    def params(self) -> Dict[str, Param]:
        return dict(self._param_specs)

    def _resolve(self, param: Any) -> str:
        name = param.name if isinstance(param, Param) else param
        if name not in self._param_specs:
            raise KeyError(f"{type(self).__name__} has no param {name!r}")
        return name

    def set(self, param: Any, value: Any) -> "Params":
        name = self._resolve(param)
        spec = self._param_specs[name]
        if value is not None:
            if spec.converter is not None:
                value = spec.converter(value)
            if spec.validator is not None and not spec.validator(value):
                raise ValueError(f"{type(self).__name__}.{name}: invalid value {value!r}")
        self._paramMap[name] = value
        return self

    def setParams(self, **kwargs: Any) -> "Params":
        for k, v in kwargs.items():
            self.set(k, v)
        return self

    def get(self, param: Any) -> Any:
        return self._paramMap[self._resolve(param)]

    def getOrDefault(self, param: Any) -> Any:
        name = self._resolve(param)
        if name in self._paramMap:
            return self._paramMap[name]
        default = self._param_specs[name].default
        if default is NO_DEFAULT:
            raise KeyError(f"{type(self).__name__}.{name} is not set and has no default")
        if isinstance(default, (list, dict, set)):
            default = _copy.copy(default)
        return default

    def isSet(self, param: Any) -> bool:
        return self._resolve(param) in self._paramMap

    def isDefined(self, param: Any) -> bool:
        name = self._resolve(param)
        return name in self._paramMap or self._param_specs[name].default is not NO_DEFAULT

    def hasParam(self, name: str) -> bool:
        return name in self._param_specs

    def clear(self, param: Any) -> "Params":
        self._paramMap.pop(self._resolve(param), None)
        return self

    def copy(self, extra: Optional[Dict[str, Any]] = None) -> "Params":
        that = _copy.copy(self)
        that._paramMap = dict(self._paramMap)
        for k, v in (extra or {}).items():
            that.set(k, v)
        return that

    def explainParams(self) -> str:
        lines = []
        for name, spec in sorted(self._param_specs.items()):
            cur = self._paramMap.get(name, "undefined")
            dflt = spec.default if spec.default is not NO_DEFAULT else "undefined"
            lines.append(f"{name}: {spec.doc} (default: {dflt!r}, current: {cur!r})")
        return "\n".join(lines)

    def extractParamMap(self) -> Dict[str, Any]:
        return {name: self.getOrDefault(name) for name, spec in self._param_specs.items()
                if name in self._paramMap or spec.default is not NO_DEFAULT}

    def __repr__(self) -> str:
        set_params = ", ".join(f"{k}={v!r}" for k, v in sorted(self._paramMap.items())
                               if not self._param_specs[k].is_complex)
        return f"{type(self).__name__}({set_params})"


def _make_getter(name: str) -> Callable[[Params], Any]:
    def getter(self: Params) -> Any:
        return self.getOrDefault(name)

    getter.__name__ = f"get{_accessor_suffix(name)}"
    return getter


def _make_setter(name: str) -> Callable[..., Params]:
    def setter(self: Params, value: Any) -> Params:
        return self.set(name, value)

    setter.__name__ = f"set{_accessor_suffix(name)}"
    return setter


# Stage registry: every Params subclass registers itself under its module
# and qualified name, which is how a saved stage's class is found on load.
_STAGE_REGISTRY: Dict[str, type] = {}


def registered_classes() -> Dict[str, type]:
    """Every registered stage class by its qualified name (a copy)."""
    return dict(_STAGE_REGISTRY)


def persisted_class_name(cls: type) -> str:
    """The class name a saved stage carries: the reference's module path for
    a class of the port (``mmlspark_tpu.<same path>``), so that the JAX
    package loads it; any other class keeps its own module."""
    name = f"{cls.__module__}.{cls.__qualname__}"
    if name.startswith(PORT_PREFIX):
        return REFERENCE_PREFIX + name[len(PORT_PREFIX):]
    return name


def port_name(qualified_name: str) -> str:
    """``mmlspark_tpu.<path>`` -> ``mmlspark_tpu_torch.<path>``; other
    names unchanged."""
    if qualified_name.startswith(REFERENCE_PREFIX):
        return PORT_PREFIX + qualified_name[len(REFERENCE_PREFIX):]
    return qualified_name


def lookup_class(qualified_name: str) -> type:
    """The port's class for a saved name, written by either package.
    Imports the port's module to register it when needed; never the JAX
    package."""
    name = port_name(qualified_name)
    if name not in _STAGE_REGISTRY:
        module_name = name.rsplit(".", 1)[0]
        try:
            importlib.import_module(module_name)
        except ModuleNotFoundError as err:
            raise LookupError(f"class {qualified_name!r} has no counterpart in the port "
                              f"(no module {module_name!r})") from err
    if name not in _STAGE_REGISTRY:
        raise LookupError(f"class {qualified_name!r} has no counterpart in the port")
    return _STAGE_REGISTRY[name]


# Shared column-param mixins (core/contracts/Params.scala:17-216)


class HasInputCol(Params):
    inputCol = Param("The name of the input column", converter=to_str)


class HasOutputCol(Params):
    outputCol = Param("The name of the output column", converter=to_str)


class HasInputCols(Params):
    inputCols = Param("The names of the input columns", converter=to_list_str)


class HasOutputCols(Params):
    outputCols = Param("The names of the output columns", converter=to_list_str)


class HasLabelCol(Params):
    labelCol = Param("The name of the label column", default="label", converter=to_str)


class HasFeaturesCol(Params):
    featuresCol = Param("The name of the features column", default="features", converter=to_str)


class HasPredictionCol(Params):
    predictionCol = Param(
        "The name of the prediction column", default="prediction", converter=to_str
    )


class HasWeightCol(Params):
    weightCol = Param("The name of the instance-weight column", converter=to_str)


class HasInitScoreCol(Params):
    initScoreCol = Param(
        "The name of the initial-score (margin) column for warm start",
        converter=to_str,
    )


class HasGroupCol(Params):
    groupCol = Param("The name of the query-group column (ranking)", converter=to_str)


class HasValidationIndicatorCol(Params):
    validationIndicatorCol = Param(
        "Boolean column marking rows used for validation / early stopping",
        converter=to_str,
    )


class HasBatchSize(Params):
    batchSize = Param("Rows per device mini-batch", default=1024, converter=to_int,
                      validator=gt(0))


class HasSeed(Params):
    seed = Param("Random seed", default=0, converter=to_int)
