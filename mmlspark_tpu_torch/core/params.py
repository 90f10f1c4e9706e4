"""Typed parameter system for pipeline stages — the port's trimmed copy of
``mmlspark_tpu/core/params.py``: :class:`Param` descriptors with defaults,
converters and validators, generated ``setX``/``getX`` accessors, and
keyword construction. No stage registry or complex-param serde yet.
"""

from __future__ import annotations

import copy as _copy
import uuid
from typing import Any, Callable, Dict, Optional


class _NoDefault:
    def __repr__(self) -> str:  # pragma: no cover
        return "<no default>"


NO_DEFAULT = _NoDefault()


class Param:
    """A typed parameter declared on a :class:`Params` subclass."""

    __slots__ = ("name", "doc", "default", "validator", "converter", "is_complex")

    def __init__(
        self,
        doc: str = "",
        default: Any = NO_DEFAULT,
        validator: Optional[Callable[[Any], bool]] = None,
        converter: Optional[Callable[[Any], Any]] = None,
        is_complex: bool = False,
    ):
        self.name = ""
        self.doc = doc
        self.default = default
        self.validator = validator
        self.converter = converter
        self.is_complex = is_complex

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

    def __init__(self, **kwargs: Any):
        self.uid = kwargs.pop("uid", None) or f"{type(self).__name__}_{uuid.uuid4().hex[:8]}"
        self._paramMap: Dict[str, Any] = {}
        self.setParams(**kwargs)

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

    def copy(self, extra: Optional[Dict[str, Any]] = None) -> "Params":
        that = _copy.copy(self)
        that._paramMap = dict(self._paramMap)
        for k, v in (extra or {}).items():
            that.set(k, v)
        return that

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
