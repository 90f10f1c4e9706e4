"""Minimal vendored ONNX protobuf wire-format codec (no ``onnx`` package).

The port's copy of ``mmlspark_tpu/dnn/onnx_proto.py``. Neither machine the
port runs on has ``onnx`` bindings, so this module hand-decodes the
protobuf wire format for exactly the message subset the graph walker in
:mod:`onnx_import` needs: ModelProto → GraphProto → Node/Tensor/Attribute/
ValueInfo. Field numbers follow the public ``onnx.proto3`` schema. A
matching minimal writer exists so tests can author .onnx files in-process.

Wire format recap: a message is a sequence of (tag, payload) where
``tag = (field_number << 3) | wire_type`` and wire types are 0 varint,
1 fixed64, 2 length-delimited, 5 fixed32. Repeated scalars may arrive
packed (wire type 2).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

# -- low-level reader --------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield field, wtype, val


def _unpack_varints(buf: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _signed(v: int) -> int:
    """Interpret a varint as two's-complement int64 (proto int64 encoding)."""
    return v - (1 << 64) if v >= (1 << 63) else v


# -- message decoders --------------------------------------------------------

# TensorProto.DataType → numpy
TENSOR_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def decode_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    double_data: List[float] = []
    for field, wtype, val in _iter_fields(buf):
        if field == 1:  # dims
            if wtype == 2:
                dims.extend(_signed(v) for v in _unpack_varints(val))
            else:
                dims.append(_signed(val))
        elif field == 2:
            dtype_code = val
        elif field == 4:  # float_data (packed fixed32)
            if wtype == 2:
                float_data.extend(struct.unpack(f"<{len(val)//4}f", val))
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif field == 5:
            if wtype == 2:
                int32_data.extend(_signed(v) for v in _unpack_varints(val))
            else:
                int32_data.append(_signed(val))
        elif field == 7:
            if wtype == 2:
                int64_data.extend(_signed(v) for v in _unpack_varints(val))
            else:
                int64_data.append(_signed(val))
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = bytes(val)
        elif field == 10:  # double_data (packed fixed64)
            if wtype == 2:
                double_data.extend(struct.unpack(f"<{len(val)//8}d", val))
            else:
                double_data.append(struct.unpack("<d", val)[0])
    np_dtype = TENSOR_DTYPES.get(dtype_code)
    if np_dtype is None:
        raise ValueError(f"unsupported TensorProto data_type {dtype_code}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np_dtype)
    elif double_data:
        arr = np.asarray(double_data, dtype=np_dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np_dtype)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=np_dtype)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    return name, arr.reshape(dims) if dims else arr


def decode_attribute(buf: bytes) -> Tuple[str, Any]:
    name = ""
    out: Any = None
    atype = 0
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for field, wtype, val in _iter_fields(buf):
        if field == 1:
            name = val.decode()
        elif field == 2:  # f (fixed32)
            out = struct.unpack("<f", val)[0]
        elif field == 3:  # i
            out = _signed(val)
        elif field == 4:  # s
            out = bytes(val)
        elif field == 5:  # t
            out = decode_tensor(val)[1]
        elif field == 7:  # floats
            if wtype == 2:
                floats.extend(struct.unpack(f"<{len(val)//4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 8:  # ints
            if wtype == 2:
                ints.extend(_signed(v) for v in _unpack_varints(val))
            else:
                ints.append(_signed(val))
        elif field == 9:  # strings
            strings.append(bytes(val))
        elif field == 20:
            atype = val
    if floats:
        out = floats
    elif ints:
        out = ints
    elif strings:
        out = strings
    if out is None:
        # proto3 omits default-valued scalars on the wire: an attribute with
        # e.g. axis=0 or beta=0.0 arrives as name+type only. Reconstruct the
        # default from AttributeProto.type (1 FLOAT, 2 INT, 3 STRING,
        # 6 FLOATS, 7 INTS, 8 STRINGS).
        out = {1: 0.0, 2: 0, 3: b"", 6: [], 7: [], 8: []}.get(atype)
    return name, out


def decode_node(buf: bytes) -> Dict[str, Any]:
    node = {"input": [], "output": [], "name": "", "op_type": "", "attrs": {}}
    for field, _, val in _iter_fields(buf):
        if field == 1:
            node["input"].append(val.decode())
        elif field == 2:
            node["output"].append(val.decode())
        elif field == 3:
            node["name"] = val.decode()
        elif field == 4:
            node["op_type"] = val.decode()
        elif field == 5:
            k, v = decode_attribute(val)
            node["attrs"][k] = v
    return node


def _decode_value_info(buf: bytes) -> str:
    for field, _, val in _iter_fields(buf):
        if field == 1:
            return val.decode()
    return ""


def decode_graph(buf: bytes) -> Dict[str, Any]:
    graph: Dict[str, Any] = {
        "nodes": [],
        "initializers": {},
        "inputs": [],
        "outputs": [],
        "name": "",
    }
    for field, _, val in _iter_fields(buf):
        if field == 1:
            graph["nodes"].append(decode_node(val))
        elif field == 2:
            graph["name"] = val.decode()
        elif field == 5:
            name, arr = decode_tensor(val)
            graph["initializers"][name] = arr
        elif field == 11:
            graph["inputs"].append(_decode_value_info(val))
        elif field == 12:
            graph["outputs"].append(_decode_value_info(val))
    return graph


def decode_model(buf: bytes) -> Dict[str, Any]:
    """ModelProto → {'graph': ..., 'opset': int, 'ir_version': int}."""
    model: Dict[str, Any] = {"graph": None, "opset": 0, "ir_version": 0}
    for field, _, val in _iter_fields(buf):
        if field == 1:
            model["ir_version"] = _signed(val)
        elif field == 7:
            model["graph"] = decode_graph(val)
        elif field == 8:  # opset_import (OperatorSetIdProto)
            for f2, _, v2 in _iter_fields(val):
                if f2 == 2:
                    model["opset"] = max(model["opset"], _signed(v2))
    if model["graph"] is None:
        raise ValueError("no GraphProto found — not an ONNX model file?")
    return model


# -- minimal writer (tests author .onnx files in-process) --------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wtype: int) -> bytes:
    return _varint((field << 3) | wtype)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def encode_tensor(name: str, arr: np.ndarray) -> bytes:
    code = {v: k for k, v in TENSOR_DTYPES.items()}[arr.dtype.type]
    out = b""
    for d in arr.shape:
        out += _tag(1, 0) + _varint(d)
    out += _tag(2, 0) + _varint(code)
    out += _ld(8, name.encode())
    out += _ld(9, np.ascontiguousarray(arr).tobytes())
    return out


def encode_attribute(name: str, value: Any) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, float):
        out += _tag(2, 5) + struct.pack("<f", value) + _tag(20, 0) + _varint(1)
    elif isinstance(value, bool):
        out += _tag(3, 0) + _varint(int(value)) + _tag(20, 0) + _varint(2)
    elif isinstance(value, int):
        out += _tag(3, 0) + _varint(value & ((1 << 64) - 1)) + _tag(20, 0) + _varint(2)
    elif isinstance(value, (bytes, str)):
        b = value.encode() if isinstance(value, str) else value
        out += _ld(4, b) + _tag(20, 0) + _varint(3)
    elif isinstance(value, np.ndarray):
        out += _ld(5, encode_tensor(name + "_t", value)) + _tag(20, 0) + _varint(4)
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        for v in value:
            out += _tag(8, 0) + _varint(v & ((1 << 64) - 1))
        out += _tag(20, 0) + _varint(7)
    elif isinstance(value, (list, tuple)):
        for v in value:
            out += _tag(7, 5) + struct.pack("<f", float(v))
        out += _tag(20, 0) + _varint(6)
    else:
        raise TypeError(f"cannot encode attribute {name}={value!r}")
    return out


def encode_node(op_type: str, inputs, outputs, attrs=None, name="") -> bytes:
    out = b""
    for i in inputs:
        out += _ld(1, i.encode())
    for o in outputs:
        out += _ld(2, o.encode())
    out += _ld(3, (name or op_type).encode())
    out += _ld(4, op_type.encode())
    for k, v in (attrs or {}).items():
        out += _ld(5, encode_attribute(k, v))
    return out


def _encode_value_info(name: str) -> bytes:
    return _ld(1, name.encode())


def encode_model(nodes, initializers, inputs, outputs, opset: int = 13) -> bytes:
    graph = b"".join(_ld(1, n) for n in nodes)
    graph += _ld(2, b"g")
    for name, arr in initializers.items():
        graph += _ld(5, encode_tensor(name, arr))
    for i in inputs:
        graph += _ld(11, _encode_value_info(i))
    for o in outputs:
        graph += _ld(12, _encode_value_info(o))
    model = _tag(1, 0) + _varint(8)  # ir_version
    model += _ld(8, _tag(2, 0) + _varint(opset))
    model += _ld(7, graph)
    return model
