"""Minimal self-contained ONNX protobuf wire-format codec.

The port's own copy of ``fs_uae_image_enhancer_project_tpu/export/onnx_proto.py``:
just enough of the protobuf wire format (varint / length-delimited fields)
and the ONNX message schema to read the shipped ``*.onnx`` artifacts
(initializer weights and graph topology) and to write the export path's
graphs (:class:`GraphBuilder`), without the ``onnx`` package. The writer
emits the same bytes as the JAX package's for the same calls.

The subset of onnx.proto3: ModelProto, GraphProto, NodeProto,
AttributeProto, TensorProto, ValueInfoProto, TypeProto, TensorShapeProto,
OperatorSetIdProto.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

# --- ONNX TensorProto.DataType values -------------------------------------
FLOAT = 1
UINT8 = 2
INT8 = 3
UINT16 = 4
INT16 = 5
INT32 = 6
INT64 = 7
STRING = 8
BOOL = 9
FLOAT16 = 10
DOUBLE = 11
UINT32 = 12
UINT64 = 13
BFLOAT16 = 16

DTYPE_TO_NUMPY = {
    FLOAT: np.float32,
    UINT8: np.uint8,
    INT8: np.int8,
    UINT16: np.uint16,
    INT16: np.int16,
    INT32: np.int32,
    INT64: np.int64,
    BOOL: np.bool_,
    FLOAT16: np.float16,
    DOUBLE: np.float64,
    UINT32: np.uint32,
    UINT64: np.uint64,
}
NUMPY_TO_DTYPE = {np.dtype(v): k for k, v in DTYPE_TO_NUMPY.items()}

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------

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
        if shift > 70:
            raise ValueError("varint too long")


def _repeated_varints(val, wtype: int):
    """Values of a repeated varint field: packed (wtype 2, a length-
    delimited run of varints) or unpacked (wtype 0, one already-decoded
    int per tag — legal protobuf that parsers must accept)."""
    if wtype == 0:
        yield val
        return
    pos = 0
    while pos < len(val):
        v, pos = _read_varint(val, pos)
        yield v


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's complement for negative int64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) triples from a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _tag(out: bytearray, fnum: int, wtype: int) -> None:
    _write_varint(out, (fnum << 3) | wtype)


def _put_varint_field(out: bytearray, fnum: int, value: int) -> None:
    _tag(out, fnum, 0)
    _write_varint(out, value)


def _put_bytes_field(out: bytearray, fnum: int, data: bytes) -> None:
    _tag(out, fnum, 2)
    _write_varint(out, len(data))
    out.extend(data)


def _put_str_field(out: bytearray, fnum: int, s: str) -> None:
    _put_bytes_field(out, fnum, s.encode("utf-8"))


def _zigzag_i64(v: int) -> int:
    return v if v >= 0 else v + (1 << 64)


# ---------------------------------------------------------------------------
# parsed message dataclasses
# ---------------------------------------------------------------------------

@dataclass
class Tensor:
    name: str = ""
    dims: Tuple[int, ...] = ()
    data_type: int = FLOAT
    raw: bytes = b""
    float_data: List[float] = field(default_factory=list)
    int32_data: List[int] = field(default_factory=list)
    int64_data: List[int] = field(default_factory=list)

    def to_numpy(self) -> np.ndarray:
        np_dtype = DTYPE_TO_NUMPY[self.data_type]
        if self.raw:
            arr = np.frombuffer(self.raw, dtype=np_dtype)
        elif self.float_data:
            arr = np.array(self.float_data, dtype=np.float32).astype(np_dtype)
        elif self.int64_data:
            arr = np.array(self.int64_data, dtype=np.int64).astype(np_dtype)
        elif self.int32_data:
            if self.data_type == FLOAT16:
                arr = np.array(self.int32_data, np.uint16).view(np.float16)
            else:
                arr = np.array(self.int32_data, dtype=np.int32).astype(np_dtype)
        else:
            arr = np.zeros(0, dtype=np_dtype)
        return arr.reshape(self.dims)


@dataclass
class Attribute:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[Tensor] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)

    @property
    def value(self) -> Any:
        if self.type == ATTR_FLOAT:
            return self.f
        if self.type == ATTR_INT:
            return self.i
        if self.type == ATTR_STRING:
            return self.s.decode("utf-8", "replace")
        if self.type == ATTR_TENSOR:
            return self.t
        if self.type == ATTR_FLOATS:
            return list(self.floats)
        if self.type == ATTR_INTS:
            return list(self.ints)
        if self.type == ATTR_STRINGS:
            return [s.decode("utf-8", "replace") for s in self.strings]
        # best-effort for unset type
        if self.ints:
            return list(self.ints)
        if self.floats:
            return list(self.floats)
        if self.s:
            return self.s.decode("utf-8", "replace")
        return self.i or self.f or self.t


@dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attributes: Dict[str, Attribute] = field(default_factory=dict)

    def attr(self, name: str, default: Any = None) -> Any:
        a = self.attributes.get(name)
        return default if a is None else a.value


@dataclass
class ValueInfo:
    name: str = ""
    elem_type: int = 0
    shape: Tuple[Any, ...] = ()  # ints or str dim_params


@dataclass
class Graph:
    name: str = ""
    nodes: List[Node] = field(default_factory=list)
    initializers: Dict[str, Tensor] = field(default_factory=dict)
    inputs: List[ValueInfo] = field(default_factory=list)
    outputs: List[ValueInfo] = field(default_factory=list)


@dataclass
class Model:
    ir_version: int = 8
    producer_name: str = ""
    opset: int = 13
    graph: Graph = field(default_factory=Graph)


# ---------------------------------------------------------------------------
# parsers
# ---------------------------------------------------------------------------

def _parse_tensor(buf: bytes) -> Tensor:
    t = Tensor()
    dims = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == 0:
            dims.append(val)
        elif fnum == 1 and wtype == 2:  # packed dims
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                dims.append(v)
        elif fnum == 2:
            t.data_type = val
        # repeated numeric fields: parsers must accept BOTH packed (wtype 2)
        # and unpacked (one value per tag) encodings, like dims above.
        # Negative values are wire-encoded as 64-bit two's-complement
        # varints; the uint16 payloads FLOAT16 smuggles through int32_data
        # are < 2^63 and pass through unchanged.
        elif fnum == 4:  # float_data
            if wtype == 2:
                t.float_data.extend(np.frombuffer(val, dtype=np.float32))
            else:
                t.float_data.append(struct.unpack("<f", val)[0])
        elif fnum == 5:  # int32_data
            for v in _repeated_varints(val, wtype):
                t.int32_data.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif fnum == 7:  # int64_data
            for v in _repeated_varints(val, wtype):
                t.int64_data.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif fnum == 8:
            t.name = val.decode("utf-8")
        elif fnum == 9:
            t.raw = bytes(val)
    t.dims = tuple(dims)
    return t


def _parse_attribute(buf: bytes) -> Attribute:
    a = Attribute()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            a.name = val.decode("utf-8")
        elif fnum == 2:
            a.f = struct.unpack("<f", val)[0]
        elif fnum == 3:
            a.i = val - (1 << 64) if val >= (1 << 63) else val
        elif fnum == 4:
            a.s = bytes(val)
        elif fnum == 5:
            a.t = _parse_tensor(val)
        elif fnum == 7:
            if wtype == 2:
                a.floats = list(np.frombuffer(val, dtype=np.float32))
            else:
                a.floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            if wtype == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    a.ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            else:
                a.ints.append(val)
        elif fnum == 9:
            a.strings.append(bytes(val))
        elif fnum == 20:
            a.type = val
    return a


def _parse_node(buf: bytes) -> Node:
    n = Node()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            n.inputs.append(val.decode("utf-8"))
        elif fnum == 2:
            n.outputs.append(val.decode("utf-8"))
        elif fnum == 3:
            n.name = val.decode("utf-8")
        elif fnum == 4:
            n.op_type = val.decode("utf-8")
        elif fnum == 5:
            a = _parse_attribute(val)
            n.attributes[a.name] = a
    return n


def _parse_dim(buf: bytes) -> Any:
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            return val
        if fnum == 2:
            return val.decode("utf-8")
    return None


def _parse_shape(buf: bytes) -> Tuple[Any, ...]:
    dims = []
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            dims.append(_parse_dim(val))
    return tuple(dims)


def _parse_value_info(buf: bytes) -> ValueInfo:
    vi = ValueInfo()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            vi.name = val.decode("utf-8")
        elif fnum == 2:  # TypeProto
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:  # tensor_type
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1:
                            vi.elem_type = v3
                        elif f3 == 2:
                            vi.shape = _parse_shape(v3)
    return vi


def _parse_graph(buf: bytes) -> Graph:
    g = Graph()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(val))
        elif fnum == 2:
            g.name = val.decode("utf-8")
        elif fnum == 5:
            t = _parse_tensor(val)
            g.initializers[t.name] = t
        elif fnum == 11:
            g.inputs.append(_parse_value_info(val))
        elif fnum == 12:
            g.outputs.append(_parse_value_info(val))
    return g


def load_model(path: str) -> Model:
    with open(path, "rb") as f:
        buf = f.read()
    m = Model()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1:
            m.ir_version = val
        elif fnum == 2:
            m.producer_name = val.decode("utf-8")
        elif fnum == 7:
            m.graph = _parse_graph(val)
        elif fnum == 8:  # opset_import
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 2:
                    m.opset = v2
    return m


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def _ser_tensor(name: str, arr: np.ndarray) -> bytes:
    out = bytearray()
    for d in arr.shape:
        _put_varint_field(out, 1, d)
    _put_varint_field(out, 2, NUMPY_TO_DTYPE[arr.dtype])
    _put_str_field(out, 8, name)
    _put_bytes_field(out, 9, np.ascontiguousarray(arr).tobytes())
    return bytes(out)


def _ser_attribute(name: str, value: Any) -> bytes:
    out = bytearray()
    _put_str_field(out, 1, name)
    if isinstance(value, bool):
        _put_varint_field(out, 3, int(value))
        _put_varint_field(out, 20, ATTR_INT)
    elif isinstance(value, int):
        _put_varint_field(out, 3, _zigzag_i64(value))
        _put_varint_field(out, 20, ATTR_INT)
    elif isinstance(value, float):
        _tag(out, 2, 5)
        out.extend(struct.pack("<f", value))
        _put_varint_field(out, 20, ATTR_FLOAT)
    elif isinstance(value, str):
        _put_bytes_field(out, 4, value.encode("utf-8"))
        _put_varint_field(out, 20, ATTR_STRING)
    elif isinstance(value, np.ndarray):
        _put_bytes_field(out, 5, _ser_tensor(name + "_value", value))
        _put_varint_field(out, 20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, int) for v in value):
            packed = bytearray()
            for v in value:
                _write_varint(packed, _zigzag_i64(v))
            _put_bytes_field(out, 8, bytes(packed))
            _put_varint_field(out, 20, ATTR_INTS)
        elif all(isinstance(v, float) for v in value):
            _put_bytes_field(
                out, 7, np.array(value, dtype=np.float32).tobytes()
            )
            _put_varint_field(out, 20, ATTR_FLOATS)
        else:
            raise TypeError(f"unsupported attribute list {value!r}")
    else:
        raise TypeError(f"unsupported attribute {value!r}")
    return bytes(out)


def _ser_node(
    op_type: str,
    inputs: List[str],
    outputs: List[str],
    name: str = "",
    **attrs: Any,
) -> bytes:
    out = bytearray()
    for s in inputs:
        _put_str_field(out, 1, s)
    for s in outputs:
        _put_str_field(out, 2, s)
    if name:
        _put_str_field(out, 3, name)
    _put_str_field(out, 4, op_type)
    for k, v in attrs.items():
        _put_bytes_field(out, 5, _ser_attribute(k, v))
    return bytes(out)


def _ser_value_info(name: str, elem_type: int, shape: Tuple[Any, ...]) -> bytes:
    shape_buf = bytearray()
    for d in shape:
        dim = bytearray()
        if isinstance(d, str):
            _put_str_field(dim, 2, d)
        else:
            _put_varint_field(dim, 1, int(d))
        _put_bytes_field(shape_buf, 1, bytes(dim))
    tensor_type = bytearray()
    _put_varint_field(tensor_type, 1, elem_type)
    _put_bytes_field(tensor_type, 2, bytes(shape_buf))
    type_proto = bytearray()
    _put_bytes_field(type_proto, 1, bytes(tensor_type))
    out = bytearray()
    _put_str_field(out, 1, name)
    _put_bytes_field(out, 2, bytes(type_proto))
    return bytes(out)


class GraphBuilder:
    """Imperative ONNX graph builder for the export path."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self._nodes: List[bytes] = []
        self._initializers: List[bytes] = []
        self._inputs: List[bytes] = []
        self._outputs: List[bytes] = []
        self._counter = 0

    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def add_input(self, name: str, elem_type: int, shape) -> str:
        self._inputs.append(_ser_value_info(name, elem_type, tuple(shape)))
        return name

    def add_output(self, name: str, elem_type: int, shape) -> str:
        self._outputs.append(_ser_value_info(name, elem_type, tuple(shape)))
        return name

    def add_initializer(self, name: str, arr: np.ndarray) -> str:
        self._initializers.append(_ser_tensor(name, np.asarray(arr)))
        return name

    def add_node(self, op_type: str, inputs, outputs=None, name: str = "", **attrs) -> List[str]:
        if outputs is None:
            outputs = [self.fresh(op_type.lower())]
        self._nodes.append(_ser_node(op_type, list(inputs), list(outputs), name, **attrs))
        return list(outputs)

    def serialize_graph(self) -> bytes:
        out = bytearray()
        for nb in self._nodes:
            _put_bytes_field(out, 1, nb)
        _put_str_field(out, 2, self.name)
        for ib in self._initializers:
            _put_bytes_field(out, 5, ib)
        for vb in self._inputs:
            _put_bytes_field(out, 11, vb)
        for vb in self._outputs:
            _put_bytes_field(out, 12, vb)
        return bytes(out)

    def serialize_model(
        self, opset: int = 13, producer: str = "fs_uae_image_enhancer_project_tpu"
    ) -> bytes:
        # the producer is the project's name, the same in both packages' files
        out = bytearray()
        _put_varint_field(out, 1, 8)  # ir_version 8
        _put_str_field(out, 2, producer)
        _put_bytes_field(out, 7, self.serialize_graph())
        opset_buf = bytearray()
        _put_str_field(opset_buf, 1, "")
        _put_varint_field(opset_buf, 2, opset)
        _put_bytes_field(out, 8, bytes(opset_buf))
        return bytes(out)
