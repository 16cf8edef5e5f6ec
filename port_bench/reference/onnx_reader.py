"""A reader of ONNX graphs for the plain reference: initializers and nodes.

Only what the reference needs: the graph's name, its nodes (op type, inputs,
outputs, float and int attributes) and its initializers as numpy arrays. It
reads the protobuf wire format directly and imports nothing of the program.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
           10: np.float16, 11: np.float64}


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class Graph:
    name: str
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of a message."""
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        num, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire} is not read here")
        yield num, wire, val


def _ints(val, wire) -> List[int]:
    """A repeated integer field, packed or not, as signed 64-bit values."""
    if wire == 0:
        raw = [val]
    else:
        raw, pos = [], 0
        while pos < len(val):
            v, pos = _varint(val, pos)
            raw.append(v)
    return [v - (1 << 64) if v >= (1 << 63) else v for v in raw]


def _tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    name, dims, dtype, raw = "", [], 1, None
    floats: List[float] = []
    ints32: List[int] = []
    ints64: List[int] = []
    for num, wire, val in _fields(buf):
        if num == 1:
            dims += _ints(val, wire)
        elif num == 2:
            dtype = val
        elif num == 4:
            floats += (list(np.frombuffer(val, np.float32)) if wire == 2
                       else [struct.unpack("<f", val)[0]])
        elif num == 5:
            ints32 += _ints(val, wire)
        elif num == 7:
            ints64 += _ints(val, wire)
        elif num == 8:
            name = bytes(val).decode()
        elif num == 9:
            raw = bytes(val)
    np_dtype = _DTYPES[dtype]
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32).astype(np_dtype)
    elif ints64:
        arr = np.asarray(ints64, np.int64).astype(np_dtype)
    elif dtype == 10:  # float16 travels as uint16 bit patterns in int32_data
        arr = np.asarray(ints32, np.uint16).view(np.float16)
    else:
        arr = np.asarray(ints32, np.int64).astype(np_dtype)
    return name, arr.reshape(dims).copy()


def _attribute(buf: bytes) -> Tuple[str, object]:
    name, value = "", None
    ints: List[int] = []
    for num, wire, val in _fields(buf):
        if num == 1:
            name = bytes(val).decode()
        elif num == 2:
            value = struct.unpack("<f", val)[0]
        elif num == 3:
            value = _ints(val, wire)[0]
        elif num == 4:
            value = bytes(val).decode(errors="replace")
        elif num == 8:
            ints += _ints(val, wire)
    return name, (ints if ints else value)


def _node(buf: bytes) -> Node:
    node = Node("", [], [])
    for num, _wire, val in _fields(buf):
        if num == 1:
            node.inputs.append(bytes(val).decode())
        elif num == 2:
            node.outputs.append(bytes(val).decode())
        elif num == 4:
            node.op_type = bytes(val).decode()
        elif num == 5:
            key, value = _attribute(val)
            node.attrs[key] = value
    return node


def read_graph(path: str) -> Graph:
    """The graph of the ONNX model at ``path``."""
    with open(path, "rb") as f:
        model = f.read()
    graph = next(bytes(val) for num, _w, val in _fields(model) if num == 7)
    name, nodes, inits = "", [], {}
    for num, _wire, val in _fields(graph):
        if num == 1:
            nodes.append(_node(val))
        elif num == 2:
            name = bytes(val).decode()
        elif num == 5:
            key, arr = _tensor(val)
            inits[key] = arr
    return Graph(name, nodes, inits)
