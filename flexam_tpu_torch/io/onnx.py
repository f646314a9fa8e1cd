"""An ONNX file reader in plain Python: the port's `cv2.dnn.readNetFromONNX`.

JAX's DWPose reads its two `.onnx` files (YOLOX-L and RTMPose-l) through
OpenCV's dnn module (`flexam_tpu/perception/dwpose.py:221-225`). The card's
machine has neither OpenCV nor the `onnx` / `protobuf` packages, so this
module decodes the protobuf wire format itself: varints, length-delimited
fields and packed repeats, for the messages and fields a graph needs.

  ModelProto       graph (7), opset_import (8)
  OperatorSetId    domain (1), version (2)
  GraphProto       node (1), name (2), initializer (5), input (11),
                   output (12)
  NodeProto        input (1), output (2), name (3), op_type (4),
                   attribute (5), domain (7)
  AttributeProto   name (1), f (2), i (3), s (4), t (5), floats (7),
                   ints (8), type (20)
  TensorProto      dims (1), data_type (2), float_data (4), int32_data (5),
                   int64_data (7), name (8), raw_data (9), double_data (10)
  ValueInfoProto   name (1), type (2) -> tensor_type (1) -> elem_type (1),
                   shape (2) -> dim (1) -> dim_value (1) / dim_param (2)

Every other field is skipped. `perception/onnx_graph.py` runs the result;
`flexam_tpu_torch/testing.py` holds the inverse, a writer of small graphs.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

# TensorProto.DataType -> numpy
DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
          5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
          10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """(value, next position) of the base-128 varint at `pos`."""
    value = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7


def _signed(v: int) -> int:
    """A varint's int64 (negative numbers are ten-byte two's complement)."""
    return v - (1 << 64) if v >= 1 << 63 else v


def fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """(field number, wire type, value) of each field of a message: an int
    for a varint, the bytes for a length-delimited field, a fixed32 or a
    fixed64."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = read_varint(buf, pos)
        elif wire == 2:
            n, pos = read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        else:
            raise ValueError(f"onnx: wire type {wire} of field {num} is "
                             "not in protobuf's encoding")
        yield num, wire, value


def _ints(wire: int, value) -> List[int]:
    """A repeated int64 field's values: one varint, or a packed run."""
    if wire == 0:
        return [_signed(value)]
    out, pos = [], 0
    while pos < len(value):
        v, pos = read_varint(value, pos)
        out.append(_signed(v))
    return out


def _floats(wire: int, value) -> List[float]:
    """A repeated float field's values: one fixed32, or a packed run."""
    return list(struct.unpack(f"<{len(value) // 4}f", value))


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    domain: str = ""
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class ValueInfo:
    name: str
    elem_type: int = 0
    shape: Tuple[Union[int, str], ...] = ()


@dataclass
class Graph:
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[ValueInfo]
    outputs: List[ValueInfo]
    name: str = ""


@dataclass
class Model:
    graph: Graph
    opset: Dict[str, int]

    @property
    def opset_version(self) -> int:
        """The default domain's opset."""
        return self.opset.get("", self.opset.get("ai.onnx", 0))


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    """(name, array) of a TensorProto."""
    dims: List[int] = []
    dtype, name = 1, ""
    raw: Optional[bytes] = None
    vals: List[float] = []
    for num, wire, v in fields(buf):
        if num == 1:
            dims += _ints(wire, v)
        elif num == 2:
            dtype = v
        elif num == 4:
            vals += _floats(wire, v)
        elif num in (5, 7):
            vals += _ints(wire, v)
        elif num == 8:
            name = bytes(v).decode()
        elif num == 9:
            raw = bytes(v)
        elif num == 10:
            vals += list(struct.unpack(f"<{len(v) // 8}d", v))
        elif num == 14 and v == 1:
            raise NotImplementedError(
                f"onnx: tensor {name!r} keeps its data in an external file")
    if dtype not in DTYPES:
        raise NotImplementedError(f"onnx: tensor {name!r} has data type "
                                  f"{dtype}, which the reader does not map")
    np_type = np.dtype(DTYPES[dtype]).newbyteorder("<")
    if raw is not None:
        arr = np.frombuffer(raw, np_type).astype(DTYPES[dtype])
    elif dtype == 10:                 # float16 bits in int32_data
        arr = np.asarray(vals, np.uint16).view(np.float16)
    else:
        arr = np.asarray(vals, DTYPES[dtype])
    return name, arr.reshape(dims)


def _parse_attribute(buf: bytes) -> Tuple[str, object]:
    name, got = "", {}
    for num, wire, v in fields(buf):
        if num == 1:
            name = bytes(v).decode()
        elif num == 2:
            got["f"] = struct.unpack("<f", v)[0]
        elif num == 3:
            got["i"] = _signed(v)
        elif num == 4:
            got["s"] = bytes(v)
        elif num == 5:
            got["t"] = parse_tensor(v)[1]
        elif num == 7:
            got.setdefault("floats", []).extend(_floats(wire, v))
        elif num == 8:
            got.setdefault("ints", []).extend(_ints(wire, v))
        elif num == 20:
            got["type"] = v
    kind = {1: "f", 2: "i", 3: "s", 4: "t", 6: "floats", 7: "ints"}.get(
        got.get("type"))
    if kind is None:            # no type field: whichever value is there
        kind = next((k for k in ("t", "floats", "ints", "s", "f", "i")
                     if k in got), None)
    if kind in ("floats", "ints") and kind not in got:
        return name, []         # an empty list
    if kind is None or kind not in got:
        raise NotImplementedError(
            f"onnx: attribute {name!r} of type {got.get('type')} is not "
            "one the reader takes (f, i, s, t, floats, ints)")
    return name, got[kind]


def _parse_node(buf: bytes) -> Node:
    node = Node("", [], [])
    for num, _, v in fields(buf):
        if num == 1:
            node.inputs.append(bytes(v).decode())
        elif num == 2:
            node.outputs.append(bytes(v).decode())
        elif num == 3:
            node.name = bytes(v).decode()
        elif num == 4:
            node.op_type = bytes(v).decode()
        elif num == 5:
            key, value = _parse_attribute(v)
            node.attrs[key] = value
        elif num == 7:
            node.domain = bytes(v).decode()
    return node


def _parse_value_info(buf: bytes) -> ValueInfo:
    info = ValueInfo("")
    for num, _, v in fields(buf):
        if num == 1:
            info.name = bytes(v).decode()
        elif num == 2:
            for tn, _, tv in fields(v):
                if tn != 1:
                    continue
                for sn, _, sv in fields(tv):
                    if sn == 1:
                        info.elem_type = sv
                    elif sn == 2:
                        dims = []
                        for dn, _, dv in fields(sv):
                            if dn != 1:
                                continue
                            dim: Union[int, str] = "?"
                            for kn, _, kv in fields(dv):
                                dim = _signed(kv) if kn == 1 else \
                                    bytes(kv).decode()
                            dims.append(dim)
                        info.shape = tuple(dims)
    return info


def parse_graph(buf: bytes) -> Graph:
    g = Graph([], {}, [], [])
    for num, _, v in fields(buf):
        if num == 1:
            g.nodes.append(_parse_node(v))
        elif num == 2:
            g.name = bytes(v).decode()
        elif num == 5:
            name, arr = parse_tensor(v)
            g.initializers[name] = arr
        elif num == 11:
            g.inputs.append(_parse_value_info(v))
        elif num == 12:
            g.outputs.append(_parse_value_info(v))
    # initializers may be listed among the inputs too (IR < 4)
    g.inputs = [i for i in g.inputs if i.name not in g.initializers]
    return g


def parse_model(buf: bytes) -> Model:
    graph, opset = None, {}
    for num, _, v in fields(buf):
        if num == 7:
            graph = parse_graph(v)
        elif num == 8:
            domain, version = "", 0
            for on, _, ov in fields(v):
                if on == 1:
                    domain = bytes(ov).decode()
                elif on == 2:
                    version = ov
            opset[domain] = version
    if graph is None:
        raise ValueError("onnx: the model holds no graph")
    return Model(graph, opset)


def read_onnx(path_or_bytes: Union[str, bytes]) -> Model:
    """The ModelProto of an `.onnx` file (or its bytes)."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return parse_model(bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return parse_model(f.read())
