"""Minimal ONNX protobuf codec — no dependency on the ``onnx`` package.

The JAX package's own wire codec (``analytics_zoo_tpu/pipeline/api/onnx/
proto.py``), copied: the message subset the loader needs (ModelProto,
GraphProto, NodeProto, TensorProto, AttributeProto, ValueInfoProto) with
the public onnx.proto3 field numbers, decode and encode, and the
``make_node``/``make_graph``/``make_model`` helpers that mirror
``onnx.helper``.  A model encoded here gives the JAX package's bytes.

Two changes.  bf16 tensors decode without ``ml_dtypes`` (numpy has no
bf16): to float32, exactly (the bf16 bits are the top half of the f32
bits).  And a message class with ``EXPLICIT = True`` tracks which fields
were set, given or decoded, and encodes a set scalar even at its default
(proto3 ``oneof`` members, as in TF's ``AttrValue``:
``tfgraph/proto.py`` builds on this codec); the ONNX messages leave it
off, so their bytes are the JAX package's.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# generic tiny-proto framework

_REG: Dict[Tuple[str, str], type] = {}

_VARINT_KINDS = {"int32", "int64", "uint64", "enum", "bool"}
_NUMERIC_KINDS = _VARINT_KINDS | {"float", "double"}


def _default(kind: str):
    if kind in _VARINT_KINDS:
        return 0
    if kind == "float" or kind == "double":
        return 0.0
    if kind == "string":
        return ""
    if kind == "bytes":
        return b""
    return None  # message


class Msg:
    """Base for schema-described protobuf messages."""

    FIELDS: Dict[int, Tuple[str, str, str]] = {}
    #: track set fields and encode a set scalar even at its default
    EXPLICIT = False

    def __init_subclass__(cls):
        # keyed by module too: the GraphDef codec's TensorProto is not
        # ONNX's
        _REG[(cls.__module__, cls.__name__)] = cls
        cls._BY_NAME = {name: (num, kind, label)
                        for num, (name, kind, label) in cls.FIELDS.items()}

    def __init__(self, **kw):
        for num, (name, kind, label) in self.FIELDS.items():
            setattr(self, name, [] if label == "rep" else _default(kind))
        if self.EXPLICIT:
            self._present = set(kw)
        for k, v in kw.items():
            if k not in self._BY_NAME:
                raise AttributeError(f"{type(self).__name__} has no field {k}")
            setattr(self, k, v)

    def has(self, name: str) -> bool:
        """Whether ``name`` was set (``EXPLICIT`` messages; otherwise
        whether it differs from its default)."""
        if self.EXPLICIT:
            return name in self._present
        v = getattr(self, name)
        return v not in ([], 0, 0.0, "", b"", None)

    def __repr__(self):
        parts = []
        for num, (name, kind, label) in sorted(self.FIELDS.items()):
            v = getattr(self, name)
            if v not in ([], 0, 0.0, "", b"", None):
                parts.append(f"{name}={v!r}" if not isinstance(v, list)
                             else f"{name}=[{len(v)} items]")
        return f"{type(self).__name__}({', '.join(parts)})"


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, i
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _signed(val: int) -> int:
    return val - (1 << 64) if val >= (1 << 63) else val


def _decode_scalar(kind: str, wire: int, buf: bytes, i: int):
    if wire == 0:
        val, i = _read_varint(buf, i)
        if kind in ("int32", "int64", "enum"):
            val = _signed(val)
        elif kind == "bool":
            val = bool(val)
        return val, i
    if wire == 5:
        (v,) = struct.unpack_from("<f", buf, i)
        return v, i + 4
    if wire == 1:
        if kind == "double":
            (v,) = struct.unpack_from("<d", buf, i)
        else:
            (v,) = struct.unpack_from("<Q", buf, i)
        return v, i + 8
    raise ValueError(f"bad wire type {wire} for scalar kind {kind}")


def decode(cls: type, buf: bytes) -> "Msg":
    """Decode ``buf`` into an instance of ``cls``."""
    msg = cls()
    i, n = 0, len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        num, wire = tag >> 3, tag & 7
        spec = cls.FIELDS.get(num)
        if spec is None:  # unknown field: skip
            if wire == 0:
                _, i = _read_varint(buf, i)
            elif wire == 1:
                i += 8
            elif wire == 5:
                i += 4
            elif wire == 2:
                ln, i = _read_varint(buf, i)
                i += ln
            else:
                raise ValueError(f"cannot skip wire type {wire}")
            continue
        name, kind, label = spec
        if msg.EXPLICIT:
            msg._present.add(name)
        if kind.startswith("msg:"):
            ln, i = _read_varint(buf, i)
            sub = decode(_REG[(cls.__module__, kind[4:])], buf[i:i + ln])
            i += ln
            if label == "rep":
                getattr(msg, name).append(sub)
            else:
                setattr(msg, name, sub)
        elif kind in ("string", "bytes"):
            ln, i = _read_varint(buf, i)
            raw = buf[i:i + ln]
            i += ln
            val = raw.decode("utf-8", "replace") if kind == "string" else raw
            if label == "rep":
                getattr(msg, name).append(val)
            else:
                setattr(msg, name, val)
        elif wire == 2 and kind in _NUMERIC_KINDS:  # packed repeated
            ln, i = _read_varint(buf, i)
            end = i + ln
            out = getattr(msg, name)
            while i < end:
                if kind == "float":
                    (v,) = struct.unpack_from("<f", buf, i)
                    i += 4
                elif kind == "double":
                    (v,) = struct.unpack_from("<d", buf, i)
                    i += 8
                else:
                    v, i = _read_varint(buf, i)
                    if kind in ("int32", "int64", "enum"):
                        v = _signed(v)
                out.append(v)
        else:
            val, i = _decode_scalar(kind, wire, buf, i)
            if label == "rep":
                getattr(msg, name).append(val)
            else:
                setattr(msg, name, val)
    return msg


def _write_varint(out: bytearray, val: int):
    if val < 0:
        val += 1 << 64
    while True:
        b = val & 0x7F
        val >>= 7
        if val:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _tag(out: bytearray, num: int, wire: int):
    _write_varint(out, (num << 3) | wire)


def _set(msg, name: str) -> bool:
    """Whether an EXPLICIT message had ``name`` set."""
    return getattr(msg, "EXPLICIT", False) and name in msg._present


def encode(msg: Msg) -> bytes:
    """Serialize ``msg`` per its schema (packed repeated numerics,
    matching what protoc-generated code emits for proto3)."""
    out = bytearray()
    for num, (name, kind, label) in sorted(msg.FIELDS.items()):
        val = getattr(msg, name)
        if kind.startswith("msg:"):
            subs = val if label == "rep" else ([val] if val is not None else [])
            for sub in subs:
                raw = encode(sub)
                _tag(out, num, 2)
                _write_varint(out, len(raw))
                out += raw
        elif kind in ("string", "bytes"):
            vals = val if label == "rep" else (
                [val] if val or _set(msg, name)
                else [])
            for v in vals:
                raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
                _tag(out, num, 2)
                _write_varint(out, len(raw))
                out += raw
        elif label == "rep":
            if not val:
                continue
            packed = bytearray()
            for v in val:
                if kind == "float":
                    packed += struct.pack("<f", v)
                elif kind == "double":
                    packed += struct.pack("<d", v)
                else:
                    _write_varint(packed, int(v))
            _tag(out, num, 2)
            _write_varint(out, len(packed))
            out += packed
        else:
            # a set scalar is written even at its default in EXPLICIT
            # messages (oneof members); else only when non-zero
            put = bool(val) or _set(msg, name)
            if kind == "float":
                if put:
                    _tag(out, num, 5)
                    out += struct.pack("<f", val)
            elif kind == "double":
                if put:
                    _tag(out, num, 1)
                    out += struct.pack("<d", val)
            else:
                if put:
                    _tag(out, num, 0)
                    _write_varint(out, int(val))
    return bytes(out)


# ---------------------------------------------------------------------------
# ONNX message subset (field numbers: public onnx.proto3)

class OperatorSetIdProto(Msg):
    FIELDS = {1: ("domain", "string", "opt"),
              2: ("version", "int64", "opt")}


class StringStringEntryProto(Msg):
    FIELDS = {1: ("key", "string", "opt"),
              2: ("value", "string", "opt")}


class TensorProto(Msg):
    FIELDS = {
        1: ("dims", "int64", "rep"),
        2: ("data_type", "int32", "opt"),
        4: ("float_data", "float", "rep"),
        5: ("int32_data", "int32", "rep"),
        6: ("string_data", "bytes", "rep"),
        7: ("int64_data", "int64", "rep"),
        8: ("name", "string", "opt"),
        9: ("raw_data", "bytes", "opt"),
        10: ("double_data", "double", "rep"),
        11: ("uint64_data", "uint64", "rep"),
    }


class Dimension(Msg):
    FIELDS = {1: ("dim_value", "int64", "opt"),
              2: ("dim_param", "string", "opt")}


class TensorShapeProto(Msg):
    FIELDS = {1: ("dim", "msg:Dimension", "rep")}


class TensorTypeProto(Msg):
    FIELDS = {1: ("elem_type", "int32", "opt"),
              2: ("shape", "msg:TensorShapeProto", "opt")}


class TypeProto(Msg):
    FIELDS = {1: ("tensor_type", "msg:TensorTypeProto", "opt")}


class ValueInfoProto(Msg):
    FIELDS = {1: ("name", "string", "opt"),
              2: ("type", "msg:TypeProto", "opt"),
              3: ("doc_string", "string", "opt")}


class AttributeProto(Msg):
    # type enum values
    FLOAT, INT, STRING, TENSOR, GRAPH = 1, 2, 3, 4, 5
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = 6, 7, 8, 9, 10

    FIELDS = {
        1: ("name", "string", "opt"),
        2: ("f", "float", "opt"),
        3: ("i", "int64", "opt"),
        4: ("s", "bytes", "opt"),
        5: ("t", "msg:TensorProto", "opt"),
        6: ("g", "msg:GraphProto", "opt"),
        7: ("floats", "float", "rep"),
        8: ("ints", "int64", "rep"),
        9: ("strings", "bytes", "rep"),
        10: ("tensors", "msg:TensorProto", "rep"),
        11: ("graphs", "msg:GraphProto", "rep"),
        13: ("doc_string", "string", "opt"),
        20: ("type", "enum", "opt"),
    }


class NodeProto(Msg):
    FIELDS = {
        1: ("input", "string", "rep"),
        2: ("output", "string", "rep"),
        3: ("name", "string", "opt"),
        4: ("op_type", "string", "opt"),
        5: ("attribute", "msg:AttributeProto", "rep"),
        6: ("doc_string", "string", "opt"),
        7: ("domain", "string", "opt"),
    }


class GraphProto(Msg):
    FIELDS = {
        1: ("node", "msg:NodeProto", "rep"),
        2: ("name", "string", "opt"),
        5: ("initializer", "msg:TensorProto", "rep"),
        10: ("doc_string", "string", "opt"),
        11: ("input", "msg:ValueInfoProto", "rep"),
        12: ("output", "msg:ValueInfoProto", "rep"),
        13: ("value_info", "msg:ValueInfoProto", "rep"),
    }


class ModelProto(Msg):
    FIELDS = {
        1: ("ir_version", "int64", "opt"),
        2: ("producer_name", "string", "opt"),
        3: ("producer_version", "string", "opt"),
        4: ("domain", "string", "opt"),
        5: ("model_version", "int64", "opt"),
        6: ("doc_string", "string", "opt"),
        7: ("graph", "msg:GraphProto", "opt"),
        8: ("opset_import", "msg:OperatorSetIdProto", "rep"),
        14: ("metadata_props", "msg:StringStringEntryProto", "rep"),
    }


# ---------------------------------------------------------------------------
# TensorProto <-> numpy

# onnx TensorProto.DataType enum -> numpy dtype
_DT_FLOAT, _DT_UINT8, _DT_INT8 = 1, 2, 3
_DT_UINT16, _DT_INT16, _DT_INT32, _DT_INT64 = 4, 5, 6, 7
_DT_STRING, _DT_BOOL, _DT_FLOAT16, _DT_DOUBLE = 8, 9, 10, 11
_DT_UINT32, _DT_UINT64, _DT_BFLOAT16 = 12, 13, 16

_DTYPE_OF = {
    _DT_FLOAT: np.dtype("float32"), _DT_UINT8: np.dtype("uint8"),
    _DT_INT8: np.dtype("int8"), _DT_UINT16: np.dtype("uint16"),
    _DT_INT16: np.dtype("int16"), _DT_INT32: np.dtype("int32"),
    _DT_INT64: np.dtype("int64"), _DT_BOOL: np.dtype("bool"),
    _DT_FLOAT16: np.dtype("float16"), _DT_DOUBLE: np.dtype("float64"),
    _DT_UINT32: np.dtype("uint32"), _DT_UINT64: np.dtype("uint64"),
}

_ENUM_OF = {v: k for k, v in _DTYPE_OF.items()}


def np_dtype(enum: int) -> np.dtype:
    """The numpy dtype a tensor of ``enum`` decodes to: bf16 decodes to
    float32 (numpy has no bf16; the values are exact)."""
    if enum == _DT_BFLOAT16:
        return np.dtype("float32")
    if enum not in _DTYPE_OF:
        raise NotImplementedError(f"ONNX tensor data_type {enum} unsupported")
    return _DTYPE_OF[enum]


def bf16_bits_to_f32(bits) -> np.ndarray:
    """bf16 bit patterns (uint16) as the float32 values they hold."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def tensor_to_numpy(tp: TensorProto) -> np.ndarray:
    dims = tuple(int(d) for d in tp.dims)
    dt = tp.data_type
    if dt == _DT_BFLOAT16:  # raw bytes, or int32_data holding the bits
        bits = (np.frombuffer(tp.raw_data, np.uint16) if tp.raw_data
                else np.asarray(tp.int32_data, np.int64).astype(np.uint16))
        return bf16_bits_to_f32(bits).reshape(dims)
    if tp.raw_data:
        return np.frombuffer(tp.raw_data, dtype=np_dtype(dt)).reshape(dims)
    if dt == _DT_FLOAT:
        return np.asarray(tp.float_data, np.float32).reshape(dims)
    if dt == _DT_DOUBLE:
        return np.asarray(tp.double_data, np.float64).reshape(dims)
    if dt == _DT_INT64:
        return np.asarray(tp.int64_data, np.int64).reshape(dims)
    if dt in (_DT_UINT32, _DT_UINT64):
        return np.asarray(tp.uint64_data, np_dtype(dt)).reshape(dims)
    if dt == _DT_FLOAT16:  # fp16 payload rides int32_data per onnx.proto
        return np.asarray(tp.int32_data, np.uint16).view(
            np.float16).reshape(dims)
    return np.asarray(tp.int32_data, np.int64).astype(
        np_dtype(dt)).reshape(dims)


def numpy_to_tensor(arr: np.ndarray, name: str = "") -> TensorProto:
    # NB: np.ascontiguousarray has ndmin=1 and would promote 0-d to 1-d
    arr = np.asarray(arr, order="C")
    if arr.dtype not in _ENUM_OF:
        raise NotImplementedError(f"dtype {arr.dtype} unsupported")
    return TensorProto(name=name, dims=[int(d) for d in arr.shape],
                       data_type=_ENUM_OF[arr.dtype],
                       raw_data=arr.tobytes())


# ---------------------------------------------------------------------------
# helper constructors (mirror onnx.helper for programmatic graph building)

def make_attribute(name: str, value: Any) -> AttributeProto:
    a = AttributeProto(name=name)
    if isinstance(value, bool) or isinstance(value, (int, np.integer)):
        a.type, a.i = AttributeProto.INT, int(value)
    elif isinstance(value, (float, np.floating)):
        a.type, a.f = AttributeProto.FLOAT, float(value)
    elif isinstance(value, str):
        a.type, a.s = AttributeProto.STRING, value.encode()
    elif isinstance(value, bytes):
        a.type, a.s = AttributeProto.STRING, value
    elif isinstance(value, np.ndarray):
        a.type, a.t = AttributeProto.TENSOR, numpy_to_tensor(value)
    elif isinstance(value, TensorProto):
        a.type, a.t = AttributeProto.TENSOR, value
    elif isinstance(value, (list, tuple)):
        vals = list(value)
        if all(isinstance(v, (int, np.integer)) for v in vals):
            a.type, a.ints = AttributeProto.INTS, [int(v) for v in vals]
        elif all(isinstance(v, (float, np.floating, int)) for v in vals):
            a.type, a.floats = AttributeProto.FLOATS, [float(v) for v in vals]
        elif all(isinstance(v, str) for v in vals):
            a.type = AttributeProto.STRINGS
            a.strings = [v.encode() for v in vals]
        else:
            raise TypeError(f"mixed attribute list for {name}: {vals}")
    else:
        raise TypeError(f"cannot make attribute from {type(value)}")
    return a


def make_node(op_type: str, inputs: List[str], outputs: List[str],
              name: str = "", **attrs) -> NodeProto:
    return NodeProto(op_type=op_type, input=list(inputs),
                     output=list(outputs), name=name,
                     attribute=[make_attribute(k, v)
                                for k, v in attrs.items()])


def make_value_info(name: str, shape=None, elem_type: int = _DT_FLOAT
                    ) -> ValueInfoProto:
    vi = ValueInfoProto(name=name)
    tt = TensorTypeProto(elem_type=elem_type)
    if shape is not None:
        tt.shape = TensorShapeProto(dim=[
            Dimension(dim_param=str(d)) if isinstance(d, str) or d is None
            else Dimension(dim_value=int(d)) for d in shape])
    vi.type = TypeProto(tensor_type=tt)
    return vi


def make_graph(nodes, name, inputs, outputs, initializer=None) -> GraphProto:
    return GraphProto(node=list(nodes), name=name, input=list(inputs),
                      output=list(outputs),
                      initializer=list(initializer or []))


def make_model(graph: GraphProto, opset_version: int = 13) -> ModelProto:
    return ModelProto(ir_version=8, producer_name="analytics_zoo_tpu",
                      graph=graph,
                      opset_import=[OperatorSetIdProto(
                          domain="", version=opset_version)])


def load_model(path_or_bytes) -> ModelProto:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return decode(ModelProto, bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as f:
        return decode(ModelProto, f.read())


def attrs_dict(node: NodeProto) -> Dict[str, Any]:
    """AttributeProto list -> python values keyed by name."""
    out: Dict[str, Any] = {}
    for a in node.attribute:
        t = a.type
        if t == AttributeProto.FLOAT:
            out[a.name] = float(a.f)
        elif t == AttributeProto.INT:
            out[a.name] = int(a.i)
        elif t == AttributeProto.STRING:
            out[a.name] = a.s.decode("utf-8", "replace")
        elif t == AttributeProto.TENSOR:
            out[a.name] = tensor_to_numpy(a.t)
        elif t == AttributeProto.FLOATS:
            out[a.name] = [float(v) for v in a.floats]
        elif t == AttributeProto.INTS:
            out[a.name] = [int(v) for v in a.ints]
        elif t == AttributeProto.STRINGS:
            out[a.name] = [v.decode("utf-8", "replace") for v in a.strings]
        elif t == AttributeProto.GRAPH:
            out[a.name] = a.g
        else:
            raise NotImplementedError(
                f"attribute {a.name} of type {t} unsupported")
    return out
