"""A GraphDef codec of the port's own — no dependency on ``tensorflow``.

The JAX package parses a frozen graph with TF itself
(``GraphDef.ParseFromString``, ``tf.make_ndarray``,
``tf.dtypes.as_dtype``).  The port must load one where TF is not
installed, so it carries the messages a frozen graph is made of, on the
wire codec of ``onnx/proto.py``: ``GraphDef``, ``NodeDef`` (its ``attr``
map), ``AttrValue`` (a ``oneof``, with its list), ``TensorProto`` and
``TensorShapeProto``, with the field numbers of TF's public
``tensorflow/core/framework/*.proto``.  It decodes TF's bytes and
encodes graphs TF parses.  It adds no format and no op.

``tensor_to_numpy`` is ``tf.make_ndarray``: ``tensor_content``, or the
typed ``*_val`` fields with the last value repeated to the shape
(``half_val`` holds f16 and bf16 bits).  bf16 decodes to float32 (numpy
has no bf16; the values are exact).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..onnx.proto import Msg, bf16_bits_to_f32, decode, encode

# ---------------------------------------------------------------------------
# messages (tensorflow/core/framework/{graph,node_def,attr_value,tensor,
# tensor_shape,versions}.proto)


class Dim(Msg):
    FIELDS = {1: ("size", "int64", "opt"),
              2: ("name", "string", "opt")}


class TensorShapeProto(Msg):
    FIELDS = {2: ("dim", "msg:Dim", "rep"),
              3: ("unknown_rank", "bool", "opt")}


class TensorProto(Msg):
    FIELDS = {
        1: ("dtype", "enum", "opt"),
        2: ("tensor_shape", "msg:TensorShapeProto", "opt"),
        3: ("version_number", "int32", "opt"),
        4: ("tensor_content", "bytes", "opt"),
        5: ("float_val", "float", "rep"),
        6: ("double_val", "double", "rep"),
        7: ("int_val", "int32", "rep"),
        8: ("string_val", "bytes", "rep"),
        10: ("int64_val", "int64", "rep"),
        11: ("bool_val", "bool", "rep"),
        13: ("half_val", "int32", "rep"),
        16: ("uint32_val", "uint64", "rep"),
        17: ("uint64_val", "uint64", "rep"),
    }


class ListValue(Msg):
    FIELDS = {2: ("s", "bytes", "rep"),
              3: ("i", "int64", "rep"),
              4: ("f", "float", "rep"),
              5: ("b", "bool", "rep"),
              6: ("type", "enum", "rep"),
              7: ("shape", "msg:TensorShapeProto", "rep"),
              8: ("tensor", "msg:TensorProto", "rep")}


class NameAttrList(Msg):
    FIELDS = {1: ("name", "string", "opt")}


class AttrValue(Msg):
    """One attribute value: exactly one of its fields is set (a proto3
    ``oneof``), tracked so that ``b=False`` or ``i=0`` survive a round
    trip (``EXPLICIT``)."""

    EXPLICIT = True
    FIELDS = {1: ("list", "msg:ListValue", "opt"),
              2: ("s", "bytes", "opt"),
              3: ("i", "int64", "opt"),
              4: ("f", "float", "opt"),
              5: ("b", "bool", "opt"),
              6: ("type", "enum", "opt"),
              7: ("shape", "msg:TensorShapeProto", "opt"),
              8: ("tensor", "msg:TensorProto", "opt"),
              9: ("placeholder", "string", "opt"),
              10: ("func", "msg:NameAttrList", "opt")}

    def which(self) -> Optional[str]:
        """The name of the set field (``WhichOneof("value")``)."""
        for _, (name, _, _) in sorted(self.FIELDS.items()):
            if name in self._present:
                return name
        return None


class AttrEntry(Msg):
    FIELDS = {1: ("key", "string", "opt"),
              2: ("value", "msg:AttrValue", "opt")}


class NodeDef(Msg):
    FIELDS = {1: ("name", "string", "opt"),
              2: ("op", "string", "opt"),
              3: ("input", "string", "rep"),
              4: ("device", "string", "opt"),
              5: ("attr_entries", "msg:AttrEntry", "rep")}

    @property
    def attr(self) -> Dict[str, AttrValue]:
        """The ``attr`` map, by key (built once)."""
        cached = self.__dict__.get("_attr_map")
        if cached is None or len(cached) != len(self.attr_entries):
            cached = {e.key: e.value for e in self.attr_entries}
            self.__dict__["_attr_map"] = cached
        return cached


class VersionDef(Msg):
    FIELDS = {1: ("producer", "int32", "opt"),
              2: ("min_consumer", "int32", "opt"),
              3: ("bad_consumers", "int32", "rep")}


class GraphDef(Msg):
    FIELDS = {1: ("node", "msg:NodeDef", "rep"),
              4: ("versions", "msg:VersionDef", "opt")}


def parse_graph_def(data: bytes) -> GraphDef:
    return decode(GraphDef, bytes(data))


# ---------------------------------------------------------------------------
# DataType (tensorflow/core/framework/types.proto)

DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16, DT_INT8 = 1, 2, 3, 4, 5, 6
DT_STRING, DT_COMPLEX64, DT_INT64, DT_BOOL = 7, 8, 9, 10
DT_BFLOAT16, DT_UINT16, DT_COMPLEX128, DT_HALF = 14, 17, 18, 19
DT_RESOURCE, DT_VARIANT, DT_UINT32, DT_UINT64 = 20, 21, 22, 23
_REF = 100  # DT_<x>_REF = DT_<x> + 100

_NP = {DT_FLOAT: "float32", DT_DOUBLE: "float64", DT_INT32: "int32",
       DT_UINT8: "uint8", DT_INT16: "int16", DT_INT8: "int8",
       DT_STRING: "object", DT_COMPLEX64: "complex64", DT_INT64: "int64",
       DT_BOOL: "bool", DT_UINT16: "uint16", DT_COMPLEX128: "complex128",
       DT_HALF: "float16", DT_UINT32: "uint32", DT_UINT64: "uint64",
       DT_BFLOAT16: "float32"}
_ENUM = {np.dtype(v): k for k, v in _NP.items() if k != DT_BFLOAT16}


def base_dtype(enum: int) -> int:
    """The value type of a dtype enum (``_REF`` variants folded)."""
    enum = int(enum)
    return enum - _REF if enum > _REF else enum


def np_dtype(enum: int) -> np.dtype:
    """numpy dtype of a TF dtype enum (``dtypes.as_dtype(e)
    .as_numpy_dtype``); bf16 maps to float32."""
    e = base_dtype(enum)
    if e not in _NP:
        raise NotImplementedError(f"TF dtype enum {enum} unsupported")
    return np.dtype(_NP[e])


def dtype_enum(dtype) -> int:
    return _ENUM[np.dtype(dtype)]


def shape_of(sp: Optional[TensorShapeProto]):
    """A TensorShapeProto as a tuple (-1 for an unknown dim), None for an
    unknown rank."""
    if sp is None:
        return ()
    if sp.unknown_rank:
        return None
    return tuple(int(d.size) for d in sp.dim)


def make_shape(shape) -> TensorShapeProto:
    if shape is None:
        return TensorShapeProto(unknown_rank=True)
    return TensorShapeProto(dim=[Dim(size=-1 if d is None else int(d))
                                 for d in shape])


_VAL_FIELD = {DT_FLOAT: "float_val", DT_DOUBLE: "double_val",
              DT_INT32: "int_val", DT_UINT8: "int_val", DT_INT16: "int_val",
              DT_INT8: "int_val", DT_UINT16: "int_val",
              DT_INT64: "int64_val", DT_BOOL: "bool_val",
              DT_HALF: "half_val", DT_BFLOAT16: "half_val",
              DT_UINT32: "uint32_val", DT_UINT64: "uint64_val",
              DT_STRING: "string_val"}


def tensor_to_numpy(tp: TensorProto) -> np.ndarray:
    """``tf.make_ndarray``: the tensor's values as numpy."""
    shape = shape_of(tp.tensor_shape) or ()
    e = base_dtype(tp.dtype)
    dtype = np_dtype(e)
    n = int(np.prod(shape)) if shape else 1
    if tp.tensor_content:
        if e == DT_BFLOAT16:
            return bf16_bits_to_f32(np.frombuffer(
                tp.tensor_content, np.uint16)).reshape(shape)
        return np.frombuffer(tp.tensor_content, dtype).copy().reshape(shape)
    field = _VAL_FIELD.get(e)
    if field is None:
        raise NotImplementedError(f"TF tensor dtype enum {tp.dtype}")
    raw = getattr(tp, field)
    if e == DT_STRING:
        values = np.array(list(raw), dtype=object)
    elif e == DT_HALF:
        values = np.asarray(raw, np.int64).astype(np.uint16).view(
            np.float16)
    elif e == DT_BFLOAT16:
        values = bf16_bits_to_f32(np.asarray(raw, np.int64).astype(
            np.uint16))
    else:
        values = np.asarray(raw).astype(dtype)
    if values.size == 0:
        return np.zeros(shape, dtype)
    if values.size != n:  # the last value repeats to the shape
        values = np.pad(values, (0, n - values.size), "edge")
    return values.reshape(shape)


def numpy_to_tensor(arr) -> TensorProto:
    """An array as a TensorProto with ``tensor_content`` (a scalar or a
    string array in its typed field), as ``tf.make_tensor_proto``."""
    arr = np.asarray(arr)
    if arr.dtype.kind in "SUO":
        return TensorProto(dtype=DT_STRING, tensor_shape=make_shape(
            arr.shape), string_val=[v if isinstance(v, bytes)
                                    else str(v).encode()
                                    for v in arr.reshape(-1)])
    tp = TensorProto(dtype=dtype_enum(arr.dtype),
                     tensor_shape=make_shape(arr.shape))
    if arr.ndim == 0:
        field = _VAL_FIELD[tp.dtype]
        v = arr.item()
        setattr(tp, field, [int(np.asarray(arr).view(np.uint16))]
                if tp.dtype == DT_HALF else [v])
    else:
        tp.tensor_content = np.ascontiguousarray(arr).tobytes()
    return tp


# ---------------------------------------------------------------------------
# attributes

def attr_value(a: AttrValue) -> Any:
    """An AttrValue as Python: int, float, bool, str, a numpy dtype, a
    shape tuple, an ndarray, or a list of one of these."""
    which = a.which()
    if which is None:
        return None
    if which == "i":
        return int(a.i)
    if which == "f":
        return float(a.f)
    if which == "b":
        return bool(a.b)
    if which == "s":
        return a.s.decode("utf-8", "replace")
    if which == "type":
        return np_dtype(a.type)
    if which == "shape":
        return tuple(int(d.size) for d in a.shape.dim)
    if which == "tensor":
        return tensor_to_numpy(a.tensor)
    if which == "list":
        lst = a.list
        if lst.i:
            return [int(v) for v in lst.i]
        if lst.f:
            return [float(v) for v in lst.f]
        if lst.s:
            return [v.decode("utf-8", "replace") for v in lst.s]
        if lst.b:
            return [bool(v) for v in lst.b]
        if lst.type:
            return [np_dtype(v) for v in lst.type]
        if lst.shape:
            return [shape_of(s) for s in lst.shape]
        return []
    if which == "placeholder":
        return a.placeholder
    if which == "func":
        return a.func.name
    raise ValueError(f"unhandled attr kind {which}")


def make_attr(value) -> AttrValue:
    """A Python value as an AttrValue (the inverse of :func:`attr_value`
    for bool, int, float, str, bytes, numpy dtypes, arrays and lists of
    ints, floats or strings; ``("shape", dims)`` for a shape)."""
    if isinstance(value, AttrValue):
        return value
    if isinstance(value, (bool, np.bool_)):
        return AttrValue(b=bool(value))
    if isinstance(value, (int, np.integer)):
        return AttrValue(i=int(value))
    if isinstance(value, (float, np.floating)):
        return AttrValue(f=float(value))
    if isinstance(value, str):
        return AttrValue(s=value.encode())
    if isinstance(value, bytes):
        return AttrValue(s=value)
    if isinstance(value, np.dtype) or (isinstance(value, type) and
                                       issubclass(value, np.generic)):
        return AttrValue(type=dtype_enum(value))
    if isinstance(value, np.ndarray):
        return AttrValue(tensor=numpy_to_tensor(value))
    if isinstance(value, tuple) and len(value) == 2 and value[0] == "shape":
        return AttrValue(shape=make_shape(value[1]))
    if isinstance(value, (list, tuple)):
        vals = list(value)
        if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
               for v in vals):
            return AttrValue(list=ListValue(i=[int(v) for v in vals]))
        if all(isinstance(v, (float, int, np.floating)) for v in vals):
            return AttrValue(list=ListValue(f=[float(v) for v in vals]))
        if all(isinstance(v, str) for v in vals):
            return AttrValue(list=ListValue(s=[v.encode() for v in vals]))
    raise TypeError(f"cannot make an AttrValue from {value!r}")


def make_node(op: str, name: str, inputs: List[str] = (),
              **attrs) -> NodeDef:
    """A NodeDef; ``attrs`` by :func:`make_attr` (sorted by key, as TF
    writes its map)."""
    return NodeDef(name=name, op=op, input=list(inputs),
                   attr_entries=[AttrEntry(key=k, value=make_attr(v))
                                 for k, v in sorted(attrs.items())])


def make_graph(nodes, producer: int = 1645) -> GraphDef:
    return GraphDef(node=list(nodes),
                    versions=VersionDef(producer=producer))


def const(name: str, value, dtype=None) -> NodeDef:
    """A ``Const`` node holding ``value``."""
    arr = np.asarray(value, dtype=dtype)
    return make_node("Const", name, dtype=arr.dtype, value=arr)


def placeholder(name: str, shape, dtype=np.float32) -> NodeDef:
    return make_node("Placeholder", name, dtype=np.dtype(dtype),
                     shape=("shape", shape))
