"""The port's ONNX import against the JAX package's.

The codec (``pipeline/api/onnx/proto.py``) encodes a model to the JAX
package's bytes and each decodes the other's; every op of the JAX
converter's table runs through both converters on one graph and the same
seeded inputs (one parametrised test: 1e-6 for elementwise ops, 1e-5 for
convolution, pooling and normalisation); ``OnnxNet`` predicts and its
gradients follow ``jax.grad``; dropout in train and eval; a bf16
initializer; the unsupported-op message.  Integer outputs are int64 in
the port where the JAX package (x64 off) returns int32: values are held,
dtypes by kind (ROADMAP Queue 3, Known differences).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.onnx import OnnxGraph as JOnnxGraph
from analytics_zoo_tpu.pipeline.api.onnx import OnnxNet as JOnnxNet
from analytics_zoo_tpu.pipeline.api.onnx import converter as jconverter
from analytics_zoo_tpu.pipeline.api.onnx import proto as JP
from analytics_zoo_tpu_torch.pipeline.api.onnx import (OnnxGraph, OnnxLoader,
                                                       OnnxNet, load_onnx)
from analytics_zoo_tpu_torch.pipeline.api.onnx import proto as P
from analytics_zoo_tpu_torch.pipeline.api.onnx.converter import _H


def mlp_model(P=P):
    w1 = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    b1 = np.zeros(8, np.float32)
    w2 = np.random.RandomState(1).randn(8, 3).astype(np.float32)
    b2 = np.zeros(3, np.float32)
    nodes = [
        P.make_node("Gemm", ["x", "w1", "b1"], ["h"], alpha=1.0, beta=1.0),
        P.make_node("Relu", ["h"], ["hr"]),
        P.make_node("Gemm", ["hr", "w2", "b2"], ["logits"]),
        P.make_node("Softmax", ["logits"], ["probs"], axis=-1),
    ]
    graph = P.make_graph(
        nodes, "mlp",
        [P.make_value_info("x", ("N", 4))],
        [P.make_value_info("probs", ("N", 3))],
        initializer=[P.numpy_to_tensor(w1, "w1"),
                     P.numpy_to_tensor(b1, "b1"),
                     P.numpy_to_tensor(w2, "w2"),
                     P.numpy_to_tensor(b2, "b2")])
    return P.make_model(graph)


# ---- the codec ---------------------------------------------------------------

def test_codec_bytes_equal_jax_and_decode_both_ways():
    ours, ref = P.encode(mlp_model(P)), JP.encode(mlp_model(JP))
    assert ours == ref
    back = P.decode(P.ModelProto, ref)
    jback = JP.decode(JP.ModelProto, ours)
    assert back.graph.name == jback.graph.name == "mlp"
    assert [n.op_type for n in back.graph.node] == \
        [n.op_type for n in jback.graph.node]
    for a, b in zip(back.graph.initializer, jback.graph.initializer):
        np.testing.assert_array_equal(P.tensor_to_numpy(a),
                                      JP.tensor_to_numpy(b))
    assert P.encode(back) == ref  # a decoded model re-encodes unchanged
    n = P.make_node("Flatten", ["x"], ["y"], axis=-1, pads=[1, 2],
                    alpha=0.5, mode="reflect")
    assert P.encode(n) == JP.encode(JP.make_node(
        "Flatten", ["x"], ["y"], axis=-1, pads=[1, 2], alpha=0.5,
        mode="reflect"))
    assert P.attrs_dict(P.decode(P.NodeProto, P.encode(n))) == \
        JP.attrs_dict(JP.decode(JP.NodeProto, P.encode(n)))


def test_codec_keeps_onnx_and_graphdef_messages_apart():
    """Both codecs loaded: each decodes its own TensorProto."""
    from analytics_zoo_tpu_torch.pipeline.api.tfgraph import proto as TP
    model = P.load_model(P.encode(mlp_model(P)))
    assert type(model.graph.initializer[0]) is P.TensorProto
    np.testing.assert_array_equal(
        P.tensor_to_numpy(model.graph.initializer[0]),
        np.random.RandomState(0).randn(4, 8).astype(np.float32))
    gd = TP.parse_graph_def(TP.encode(TP.make_graph(
        [TP.const("c", np.arange(6, dtype=np.int32).reshape(2, 3))])))
    assert type(gd.node[0].attr["value"].tensor) is TP.TensorProto


@pytest.mark.parametrize("arr", [
    np.arange(6, dtype=np.int64).reshape(2, 3), np.ones((3,), np.float64),
    np.array([True, False]), np.arange(4, dtype=np.int32),
    np.linspace(-2, 2, 6, dtype=np.float16).reshape(3, 2),
    np.array(3.5, np.float32)])
def test_codec_tensor_dtypes(arr):
    tp = P.numpy_to_tensor(arr, "t")
    assert P.encode(tp) == JP.encode(JP.numpy_to_tensor(arr, "t"))
    back = P.tensor_to_numpy(P.decode(P.TensorProto, P.encode(tp)))
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)
    tp = P.TensorProto(name="t", dims=[2, 2], data_type=1,
                       float_data=[1.0, 2.0, 3.0, 4.0])
    np.testing.assert_array_equal(P.tensor_to_numpy(tp),
                                  JP.tensor_to_numpy(tp))


def test_bf16_initializer_decodes_without_ml_dtypes():
    """A bf16 initializer decodes to its exact float32 values (the JAX
    package decodes to ml_dtypes' bf16, the same numbers) and serves."""
    vals = np.array([[1.5, -2.25, 3.0], [0.0078125, -0.5, 1e-3]],
                    np.float32)
    bits = (vals.view(np.uint32) >> 16).astype(np.uint16)
    tp = P.TensorProto(name="w", dims=[2, 3], data_type=16,
                       raw_data=bits.tobytes())
    got = P.tensor_to_numpy(tp)
    want = np.asarray(JP.tensor_to_numpy(
        JP.decode(JP.TensorProto, P.encode(tp))), np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    nodes = [P.make_node("MatMul", ["x", "w"], ["y"])]
    graph = P.make_graph(nodes, "bf", [P.make_value_info("x", ("N", 2))],
                         [P.make_value_info("y", ("N", 3))],
                         initializer=[tp])
    x = np.random.RandomState(0).randn(4, 2).astype(np.float32)
    (out,) = OnnxGraph(graph)(OnnxGraph(graph).initial_params, x,
                              device="cpu")
    jg = JOnnxGraph(JP.decode(JP.GraphProto, P.encode(graph)))
    (ref,) = jg(jg.initial_params, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


# ---- the op sweep ------------------------------------------------------------

def _r(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(
        lo, hi, shape).astype(np.float32)


def _i64(*vals):
    return np.array(vals, np.int64)


# id -> (op, inputs {name: array}, static inits {name: array}, attrs,
#        n outputs, tol); inputs feed in order, float inits become params
SWEEP = {
    "Identity": ("Identity", {"x": _r(3, 4)}, {}, {}, 1, 1e-6),
    "Constant": None,            # graph-level cases below
    "ConstantOfShape": None,
    "Shape": None,
    "Size": None,
    "Range": None,
    "Cast": ("Cast", {"x": _r(3, 4)}, {}, {"to": 7}, 1, 0),
    "Dropout": ("Dropout", {"x": _r(3, 4)}, {}, {"ratio": 0.3}, 1, 0),
    "Reshape": ("Reshape", {"x": _r(2, 3, 4)}, {"s": _i64(0, -1)}, {}, 1, 0),
    "Flatten": ("Flatten", {"x": _r(2, 3, 4)}, {}, {"axis": 2}, 1, 0),
    "Transpose": ("Transpose", {"x": _r(2, 3, 4)}, {},
                  {"perm": [2, 0, 1]}, 1, 0),
    "Squeeze": ("Squeeze", {"x": _r(2, 1, 4, 1)}, {"a": _i64(1, -1)}, {},
                1, 0),
    "Unsqueeze": ("Unsqueeze", {"x": _r(2, 4)}, {"a": _i64(0, -1)}, {},
                  1, 0),
    "Slice": ("Slice", {"x": _r(5, 6)},
              {"s": _i64(4, 1), "e": _i64(0, 5), "a": _i64(0, 1),
               "st": _i64(-2, 2)}, {}, 1, 0),
    "Gather": ("Gather", {"x": _r(5, 3)}, {"i": _i64(4, 0, -1, 2)},
               {"axis": 0}, 1, 0),
    "Concat": ("Concat", {"x": _r(2, 3), "y": _r(2, 2, seed=1)}, {},
               {"axis": 1}, 1, 0),
    "Split": ("Split", {"x": _r(2, 7)}, {"sp": _i64(3, 4)}, {"axis": 1},
              2, 0),
    "Pad": ("Pad", {"x": _r(3, 4)}, {"p": _i64(1, 2, 0, 1)},
            {"mode": "reflect"}, 1, 0),
    "Expand": ("Expand", {"x": _r(3, 1)}, {"s": _i64(2, 3, 4)}, {}, 1, 0),
    "Tile": ("Tile", {"x": _r(2, 3)}, {"r": _i64(2, 1)}, {}, 1, 0),
    "OneHot": ("OneHot", {}, {"i": _i64(0, 3, 1, 7), "d": _i64(5),
                              "v": _i64(-1, 2)},
               {"axis": 0}, 1, 0),
    "Add": ("Add", {"x": _r(3, 4), "y": _r(4, seed=1)}, {}, {}, 1, 1e-6),
    "Sub": ("Sub", {"x": _r(3, 4), "y": _r(3, 1, seed=1)}, {}, {}, 1, 1e-6),
    "Mul": ("Mul", {"x": _r(3, 4), "y": _r(3, 4, seed=1)}, {}, {}, 1, 1e-6),
    "Div": ("Div", {"x": _r(3, 4), "y": _r(3, 4, seed=1, lo=0.5)}, {}, {},
            1, 1e-6),
    "Pow": ("Pow", {"x": _r(3, 4, lo=0.1), "y": _r(3, 4, seed=1)}, {}, {},
            1, 1e-6),
    "Mod": ("Mod", {"x": _r(3, 4, lo=-5, hi=5),
                    "y": _r(3, 4, seed=1, lo=0.5)}, {}, {}, 1, 1e-6),
    "Min": ("Min", {"x": _r(3, 4), "y": _r(3, 4, seed=1),
                    "z": _r(4, seed=2)}, {}, {}, 1, 0),
    "Max": ("Max", {"x": _r(3, 4), "y": _r(3, 4, seed=1)}, {}, {}, 1, 0),
    "Sum": ("Sum", {"x": _r(3, 4), "y": _r(3, 4, seed=1),
                    "z": _r(3, 4, seed=2)}, {}, {}, 1, 1e-6),
    "Mean": ("Mean", {"x": _r(3, 4), "y": _r(3, 4, seed=1)}, {}, {}, 1,
             1e-6),
    "MatMul": ("MatMul", {"x": _r(2, 3, 4), "y": _r(4, 5, seed=1)}, {}, {},
               1, 1e-6),
    "Gemm": ("Gemm", {"x": _r(4, 3), "y": _r(5, 4, seed=1),
                      "c": _r(5, seed=2)}, {},
             {"transA": 1, "transB": 1, "alpha": 0.5, "beta": 2.0}, 1,
             1e-6),
    "Einsum": ("Einsum", {"x": _r(2, 3, 4), "y": _r(2, 4, 5, seed=1)}, {},
               {"equation": "bij,bjk->bik"}, 1, 1e-6),
    "Neg": ("Neg", {"x": _r(3, 4)}, {}, {}, 1, 0),
    "Abs": ("Abs", {"x": _r(3, 4)}, {}, {}, 1, 0),
    "Sqrt": ("Sqrt", {"x": _r(3, 4, lo=0.0)}, {}, {}, 1, 1e-6),
    "Exp": ("Exp", {"x": _r(3, 4)}, {}, {}, 1, 1e-6),
    "Log": ("Log", {"x": _r(3, 4, lo=0.1)}, {}, {}, 1, 1e-6),
    "Reciprocal": ("Reciprocal", {"x": _r(3, 4, lo=0.5)}, {}, {}, 1, 1e-6),
    "Floor": ("Floor", {"x": _r(3, 4)}, {}, {}, 1, 0),
    "Ceil": ("Ceil", {"x": _r(3, 4)}, {}, {}, 1, 0),
    "Round": ("Round", {"x": np.array([0.5, 1.5, 2.5, -0.5, 0.2],
                                      np.float32)}, {}, {}, 1, 0),
    "Sign": ("Sign", {"x": np.array([-1.5, 0.0, 2.0], np.float32)}, {}, {},
             1, 0),
    "Erf": ("Erf", {"x": _r(3, 4)}, {}, {}, 1, 1e-6),
    "Sin": ("Sin", {"x": _r(3, 4)}, {}, {}, 1, 1e-6),
    "Cos": ("Cos", {"x": _r(3, 4)}, {}, {}, 1, 1e-6),
    "Clip": ("Clip", {"x": _r(3, 4)},
             {"lo": np.array(-0.5, np.float32),
              "hi": np.array(0.7, np.float32)}, {}, 1, 0),
    "Relu": ("Relu", {"x": _r(3, 4)}, {}, {}, 1, 0),
    "LeakyRelu": ("LeakyRelu", {"x": _r(3, 4)}, {}, {"alpha": 0.1}, 1,
                  1e-6),
    "PRelu": ("PRelu", {"x": _r(3, 4), "y": _r(4, seed=1)}, {}, {}, 1,
              1e-6),
    "Elu": ("Elu", {"x": _r(3, 4)}, {}, {"alpha": 0.7}, 1, 1e-6),
    "Selu": ("Selu", {"x": _r(3, 4)}, {}, {}, 1, 1e-6),
    "Celu": ("Celu", {"x": _r(3, 4)}, {}, {"alpha": 1.3}, 1, 1e-6),
    "Sigmoid": ("Sigmoid", {"x": _r(3, 4)}, {}, {}, 1, 1e-6),
    "HardSigmoid": ("HardSigmoid", {"x": _r(3, 4, lo=-4, hi=4)}, {},
                    {"alpha": 0.3, "beta": 0.4}, 1, 1e-6),
    "Tanh": ("Tanh", {"x": _r(3, 4)}, {}, {}, 1, 1e-6),
    "Softplus": ("Softplus", {"x": _r(3, 4, lo=-30, hi=30)}, {}, {}, 1,
                 1e-6),
    "Softsign": ("Softsign", {"x": _r(3, 4)}, {}, {}, 1, 1e-6),
    "Softmax": ("Softmax", {"x": _r(3, 4)}, {}, {"axis": 0}, 1, 1e-6),
    "LogSoftmax": ("LogSoftmax", {"x": _r(3, 4)}, {}, {"axis": -1}, 1,
                   1e-6),
    "Gelu": ("Gelu", {"x": _r(3, 4, lo=-4, hi=4)}, {}, {}, 1, 1e-6),
    "Conv": ("Conv", {"x": _r(2, 3, 9, 8), "w": _r(6, 3, 3, 3, seed=1)},
             {}, {"strides": [2, 1], "pads": [0, 1, 2, 1],
                  "dilations": [1, 2]}, 1, 1e-5),
    "ConvTranspose": ("ConvTranspose", {"x": _r(2, 4, 5, 5),
                                        "w": _r(4, 3, 3, 3, seed=1)},
                      {}, {"strides": [2, 2], "pads": [1, 0, 0, 1],
                           "output_padding": [1, 0]}, 1, 1e-5),
    "MaxPool": ("MaxPool", {"x": _r(2, 3, 7, 8)}, {},
                {"kernel_shape": [3, 2], "strides": [2, 2],
                 "auto_pad": "SAME_UPPER"}, 1, 1e-5),
    "AveragePool": ("AveragePool", {"x": _r(2, 3, 7, 8)}, {},
                    {"kernel_shape": [3, 3], "strides": [2, 2],
                     "pads": [1, 0, 2, 1]}, 1, 1e-5),
    "GlobalAveragePool": ("GlobalAveragePool", {"x": _r(2, 3, 5, 4)}, {},
                          {}, 1, 1e-5),
    "GlobalMaxPool": ("GlobalMaxPool", {"x": _r(2, 3, 5, 4)}, {}, {}, 1,
                      1e-5),
    "BatchNormalization": ("BatchNormalization",
                           {"x": _r(2, 3, 4, 4), "sc": _r(3, seed=1),
                            "b": _r(3, seed=2), "m": _r(3, seed=3),
                            "v": _r(3, seed=4, lo=0.5)}, {},
                           {"epsilon": 1e-3}, 1, 1e-5),
    "InstanceNormalization": ("InstanceNormalization",
                              {"x": _r(2, 3, 4, 5), "sc": _r(3, seed=1),
                               "b": _r(3, seed=2)}, {}, {}, 1, 1e-5),
    "LRN": ("LRN", {"x": _r(2, 6, 3, 3)}, {},
            {"size": 4, "alpha": 1e-2, "beta": 0.75, "bias": 2.0}, 1, 1e-5),
    "ReduceMean": ("ReduceMean", {"x": _r(2, 3, 4)}, {},
                   {"axes": [0, 2], "keepdims": 0}, 1, 1e-6),
    "ReduceSum": ("ReduceSum", {"x": _r(2, 3, 4)}, {"a": _i64(1)}, {}, 1,
                  1e-6),
    "ReduceMax": ("ReduceMax", {"x": _r(2, 3, 4)}, {}, {"axes": [-1]}, 1,
                  0),
    "ReduceMin": ("ReduceMin", {"x": _r(2, 3, 4)}, {},
                  {"keepdims": 0}, 1, 0),
    "ReduceProd": ("ReduceProd", {"x": _r(2, 3, 4)}, {},
                   {"axes": [0, 1]}, 1, 1e-6),
    "ReduceL2": ("ReduceL2", {"x": _r(2, 3, 4)}, {}, {"axes": [2]}, 1,
                 1e-6),
    "ArgMax": ("ArgMax", {"x": _r(3, 5)}, {}, {"axis": 1}, 1, 0),
    "ArgMin": ("ArgMin", {"x": _r(3, 5)}, {},
               {"axis": 0, "keepdims": 0}, 1, 0),
    "TopK": ("TopK", {"x": _r(3, 6)}, {"k": _i64(3)},
             {"axis": -1, "largest": 0}, 2, 0),
    "Greater": ("Greater", {"x": _r(3, 4), "y": _r(4, seed=1)}, {}, {}, 1,
                0),
    "GreaterOrEqual": ("GreaterOrEqual", {"x": _r(3, 4),
                                          "y": _r(3, 4, seed=1)}, {}, {},
                       1, 0),
    "Less": ("Less", {"x": _r(3, 4), "y": _r(3, 4, seed=1)}, {}, {}, 1, 0),
    "LessOrEqual": ("LessOrEqual", {"x": _r(3, 4), "y": _r(3, 4, seed=1)},
                    {}, {}, 1, 0),
    "Equal": ("Equal", {"x": np.array([1.0, 2.0, 3.0], np.float32),
                        "y": np.array([1.0, 0.0, 3.0], np.float32)}, {},
              {}, 1, 0),
    "Not": None, "And": None, "Or": None, "Xor": None, "Where": None,
}


def _graph_case(P, key):
    """The cases that need more than one node (bool inputs from a
    comparison, constants, shape math), as (graph, inputs, tol)."""
    mk, vi, t = P.make_node, P.make_value_info, P.numpy_to_tensor
    x = _r(3, 4)
    if key in ("Not", "And", "Or", "Xor", "Where"):
        nodes = [mk("Greater", ["x", "z"], ["a"]),
                 mk("Less", ["x", "h"], ["b"])]
        if key == "Not":
            nodes.append(mk("Not", ["a"], ["y"]))
        elif key == "Where":
            nodes.append(mk("Where", ["a", "x", "n"], ["y"]))
        else:
            nodes.append(mk(key, ["a", "b"], ["y"]))
        inits = [t(np.array(0.0, np.float32), "z"),
                 t(np.array(1.0, np.float32), "h"),
                 t(np.full((3, 4), -7.0, np.float32), "n")]
    elif key in ("Constant", "ConstantOfShape", "Shape", "Size", "Range"):
        nodes = [mk("Shape", ["x"], ["s"]),
                 mk("Size", ["x"], ["n"]),
                 mk("Constant", [], ["c"], value=np.array(3, np.int64)),
                 mk("Range", ["z", "c", "one"], ["r"]),
                 mk("ConstantOfShape", ["s"], ["k"],
                    value=np.array([0.25], np.float32)),
                 mk("Add", ["x", "k"], ["xa"]),
                 mk("Cast", ["r"], ["rf"], to=1),
                 mk("Mul", ["xa", "rf"], ["y0"]),
                 mk("Cast", ["n"], ["nf"], to=1),
                 mk("Add", ["y0", "nf"], ["y"])]
        x = _r(3, 3)
        inits = [t(np.array(0, np.int64), "z"),
                 t(np.array(1, np.int64), "one")]
    else:
        raise KeyError(key)
    graph = P.make_graph(nodes, key, [vi("x", x.shape)],
                         [vi("y", None)], initializer=inits)
    return graph, {"x": x}, 0


def _single_case(P, key):
    op, inputs, statics, attrs, n_out, tol = SWEEP[key]
    inits = [P.numpy_to_tensor(v, k) for k, v in statics.items()]
    node = P.make_node(op, list(inputs) + list(statics),
                       [f"y{i}" for i in range(n_out)], **attrs)
    graph = P.make_graph([node], key,
                         [P.make_value_info(k, v.shape)
                          for k, v in inputs.items()],
                         [P.make_value_info(f"y{i}", None)
                          for i in range(n_out)],
                         initializer=inits)
    return graph, inputs, tol


def _jax_conv_transpose(attrs, x, w):
    """The JAX converter's ConvTranspose expression (``converter.py``
    ``_conv_transpose``) with its kernel transposed by hand: it passes
    ``transpose_kernel=`` to ``lax.conv_general_dilated``, which the
    installed jax does not take, so the JAX function itself raises."""
    from jax import lax
    rank = x.ndim - 2
    strides, dil = attrs["strides"], [1] * rank
    pads = [(attrs["pads"][i], attrs["pads"][i + rank]) for i in range(rank)]
    tpads = [(d * (k - 1) - p0, d * (k - 1) - p1 + op)
             for (p0, p1), k, d, op in zip(pads, w.shape[2:], dil,
                                           attrs["output_padding"])]
    wt = jnp.swapaxes(jnp.flip(jnp.asarray(w), tuple(range(2, w.ndim))),
                      0, 1)
    return lax.conv_general_dilated(
        jnp.asarray(x), wt, (1,) * rank, tpads, lhs_dilation=tuple(strides),
        rhs_dilation=tuple(dil), dimension_numbers=("NCHW", "OIHW", "NCHW"))


def test_sweep_covers_the_jax_table():
    assert set(SWEEP) == set(jconverter._H) == set(_H)


@pytest.mark.parametrize("key", sorted(SWEEP))
def test_op_matches_jax_converter(key):
    build = _single_case if SWEEP[key] is not None else _graph_case
    graph, inputs, tol = build(P, key)
    data = P.encode(graph)
    ours = OnnxGraph(P.decode(P.GraphProto, data))
    ref = JOnnxGraph(JP.decode(JP.GraphProto, data))
    assert ours.input_names == ref.input_names
    xs = [inputs[n] for n in ours.input_names]
    got = ours(ours.initial_params, *xs, device="cpu")
    if key == "ConvTranspose":
        want = [_jax_conv_transpose(SWEEP[key][3], *xs)]
    else:
        want = ref({k: jnp.asarray(v)
                    for k, v in ref.initial_params.items()},
                   *[jnp.asarray(v) for v in xs])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else \
            np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype.kind == w.dtype.kind, (g.dtype, w.dtype)
        if tol:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(g, w)


def test_training_dropout_keeps_or_scales():
    """Dropout in training draws from the layer's generator (the JAX
    package folds a key per node: the masks differ, the law agrees); in
    eval it is the identity."""
    nodes = [P.make_node("Dropout", ["x"], ["y"], ratio=0.5)]
    graph = P.make_graph(nodes, "d", [P.make_value_info("x", (4, 10))],
                         [P.make_value_info("y", (4, 10))])
    net = OnnxNet(model=P.make_model(graph), device="cpu")
    x = torch.ones(4, 10)
    net.eval()
    np.testing.assert_array_equal(net(x).numpy(), x.numpy())
    net.train()
    out = net(x).numpy()
    assert set(np.round(np.unique(out), 4)) <= {0.0, 2.0}
    assert 0 < (out == 0).sum() < out.size
    jnet = JOnnxNet(model=JP.decode(JP.ModelProto, P.encode(
        P.make_model(graph))))
    jout, _ = jnet.apply({}, {}, np.ones((4, 10), np.float32),
                         training=True, rng=jax.random.PRNGKey(0))
    assert set(np.round(np.unique(np.asarray(jout)), 4)) <= {0.0, 2.0}


def test_onnxnet_predict_and_grad_match_jax(tmp_path):
    path = str(tmp_path / "mlp.onnx")
    with open(path, "wb") as f:
        f.write(P.encode(mlp_model(P)))
    net = load_onnx(path, device="cpu")
    jnet = JOnnxNet(path=path)
    x = np.random.RandomState(3).randn(6, 4).astype(np.float32)
    preds = net.predict(x, batch_per_thread=4)
    np.testing.assert_allclose(preds, jnet.predict(x, batch_per_thread=4),
                               rtol=1e-6, atol=1e-6)
    assert set(net.params()) == {"w1", "b1", "w2", "b2"}
    jparams = jnet.init_params(jax.random.PRNGKey(0), None)

    def jloss(p):
        out = jnet.fn(p, x)[0]
        return -jnp.mean(jnp.log(out[:, 0] + 1e-8))

    jgrads = jax.grad(jloss)(jparams)
    out = net(torch.from_numpy(x))
    loss = -torch.mean(torch.log(out[:, 0] + 1e-8))
    params = net.params()
    grads = torch.autograd.grad(loss, list(params.values()))
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(grads[0].abs().sum()) > 0
    again = OnnxLoader.from_bytes(P.encode(mlp_model(P)), device="cpu")
    np.testing.assert_array_equal(again.predict(x), net.predict(x))
    assert net.compute_output_shape((None, 4)) == (None, 3)


def test_static_shape_subgraph_folds_at_build():
    axes0 = np.array([0], np.int64)
    tail = np.array([-1], np.int64)
    nodes = [
        P.make_node("Shape", ["x"], ["shp"]),
        P.make_node("Gather", ["shp", "idx0"], ["n"], axis=0),
        P.make_node("Unsqueeze", ["n", "ax0"], ["n1"]),
        P.make_node("Concat", ["n1", "tail"], ["tgt"], axis=0),
        P.make_node("Reshape", ["x", "tgt"], ["y"]),
        P.make_node("Constant", [], ["c"], value=np.array([2.0], np.float32)),
        P.make_node("Mul", ["c", "c"], ["c2"]),
        P.make_node("Mul", ["y", "c2"], ["z"]),
    ]
    graph = P.make_graph(
        nodes, "reshaper", [P.make_value_info("x", (2, 3, 4))],
        [P.make_value_info("z", (2, 12))],
        initializer=[P.numpy_to_tensor(np.array(0, np.int64), "idx0"),
                     P.numpy_to_tensor(axes0, "ax0"),
                     P.numpy_to_tensor(tail, "tail")])
    fn = OnnxGraph(graph)
    folded = {fn._order[k].op_type for k in range(len(fn._order))
              if k not in fn._todo}
    assert folded == {"Constant", "Mul"}  # c and c2, not y * c2
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    (out,) = fn({}, x, device="cpu")
    np.testing.assert_array_equal(out.numpy(), x.reshape(2, 12) * 4.0)


def test_unsupported_op_fails_at_conversion():
    nodes = [P.make_node("NonMaxSuppression", ["x"], ["y"])]
    graph = P.make_graph(nodes, "bad", [P.make_value_info("x", (1, 4))],
                         [P.make_value_info("y", None)])
    with pytest.raises(NotImplementedError,
                       match=r"unsupported ONNX ops \['NonMaxSuppression'\]"):
        OnnxGraph(graph)
    with pytest.raises(NotImplementedError) as ref:
        JOnnxGraph(JP.decode(JP.GraphProto, P.encode(graph)))
    with pytest.raises(NotImplementedError) as ours:
        OnnxGraph(graph)
    assert str(ours.value) == str(ref.value)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OnnxNet(model=mlp_model(P))


def test_interop_modules_import_no_optional_package():
    """The slice's modules import neither jax nor tensorflow, pandas,
    onnx or ml_dtypes when they are imported (a fresh process)."""
    import subprocess
    import sys
    import os
    mods = ["analytics_zoo_tpu_torch.pipeline.api.net",
            "analytics_zoo_tpu_torch.pipeline.api.onnx",
            "analytics_zoo_tpu_torch.pipeline.api.tfgraph",
            "analytics_zoo_tpu_torch.pipeline.estimator",
            "analytics_zoo_tpu_torch.pipeline.inference",
            "analytics_zoo_tpu_torch.data.dataset"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in ('jax', 'tensorflow', 'pandas', 'onnx', "
              "'ml_dtypes', 'analytics_zoo_tpu') if m in sys.modules]\n"
              "print('LOADED', bad)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert "LOADED []" in proc.stdout, proc.stdout
