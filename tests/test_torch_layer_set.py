"""The rest of the Keras layer set in the port against the JAX package's
layers: advanced activations, noise, the convolution family (3-D,
atrous, shared, transposed, locally connected, padding, cropping,
upsampling, bilinear resize), the 1-D and 3-D pools, the rest of
core.py (TimeDistributed over a training BatchNormalization included),
the two LRNs, every Merge mode, and the torch-style layers.

Each case builds the layer in both packages under one name, carries the
JAX package's parameters (perturbed from their init by a seeded draw)
and state across with ``from_jax_params``, and feeds both the same
numpy inputs made from a seed: the forward, the inputs' gradients and
every parameter's gradient of ``sum(out * cot)`` (``cot`` a seeded
draw) agree within 1e-5 relative and 1e-6 of the largest entry
absolute; the output shapes and configs are equal.  The random layers
run in eval mode, where they are exact.  Tie points (Merge max/min,
SReLU, ThresholdedReLU, HardShrink, HardTanh) are held against
``jax.grad`` with ``jax.disable_jit()``.
"""

import itertools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import layers as J
from analytics_zoo_tpu_torch.models import from_jax_params, to_jax_state
from analytics_zoo_tpu_torch.pipeline.api.keras import Model, Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as T

RTOL, ATOL = 1e-5, 1e-6
N = 3  # batch


def close(got, ref, what=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        np.asarray(got), ref, rtol=RTOL, err_msg=what,
        atol=ATOL * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0))


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def port_model(layer, shapes):
    """The port's layer in a CPU model: a Sequential for one input, a
    functional Model for several."""
    if len(shapes) == 1:
        model = Sequential(device="cpu")
        model.add(layer)
        return model
    ins = [T.Input(s) for s in shapes]
    return Model(input=ins, output=layer(ins), device="cpu")


def check(factory, shapes, inputs=None, training=False, seed=0,
          perturb=0.1, jit=True, modules=(J, T)):
    """``factory(L, input_shape)`` builds the layer from a layer module
    (``modules``: the JAX package's, then the port's) under the name
    ``"t"``; ``shapes`` are the per-sample input shapes; ``inputs`` the
    batch (a seeded normal draw when None).  Returns the port's layer."""
    rng = np.random.default_rng(seed)
    single = len(shapes) == 1
    in_shape = shapes[0] if single else None
    jl = factory(modules[0], in_shape)
    tl = factory(modules[1], in_shape)
    batch_shapes = [(None,) + tuple(s) for s in shapes]
    jshape = batch_shapes[0] if single else batch_shapes
    params, state = jl.init(jax.random.PRNGKey(seed), jshape)
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + perturb * _normal(rng, np.shape(v))
                   ).astype(np.float32), params)
    model = port_model(tl, shapes)
    from_jax_params(model, {"t": params},
                    {"t": jax.device_get(state)} if state else None)
    xs = inputs if inputs is not None else [
        _normal(rng, (N,) + tuple(s)) for s in shapes]

    def jfwd(p, args):
        return jl.apply(p, state, args[0] if single else list(args),
                        training=training, rng=None)

    jargs = [jnp.asarray(x) for x in xs]
    out_shape = jax.eval_shape(lambda p, a: jfwd(p, a)[0], params,
                               jargs).shape
    cot = _normal(rng, out_shape)

    def forward_and_grads(p, args):
        out, vjp, new_state = jax.vjp(jfwd, p, args, has_aux=True)
        return (out, new_state) + vjp(jnp.asarray(cot))

    if jit:
        ref, new_state, jp, jx = jax.jit(forward_and_grads)(params, jargs)
    else:
        with jax.disable_jit():
            ref, new_state, jp, jx = forward_and_grads(params, jargs)
    ref = np.asarray(ref)
    model.train(training)
    xts = [torch.from_numpy(np.array(x)).requires_grad_() for x in xs]
    out = tl(xts[0] if single else xts)
    assert tuple(out.shape) == ref.shape
    close(out.detach().numpy(), ref, "forward")
    assert tuple(jl.compute_output_shape(jshape))[1:] == ref.shape[1:]
    assert tuple(tl.compute_output_shape(jshape))[1:] == ref.shape[1:]
    if not isinstance(tl, T.KerasLayerWrapper):  # refuses, as in JAX
        assert tl.get_config() == jl.get_config()
    if training and state:
        got_state = to_jax_state(model)["t"]
        for k, v in jax.device_get(new_state).items():
            close(got_state[k], v, f"state {k}")

    names = list(tl.params())
    assert sorted(names) == sorted(params)
    wrt = xts + [tl.params()[k] for k in names]
    grads = (torch.autograd.grad((out * torch.from_numpy(cot)).sum(), wrt,
                                 allow_unused=True)
             if out.requires_grad else [None] * len(wrt))
    for i, (g, ref_g) in enumerate(zip(grads, list(jx) + [jp[k]
                                                         for k in names])):
        g = np.zeros(np.shape(ref_g), np.float32) if g is None else g.numpy()
        what = f"input {i} grad" if i < len(xts) else \
            f"{names[i - len(xts)]} grad"
        close(g, ref_g, what)
    return tl


# ---- one factory per case: (layer module, input shape) -> layer ----

def _f(name, *args, **kw):
    return lambda L, s: getattr(L, name)(*args, input_shape=s, name="t",
                                         **kw)


CASES = {
    # advanced activations
    "ELU": (_f("ELU", 0.8), (4, 5)),
    "LeakyReLU": (_f("LeakyReLU", 0.1), (4, 5)),
    "ThresholdedReLU": (_f("ThresholdedReLU", 0.5), (4, 5)),
    "PReLU": (_f("PReLU"), (4, 5)),
    "SReLU": (_f("SReLU"), (4, 5)),
    # noise, in eval mode
    "GaussianNoise": (_f("GaussianNoise", 0.2), (6,)),
    "GaussianDropout": (_f("GaussianDropout", 0.2), (6,)),
    # convolutional
    "Convolution3D": (_f("Convolution3D", 3, 2, 2, 2), (5, 5, 5, 2)),
    "Convolution3D_same_s2": (_f("Convolution3D", 3, 3, 2, 3,
                                 border_mode="same", subsample=(2, 2, 2)),
                              (5, 6, 5, 2)),
    "Convolution3D_th": (_f("Convolution3D", 3, 2, 2, 2, dim_ordering="th",
                            activation="relu"), (2, 4, 5, 4)),
    "AtrousConvolution1D": (_f("AtrousConvolution1D", 4, 3, atrous_rate=2),
                            (10, 3)),
    "AtrousConvolution2D": (_f("AtrousConvolution2D", 4, 3, 3,
                               atrous_rate=(2, 2), border_mode="same"),
                            (9, 9, 2)),
    "ShareConvolution2D": (_f("ShareConvolution2D", 4, 3, 3), (8, 8, 2)),
    "LocallyConnected1D": (_f("LocallyConnected1D", 4, 3), (8, 3)),
    "LocallyConnected1D_s2": (_f("LocallyConnected1D", 4, 3,
                                 subsample_length=2, activation="tanh"),
                              (9, 3)),
    "LocallyConnected1D_same": (_f("LocallyConnected1D", 2, 3,
                                   border_mode="same"), (6, 2)),
    "LocallyConnected2D": (_f("LocallyConnected2D", 3, 2, 2), (5, 5, 2)),
    "LocallyConnected2D_s2": (_f("LocallyConnected2D", 3, 3, 2,
                                 subsample=(2, 2)), (7, 6, 2)),
    "LocallyConnected2D_same_th": (_f("LocallyConnected2D", 2, 2, 3,
                                      border_mode="same",
                                      dim_ordering="th"), (2, 4, 5)),
    "ZeroPadding1D": (_f("ZeroPadding1D", 2), (5, 3)),
    "ZeroPadding1D_pair": (_f("ZeroPadding1D", (1, 3)), (5, 3)),
    "ZeroPadding3D": (_f("ZeroPadding3D", (1, 2, 0)), (3, 4, 3, 2)),
    "ZeroPadding3D_th": (_f("ZeroPadding3D", (2, 1, 1), dim_ordering="th"),
                         (2, 3, 4, 3)),
    "Cropping1D": (_f("Cropping1D", (1, 2)), (6, 3)),
    "Cropping2D": (_f("Cropping2D", ((1, 0), (2, 1))), (6, 6, 2)),
    "Cropping2D_th": (_f("Cropping2D", ((0, 2), (1, 1)), dim_ordering="th"),
                      (2, 6, 5)),
    "Cropping3D": (_f("Cropping3D", ((1, 1), (0, 2), (1, 0))),
                   (4, 5, 4, 2)),
    "Cropping3D_th": (_f("Cropping3D", dim_ordering="th"), (2, 4, 4, 5)),
    "UpSampling1D": (_f("UpSampling1D", 3), (4, 3)),
    "UpSampling2D": (_f("UpSampling2D", (2, 3)), (3, 4, 2)),
    "UpSampling2D_th": (_f("UpSampling2D", (3, 2), dim_ordering="th"),
                        (2, 3, 4)),
    "UpSampling3D": (_f("UpSampling3D", (2, 1, 2)), (3, 3, 2, 2)),
    "UpSampling3D_th": (_f("UpSampling3D", dim_ordering="th"),
                        (2, 2, 3, 2)),
    # pooling
    "MaxPooling1D": (_f("MaxPooling1D", 3, 2), (9, 3)),
    "MaxPooling1D_same": (_f("MaxPooling1D", 3, 2, border_mode="same"),
                          (8, 3)),
    "AveragePooling1D": (_f("AveragePooling1D", 2), (8, 3)),
    "AveragePooling1D_same": (_f("AveragePooling1D", 4, 3,
                                 border_mode="same"), (10, 3)),
    "MaxPooling3D": (_f("MaxPooling3D"), (4, 4, 4, 2)),
    "MaxPooling3D_same": (_f("MaxPooling3D", (3, 2, 3), (2, 2, 1),
                             border_mode="same"), (5, 4, 3, 2)),
    "AveragePooling3D": (_f("AveragePooling3D", (2, 2, 1)), (4, 4, 3, 2)),
    "AveragePooling3D_same": (_f("AveragePooling3D", (3, 3, 2), (2, 1, 2),
                                 border_mode="same"), (5, 4, 5, 2)),
    "AveragePooling3D_same_th": (_f("AveragePooling3D", (2, 3, 2),
                                    border_mode="same", dim_ordering="th"),
                                 (2, 5, 5, 3)),
    # core
    "SparseDense": (_f("SparseDense", 5), (6,)),
    "SpatialDropout1D": (_f("SpatialDropout1D", 0.3), (5, 6)),
    "SpatialDropout2D": (_f("SpatialDropout2D", 0.3), (5, 5, 3)),
    "SpatialDropout3D": (_f("SpatialDropout3D", 0.3), (4, 4, 4, 2)),
    "Permute": (_f("Permute", (2, 1)), (3, 5)),
    "Permute_3d": (_f("Permute", (3, 1, 2)), (3, 4, 5)),
    "RepeatVector": (_f("RepeatVector", 4), (6,)),
    "Highway": (_f("Highway"), (6,)),
    "Highway_nobias_relu": (_f("Highway", activation="relu", bias=False),
                            (6,)),
    "MaxoutDense": (_f("MaxoutDense", 5), (6,)),
    "MaxoutDense_nobias": (_f("MaxoutDense", 3, nb_feature=2, bias=False),
                           (6,)),
    "TimeDistributed_Dense": (
        lambda L, s: L.TimeDistributed(L.Dense(4, activation="tanh"),
                                       input_shape=s, name="t"), (5, 6)),
    "TimeDistributed_Conv2D": (
        lambda L, s: L.TimeDistributed(L.Convolution2D(3, 2, 2),
                                       input_shape=s, name="t"),
        (3, 5, 5, 2)),
    # normalization
    "LRN2D": (_f("LRN2D"), (4, 4, 7)),
    "LRN2D_even_th": (_f("LRN2D", 1e-2, 2.0, 0.5, 4, dim_ordering="th"),
                      (6, 3, 4)),
    "WithinChannelLRN2D": (_f("WithinChannelLRN2D"), (6, 7, 2)),
    "WithinChannelLRN2D_4": (_f("WithinChannelLRN2D", 4, 0.5, 0.6),
                             (5, 6, 3)),
    # torch-style
    "AddConstant": (_f("AddConstant", 2.0), (6,)),
    "MulConstant": (_f("MulConstant", -1.5), (6,)),
    "BinaryThreshold": (_f("BinaryThreshold", 0.1), (6,)),
    "Threshold": (_f("Threshold", 0.1, -2.0), (6,)),
    "HardShrink": (_f("HardShrink", 0.4), (6,)),
    "SoftShrink": (_f("SoftShrink", 0.4), (6,)),
    "HardTanh": (_f("HardTanh", -0.5, 0.7), (6,)),
    "RReLU": (_f("RReLU"), (6,)),
    "Exp": (_f("Exp"), (6,)),
    "Square": (_f("Square"), (6,)),
    "Negative": (_f("Negative"), (6,)),
    "Identity": (_f("Identity"), (6,)),
    "Mul": (_f("Mul"), (6,)),
    "CAdd": (_f("CAdd", [1, 6]), (6,)),
    "CMul": (_f("CMul", [4, 1]), (4, 6)),
    "Scale": (_f("Scale", [6]), (3, 6)),
    "KerasLayerWrapper": (
        lambda L, s: L.KerasLayerWrapper(lambda x: x[:, 1:] * 2.0,
                                         input_shape=s, name="t"), (6,)),
    "Narrow": (_f("Narrow", 1, 1, 3), (6,)),
    "Narrow_negative": (_f("Narrow", -1, 1, -1), (3, 5)),
    "Select": (_f("Select", 1, 2), (4, 3)),
    "Select_last": (_f("Select", -1, -1), (4, 3)),
    "Squeeze": (_f("Squeeze", 2), (3, 1, 4)),
    "Squeeze_all": (_f("Squeeze"), (1, 3, 1)),
}

#: layers whose input must be positive
POSITIVE = {"Log": _f("Log"), "Sqrt": _f("Sqrt"),
            "Power": _f("Power", 2.5, 0.5, 0.2)}


@pytest.mark.parametrize("name", sorted(CASES), ids=sorted(CASES))
def test_layer_matches_jax(name):
    factory, shape = CASES[name]
    check(factory, [shape])


@pytest.mark.parametrize("name", sorted(POSITIVE))
def test_positive_input_layer_matches_jax(name):
    x = np.abs(_normal(np.random.default_rng(3), (N, 6))) + 0.5
    check(POSITIVE[name], [(6,)], inputs=[x])


@pytest.mark.parametrize("k,s,border,ordering", [
    *itertools.product((2, 3, 4), (1, 2), ("same", "valid"), ("tf",)),
    (4, 2, "same", "th"), (3, 3, "valid", "th"), (2, 3, "same", "tf")])
def test_deconvolution2d_grid_matches_jax(k, s, border, ordering):
    shape = (5, 6, 3) if ordering == "tf" else (3, 5, 6)
    check(_f("Deconvolution2D", 4, k, k + (1 if s == 1 else 0),
             border_mode=border, subsample=(s, s), dim_ordering=ordering,
             activation="relu" if k == 3 else None), [shape])


@pytest.mark.parametrize("in_hw,out_hw,ordering", [
    ((4, 5), (7, 9), "tf"),     # up
    ((9, 11), (4, 5), "tf"),    # down: antialiased
    ((12, 8), (5, 3), "tf"),    # down by more than 2
    ((6, 5), (3, 8), "tf"),     # down one axis, up the other
    ((5, 6), (5, 6), "tf"),     # same size
    ((7, 6), (3, 13), "th")])
def test_resize_bilinear_matches_jax(in_hw, out_hw, ordering):
    shape = in_hw + (2,) if ordering == "tf" else (2,) + in_hw
    check(_f("ResizeBilinear", out_hw[0], out_hw[1], dim_ordering=ordering,
             align_corners=True), [shape])


def test_masking_matches_jax():
    x = _normal(np.random.default_rng(5), (N, 5, 3))
    x[0, 1] = 0.0
    x[2, [0, 4]] = 0.0
    x[1, 2, 0] = 0.0  # one feature zero: the step stays
    layer = check(_f("Masking", 0.0), [(5, 3)], inputs=[x])
    out = layer(torch.from_numpy(x))
    keep = np.any(x != 0.0, axis=-1, keepdims=True)
    np.testing.assert_array_equal(out.numpy(), np.where(keep, x, 0.0))


def test_time_distributed_batchnorm_trains_with_its_state():
    """An inner BatchNormalization in training mode through
    TimeDistributed: the output, the gradients and the updated moving
    statistics and count agree with the JAX package's."""
    layer = check(lambda L, s: L.TimeDistributed(
        L.BatchNormalization(momentum=0.9), input_shape=s, name="t"),
        [(4, 5, 3)], training=True)
    assert set(layer.state()) == {"moving_mean", "moving_var", "count"}
    assert float(layer.state()["count"]) == 1.0


MERGE_MODES = ("sum", "mul", "max", "min", "ave", "sub", "div", "concat",
               "dot", "cosine")


@pytest.mark.parametrize("mode", MERGE_MODES)
def test_merge_modes_match_jax(mode):
    rng = np.random.default_rng(11)
    xs = [_normal(rng, (N, 5)) for _ in range(2)]
    if mode == "div":
        xs[1] = np.abs(xs[1]) + 0.5
    check(lambda L, s: L.Merge(mode=mode, name="t"), [(5,), (5,)],
          inputs=xs)


def test_merge_of_three_and_broadcast_shapes():
    rng = np.random.default_rng(12)
    for mode in ("sum", "mul", "max", "min", "ave"):
        check(lambda L, s: L.Merge(mode=mode, name="t"), [(4,)] * 3,
              inputs=[_normal(rng, (N, 4)) for _ in range(3)])
    check(lambda L, s: L.Merge(mode="concat", concat_axis=1, name="t"),
          [(2, 3), (4, 3)])


def test_merge_function_and_branch_layers_as_jax():
    """``merge`` adds a Merge node; ``Merge(layers=...)`` is accepted and
    stored, as the JAX package accepts it."""
    a, b = T.Input((4,)), T.Input((4,))
    out = T.merge([a, b], mode="mul", name="m")
    model = Model(input=[a, b], output=out, device="cpu")
    x = [np.full((2, 4), 2.0, np.float32), np.full((2, 4), 3.0, np.float32)]
    np.testing.assert_array_equal(model.predict(x), np.full((2, 4), 6.0))
    branches = [T.Dense(3), T.Dense(3)]
    m = T.Merge(layers=branches, mode="ave")
    jm = J.Merge(layers=[J.Dense(3), J.Dense(3)], mode="ave")
    assert m.layers is branches
    assert m.get_config().keys() == jm.get_config().keys()


def test_tie_gradients_match_jax():
    """Inputs exactly on each branch point: gradients as ``jax.grad``
    gives them (half to each side of a max/min or clip tie, all to the
    selected branch of a where)."""
    x = np.array([[-1.0, -0.5, 0.0, 0.5, 1.0, 0.7]], np.float32)
    y = np.array([[-1.0, 0.0, 0.0, 0.5, 2.0, 0.7]], np.float32)
    for mode in ("max", "min"):
        check(lambda L, s: L.Merge(mode=mode, name="t"), [(6,), (6,)],
              inputs=[x, y], jit=False)
    check(_f("ThresholdedReLU", 0.5), [(6,)], inputs=[x], jit=False)
    check(_f("HardShrink", 0.5), [(6,)], inputs=[x], jit=False)
    check(_f("HardTanh", -0.5, 0.7), [(6,)], inputs=[x], jit=False)
    check(_f("LeakyReLU", 0.2), [(6,)], inputs=[x], jit=False)
    # SReLU at its initial thresholds (0 and 1), unperturbed
    check(_f("SReLU"), [(6,)], inputs=[x], jit=False, perturb=0.0)


def test_gaussian_sampler_in_eval_returns_the_mean():
    check(lambda L, s: L.GaussianSampler(name="t"), [(5,), (5,)])


def test_full_border_mode_raises_as_in_jax():
    """``border_mode="full"`` raises a ValueError in both packages (the
    JAX package's convolutions when they run)."""
    jl = J.Convolution2D(2, 3, 3, border_mode="full", name="t")
    params, _ = jl.init(jax.random.PRNGKey(0), (None, 5, 5, 1))
    with pytest.raises(ValueError, match="border_mode"):
        jl.apply(params, {}, jnp.zeros((1, 5, 5, 1)))
    for make in (lambda: T.Convolution2D(2, 3, 3, border_mode="full"),
                 lambda: T.Convolution3D(2, border_mode="full"),
                 lambda: T.Deconvolution2D(2, 3, 3, border_mode="full"),
                 lambda: T.LocallyConnected1D(2, 3, border_mode="full")):
        with pytest.raises(ValueError, match="border_mode"):
            make()


def test_random_layers_draw_in_training_from_their_generator():
    """In training each random layer draws from its own generator: the
    same generator state gives the same draw, and the layer's statistics
    are those of its law; in eval mode it is exact."""
    x = torch.ones(4000, 50)
    for make, mean, std in (
            (lambda g: T.GaussianNoise(0.5, generator=g), 1.0, 0.5),
            (lambda g: T.GaussianDropout(0.2, generator=g), 1.0, 0.5),
            (lambda g: T.SpatialDropout1D(0.5, generator=g), 1.0, 1.0)):
        layer = make(torch.Generator().manual_seed(3))
        twin = make(torch.Generator().manual_seed(3))
        xi = x.reshape(200, 20, 50) if isinstance(
            layer, T.SpatialDropout1D) else x
        a, b = layer(xi), twin(xi)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert abs(float(a.mean()) - mean) < 0.05
        assert abs(float(a.std()) - std) < 0.05
        layer.eval()
        assert torch.equal(layer(xi), xi)
    rrelu = T.RReLU(0.1, 0.3, generator=torch.Generator().manual_seed(0))
    slopes = rrelu(-x) / -x
    assert 0.1 <= float(slopes.min()) and float(slopes.max()) <= 0.3
    assert abs(float(slopes.mean()) - 0.2) < 0.01
    rrelu.eval()
    torch.testing.assert_close(rrelu(-x), -x * 0.2, rtol=0, atol=0)
    sampler = T.GaussianSampler(generator=torch.Generator().manual_seed(1))
    mean_in, log_var = torch.full((4000, 50), 2.0), torch.full((4000, 50),
                                                              np.log(0.25))
    z = sampler([mean_in, log_var])
    assert abs(float(z.mean()) - 2.0) < 0.01
    assert abs(float(z.std()) - 0.5) < 0.01


def test_keras_layer_wrapper_infers_shapes_on_meta_and_refuses_config():
    lin = torch.nn.Linear(6, 3)
    wrapper = T.KerasLayerWrapper(lin, input_shape=(6,))
    assert wrapper.compute_output_shape((None, 6)) == (None, 3)
    model = Sequential(device="cpu")
    model.add(wrapper)
    assert set(wrapper.params()) == {"weight", "bias"}
    assert lin.weight.device.type == "cpu"
    x = torch.randn(2, 6)
    torch.testing.assert_close(wrapper(x), lin(x))
    with pytest.raises(NotImplementedError):
        wrapper.get_config()


def test_batchnorm_debias_after_training_matches_jax():
    """A BatchNormalization trained 5 steps (its moving statistics
    updated 5 times) predicts in eval mode as the JAX package's does.
    The debias divides by ``1 - momentum ** count`` (0.049 here), which
    magnifies the last bits of the statistics 20-fold, and the port takes
    it in f64 (from the f32 momentum ``jnp.power`` takes) where the JAX
    package takes it in f32.  So: the statistics within 1e-5; the eval
    output from the port's own statistics within 1e-5, and from the JAX
    package's statistics within 1e-6, each of the largest entry."""
    rng = np.random.default_rng(21)
    shape = (6, 6, 8)
    jl = J.BatchNormalization(name="t", input_shape=shape)
    params, state = jl.init(jax.random.PRNGKey(0), (None,) + shape)
    params = {k: (np.asarray(v) + 0.1 * _normal(rng, np.shape(v)))
              for k, v in params.items()}
    tl = T.BatchNormalization(name="t", input_shape=shape)
    model = port_model(tl, [shape])
    from_jax_params(model, {"t": params}, {"t": jax.device_get(state)})
    model.train(True)
    for _ in range(5):
        x = 1.5 + 2.0 * _normal(rng, (4,) + shape)
        _, state = jl.apply(params, state, jnp.asarray(x), training=True)
        tl(torch.from_numpy(x))
    state = jax.device_get(state)
    for k, v in state.items():
        close(tl.state()[k].numpy(), v, k)
    x = 1.5 + 2.0 * _normal(rng, (4,) + shape)
    ref = np.asarray(jl.apply(params, state, jnp.asarray(x))[0])
    bound = np.abs(ref).max()
    model.train(False)
    own = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(own, ref, rtol=0, atol=1e-5 * bound)
    from_jax_params(model, {"t": params}, {"t": state})
    out = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * bound)
    mean, var = tl.debiased_statistics()
    assert mean.dtype == var.dtype == torch.float32
