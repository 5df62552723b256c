"""The port's Keras-2 API (``pipeline/api/keras2``) against the JAX
package's: each layer's forward, input and parameter gradients within
1e-5 (the layer-set sweep's ``check``, weights carried across by
``from_jax_params``), its Keras-2 config equal to the JAX package's, the
``maximum``/``minimum``/``average`` helpers in a functional model, and a
small Keras-2 model trained in both packages."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import analytics_zoo_tpu.pipeline.api.keras2 as JK2
import analytics_zoo_tpu_torch.pipeline.api.keras2 as TK2
from analytics_zoo_tpu.core.module import name_scope as j_name_scope
from analytics_zoo_tpu_torch.core.module import name_scope
from test_torch_layer_set import check

MODULES = (JK2.layers, TK2.layers)


def _f(name, *args, **kw):
    return lambda L, s: getattr(L, name)(*args, input_shape=s, name="t",
                                         **kw)


CASES = {
    "Dense": (_f("Dense", 5, activation="relu"), (6,)),
    "Dense_nobias": (_f("Dense", 4, use_bias=False), (3, 6)),
    "Dropout": (_f("Dropout", 0.4), (6,)),
    "Conv1D": (_f("Conv1D", 4, 3, strides=2, padding="same"), (9, 3)),
    "Conv2D": (_f("Conv2D", 4, (3, 2), strides=(2, 1), padding="same",
                  activation="tanh"), (7, 6, 2)),
    "Conv2D_channels_first": (_f("Conv2D", 3, 3, data_format="th"),
                              (2, 6, 5)),
    "Cropping1D": (_f("Cropping1D", (2, 1)), (6, 3)),
    "LocallyConnected1D": (_f("LocallyConnected1D", 4, 3, strides=2),
                           (9, 3)),
    "MaxPooling1D": (_f("MaxPooling1D", 3, 2, padding="same"), (8, 3)),
    "AveragePooling1D": (_f("AveragePooling1D", 3, 2, padding="same"),
                         (8, 3)),
    "Activation": (_f("Activation", "softplus"), (6,)),
    "Flatten": (_f("Flatten"), (3, 4)),
    "GlobalMaxPooling2D": (_f("GlobalMaxPooling2D"), (4, 4, 3)),
    "GlobalAveragePooling1D": (_f("GlobalAveragePooling1D"), (5, 3)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_keras2_layer_matches_jax(name):
    factory, shape = CASES[name]
    check(factory, [shape], modules=MODULES)


@pytest.mark.parametrize("name", ["Maximum", "Minimum", "Average"])
def test_keras2_merges_match_jax(name):
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(3)]
    xs[1][0, :2] = xs[0][0, :2]  # ties
    check(lambda L, s: getattr(L, name)(name="t"), [(5,)] * 3, inputs=xs,
          modules=MODULES, jit=False)


def test_keras2_functional_helpers_and_model_train_as_jax():
    """A functional Keras-2 model (Dense, the three merge helpers) built
    in both packages under one name scope: predictions within 1e-5, and
    2 sgd steps on the same batch within 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    y = rng.normal(size=(8, 4)).astype(np.float32)

    def build(K, scope):
        with scope("k2"):
            inp = K.Input((6,))
            a = K.layers.Dense(4, activation="tanh")(inp)
            b = K.layers.Dense(4)(inp)
            c = K.layers.Dense(4, activation="relu")(inp)
            out = K.layers.average([K.layers.maximum([a, b]),
                                    K.layers.minimum([b, c]), a])
            return inp, out

    jin, jout = build(JK2, j_name_scope)
    jm = JK2.Model(input=jin, output=jout)
    tin, tout = build(TK2, name_scope)
    tm = TK2.Model(input=tin, output=tout, device="cpu")
    jm.compile(optimizer={"name": "sgd", "lr": 0.1}, loss="mse")
    jm.trainer.ensure_initialized()
    tm.set_weights(jax.device_get(jm.get_weights()))
    np.testing.assert_allclose(tm.predict(x), np.asarray(jm.predict(x)),
                               rtol=1e-5, atol=1e-6)
    tm.compile(optimizer={"name": "sgd", "lr": 0.1}, loss="mse")
    for _ in range(2):
        jm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)
        tm.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)
    jw, tw = jax.device_get(jm.get_weights()), tm.get_weights()
    for layer in jw:
        for k in jw[layer]:
            np.testing.assert_allclose(tw[layer][k], jw[layer][k],
                                       rtol=1e-5, atol=1e-6)
