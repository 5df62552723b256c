"""The port's recurrent layers against real tf.keras (Keras 3), on the CPU.

Counterpart of the recurrent cases of ``tests/test_keras_oracle.py``
(SimpleRNN, LSTM, GRU with ``reset_after=False``, ConvLSTM2D and
Bidirectional, with the sigmoid inner activation on which both
frameworks agree): the port's layer draws its own weights, the keras
layer takes them through the same converter (``[W, U, b]``, forward
then backward for Bidirectional), and the outputs (inference mode),
shape inference, the input gradient and every weight gradient of
``sum(out * w)`` agree at that file's tolerances (1e-3 forward, 1e-2
gradients).
"""

import numpy as np
import pytest
import torch
import tensorflow as tf
from tensorflow import keras as K

from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

B = 4
FWD_TOL = dict(rtol=1e-3, atol=1e-3)
GRAD_TOL = dict(rtol=1e-2, atol=1e-2)

rnn_conv = lambda p: [p["W"], p["U"], p["b"]]
bidir_conv = lambda p: rnn_conv(p["forward"]) + rnn_conv(p["backward"])

SPECS = [
    ("simplernn", lambda: L.SimpleRNN(5, activation="tanh"),
     lambda: K.layers.SimpleRNN(5, activation="tanh"), (7, 4), rnn_conv),
    ("simplernn_seq", lambda: L.SimpleRNN(5, return_sequences=True),
     lambda: K.layers.SimpleRNN(5, return_sequences=True), (7, 4),
     rnn_conv),
    ("lstm", lambda: L.LSTM(5, inner_activation="sigmoid"),
     lambda: K.layers.LSTM(5, recurrent_activation="sigmoid"), (7, 4),
     rnn_conv),
    ("lstm_seq",
     lambda: L.LSTM(5, inner_activation="sigmoid", return_sequences=True),
     lambda: K.layers.LSTM(5, recurrent_activation="sigmoid",
                           return_sequences=True), (7, 4), rnn_conv),
    ("lstm_backwards",
     lambda: L.LSTM(5, inner_activation="sigmoid", go_backwards=True),
     lambda: K.layers.LSTM(5, recurrent_activation="sigmoid",
                           go_backwards=True), (7, 4), rnn_conv),
    ("gru", lambda: L.GRU(5, inner_activation="sigmoid"),
     lambda: K.layers.GRU(5, recurrent_activation="sigmoid",
                          reset_after=False), (7, 4), rnn_conv),
    ("gru_seq",
     lambda: L.GRU(5, inner_activation="sigmoid", return_sequences=True),
     lambda: K.layers.GRU(5, recurrent_activation="sigmoid",
                          reset_after=False, return_sequences=True),
     (7, 4), rnn_conv),
    ("convlstm2d",
     lambda: L.ConvLSTM2D(4, 3, inner_activation="sigmoid"),
     lambda: K.layers.ConvLSTM2D(4, 3, padding="same",
                                 recurrent_activation="sigmoid"),
     (5, 6, 6, 2), rnn_conv),
    ("convlstm2d_seq",
     lambda: L.ConvLSTM2D(4, 3, inner_activation="sigmoid",
                          return_sequences=True),
     lambda: K.layers.ConvLSTM2D(4, 3, padding="same",
                                 recurrent_activation="sigmoid",
                                 return_sequences=True),
     (5, 6, 6, 2), rnn_conv),
    ("bidirectional_lstm",
     lambda: L.Bidirectional(L.LSTM(4, inner_activation="sigmoid",
                                    return_sequences=True)),
     lambda: K.layers.Bidirectional(K.layers.LSTM(
         4, recurrent_activation="sigmoid", return_sequences=True)),
     (6, 3), bidir_conv),
    ("bidirectional_gru_sum",
     lambda: L.Bidirectional(L.GRU(4, inner_activation="sigmoid",
                                   return_sequences=True),
                             merge_mode="sum"),
     lambda: K.layers.Bidirectional(
         K.layers.GRU(4, recurrent_activation="sigmoid", reset_after=False,
                      return_sequences=True), merge_mode="sum"),
     (6, 3), bidir_conv),
]


#: a Bidirectional's param subtrees and the modules that hold them
MODULE_OF = {"forward": "layer.", "backward": "backward_layer."}


@pytest.mark.parametrize("spec", SPECS, ids=[s[0] for s in SPECS])
def test_torch_recurrent_vs_keras(spec):
    _, port_fn, keras_fn, shape, conv = spec
    rng = np.random.default_rng(12345)
    x = rng.normal(size=(B,) + shape).astype(np.float32)
    layer = port_fn()
    layer.build((B,) + shape, torch.Generator("cpu").manual_seed(0))
    params = layer.params()

    def as_numpy(tree):
        return {k: (as_numpy(v) if isinstance(v, dict)
                    else v.detach().numpy()) for k, v in tree.items()}

    keras_layer = keras_fn()
    keras_layer(tf.constant(x))
    keras_layer.set_weights(conv(as_numpy(params)))
    k_out = np.asarray(keras_layer(tf.constant(x)))

    xt = torch.tensor(x, requires_grad=True)
    out = layer(xt)
    assert tuple(out.shape) == k_out.shape
    assert tuple(layer.compute_output_shape((B,) + shape)) == k_out.shape
    np.testing.assert_allclose(out.detach().numpy(), k_out, **FWD_TOL)

    w = rng.normal(size=k_out.shape).astype(np.float32)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)),
                                [xt] + list(layer.parameters()))
    names = [n for n, _ in layer.named_parameters()]
    by_name = dict(zip(names, grads[1:]))

    def grad_tree(tree, prefix=""):
        return {k: (grad_tree(v, prefix + MODULE_OF[k])
                    if isinstance(v, dict)
                    else by_name[prefix + k].numpy())
                for k, v in tree.items()}

    xv = tf.Variable(x)
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(keras_layer(xv) * w)
    k_grads = tape.gradient(loss, [xv] + list(keras_layer.trainable_variables))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(k_grads[0]),
                               **GRAD_TOL, err_msg="input gradient")
    port_wgrads = conv(grad_tree(params))
    assert len(port_wgrads) == len(k_grads) - 1
    for pg, kg, v in zip(port_wgrads, k_grads[1:],
                         keras_layer.trainable_variables):
        np.testing.assert_allclose(pg, np.asarray(tf.convert_to_tensor(kg)),
                                   **GRAD_TOL, err_msg=v.name)
