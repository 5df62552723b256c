"""Gradients at the clipping ties of the port's activations and losses
against ``jax.grad`` of the JAX package's functions, on the CPU.

The JAX package clips with ``jnp.clip``/``jnp.maximum``/``jnp.minimum``,
whose gradient at a tie with the bound is half the slope; ``torch.clamp``
passes all of it.  Each case puts inputs exactly on a bound: the
hard sigmoid at +-2.5 (0.1, not 0.2), relu6 at 0 and 6, hinge and
squared hinge at ``y * p = 1``, rank hinge at its margin, categorical
and sparse categorical crossentropy and KL divergence at p = 1, binary
crossentropy at ``EPS`` and ``1 - EPS``; a few points off the ties ride
along.  Gradients agree within 1e-6 (relative) of ``jax.grad``'s.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from analytics_zoo_tpu.pipeline.api.keras import activations as JA
from analytics_zoo_tpu.pipeline.api.keras import objectives as JO
from analytics_zoo_tpu_torch.pipeline.api.keras import activations as TA
from analytics_zoo_tpu_torch.pipeline.api.keras import objectives as TO

EPS = np.float32(TO.EPS)


def _grads(jfn, tfn, x, *rest):
    jg = jax.grad(lambda a: jnp.sum(jfn(a, *map(jnp.asarray, rest))))(
        jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    torch.sum(tfn(t, *map(torch.from_numpy, rest))).backward()
    return t.grad.numpy(), np.asarray(jg)


@pytest.mark.parametrize("name,points,at_tie", [
    ("hard_sigmoid", [-2.5, 2.5, 0.3, -3.0, 3.0], [0.1, 0.1, 0.2, 0, 0]),
    ("relu6", [0.0, 6.0, 3.0, -1.0, 7.0], [0.0, 0.5, 1.0, 0, 0]),
])
def test_clipping_activations_take_jax_tie_gradients(name, points, at_tie):
    x = np.array(points, np.float32)
    got, ref = _grads(getattr(JA, name), getattr(TA, name), x)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, at_tie, rtol=1e-6, atol=0)


def _swap(fn):
    """A loss as f(y_pred, y_true), so the first argument is the
    differentiated one."""
    return lambda p, y: fn(y, p)


LOSS_CASES = [
    # (loss name, y_pred, y_true): y_pred on the bound in the first entries
    ("hinge", [[1.0, -1.0, 0.5]], [[1.0, 1.0, -1.0]]),
    ("squared_hinge", [[1.0, -1.0, 0.5]], [[1.0, -1.0, 1.0]]),
    ("categorical_crossentropy", [[1.0, 0.0, 0.0], [0.2, 0.3, 0.5]],
     [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
    ("kullback_leibler_divergence", [[1.0, 0.0, 0.0], [0.2, 0.3, 0.5]],
     [[0.7, 0.2, 0.1], [0.1, 0.1, 0.8]]),
    ("binary_crossentropy", [[EPS, 1.0 - EPS, 0.3, 0.0, 1.0]],
     [[1.0, 0.0, 1.0, 1.0, 0.0]]),
    ("mean_squared_logarithmic_error", [[EPS, 0.5, -1.0]], [[1.0, 2.0, 0.0]]),
    ("cosine_proximity", [[0.6, 0.8], [3.0, 4.0]], [[1.0, 0.0], [0.0, 1.0]]),
]


@pytest.mark.parametrize("name,y_pred,y_true", LOSS_CASES,
                         ids=[c[0] for c in LOSS_CASES])
def test_losses_take_jax_tie_gradients(name, y_pred, y_true):
    p = np.array(y_pred, np.float32)
    y = np.array(y_true, np.float32)
    got, ref = _grads(_swap(getattr(JO, name)), _swap(getattr(TO, name)), p,
                      y)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_sparse_categorical_crossentropy_at_probability_one():
    p = np.array([[1.0, 0.0, 0.0], [0.1, 0.6, 0.3]], np.float32)
    y = np.array([0, 1], np.int32)
    got, ref = _grads(_swap(JO.sparse_categorical_crossentropy),
                      _swap(TO.sparse_categorical_crossentropy), p, y)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert got[0, 0] == pytest.approx(-0.5)  # half of -1/p at the tie


def test_rank_hinge_at_its_margin():
    # pairs (pos, neg): margin - pos + neg = 0 for the first pair
    p = np.array([[1.5], [0.5], [2.0], [0.5]], np.float32)
    got, ref = _grads(lambda a, y: JO.rank_hinge(y, a),
                      lambda a, y: TO.rank_hinge(y, a), p,
                      np.zeros((4, 1), np.float32))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[:2, 0], [-1.0, 1.0])  # 2 x half
