"""Every architecture of the ImageClassifier registry on the port against
the JAX package's, at a small input (32x32, 75x75 for inception-v3) with
7 classes, on the CPU: equal layer names and parameter and state shapes,
and ``predict`` within 1e-5 on the same weights and BatchNorm state
(moving statistics as five EMA updates toward random ones would leave
them, so eval mode's debias is exercised).  The three largest graphs
are in ``tests/test_torch_image_registry_large.py`` and
``tests/test_torch_image_registry_densenet.py``, so that each file stays
under a minute on one worker.
"""

import numpy as np
import pytest
import jax

from analytics_zoo_tpu.models.image import ImageClassifier as JImageClassifier
from analytics_zoo_tpu_torch.models import (ImageClassifier, from_jax_params,
                                            to_jax_state)

CLASSES = 7


def input_shape(arch):
    return (75, 75, 3) if arch == "inception-v3" else (32, 32, 3)


def ema_state(state, rng, count=5, momentum=0.99):
    """A JAX model_state as ``count`` EMA updates toward random
    statistics would leave it."""
    d = momentum ** count

    def leaf(shape):
        return {"moving_mean": ((1 - d) * rng.normal(0, 0.5, shape)).astype(
                    np.float32),
                "moving_var": (d + (1 - d) * rng.uniform(0.5, 2.0, shape)
                               ).astype(np.float32),
                "count": np.asarray(count, np.float32)}
    return {name: leaf(np.shape(leaves["moving_mean"]))
            for name, leaves in state.items()}


def check_arch(arch, seed=0):
    shape = input_shape(arch)
    jm = JImageClassifier(arch, input_shape=shape, num_classes=CLASSES)
    jm.ensure_inference_ready()
    st = jm.trainer.state
    params = jax.device_get(st.params)
    state = ema_state(jax.device_get(st.model_state),
                      np.random.default_rng(seed))
    st.model_state = jax.device_put(state)
    x = np.random.default_rng(seed + 1).normal(size=(4,) + shape).astype(
        np.float32)
    ref = np.asarray(jm.predict(x, batch_size=4))
    tm = ImageClassifier(arch, input_shape=shape, num_classes=CLASSES,
                         device="cpu")
    assert set(tm.get_weights()) == set(params)
    assert set(to_jax_state(tm)) == set(state)
    from_jax_params(tm, params, state)
    out = tm.predict(x, batch_size=4)
    assert out.shape == (4, CLASSES) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["resnet-50", "vgg-16", "vgg-19",
                                  "mobilenet", "mobilenet-v2",
                                  "squeezenet"])
def test_registry_arch_predicts_like_jax(arch):
    check_arch(arch)
