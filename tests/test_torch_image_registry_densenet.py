"""densenet-161 of the ImageClassifier registry on the port against the
JAX package's: ``tests/test_torch_image_registry.py``'s check (names,
shapes and ``predict`` within 1e-5 on the same weights and BatchNorm
state, 161 BatchNormalization layers), in a file of its own to keep each
file near half a minute on one worker.
"""

from test_torch_image_registry import check_arch


def test_densenet161_predicts_like_jax():
    check_arch("densenet-161")
