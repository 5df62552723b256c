"""Two of the largest graphs of the ImageClassifier registry on the port
against the JAX package's: ``tests/test_torch_image_registry.py``'s
check (names, shapes and ``predict`` within 1e-5 on the same weights and
BatchNorm state) for inception-v1 and inception-v3 (75x75); densenet-161
is in ``tests/test_torch_image_registry_densenet.py``.
"""

import pytest

from test_torch_image_registry import check_arch


@pytest.mark.parametrize("arch", ["inception-v1", "inception-v3"])
def test_large_registry_arch_predicts_like_jax(arch):
    check_arch(arch)
