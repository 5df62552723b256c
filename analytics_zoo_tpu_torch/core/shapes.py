"""Shape utilities for Keras-1-style shape inference.

Counterpart of ``analytics_zoo_tpu/core/shapes.py`` (a copy: the port
imports nothing of the JAX package).  Shapes are plain tuples whose
leading batch dimension is ``None``; layers infer their parameter widths
from them when a model builds them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

Shape = Tuple[Optional[int], ...]


def to_batch_shape(input_shape: Sequence[Optional[int]]) -> Shape:
    """Prepend a ``None`` batch dim to a per-sample shape."""
    return (None,) + tuple(int(d) for d in input_shape)


def drop_batch(shape: Shape) -> Tuple[int, ...]:
    return tuple(shape[1:])


def is_shape(x) -> bool:
    return isinstance(x, (tuple, list)) and all(
        d is None or isinstance(d, int) for d in x
    )


def merge_batch(shapes: Sequence[Shape]) -> Optional[int]:
    """Return the common batch dim of several shapes (None if unknown)."""
    batch = None
    for s in shapes:
        if s and s[0] is not None:
            if batch is not None and batch != s[0]:
                raise ValueError(f"Incompatible batch dims: {batch} vs {s[0]}")
            batch = s[0]
    return batch


def conv_output_length(
    input_length: Optional[int],
    filter_size: int,
    border_mode: str,
    stride: int,
    dilation: int = 1,
) -> Optional[int]:
    """Keras-1 convolution length arithmetic (border_mode in {same, valid, full, causal})."""
    if input_length is None:
        return None
    dilated = filter_size + (filter_size - 1) * (dilation - 1)
    if border_mode in ("same", "causal"):
        out = input_length
    elif border_mode == "valid":
        out = input_length - dilated + 1
    elif border_mode == "full":
        out = input_length + dilated - 1
    else:
        raise ValueError(f"Unknown border_mode {border_mode!r}")
    result = (out + stride - 1) // stride
    if result <= 0:
        raise ValueError(
            f"Convolution output length is {result} (input {input_length}, "
            f"filter {filter_size}, stride {stride}, {border_mode}): input "
            "too small for this layer stack")
    return result


def deconv_output_length(
    input_length: Optional[int], filter_size: int, border_mode: str, stride: int
) -> Optional[int]:
    if input_length is None:
        return None
    out = input_length * stride
    if border_mode == "valid":
        out += max(filter_size - stride, 0)
    return out


def pool_output_length(
    input_length: Optional[int], pool_size: int, border_mode: str, stride: int
) -> Optional[int]:
    if input_length is None:
        return None
    if border_mode == "same":
        result = math.ceil(input_length / stride)
    else:
        result = (input_length - pool_size) // stride + 1
    if result <= 0:
        raise ValueError(
            f"Pooling output length is {result} (input {input_length}, "
            f"pool {pool_size}, stride {stride}, {border_mode}): input "
            "too small for this layer stack")
    return result


def normalize_tuple(value, n: int, name: str = "value") -> Tuple[int, ...]:
    """Accept int or length-n sequence; return an n-tuple of ints."""
    if isinstance(value, int):
        return (value,) * n
    value = tuple(int(v) for v in value)
    if len(value) != n:
        raise ValueError(f"{name} must be an int or length-{n} tuple, got {value}")
    return value


def normalize_data_format(value: Optional[str]) -> str:
    """Map Keras-1 dim_ordering / Keras-2 data_format spellings to canonical form.

    The default is channels_last (NHWC), the JAX package's layout;
    ``th``/``channels_first`` inputs are accepted for API parity with the
    reference and transposed at the layer boundary.
    """
    if value is None:
        return "channels_last"
    v = value.lower()
    if v in ("tf", "channels_last", "nhwc"):
        return "channels_last"
    if v in ("th", "channels_first", "nchw"):
        return "channels_first"
    raise ValueError(f"Unknown data format {value!r}")


def same_padding(input_length: int, filter_size: int, stride: int,
                 dilation: int = 1) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``SAME``: ``max((ceil(n / s) - 1) * s
    + (k - 1) * d + 1 - n, 0)`` in all, the odd element on the high side.
    Symmetric padding (``F.conv2d(padding="same")``) differs when the total
    is odd, and refuses stride > 1."""
    out = -(-input_length // stride)
    total = max((out - 1) * stride + (filter_size - 1) * dilation + 1
                - input_length, 0)
    return total // 2, total - total // 2
