"""The Keras-2 API of the port: Keras-2 argument names over the Keras-1
layers (``layers``), with the Keras-1 engine's ``Sequential``, ``Model``
and ``Input``."""

from .layers import (
    Dense, Activation, Dropout, Flatten, Conv1D, Conv2D, Cropping1D,
    LocallyConnected1D, MaxPooling1D, AveragePooling1D,
    GlobalMaxPooling1D, GlobalMaxPooling2D, GlobalMaxPooling3D,
    GlobalAveragePooling1D, GlobalAveragePooling2D, GlobalAveragePooling3D,
    Maximum, Minimum, Average, maximum, minimum, average)
from ....core.graph import Input


def __getattr__(name):
    # the engine imports the trainer, so it loads at first use, as in
    # pipeline.api.keras
    if name in ("Sequential", "Model"):
        from ..keras import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
