"""The Keras-1 API of the port: ``Sequential``, ``Model``, ``Input`` and
``load_model`` (from ``engine``), with ``layers``, ``objectives``,
``metrics`` and ``optimizers`` beside them.  The engine loads at first
use: it imports the trainer, which imports this package's metrics."""

from . import layers  # noqa: F401

_ENGINE_NAMES = ("Input", "KerasNet", "Model", "Sequential", "load_model")


def __getattr__(name):
    if name in _ENGINE_NAMES:
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
