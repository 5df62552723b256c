"""The autograd DSL: Variable ops, Parameter, Lambda, CustomLoss.

Counterpart of ``analytics_zoo_tpu/pipeline/api/autograd.py`` (the
reference's ``autograd`` package).  Every op is a node of the graph the
functional API builds (``core/graph.py``, ``ops/elementwise.py``), and
differentiation is torch's autograd through the whole graph, so custom
layers and losses need no backward of their own.  Axes index the full
array (batch = axis 0), as in the JAX package.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import numpy as np
import torch

from ...core.graph import GraphModule, Input, Variable
from ...core.module import Layer, register_layer
from ...ops import elementwise as _ops

# ---- module-level ops (the reference's autograd functions) ----
abs = _ops.abs  # noqa: A001
sum = _ops.sum  # noqa: A001
clip = _ops.clip
square = _ops.square
sqrt = _ops.sqrt
maximum = _ops.maximum
minimum = _ops.minimum
mean = _ops.mean
max = _ops.max  # noqa: A001
min = _ops.min  # noqa: A001
log = _ops.log
exp = _ops.exp
pow = _ops.pow  # noqa: A001
softsign = _ops.softsign
softplus = _ops.softplus
stack = _ops.stack
concat = _ops.concat
expand_dims = _ops.expand_dims
squeeze = _ops.squeeze
contiguous = _ops.contiguous
mm = _ops.mm
batch_dot = _ops.batch_dot
l2_normalize = _ops.l2_normalize
constant = _ops.constant
relu = _ops.relu
sigmoid = _ops.sigmoid
tanh = _ops.tanh
slice = _ops.slice  # noqa: A001
index_select = _ops.index_select
epsilon = _ops.epsilon


@register_layer
class ParameterLayer(Layer):
    """Zero-input node holding a standalone trainable weight, named
    ``weight`` as in the JAX package."""

    is_source = True
    needs_input_shape = False

    def __init__(self, shape=None, init_method="glorot_uniform",
                 init_weight=None, name=None, input_shape=None,
                 trainable=True):
        super().__init__(name=name, input_shape=input_shape,
                         trainable=trainable)
        self.shape = tuple(int(d) for d in shape)
        self.init_method = init_method
        self.init_weight = (np.asarray(init_weight, dtype=np.float32)
                            if init_weight is not None else None)

    def build_params(self, input_shape, generator):
        if self.init_weight is None:
            self.add_param("weight", self.init_method, self.shape, generator)
        else:
            self.register_parameter("weight", torch.nn.Parameter(
                torch.from_numpy(self.init_weight.copy()).to(
                    generator.device)))

    def forward(self):
        return self.weight

    def compute_output_shape(self, input_shape):
        return self.shape

    def get_config(self):
        cfg = super().get_config()
        cfg.update(shape=list(self.shape), init_method=self.init_method,
                   init_weight=None if self.init_weight is None
                   else self.init_weight.tolist(),
                   trainable=self.trainable)
        return cfg


def Parameter(shape, init_method="glorot_uniform", init_weight=None,
              name=None) -> Variable:
    """A trainable weight Variable for use inside expressions; ``shape``
    has no batch axis."""
    layer = ParameterLayer(shape=shape, init_method=init_method,
                           init_weight=init_weight, name=name)
    return Variable(layer, (), tuple(layer.shape), name=layer.name)


@register_layer
class Lambda(Layer):
    """A user function as a layer.  It receives a tensor (or, for
    several inputs, the tensors as arguments) and returns one; the output
    shape is inferred by running it on ``meta`` tensors at batch 2 (the
    JAX package traces it with ``jax.eval_shape``).  Functions are not
    serializable: a model with a Lambda saves and loads its weights, and
    needs the code to rebuild, as in the JAX package."""

    needs_input_shape = False

    def __init__(self, function: Callable = None, input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        if function is None:
            raise ValueError("Lambda requires a function")
        self.function = function

    def forward(self, inputs):
        if isinstance(inputs, (list, tuple)):
            return self.function(*inputs)
        return self.function(inputs)

    def compute_output_shape(self, input_shape):
        multi = isinstance(input_shape[0], (tuple, list))
        shapes = input_shape if multi else [input_shape]
        dummies = [torch.empty(tuple(2 if d is None else d for d in s),
                               device="meta") for s in shapes]
        out_shape = tuple(self.function(*dummies).shape)
        if shapes[0][0] is None and out_shape:
            return (None,) + out_shape[1:]
        return out_shape

    def get_config(self):
        cfg = super().get_config()
        cfg["function"] = None  # not serializable
        return cfg


class CustomLoss:
    """A loss from a function of (y_true, y_pred).

    ``loss_func(y_true, y_pred)`` receives the batch's tensors and
    returns per-sample losses or a scalar; an instance has the trainer's
    loss signature, so it goes to ``compile(loss=...)``.
    ``from_variables`` takes the reference's Variable-expression form.
    """

    def __init__(self, loss_func: Callable, y_pred_shape=None,
                 y_true_shape=None):
        self.loss_func = loss_func
        self.y_pred_shape = y_pred_shape
        self.y_true_shape = y_true_shape

    @classmethod
    def from_variables(cls, y_true: Variable, y_pred: Variable,
                       loss: Variable) -> "CustomLoss":
        """The loss that the graph from ``y_true``, ``y_pred`` to ``loss``
        computes.  A Parameter in it holds its seed-0 init (it is not
        trained, as in the JAX package), and the graph runs at inference
        (Dropout off, BatchNormalization on its moving statistics), as
        the JAX package applies it with ``training=False``.  The graph is
        built on the device of the tensors it is called with, one copy a
        device."""
        graph = GraphModule([y_true, y_pred], loss, name="custom_loss")
        built: Dict[torch.device, GraphModule] = {}

        def fn(yt, yp):
            g = built.get(yp.device)
            if g is None:
                g = built[yp.device] = copy.deepcopy(graph)
                g.build(None, torch.Generator(yp.device).manual_seed(0))
                g.eval()  # the loss graph runs at inference, as in JAX
            return g([yt, yp])

        return cls(fn)

    def __call__(self, y_true, y_pred):
        out = torch.as_tensor(self.loss_func(y_true, y_pred))
        if out.dim() == 0:
            # a scalar loss counts for every sample of the trainer's mean
            batch = (y_pred[0] if isinstance(y_pred, (list, tuple))
                     else y_pred).shape[0]
            return out.expand(batch)
        if out.dim() > 1:
            return out.mean(dim=tuple(range(1, out.dim())))
        return out

    def forward(self, y_true, y_pred) -> float:
        """The mean loss, as the reference's CustomLoss.forward."""
        with torch.no_grad():
            return float(torch.mean(self(torch.as_tensor(y_true),
                                         torch.as_tensor(y_pred))))

    def backward(self, y_true, y_pred) -> np.ndarray:
        """d(mean loss)/d(y_pred), as the reference's
        CustomLoss.backward, by autograd."""
        yp = torch.as_tensor(np.asarray(y_pred)).clone().requires_grad_()
        loss = torch.mean(self(torch.as_tensor(np.asarray(y_true)), yp))
        (grad,) = torch.autograd.grad(loss, yp)
        return grad.numpy()


#: the reference's name for Lambda
LambdaLayer = Lambda

__all__ = [
    "Variable", "Input", "Parameter", "ParameterLayer", "Lambda",
    "CustomLoss", "constant", "abs", "sum", "clip", "square", "sqrt",
    "maximum", "minimum", "mean", "max", "min", "log", "exp", "pow",
    "softsign", "softplus", "stack", "concat", "expand_dims", "squeeze",
    "contiguous", "mm", "batch_dot", "l2_normalize", "epsilon", "relu",
    "sigmoid", "tanh", "slice", "index_select",
]
