"""TF interop: run user-written TensorFlow graphs with the port.

Counterpart of ``analytics_zoo_tpu/pipeline/api/tfgraph``: a frozen
GraphDef converts, op by op, into a torch function (:mod:`.converter`),
parsed by the port's own codec (:mod:`.proto`), so loading and running a
graph needs no TF; ``TFDataset``'s placeholders, ``TFOptimizer``,
``TFPredictor``, ``export_tf`` and ``TFNet.from_session`` take live TF
graphs and sessions and need tensorflow.
"""

from .converter import ConvertedGraph, convert_graph_def  # noqa: F401
from .dataset import TFDataset  # noqa: F401
from .net import TFNet, export_tf  # noqa: F401
from .optimizer import TFOptimizer, TFPredictor  # noqa: F401
