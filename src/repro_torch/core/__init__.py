"""The ICSML framework core in PyTorch (``repro.core``'s counterpart).

Public API:

* layers: :mod:`repro_torch.core.layers` (Dense, Activation, Concat, Conv2D, ...)
* graphs/models: :func:`repro_torch.core.model.sequential`, :class:`Model`,
  :class:`Graph`
* static memory planning: :func:`repro_torch.core.memory.plan_memory`
* quantization (§6.1): :func:`repro_torch.core.quantize.quantize_params`
* pruning (§6.2): :mod:`repro_torch.core.prune`
* multipart inference + scan-cycle runtime (§6.3): :mod:`repro_torch.core.runtime`
* porting methodology (§4.3): :mod:`repro_torch.core.porting`
"""

from repro_torch.core import (graph, layers, memory, model, porting, prune,
                              quantize, runtime)
from repro_torch.core.graph import Graph, Node, chain
from repro_torch.core.model import Model, ParamTree, sequential
from repro_torch.core.runtime import (MultipartInference, ScanCycleRuntime,
                                      SlidingWindowDetector)

__all__ = [
    "graph", "layers", "memory", "model", "porting", "prune", "quantize",
    "runtime", "Graph", "Node", "chain", "Model", "ParamTree", "sequential",
    "MultipartInference", "ScanCycleRuntime", "SlidingWindowDetector",
]
