"""The ICSML framework core in PyTorch: layers, graphs, models and §6.1
quantization (``repro.core``'s counterpart)."""

from repro_torch.core.graph import Graph, Node, chain
from repro_torch.core.model import Model, ParamTree, sequential

__all__ = ["Graph", "Node", "chain", "Model", "ParamTree", "sequential"]
