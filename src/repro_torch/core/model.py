"""ICSML Models: an array of layers wired together + an inference method (§4.1).

The counterpart of ``repro.core.model``: :meth:`Model.apply` evaluates the
layer graph over a per-node value table in linear-schedule order.  Node uids
come from the same :func:`~repro_torch.core.graph.chain` as the reference's
``sequential``, so a param tree of either package lines up node for node
(see :mod:`repro_torch.bridge`).  The reference's planned-arena execution
(``apply_planned``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.graph import Graph, chain
from repro_torch.core.layers import Layer, Params
from repro_torch.device import Device, resolve_device

ParamTree = Dict[int, Params]


@dataclasses.dataclass(frozen=True)
class Model:
    """A statically shaped ICSML model."""

    graph: Graph
    input_shape: Tuple[int, ...]

    def init_params(self, generator: torch.Generator, *,
                    device: Device = "cuda") -> ParamTree:
        """Glorot-initialised params drawn from ``generator`` (a CPU
        generator: the draws do not depend on ``device``), placed on
        ``device``."""
        dev = resolve_device(device)
        shapes = self.graph.infer_shapes(self.input_shape)
        params: ParamTree = {}
        for node in self.graph.nodes:
            in_shapes = [shapes[r] for r in node.inputs] or [self.input_shape]
            params[node.uid] = {
                k: v.to(dev) for k, v in
                node.layer.init_params(generator, in_shapes).items()}
        return params

    def apply(self, params: ParamTree, x: torch.Tensor) -> torch.Tensor:
        """Reference (value-table) execution in linear-schedule order."""
        values: Dict[int, torch.Tensor] = {}
        for node in self.graph.nodes:
            inputs = [values[r] for r in node.inputs] or [x]
            values[node.uid] = node.layer.apply(params[node.uid], inputs)
        return values[self.graph.output_uid]


def sequential(layers: Sequence[Layer], input_shape: Sequence[int]) -> Model:
    """Convenience: build the common sequential model."""
    return Model(graph=chain(layers), input_shape=tuple(input_shape))
