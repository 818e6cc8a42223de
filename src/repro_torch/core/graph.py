"""Layer graph and linear (non-chained) execution schedule.

ICSML (§4.2.3) evaluates models by *linearly* calling layer evaluation
functions over shared memory areas, because IEC 61131-3 forbids recursion and
chained function-block calls.  The analogue here is an explicit, ahead-of-time
topological schedule over a DAG of layer nodes (a copy of ``repro.core.graph``,
which is pure Python): no recursion appears in the forward pass.

A :class:`Graph` is a list of :class:`Node` objects.  Each node names its
input nodes by id; node 0 conventionally is the model input.  The linear
schedule is just a validated topological order — for ICSML models the authoring
order *is* the schedule (models are "an array of layers wired together").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.layers import Layer


class GraphError(ValueError):
    """Raised for malformed layer graphs (cycles, dangling refs, ...)."""


@dataclasses.dataclass(frozen=True)
class Node:
    """One entry of the model's layer array.

    Attributes:
      uid:    integer id, unique within the graph.
      layer:  the :class:`~repro_torch.core.layers.Layer` evaluated at this node.
      inputs: uids of producer nodes (empty for the input node).
    """

    uid: int
    layer: Layer
    inputs: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class Graph:
    """A DAG of layers with a validated linear schedule."""

    nodes: Tuple[Node, ...]

    def __post_init__(self) -> None:
        seen: set = set()
        for node in self.nodes:
            if node.uid in seen:
                raise GraphError(f"duplicate node uid {node.uid}")
            for ref in node.inputs:
                if ref not in seen:
                    raise GraphError(
                        f"node {node.uid} reads {ref} before it is produced; "
                        "the layer array must be a valid linear schedule "
                        "(ICSML forbids forward/recursive references)"
                    )
            seen.add(node.uid)

    @property
    def schedule(self) -> Tuple[int, ...]:
        """The linear evaluation order (authoring order, validated acyclic)."""
        return tuple(n.uid for n in self.nodes)

    @property
    def output_uid(self) -> int:
        return self.nodes[-1].uid

    def node(self, uid: int) -> Node:
        for n in self.nodes:
            if n.uid == uid:
                return n
        raise GraphError(f"no node with uid {uid}")

    def consumers(self) -> Dict[int, List[int]]:
        """Map producer uid -> list of consumer uids (for liveness analysis)."""
        out: Dict[int, List[int]] = {n.uid: [] for n in self.nodes}
        for n in self.nodes:
            for ref in n.inputs:
                out[ref].append(n.uid)
        return out

    def last_use(self) -> Dict[int, int]:
        """Map uid -> schedule position of its last consumer.

        The model output is considered live until the end of the schedule.
        Used by the static memory planner to compute liveness intervals.
        """
        pos = {uid: i for i, uid in enumerate(self.schedule)}
        last = {n.uid: pos[n.uid] for n in self.nodes}
        for n in self.nodes:
            for ref in n.inputs:
                last[ref] = max(last[ref], pos[n.uid])
        last[self.output_uid] = len(self.nodes) - 1
        return last

    def infer_shapes(self, input_shape: Sequence[int]) -> Dict[int, Tuple[int, ...]]:
        """Propagate static shapes through the schedule.

        Mirrors ICSML's structured declaration of layer sizes via constants:
        every buffer size is known before anything executes.
        """
        shapes: Dict[int, Tuple[int, ...]] = {}
        for node in self.nodes:
            in_shapes = [shapes[r] for r in node.inputs]
            if not in_shapes:
                in_shapes = [tuple(int(d) for d in input_shape)]
            shapes[node.uid] = node.layer.out_shape(in_shapes)
        return shapes


def chain(layers: Sequence[Layer]) -> Graph:
    """Build the common case: a purely sequential model (array of layers)."""
    nodes = []
    for i, layer in enumerate(layers):
        nodes.append(Node(uid=i, layer=layer, inputs=() if i == 0 else (i - 1,)))
    return Graph(nodes=tuple(nodes))
