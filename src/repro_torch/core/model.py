"""ICSML Models: an array of layers wired together + an inference method (§4.1).

The counterpart of ``repro.core.model``.  Two execution modes, held equal:

* :meth:`Model.apply` — value-table execution in linear-schedule order (how
  a conventional framework would do it).
* :meth:`Model.apply_planned` — ICSML execution: every activation lives at
  its statically planned offset inside one flat f32 arena (see
  :mod:`repro_torch.core.memory`), and layers run strictly in the linear
  schedule (§4.2.1 + §4.2.3).  :meth:`Model.apply_segment` runs a slice of
  the schedule over an existing arena, for multipart inference (§6.3).

Node uids come from the same :func:`~repro_torch.core.graph.chain` as the
reference's ``sequential``, so a param tree of either package lines up node
for node (see :mod:`repro_torch.bridge`).  Arenas are allocated on the
device of the input they serve.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import memory as memlib
from repro_torch.core.graph import Graph, chain
from repro_torch.core.layers import Layer, Params
from repro_torch.device import Device, resolve_device

ParamTree = Dict[int, Params]


@dataclasses.dataclass(frozen=True)
class Model:
    """A statically planned ICSML model."""

    graph: Graph
    input_shape: Tuple[int, ...]

    # ------------------------------------------------------------------ setup
    def init_params(self, generator: torch.Generator, *,
                    device: Device = "cuda") -> ParamTree:
        """Glorot-initialised params drawn from ``generator`` (a CPU
        generator: the draws do not depend on ``device``), placed on
        ``device``."""
        dev = resolve_device(device)
        in_shapes = self.node_in_shapes()
        return {node.uid: {k: v.to(dev) for k, v in node.layer.init_params(
                    generator, in_shapes[node.uid]).items()}
                for node in self.graph.nodes}

    def memory_plan(self, *, reuse: bool = True) -> memlib.MemoryPlan:
        return memlib.plan_memory(self.graph, self.input_shape, reuse=reuse)

    # -------------------------------------------------------------- accounting
    def node_in_shapes(self) -> Dict[int, List[Tuple[int, ...]]]:
        shapes = self.graph.infer_shapes(self.input_shape)
        return {
            n.uid: ([shapes[r] for r in n.inputs] or [self.input_shape])
            for n in self.graph.nodes
        }

    def param_bytes(self) -> int:
        in_shapes = self.node_in_shapes()
        return sum(
            n.layer.param_bytes(in_shapes[n.uid]) for n in self.graph.nodes
        )

    def flops(self) -> int:
        in_shapes = self.node_in_shapes()
        return sum(n.layer.flops(in_shapes[n.uid]) for n in self.graph.nodes)

    def node_flops(self) -> Dict[int, int]:
        in_shapes = self.node_in_shapes()
        return {n.uid: n.layer.flops(in_shapes[n.uid]) for n in self.graph.nodes}

    # -------------------------------------------------------------- execution
    def apply(self, params: ParamTree, x: torch.Tensor) -> torch.Tensor:
        """Reference (value-table) execution in linear-schedule order."""
        values: Dict[int, torch.Tensor] = {}
        for node in self.graph.nodes:
            inputs = [values[r] for r in node.inputs] or [x]
            values[node.uid] = node.layer.apply(params[node.uid], inputs)
        return values[self.graph.output_uid]

    def apply_planned(self, params: ParamTree, x: torch.Tensor) -> torch.Tensor:
        """Planned (arena) execution — activations live in one flat buffer."""
        arena, plan = self._run_arena(params, x)
        return memlib.arena_read(arena, plan.buffers[self.graph.output_uid])

    def _run_arena(
        self, params: ParamTree, x: torch.Tensor, upto: Optional[int] = None
    ) -> Tuple[torch.Tensor, memlib.MemoryPlan]:
        plan = self.memory_plan()
        arena = memlib.new_arena(plan, x.device)
        stop = len(self.graph.nodes) if upto is None else upto
        return self.apply_segment(params, arena, x, 0, stop, plan), plan

    def apply_segment(
        self,
        params: ParamTree,
        arena: torch.Tensor,
        x: torch.Tensor,
        start: int,
        stop: int,
        plan: Optional[memlib.MemoryPlan] = None,
    ) -> torch.Tensor:
        """Evaluate schedule positions [start, stop) over an existing arena
        (multipart inference, §6.3); the arena is written in place and
        returned."""
        plan = plan or self.memory_plan()
        for node in self.graph.nodes[start:stop]:
            if node.inputs:
                inputs = [memlib.arena_read(arena, plan.buffers[r])
                          for r in node.inputs]
            else:
                inputs = [x]
            out = node.layer.apply(params[node.uid], inputs)
            arena = memlib.arena_write(arena, plan.buffers[node.uid], out)
        return arena

    def read_output(self, arena: torch.Tensor,
                    plan: Optional[memlib.MemoryPlan] = None) -> torch.Tensor:
        plan = plan or self.memory_plan()
        return memlib.arena_read(arena, plan.buffers[self.graph.output_uid])

    # ------------------------------------------------------------------- misc
    def summary(self) -> str:
        shapes = self.graph.infer_shapes(self.input_shape)
        in_shapes = self.node_in_shapes()
        lines = ["uid  layer                     out_shape        params(B)   flops"]
        for n in self.graph.nodes:
            lines.append(
                f"{n.uid:<4d} {type(n.layer).__name__:<25s} "
                f"{str(shapes[n.uid]):<16s} "
                f"{n.layer.param_bytes(in_shapes[n.uid]):<11d} "
                f"{n.layer.flops(in_shapes[n.uid])}"
            )
        plan = self.memory_plan()
        lines.append(f"arena: {plan.arena_bytes} B, params: {self.param_bytes()} B")
        return "\n".join(lines)


def sequential(layers: Sequence[Layer], input_shape: Sequence[int]) -> Model:
    """Convenience: build the common sequential model."""
    return Model(graph=chain(layers), input_shape=tuple(input_shape))
