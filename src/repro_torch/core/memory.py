"""Static memory planner — ICSML's ``dataMem`` (§4.2.1) in PyTorch, the
counterpart of ``repro.core.memory``.

IEC 61131-3 has no dynamic memory management, so ICSML statically declares
every activation buffer and wraps the raw memory areas in ``dataMem``
structures carrying address + dimensionality metadata; layers share these
areas by reference, so one flat region backs many logical buffers.

* :func:`plan_memory` gives every activation buffer of the linear schedule a
  liveness interval and packs the buffers into one flat arena by first-fit
  offset assignment (buffers whose lifetimes do not overlap share memory).
  Plans are integers computed on the host, equal field for field to the
  reference's plan of the same graph.
* :class:`MemoryPlan` is the dataMem table; ``validate()`` proves the
  no-overlap invariant.
* :func:`arena_write` / :func:`arena_read` are the accessors of planned
  execution (``Model.apply_planned``): activations live in one f32 tensor on
  the model's device, written in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core.graph import Graph

Shape = Tuple[int, ...]

# Buffer offsets and sizes are rounded up to 128 f32 elements, as the
# reference rounds them, so offsets and the arena bytes of the §5.1
# accounting are the reference's.  (The PLC analogue is word alignment.)
DEFAULT_ALIGN = 128


@dataclasses.dataclass(frozen=True)
class BufferInfo:
    """One dataMem entry: a buffer's address + metadata (§4.2.1)."""

    uid: int                 # producing node
    offset: int              # element offset into the arena
    size: int                # number of elements
    shape: Shape             # logical dimensionality ("dimensions" metadata)
    live: Tuple[int, int]    # [first, last] schedule positions (inclusive)

    @property
    def end(self) -> int:
        return self.offset + self.size


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """The static activation-memory plan for one model."""

    arena_size: int                      # elements (f32)
    buffers: Dict[int, BufferInfo]

    @property
    def arena_bytes(self) -> int:
        return self.arena_size * 4

    def validate(self) -> None:
        """No two *concurrently live* buffers may overlap, and every buffer
        must fit in the arena.  Raises ``ValueError`` on violation."""
        infos = list(self.buffers.values())
        for b in infos:
            if b.offset < 0 or b.end > self.arena_size:
                raise ValueError(f"buffer {b.uid} [{b.offset},{b.end}) outside arena")
            if b.live[0] > b.live[1]:
                raise ValueError(f"buffer {b.uid} has empty liveness {b.live}")
        for i, a in enumerate(infos):
            for b in infos[i + 1:]:
                lives_overlap = not (a.live[1] < b.live[0] or b.live[1] < a.live[0])
                mem_overlap = not (a.end <= b.offset or b.end <= a.offset)
                if lives_overlap and mem_overlap:
                    raise ValueError(
                        f"live buffers overlap: {a.uid}@[{a.offset},{a.end}) "
                        f"live{a.live} vs {b.uid}@[{b.offset},{b.end}) live{b.live}"
                    )


def _align(x: int, align: int) -> int:
    return ((x + align - 1) // align) * align


def plan_memory(
    graph: Graph,
    input_shape: Sequence[int],
    *,
    align: int = DEFAULT_ALIGN,
    reuse: bool = True,
) -> MemoryPlan:
    """First-fit static packing of activation buffers.

    With ``reuse=False`` every buffer gets a private region (the naive layout
    ICSML models declare by hand); with ``reuse=True`` dead buffers' space is
    recycled — the paper's dataMem sharing, automated.  Both layouts satisfy
    ``validate()``.
    """
    shapes = graph.infer_shapes(input_shape)
    last_use = graph.last_use()
    pos = {uid: i for i, uid in enumerate(graph.schedule)}

    buffers: Dict[int, BufferInfo] = {}
    allocated: List[BufferInfo] = []
    arena_end = 0

    for node in graph.nodes:
        uid = node.uid
        size = _align(max(1, math.prod(shapes[uid]) if shapes[uid] else 1), align)
        first = pos[uid]
        last = last_use[uid]

        if reuse:
            # First-fit: the lowest gap not overlapping any buffer live
            # during [first, last].
            live_now = sorted(
                (b for b in allocated if b.live[1] >= first),
                key=lambda b: b.offset,
            )
            cursor = 0
            for b in live_now:
                if b.offset - cursor >= size:
                    break
                cursor = max(cursor, b.end)
            offset = cursor
        else:
            offset = arena_end

        info = BufferInfo(uid=uid, offset=offset, size=size,
                          shape=shapes[uid], live=(first, last))
        buffers[uid] = info
        allocated.append(info)
        arena_end = max(arena_end, info.end)

    plan = MemoryPlan(arena_size=max(arena_end, align), buffers=buffers)
    plan.validate()
    return plan


# ---------------------------------------------------------------------------
# Arena accessors (planned execution)
# ---------------------------------------------------------------------------


def new_arena(plan: MemoryPlan, device: torch.device) -> torch.Tensor:
    """A zeroed f32 arena for ``plan`` on ``device``."""
    return torch.zeros((plan.arena_size,), dtype=torch.float32, device=device)


def arena_write(arena: torch.Tensor, info: BufferInfo,
                value: torch.Tensor) -> torch.Tensor:
    """Store ``value`` (any shape) into its dataMem region of the flat arena,
    in place, zero-filling the region's padded tail as the reference does;
    returns the arena."""
    flat = value.reshape(-1).to(arena.dtype)
    n = flat.shape[0]
    arena[info.offset:info.offset + n] = flat
    if n < info.size:
        arena[info.offset + n:info.end].zero_()
    return arena


def arena_read(arena: torch.Tensor, info: BufferInfo) -> torch.Tensor:
    """The logical tensor of a buffer, a view into the arena."""
    n = math.prod(info.shape) if info.shape else 1
    return arena[info.offset:info.offset + n].view(info.shape)


def activation_bytes(graph: Graph, input_shape: Sequence[int]) -> Dict[str, int]:
    """Memory accounting used by the §5.1 benchmark: naive vs planned arena."""
    naive = plan_memory(graph, input_shape, reuse=False)
    packed = plan_memory(graph, input_shape, reuse=True)
    return {"naive": naive.arena_bytes, "planned": packed.arena_bytes}
