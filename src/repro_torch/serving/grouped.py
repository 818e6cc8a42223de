"""Heterogeneous model-group fleet serving: many detectors, one engine.

The counterpart of ``repro.serving.grouped``.  A fleet's
stream axis is partitioned into contiguous **model groups**
(:class:`ModelGroup`), each with its own model, detector head (and
calibrated threshold), §6.1 quantization scales, fused/per-layer flavor and
optional drift adaptation.  :class:`GroupedStreamEngine` is the many-model
façade over :class:`~repro_torch.serving.core.ServingCore` (one group = one
``ServingUnit``).

When the fleet packs (all-Dense stacks, one weight dtype per layer position,
the grouped kernel's shared-memory bill within Hopper's, every head with an
in-kernel epilogue), each verdict step whose ready groups share their ring
geometry is ONE ``grouped_fused_mlp`` launch on the card — a G-group fleet
is one launch per step, never G.  ``megakernel=False`` pins the per-group
path (each fusable group its own ``fused_mlp`` launch); ``megakernel=True``
raises with the packing reason when the fleet cannot pack.  Groups whose
windows differ fire on their own cadences and serve per group at the
boundaries where they cannot stack.  ``async_depth=1`` double-buffers the
whole step (verdicts bit-match sync mode one ready boundary later; drain
with ``flush()``).  ``Verdict.group`` names the group of each verdict.

**Sharding** composes per group: under the ``"data"`` axis of a fleet mesh
each group's arena is padded to the mesh (its own pad-stream contract) and
every rank serves its contiguous shard of every group; a ``("data",
"model")`` mesh also column-shards each group's wide layers (see
``serving/core.py``).  The megakernel stays off under a mesh unless
``megakernel=True``, which runs each rank's shard of the fleet as one
``grouped_fused_mlp`` launch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import msf_detector as spec
from repro_torch.core.model import Model, ParamTree
from repro_torch.device import Device
from repro_torch.serving.core import AdaptConfig, ServingCore, ServingUnit
from repro_torch.sim.heads import DetectorHead

__all__ = ["GroupedStreamEngine", "ModelGroup"]


@dataclasses.dataclass
class ModelGroup:
    """One detector population inside a grouped fleet.

    ``head`` defaults to the §7 classifier; ``fused`` follows the
    ``StreamEngine`` contract (None = auto, True = require the fused
    one-launch step, False = per-layer loop); ``adapt`` turns on streaming
    threshold recalibration for this group alone.
    """

    name: str
    model: Model
    params: ParamTree
    n_streams: int
    head: Optional[DetectorHead] = None
    fused: Optional[bool] = None
    adapt: Union[bool, AdaptConfig, None] = None


class GroupedStreamEngine(ServingCore):
    """Batched sliding-window serving over a heterogeneous detector fleet.

    ``groups`` partitions the global stream axis contiguously: group ``i``
    owns streams ``[sum(n_j for j < i), ...)``.  Call :meth:`ingest` with
    one ``(n_streams, n_features)`` reading block per scan cycle, exactly as
    ``StreamEngine``.

    ``device`` (default ``"cuda"``) is where the rings and steps run; every
    group's params must live there.  Without a card the default raises;
    pass ``device="cpu"`` for the plain PyTorch path.  ``backend`` follows
    ``kernels.ops``.  ``megakernel``: None packs the fleet into one launch
    per step when it can and the engine is unsharded, False pins the
    per-group path, True forces it (sharded steps included) and raises when
    the fleet cannot pack (:attr:`mega_reason` says why).  ``shard`` and
    ``mesh`` follow the ``StreamEngine`` contract; the auto mesh is never
    wider than the smallest group, and a wider explicit mesh still serves
    through each group's pad-stream contract.
    """

    def __init__(self, groups: Sequence[ModelGroup], *,
                 n_features: int = spec.N_FEATURES,
                 stride: int = spec.STRIDE,
                 deadline_s: float = spec.DEADLINE_S,
                 norm_mean: Sequence[float] = spec.NORM_MEAN,
                 norm_std: Sequence[float] = spec.NORM_STD,
                 backend: str = "auto",
                 shard: Optional[bool] = None,
                 mesh: Optional[DeviceMesh] = None,
                 async_depth: int = 0,
                 megakernel: Optional[bool] = None,
                 device: Device = "cuda"):
        if not groups:
            raise ValueError("need at least one ModelGroup")
        names = [g.name for g in groups]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate group names: {names}")
        super().__init__(
            [ServingUnit(name=g.name, model=g.model, params=g.params,
                         n_streams=g.n_streams, head=g.head, fused=g.fused,
                         adapt=g.adapt, what=f"group {g.name!r}: ")
             for g in groups],
            n_features=n_features, stride=stride, deadline_s=deadline_s,
            norm_mean=norm_mean, norm_std=norm_std, backend=backend,
            shard=shard, mesh=mesh, async_depth=async_depth,
            megakernel=megakernel, device=device)

    @property
    def groups(self) -> List[Tuple[str, int, int]]:
        """(name, first_stream, n_streams) per group, in stream order."""
        return [(st.name, st.offset, st.n_streams) for st in self._units]

    def group_windows(self) -> Dict[str, int]:
        """Verdicts emitted per group."""
        return {st.name: st.windows for st in self._units}

    def live_thresholds(self) -> Dict[str, Optional[float]]:
        """Each group's live threshold (None for threshold-free heads;
        equals the offline-calibrated cutoff until adaptation moves it)."""
        return {st.name: st.live_threshold for st in self._units}
