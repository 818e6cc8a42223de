"""Fleet-scale streaming anomaly detection: many plants, one detector step.

:class:`StreamEngine` serves a fleet of plants with the §7 detector: it
ingests one reading per plant per scan cycle, keeps a per-stream ring-buffer
sliding window (2 features x 10 Hz x 20 s = 400 inputs), and when windows
complete runs all ready streams through one step — ring scatter, window
unroll, the batched detector forward and the head's epilogue — on the card.
For all-Dense models (the detector) the forward is ONE ``fused_mlp`` kernel
launch per verdict step; with ``fused=False`` it is one launch per layer
(``qmatmul`` for SINT layers).

This is the one-model façade over :class:`~repro_torch.serving.core.
ServingCore`, the counterpart of ``repro.serving.streams.StreamEngine`` (a
fleet of different models is ``GroupedStreamEngine``).

**Fleet sharding.**  Under a ``torch.distributed`` fleet mesh
(``launch.mesh.make_fleet_mesh``; one process per rank) every rank ingests
the whole fleet's readings, keeps its contiguous shard of the streams over
the ``"data"`` axis and runs the step on it (the fused kernel included, one
launch per rank per step); one gather over ``"data"`` a step gives every
rank the whole fleet's outputs, and every rank returns the same verdicts.
A ``("data", "model")`` mesh also column-shards wide Dense layers, one
gather over ``"model"`` each (see ``serving/core.py``).  Fleets that do not
divide by the data width are padded with zero streams that never surface
(the pad-stream contract).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import msf_detector as spec
from repro_torch.core.model import Model, ParamTree
from repro_torch.device import Device
from repro_torch.serving.core import (AdaptConfig, ServingCore, ServingUnit,
                                      Verdict)
from repro_torch.sim.heads import DetectorHead

__all__ = ["StreamEngine", "AdaptConfig", "Verdict"]


class StreamEngine(ServingCore):
    """Batched sliding-window detector service over ``n_streams`` plants.

    Per scan cycle, call :meth:`ingest` with one ``(n_streams, n_features)``
    reading block.  The first verdict batch fires once every stream has seen
    ``window`` readings, then every ``stride`` cycles.

    ``device`` (default ``"cuda"``) is where the ring arena and the step
    run; ``params`` must live there (``Model.init_params`` /
    ``bridge.params_from_numpy`` with the same device).  Without a card the
    default raises; pass ``device="cpu"`` for the plain PyTorch path.

    ``backend``: ``"auto"`` (the kernels on the card, the plain versions on
    the CPU), ``"kernel"`` or ``"ref"`` (see ``kernels.ops``).  ``fused``:
    None auto-selects the single-launch forward for fusable stacks, False
    forces the per-layer loop, True raises if the model cannot fuse.
    ``head`` selects the verdict semantics (default
    :class:`~repro_torch.sim.heads.ClassifierHead`; a calibrated
    :class:`~repro_torch.sim.heads.ReconstructionHead` serves the
    autoencoder, and ``last_logits`` then holds the (n_streams, 1) scores).
    ``adapt`` turns on streaming threshold recalibration for a calibrated
    score head.  ``async_depth=1`` double-buffers: verdicts bit-match sync
    mode, one ready boundary later; drain with :meth:`flush`.

    ``shard``/``mesh`` control fleet sharding (module docstring):
    ``shard=None`` shards when the default process group has more than one
    rank, ``shard=True`` forces it (a one-rank mesh still takes the sharded
    path, and a process with no group raises), ``shard=False`` pins the
    unsharded step.  ``mesh`` is a ``DeviceMesh`` whose ``"data"`` axis
    carries the streams; a ``"model"`` axis of any size column-shards wide
    layers, other axes must have size 1.  It defaults to
    ``make_fleet_mesh()`` over the ranks, never wider than the fleet.
    """

    def __init__(self, model: Model, params: ParamTree, *,
                 n_streams: int,
                 n_features: int = spec.N_FEATURES,
                 window: Optional[int] = None,
                 stride: int = spec.STRIDE,
                 deadline_s: float = spec.DEADLINE_S,
                 norm_mean: Sequence[float] = spec.NORM_MEAN,
                 norm_std: Sequence[float] = spec.NORM_STD,
                 backend: str = "auto",
                 fused: Optional[bool] = None,
                 head: Optional[DetectorHead] = None,
                 shard: Optional[bool] = None,
                 mesh: Optional[DeviceMesh] = None,
                 adapt: Union[bool, AdaptConfig, None] = None,
                 async_depth: int = 0,
                 device: Device = "cuda"):
        super().__init__(
            [ServingUnit(name=None, model=model, params=params,
                         n_streams=n_streams, head=head, fused=fused,
                         adapt=adapt, window=window)],
            n_features=n_features, stride=stride, deadline_s=deadline_s,
            norm_mean=norm_mean, norm_std=norm_std, backend=backend,
            shard=shard, mesh=mesh, async_depth=async_depth, device=device)
        unit = self._units[0]
        self.model = model
        self.window = unit.window
        # Resolved constructor-only knobs, for introspection.
        self.head = unit.head
        self.fused = unit.use_fused
        self.adapt = unit.adapt
        self.shard_streams = unit.rows

    @property
    def last_logits(self) -> Optional[np.ndarray]:
        """The last verdict step's outputs (host numpy)."""
        return self.last_outputs.get(self._units[0].name)

    @property
    def live_threshold(self) -> Optional[float]:
        return self._units[0].live_threshold

    @live_threshold.setter
    def live_threshold(self, value: Optional[float]) -> None:
        self._units[0].live_threshold = value

    @property
    def _ring(self) -> torch.Tensor:
        """This rank's rows of the ring arena."""
        return self._rings[0]

    @property
    def _step(self) -> Callable:
        """The single-model step over the unit's body (see
        ``ServingCore._single_step_view``)."""
        return self._single_step_view()
