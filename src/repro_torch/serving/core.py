"""The fleet-serving core behind ``StreamEngine`` and
``GroupedStreamEngine``: ``repro.serving.core`` in PyTorch.

**The unit model.**  A serving core drives a list of *units*: contiguous
stream-axis slices, each with its own model, detector head, window geometry,
fused/per-layer forward and optional drift adaptation.  ``StreamEngine`` is
the one-unit case (its unit is anonymous, so verdicts keep ``group=None``);
``GroupedStreamEngine`` the N-unit case with named groups.  Per verdict
cadence the core runs one step for each ready unit: the ring scatter of the
pending readings, the oldest-first window unroll, the head's ``prepare``,
the forward and the head's device epilogue.

**The ring arena** of each unit is one tensor preallocated on the device and
updated in place, the counterpart of the reference's donated
``donate_argnums=(0, 1, 2)`` step (the ring and the adaptation state are
never reallocated).  Units that share ``(s_pad, window)`` keep their
rings as views of one ``(G, S, W, F)`` arena, so the megakernel step writes
and unrolls them in one batched op.  Readings accumulate on the host between
cadences and are uploaded once per step, so a stride-10 fleet touches the
device once per verdict cadence.

**The forward** is ``ops.fused_forward``: the whole Dense stack as ONE
``fused_mlp`` kernel launch on the card, SINT requantizing in-kernel.  With
``fused=False`` (or a stack that does not fuse) it is the per-layer loop
:func:`_dense_batched`, where each SINT layer is one ``qmatmul`` launch.

**Megakernel (one launch per multi-group step).**  When every unit's stack
packs (``ops.grouped_fuse_reason``: all-Dense, one weight dtype per layer
position, the grouped kernel's shared-memory bill within Hopper's) and every
head exposes an in-kernel epilogue (``DetectorHead.kernel_epilogue``), a
step whose co-firing units share ``(s_pad, window)`` and block length is
ONE ``grouped_fused_mlp`` launch: the units' arena is scattered and unrolled
batched over the group axis, and ``ops.grouped_apply`` runs the whole fleet
— per-group quantization, activations (a final softmax masked to each
group's true class count) and head epilogues included.  Adaptive units
update their calibration state from the payload inside the step.  The
packed arenas are built once per ready subset (:class:`_MegaPack`).
``megakernel=None`` packs when the fleet can, ``False`` pins the per-group
path, ``True`` raises with the packing reason when the fleet cannot.  Ready
subsets whose geometry cannot stack serve per group for that boundary.

**Async double-buffering (``async_depth=1``).**  ``ingest()`` at a ready
boundary first *harvests* the previous step (its outputs were copied to the
host by a non-blocking copy queued right after the step), then *dispatches*
the new step and returns without synchronising.  Verdicts are therefore
delivered one ready boundary late but are bit-identical to synchronous mode
(same kernels, same operands, and the adapt threshold is recalibrated before
the next dispatch exactly as in the sync loop).  ``flush()`` drains the last
in-flight step.  ``latency_s`` is dispatch→harvest time; ``stats.steps``
counts at dispatch, ``windows``/``deadline_misses``/``latencies_s`` at
harvest, and ``wall_s`` is host time inside ``ingest()``/``flush()`` only.

**Fleet meshes.**  One process per rank, the stream axis over the ``"data"``
axis of a :class:`~torch.distributed.device_mesh.DeviceMesh`
(``launch.mesh.make_fleet_mesh``) and, on a 2-D ``("data", "model")`` mesh,
wide Dense layers column-sharded over ``"model"``.  Every rank is given the
whole fleet's readings, as the reference's host holds them; it keeps only
its contiguous shard of every unit's streams (rows ``[shard * rows, (shard +
1) * rows)`` of the unit padded to ``s_pad = ceil(n / shards) * shards``,
the *pad-stream contract*: pad rows are zero streams that ride through the
step and never surface) and runs its shard of every ready unit's step.  A
layer whose output is at least ``MODEL_SHARD_MIN_WIDTH`` wide keeps only this
model rank's ``nc`` columns (weights, bias and per-channel scales, padded
with zero columns and scale 1.0 to ``m * nc``): each rank computes the
full-K dot of its columns and one gather over the ``"model"`` group rebuilds
the row, so every column is the unsharded layer's own arithmetic.  Those
gathers are the only collectives inside a step.  After it, ONE gather over
the ``"data"`` group brings every rank the whole fleet's outputs (and the
adaptive units' calibration state), the counterpart of the reference's
``device_get`` of a sharded array, and every rank builds the same verdict
list in the reference's stream order.  ``stats.collectives`` counts both
kinds of gather by axis.  The fused kernel cannot span the model gather, so
``fused=None`` serves per layer on a model-sharded mesh and ``fused=True``
raises; the megakernel is off under a mesh unless ``megakernel=True``.  A
rank outside the mesh (a mesh takes a prefix of the world) holds no shard:
its ``ingest`` counts the cycle and returns ``[]``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import msf_detector as spec
from repro_torch.core.layers import ACTIVATIONS, Dense, Input
from repro_torch.core.model import Model, ParamTree
from repro_torch.device import Device, resolve_device, to_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.sim.heads import (ClassifierHead, DetectorHead, ForecastHead,
                                   ScoreHead)

# Column-shard a Dense layer over the mesh's "model" axis only when its
# output is at least this wide: below it the gather costs more than the
# sharded columns save (the detector's 2-wide logit layer is the extreme
# case), so the §7 detector runs exactly one model gather a step.
MODEL_SHARD_MIN_WIDTH = 64

# The gather that concatenates every rank's tensor along dim 0 (torch 2.13
# renamed all_gather_into_tensor).
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


@dataclasses.dataclass
class Verdict:
    """One per-stream verdict on a completed window.

    A classifier head fills ``pred``/``prob`` (argmax class + its softmax
    probability); a score head fills ``pred``/``score``/``threshold``.
    ``pred != 0`` always means "anomalous".
    """

    stream: int               # stream index in the fleet
    cycle: int                # scan cycle at which the window completed
    pred: int                 # verdict class (0 = normal)
    prob: Optional[float]     # classifier: softmax prob of the predicted class
    latency_s: float          # window-completion -> verdict-on-host wall time
                              # (async: dispatch -> harvest)
    deadline_miss: bool       # latency_s > deadline_s
    score: Optional[float] = None       # score heads: anomaly score
    threshold: Optional[float] = None   # score heads: calibrated cutoff
    group: Optional[str] = None         # model-group name (grouped fleets)


# Default reservoir seeds come from a process-global counter, so every
# engine's reservoir draws a distinct replacement sequence.
_reservoir_seeds = itertools.count()


class LatencyReservoir:
    """Bounded uniform sample of verdict latencies (Vitter's Algorithm R).

    Retains the first ``capacity`` samples verbatim (append order kept, so
    short runs see an exact list) and thereafter replaces a uniformly random
    retained sample with probability ``capacity / seen``.  Slicing raises
    once ``seen`` exceeds ``capacity`` (the retained items are no longer an
    append-ordered tail); take per-pass tails via
    :meth:`StreamStats.reset_latencies`.
    """

    __slots__ = ("capacity", "seen", "seed", "_items", "_rng")

    def __init__(self, capacity: int = 4096, seed: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.seen = 0                 # total appends ever observed
        self.seed = next(_reservoir_seeds) if seed is None else seed
        self._items: List[float] = []
        self._rng = np.random.default_rng(self.seed)

    def append(self, value: float) -> None:
        self.seen += 1
        if len(self._items) < self.capacity:
            self._items.append(float(value))
        else:
            j = int(self._rng.integers(self.seen))
            if j < self.capacity:
                self._items[j] = float(value)

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, idx):
        if isinstance(idx, slice) and self.seen > self.capacity:
            raise ValueError(
                f"latency tail slices are only exact below the reservoir "
                f"capacity ({self.capacity}); after {self.seen} appends "
                "Algorithm R has replaced random retained indices — take "
                "per-pass tails via StreamStats.reset_latencies()")
        return self._items[idx]

    def percentile(self, q: float) -> float:
        """Latency percentile of the retained sample; raises while empty (no
        verdict step has fired yet)."""
        if not self._items:
            raise ValueError(
                "percentile of an empty latency reservoir: no verdict step "
                "has fired yet")
        return float(np.percentile(self._items, q))


@dataclasses.dataclass
class StreamStats:
    """Aggregate serve accounting.

    ``dispatches`` counts forward launches: a megakernel step is 1 however
    many groups co-fired (one ``grouped_fused_mlp`` launch); on the
    per-group path each ready unit adds 1 when fused and one per Dense layer
    when per-layer (a ``qmatmul`` launch for each SINT layer, a plain matmul
    for the others).  ``dispatches == steps`` is the one-launch-per-step
    guarantee of a packed fleet.  Under ``async_depth=1``
    ``steps`` counts at dispatch and ``windows``/``deadline_misses``/
    ``latencies_s`` at harvest.  ``dispatches`` and ``collectives`` count
    this rank's own.
    """

    steps: int                       # detector steps executed
    cycles: int                      # scan cycles ingested
    windows: int                     # verdicts emitted (streams x steps)
    deadline_misses: int
    wall_s: float                    # total time spent inside ingest()
    dispatches: int = 0              # forward launches issued
    latencies_s: LatencyReservoir = dataclasses.field(
        default_factory=LatencyReservoir)
    # gathers by mesh axis: one "data" gather a step under a mesh, one
    # "model" gather per column-sharded layer a step
    collectives: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"model": 0, "data": 0})

    def latency_p(self, q: float) -> float:
        return self.latencies_s.percentile(q)

    def reset_latencies(self) -> LatencyReservoir:
        """Swap in a fresh reservoir and return the retired one."""
        old = self.latencies_s
        self.latencies_s = LatencyReservoir(capacity=old.capacity)
        return old

    def windows_per_s(self) -> float:
        return self.windows / self.wall_s if self.wall_s > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Streaming threshold-recalibration policy (online drift adaptation).

    ``capacity``: per-stream rolling score-ring length.  ``every``:
    recalibrate once per that many fired steps (the device-side state update
    runs every step).  ``min_count``: hold the offline threshold until that
    many scores have been admitted fleet-wide.  ``headroom``: scores at most
    ``headroom`` times the live threshold enter the calibration state.
    """

    capacity: int = 32
    every: int = 1
    min_count: int = 16
    headroom: float = 4.0

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if self.min_count < 1:
            raise ValueError(f"min_count must be >= 1, got {self.min_count}")
        if self.headroom < 1.0:
            raise ValueError(
                f"headroom must be >= 1 (the gate must at least admit "
                f"sub-threshold scores), got {self.headroom}")


def _resolve_adapt(adapt: Union[bool, AdaptConfig, None],
                   head: DetectorHead, what: str = "") -> Optional[AdaptConfig]:
    """Validate and normalize an ``adapt=`` knob: None/False off, True the
    default policy, an :class:`AdaptConfig` verbatim.  Needs a calibrated
    :class:`ScoreHead` with a recorded ``target_fpr``."""
    if adapt is None or adapt is False:
        return None
    cfg = AdaptConfig() if adapt is True else adapt
    if not isinstance(cfg, AdaptConfig):
        raise ValueError(f"{what}adapt must be None/bool/AdaptConfig, "
                         f"got {cfg!r}")
    if not isinstance(head, ScoreHead):
        raise ValueError(
            f"{what}adapt=True needs a score-vs-threshold head (ScoreHead); "
            f"the {head.name!r} head has no score distribution to "
            "recalibrate on")
    if head.threshold is None or head.target_fpr is None:
        raise ValueError(
            f"{what}adapt=True needs a calibrated head with a recorded "
            "target_fpr to seed and steer the live threshold")
    return cfg


def _layer_stack(model: Model, params: ParamTree) -> List[Tuple[Dict, str]]:
    """(params, activation) per Dense node in schedule order."""
    stack = ops.dense_stack(model, params)
    if not stack:
        raise ValueError("model has no Dense layers to serve")
    return stack


def _dense_batched(x: torch.Tensor, p: Dict, act: str,
                   backend: str) -> torch.Tensor:
    """One Dense layer over a (M, K) batch, float or quantized (§6.1)."""
    if "qw" in p:
        qw = p["qw"]
        # Symmetric activation clip, as quantize.quantize_tensor.
        qmax = torch.iinfo(qw.dtype).max
        xq = torch.clamp(torch.round(x / p["x_scale"]), -qmax, qmax)
        scale = p["x_scale"] * p["w_scale"]
        if qw.dtype == torch.int8:
            # SINT: the qmatmul kernel (int8 products, int32 accumulation).
            y = ops.quantized_matmul(xq.to(torch.int8), qw, scale, p.get("b"),
                                     backend=backend)
        else:
            # INT/DINT: the integer grid emulated in f32, with no round trip
            # through the int dtype (int32's qmax is not f32-representable).
            y = xq @ qw.to(torch.float32) * scale
            if "b" in p:
                y = y + p["b"]
    else:
        y = x @ p["w"]
        if "b" in p:
            y = y + p["b"]
    return ACTIVATIONS[act](y)


def _pad_layer_cols(p: Dict, n_pad: int) -> Dict:
    """A Dense layer's params with the output columns padded to ``n_pad``,
    so every model rank owns an equal column slice.  Bias and per-channel
    weight scales become per-column vectors, padded alongside (pad scale 1.0,
    so every stored scale decodes some grid); pad columns are sliced off
    after the gather and never surface."""
    wkey = "qw" if "qw" in p else "w"
    n = p[wkey].shape[1]
    q = dict(p)
    q[wkey] = torch.nn.functional.pad(p[wkey], (0, n_pad - n))
    if "b" in p:
        q["b"] = torch.nn.functional.pad(
            torch.broadcast_to(p["b"].to(torch.float32), (n,)), (0, n_pad - n))
    if "w_scale" in p:
        q["w_scale"] = torch.nn.functional.pad(
            torch.broadcast_to(p["w_scale"].to(torch.float32), (n,)),
            (0, n_pad - n), value=1.0)
    return q


def _model_shard_plan(stack, model_shards: int, model_rank: int):
    """Per layer: ``(params, act, cols_per_rank | None, true_width)``.

    A layer at least ``MODEL_SHARD_MIN_WIDTH`` wide keeps only model rank
    ``model_rank``'s ``cols_per_rank`` columns of its padded params; the
    others (and a softmax, which is not column-wise) stay whole."""
    plan = []
    for p, act in stack:
        n_out = int((p["qw"] if "qw" in p else p["w"]).shape[1])
        if (model_shards > 1 and n_out >= MODEL_SHARD_MIN_WIDTH
                and act != "softmax"):
            nc = -(-n_out // model_shards)
            cols = slice(model_rank * nc, (model_rank + 1) * nc)
            padded = _pad_layer_cols(p, nc * model_shards)
            own = {k: (v[:, cols] if k in ("w", "qw") else
                       v[cols] if k in ("b", "w_scale") else v).contiguous()
                   for k, v in padded.items()}
            plan.append((own, act, nc, n_out))
        else:
            plan.append((p, act, None, n_out))
    return plan


def _gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` (``size`` ranks), concatenated
    along dim 0 in group-rank order."""
    out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _all_gather(out, t.contiguous(), group=group)
    return out


def _dense_model_sharded(x: torch.Tensor, p: Dict, act: str, backend: str,
                         nc: int, n_out: int, group,
                         model_shards: int) -> torch.Tensor:
    """One Dense layer column-sharded over the ``"model"`` group: this
    rank's ``nc`` columns (``p`` holds only them) through the unsharded
    layer's own arithmetic, then one gather rebuilds the ``(M, n_out)``
    activation."""
    y = _dense_batched(x, p, act, backend)
    cols = _gather(y, group, model_shards).view(model_shards, *y.shape)
    return cols.permute(1, 0, 2).reshape(y.shape[0], -1)[:, :n_out] \
        .contiguous()


@dataclasses.dataclass
class ServingUnit:
    """One detector population inside a serving core.

    ``name=None`` marks the anonymous single-model case (verdicts carry
    ``group=None``); ``window`` overrides the head-derived ring extent;
    ``what`` prefixes this unit's constructor error messages.
    """

    name: Optional[str]
    model: Model
    params: ParamTree
    n_streams: int
    head: Optional[DetectorHead] = None
    fused: Optional[bool] = None
    adapt: Union[bool, AdaptConfig, None] = None
    window: Optional[int] = None
    what: str = ""


class _UnitState:
    """Per-unit serving state: geometry, step body, ring bookkeeping."""

    __slots__ = ("name", "head", "window", "offset", "n_streams", "s_pad",
                 "rows", "row0", "body", "pos", "consumed", "use_fused",
                 "windows", "adapt", "live_threshold", "fires",
                 "dispatch_cost", "model_gathers", "stack", "kernel_epi",
                 "fused_knob", "all_dense")

    def __init__(self, name, head, window, offset, n_streams):
        self.name = name
        self.head = head
        self.window = window
        self.offset = offset          # first global stream index
        self.n_streams = n_streams
        self.pos = 0                  # next ring write index (host-tracked)
        self.consumed = 0             # scan count at the last fired step
        self.windows = 0              # verdicts emitted for this unit
        self.fires = 0                # steps this unit participated in


class _InFlight:
    """One dispatched verdict step whose outputs are on their way to the
    host: the device-to-host copies are queued right after the step, and
    ``done`` marks their completion on the stream.  ``unpack`` turns the
    host copies into one array per ready unit (the identity for per-group
    steps; a mega step slices each unit's payload out of one tensor).
    ``states`` holds, under a mesh, the gathered calibration state
    ``(calib, counts)`` of each adaptive ready unit, by unit index."""

    __slots__ = ("key", "outs", "states", "cycle", "t0", "done", "unpack")

    def __init__(self, key, outs: Sequence[torch.Tensor], cycle, t0,
                 unpack: Callable[[List[np.ndarray]], List[np.ndarray]]
                 = lambda hosts: hosts,
                 states: Optional[Dict[int, Tuple[torch.Tensor,
                                                  torch.Tensor]]] = None):
        self.key = key                # ((unit index, block length), ...)
        self.cycle = cycle            # boundary cycle the windows completed at
        self.t0 = t0                  # dispatch wall-clock (latency origin)
        self.unpack = unpack
        self.outs = [o.to("cpu", non_blocking=True) for o in outs]
        self.states = {gi: tuple(t.to("cpu", non_blocking=True) for t in st)
                       for gi, st in (states or {}).items()}
        self.done = None
        if any(o.is_cuda for o in outs):
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(outs[0].device))

    def host_outputs(self) -> List[np.ndarray]:
        if self.done is not None:
            self.done.synchronize()
        return self.unpack([o.numpy() for o in self.outs])


class _MegaPack:
    """One ready subset's packed megakernel operands and static geometry.

    Owns the arenas (``arrays``) and the kernel's launch layout (``kernel``,
    whose descriptor points into them; None off the card) for as long as
    the engine serves the subset.  ``tgt`` is the subset's epilogue-target
    buffer, (G, S, plan.n_out) on the device: margin centers are written
    once, classifier rows stay zero, and each step copies the window (or its
    newest reading) into the reconstruction (forecast) rows.  ``sig`` is the
    step-cache key: the hashable plan plus the serving geometry, epilogue
    selectors and adapt policy the step closes over.
    """

    __slots__ = ("plan", "arrays", "kernel", "tgt", "tgt_sels", "widths",
                 "heads", "adapts", "sig")

    def __init__(self, plan, arrays, kernel, tgt, tgt_sels, widths, heads,
                 adapts, sig):
        self.plan = plan
        self.arrays = arrays
        self.kernel = kernel
        self.tgt = tgt
        self.tgt_sels = tgt_sels      # per slot: none|window|tail|center
        self.widths = widths          # true payload width per slot
        self.heads = heads
        self.adapts = adapts
        self.sig = sig

    def unpack(self, hosts: List[np.ndarray]) -> List[np.ndarray]:
        (pay,) = hosts
        return [pay[k, :, :w] for k, w in enumerate(self.widths)]


def _ring_write(ring: torch.Tensor, vals: torch.Tensor, start: int) -> None:
    """Write ``vals`` (S, n, F), n <= window, into the ring's reading axis
    from ``start`` on, wrapping at the window: at most two slice copies."""
    w = ring.shape[1]
    n = vals.shape[1]
    first = min(n, w - start)
    ring[:, start:start + first] = vals[:, :first]
    if n > first:
        ring[:, :n - first] = vals[:, first:]


class ServingCore:
    """Batched sliding-window serving over a list of :class:`ServingUnit`.

    The machinery layer — see the module docstring for the serving model
    and :class:`~repro_torch.serving.streams.StreamEngine` for the public
    constructor contract.  ``device`` defaults to the card and raises on a
    machine without CUDA; params must already live there.  Under a mesh,
    ``device`` is this rank's (its current card by default) and must be of
    the mesh's device type.
    """

    def __init__(self, units: Sequence[ServingUnit], *,
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
        if not units:
            raise ValueError("need at least one serving unit")
        if any(u.n_streams < 1 for u in units):
            raise ValueError("every unit needs n_streams >= 1")
        if stride < 1:
            raise ValueError("stride must be >= 1")
        if async_depth not in (0, 1):
            raise ValueError(
                f"async_depth must be 0 (synchronous) or 1 (double-"
                f"buffered), got {async_depth!r}")
        if backend not in ops.BACKENDS:
            raise ValueError(f"backend must be one of {ops.BACKENDS}, got "
                             f"{backend!r}")
        self.device = resolve_device(device)
        self.n_features = n_features
        self.stride = stride
        self.deadline_s = deadline_s
        self.async_depth = async_depth
        self._mean = np.asarray(norm_mean, np.float32)
        self._std = np.asarray(norm_std, np.float32)
        if self._mean.shape != (n_features,) or \
                self._std.shape != (n_features,):
            raise ValueError("norm_mean/norm_std must have one entry per "
                             "feature")
        self._backend = backend
        self.n_streams = sum(u.n_streams for u in units)
        self._init_mesh(shard, mesh, units)

        self._units: List[_UnitState] = []
        self._rings: List[torch.Tensor] = []
        self._calibs: List[Optional[torch.Tensor]] = []
        self._counts: List[Optional[torch.Tensor]] = []
        offset = 0
        for u in units:
            head = ClassifierHead() if u.head is None else u.head
            (input_size,) = u.model.input_shape
            window = (head.ring_window(input_size, n_features)
                      if u.window is None else u.window)
            if head.model_input_size(window, n_features) != input_size:
                raise ValueError(
                    f"window {window} x features {n_features} (head "
                    f"{head.name!r}) != model input {input_size}")
            stack = _layer_stack(u.model, u.params)
            for p, _ in stack:
                for t in p.values():
                    if t.device != self.device:
                        raise ValueError(
                            f"{u.what}params live on {t.device} but the "
                            f"engine serves on {self.device}; build them with "
                            "the same device")
            last = stack[-1][0]
            n_out = (last["qw"] if "qw" in last else last["w"]).shape[1]
            head.validate(input_size, n_out)
            fusable = ops.model_fusable(u.model, stack)
            if u.fused and not fusable:
                reason = ops.fuse_reason(stack) or \
                    "the model graph has non-Dense nodes"
                raise ValueError(
                    f"{u.what}fused=True but the model cannot fuse: {reason}")
            if u.fused and self.model_shards > 1:
                raise ValueError(
                    f"{u.what}fused=True cannot serve on a model-sharded "
                    "mesh: the gather between column-sharded layers cannot "
                    "live inside one fused_mlp launch — use fused=None/"
                    "False, or a mesh with model_shards=1")
            use_fused = ((fusable and self.model_shards == 1)
                         if u.fused is None else u.fused)
            st = _UnitState(u.name, head, window, offset, u.n_streams)
            # Pad-stream contract: each data shard owns `rows` contiguous
            # rows of the unit padded to s_pad; pad rows are zero streams.
            st.s_pad = -(-u.n_streams // self.n_shards) * self.n_shards
            st.rows = st.s_pad // self.n_shards
            st.row0 = self._shard * st.rows
            st.use_fused = use_fused
            st.stack = stack
            st.kernel_epi = head.kernel_epilogue()
            st.fused_knob = u.fused
            st.all_dense = all(isinstance(n.layer, (Input, Dense))
                               for n in u.model.graph.nodes)
            st.dispatch_cost = 1 if use_fused else len(stack)
            st.adapt = _resolve_adapt(u.adapt, head, what=u.what)
            st.live_threshold = (head.threshold
                                 if isinstance(head, ScoreHead) else None)
            st.body, st.model_gathers = self._make_body(
                stack, head, use_fused, window, st.adapt)
            self._units.append(st)
            calib, counts = self._calib_state(st)
            self._calibs.append(calib)
            self._counts.append(counts)
            offset += u.n_streams
        self.max_window = max(st.window for st in self._units)

        # Ring arenas: units of equal (s_pad, window) keep their rings (this
        # rank's rows) as views of one (G, rows, W, F) tensor, keyed by the
        # member unit indices.  Such units always fire together (readiness
        # depends on the window only), so a stackable ready subset is
        # exactly one arena.
        members: Dict[Tuple[int, int], List[int]] = {}
        for gi, st in enumerate(self._units):
            members.setdefault((st.s_pad, st.window), []).append(gi)
        self._arenas: Dict[Tuple[int, ...], torch.Tensor] = {}
        self._rings = [None] * len(self._units)
        for (s_pad, window), gis in members.items():
            arena = torch.zeros((len(gis), s_pad // self.n_shards, window,
                                 n_features),
                                dtype=torch.float32, device=self.device)
            self._arenas[tuple(gis)] = arena
            for k, gi in enumerate(gis):
                self._rings[gi] = arena[k]

        # -- megakernel (one launch per multi-group step) -----------------
        # Packs are built once per ready subset; steps are cached closures
        # keyed by (pack.sig, block length), the block shape.
        self._mega_packs: Dict[Tuple[int, ...], _MegaPack] = {}
        self._mega_steps: Dict[Tuple, Callable] = {}
        self._mega_reason = self._compute_mega_reason()
        if megakernel and self._mega_reason is not None:
            raise ValueError(
                "megakernel=True but the fleet cannot pack into one launch: "
                f"{self._mega_reason}")
        # On by default only without a mesh, as the reference's (whose
        # sharded per-group step rounds differently from its sharded mega
        # step); megakernel=True serves a mesh's shards through it.
        self._mega = (self._mega_reason is None
                      and (megakernel is True
                           or (megakernel is None and self.mesh is None)))

        self._count = 0
        self._pending: List[np.ndarray] = []
        self._inflight: Optional[_InFlight] = None
        self.last_outputs: Dict[Optional[str], np.ndarray] = {}
        self.stats = StreamStats(steps=0, cycles=0, windows=0,
                                 deadline_misses=0, wall_s=0.0)

    def _init_mesh(self, shard: Optional[bool], mesh: Optional[DeviceMesh],
                   units: Sequence[ServingUnit]) -> None:
        """Resolve ``shard``/``mesh`` (the reference's contract) and this
        rank's place in the mesh: its data shard, its model rank and the
        groups it gathers over."""
        if shard is False and mesh is not None:
            raise ValueError("shard=False contradicts an explicit mesh")
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
        if mesh is None and (shard or (shard is None and world > 1)):
            # Never wider than the smallest unit: pure-pad shards would
            # launch a step per rank on zero streams every cadence.  Raises
            # without a process group.
            mesh = make_fleet_mesh(min(world, *(u.n_streams for u in units)),
                                   device_type=self.device.type)
        self.mesh = mesh
        self.n_shards = self.model_shards = 1
        self._shard, self._in_mesh = 0, True
        self._data_group = self._model_group = None
        self._model_rank = 0
        if mesh is None:
            return
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if "data" not in names:
            raise ValueError(f"fleet mesh needs a 'data' axis, got {names}")
        extra = [a for a in names if a not in ("data", "model")
                 and mesh.size(names.index(a)) != 1]
        if extra:
            raise ValueError(
                f"non-'data' mesh axes must have size 1, got {extra} "
                "(weight sharding lives on the 'model' axis)")
        if mesh.device_type != self.device.type:
            raise ValueError(
                f"the mesh serves on {mesh.device_type!r} but the engine's "
                f"device is {self.device}")
        self.n_shards = mesh.size(names.index("data"))
        if "model" in names:
            self.model_shards = mesh.size(names.index("model"))
        self._in_mesh = mesh.get_coordinate() is not None
        if not self._in_mesh:
            return
        self._shard = mesh.get_local_rank("data")
        self._data_group = mesh.get_group("data")
        if self.model_shards > 1:
            self._model_rank = mesh.get_local_rank("model")
            self._model_group = mesh.get_group("model")

    @property
    def mega_reason(self) -> Optional[str]:
        """Why this fleet cannot pack into the one-launch megakernel step
        (None when it can; ``megakernel=False`` may still pin the per-group
        path)."""
        return self._mega_reason

    # -- construction helpers ----------------------------------------------

    def _calib_state(self, st: _UnitState) -> Tuple[
            Optional[torch.Tensor], Optional[torch.Tensor]]:
        """A unit's rolling calibration state; (None, None) when it does not
        adapt."""
        if st.adapt is None:
            return None, None
        return st.head.calib_state(st.rows, st.adapt.capacity, self.device)

    @staticmethod
    def _thr(st: _UnitState) -> float:
        """The unit's live threshold as the step's scalar operand (0.0 for
        heads with no threshold — the body never reads it then)."""
        return 0.0 if st.live_threshold is None else float(st.live_threshold)

    def _make_body(self, stack, head, use_fused, window, adapt_cfg):
        """One unit's device step on this rank's rows: ring scatter,
        oldest-first unroll, the head's ``prepare`` view, the forward (its
        column-sharded layers each end in a model gather), the head's device
        epilogue and, when the unit adapts, the rolling calibration-state
        write.  Ring and calibration state are updated in place.  Returns
        (body, model gathers a step)."""
        backend = self._backend
        w = window
        # Laid out for the kernel once: the launch descriptor carries the
        # activation scales by value, read from the device here and never
        # again on the serving path.
        fused = ops.prepare_fused(stack) if use_fused else None
        plan = _model_shard_plan(stack, self.model_shards, self._model_rank)
        group, m = self._model_group, self.model_shards

        def forward(x):
            if fused is not None:
                return ops.fused_forward(x, fused, backend=backend)
            for p, act, nc, n_out in plan:
                x = (_dense_batched(x, p, act, backend) if nc is None else
                     _dense_model_sharded(x, p, act, backend, nc, n_out,
                                          group, m))
            return x

        def body(ring, calib, counts, block, pos, thr):
            # block: (S, L, F) pending readings.  Only the last `window` of
            # them can land, so trim before writing (ingest() already trims
            # longer spans on the host).
            length = block.shape[1]
            offset = max(length - w, 0)
            _ring_write(ring, block[:, offset:], (pos + offset) % w)
            # Window unroll, oldest reading first: the ring holds exactly the
            # last `window` readings, ending at (pos + L - 1) mod window.
            end = (pos + length) % w
            win = torch.cat((ring[:, end:], ring[:, :end]), dim=1) \
                .reshape(ring.shape[0], -1)
            out = head.epilogue(win, forward(head.prepare(win)))
            if adapt_cfg is not None:
                head.calib_update(calib, counts, out, thr, adapt_cfg.headroom)
            return out

        gathers = 0 if fused is not None else sum(
            nc is not None for _, _, nc, _ in plan)
        return body, gathers

    def _single_step_view(self) -> Callable:
        """Unit 0's step on state the caller passes, in the reference's
        single-model signatures: ``(ring, block, pos) -> out`` without
        adaptation, ``(ring, calib, counts, block, pos, thr) -> out`` with
        (the state is updated in place).  Under a mesh a rank passes its
        shard's rows, and the model gathers run inside."""
        body = self._units[0].body
        if self._units[0].adapt is not None:
            return body
        return lambda ring, block, pos: body(ring, None, None, block, pos,
                                             0.0)

    # -- megakernel: the whole ready fleet in ONE launch ------------------

    def _compute_mega_reason(self) -> Optional[str]:
        """None when multi-unit ready steps can run as one grouped kernel
        launch, else why the engine serves per group: engine-level
        prerequisites first (unit count, step flavor, head epilogue hooks),
        then the kernel's packing contract (``ops.grouped_fuse_reason``)."""
        if len(self._units) < 2:
            return ("fleet has a single unit; its step is already one "
                    "launch")
        if self.model_shards > 1:
            return ("the megakernel cannot span the model-axis gather of "
                    "column-sharded layers")
        for st in self._units:
            what = f"group {st.name!r}: " if st.name else ""
            if st.fused_knob is False:
                return f"{what}fused=False pins the per-layer path"
            if not st.all_dense:
                return f"{what}the model graph has non-Dense nodes"
            epi = st.kernel_epi
            if epi is None:
                return (f"{what}head {st.head.name!r} has no in-kernel "
                        "epilogue (kernel_epilogue() returned None)")
            if epi[0] not in ("logits", "mse") or \
                    epi[1] not in ("none", "window", "tail", "center"):
                return f"{what}unknown kernel epilogue spec {epi!r}"
            if epi[1] == "center" and not hasattr(st.head, "_center"):
                return (f"{what}'center' epilogue needs a head exposing a "
                        "_center() row")
            if type(st.head).prepare not in (DetectorHead.prepare,
                                             ForecastHead.prepare):
                return (f"{what}head {st.head.name!r} overrides prepare(); "
                        "the megakernel feeds the raw window and only "
                        "subsumes the base window/forecast views via zero "
                        "weight rows")
        return ops.grouped_fuse_reason(
            [st.stack for st in self._units],
            names=[st.name or f"unit{i}"
                   for i, st in enumerate(self._units)],
            k0=max(st.window * self.n_features for st in self._units))

    def _mega_applicable(self, key: Tuple) -> bool:
        """True when THIS ready-combination runs as one launch: the engine
        packs, more than one unit co-fired, and the co-firing units agree on
        (padded streams, window, block length), so one arena holds them
        all."""
        if not self._mega or len(key) < 2:
            return False
        sts = [self._units[gi] for gi, _ in key]
        return (len({(st.s_pad, st.window) for st in sts}) == 1
                and len({length for _, length in key}) == 1)

    def _mega_pack(self, subset: Tuple[int, ...]) -> _MegaPack:
        """The packed arenas, kernel layout and target buffer for one ready
        subset, built on first use."""
        pack = self._mega_packs.get(subset)
        if pack is not None:
            return pack
        sts = [self._units[gi] for gi in subset]
        kinds = [ops.GROUPED_KIND_LOGITS if st.kernel_epi[0] == "logits"
                 else ops.GROUPED_KIND_SCORE for st in sts]
        plan, arrays = ops.build_grouped_plan(
            [st.stack for st in sts], kinds,
            k0=max(st.window * self.n_features for st in sts))
        tgt = torch.zeros((len(sts), sts[0].rows, plan.n_out),
                          dtype=torch.float32, device=self.device)
        for k, st in enumerate(sts):
            if st.kernel_epi[1] == "center":
                # The head's cached device row: uploaded once, shared with
                # its per-group epilogue.
                center = st.head._center(self.device)
                tgt[k, :, :center.shape[0]] = center
        widths = tuple(
            plan.n_outs[k] if kinds[k] == ops.GROUPED_KIND_LOGITS else 1
            for k in range(len(sts)))
        adapt_sig = tuple(
            None if st.adapt is None else
            (type(st.head).calib_update, st.adapt.capacity,
             st.adapt.headroom) for st in sts)
        sig = (plan, tuple((st.s_pad, st.window) for st in sts),
               tuple(st.kernel_epi for st in sts), adapt_sig)
        pack = _MegaPack(
            plan=plan, arrays=arrays,
            kernel=(ops.prepare_grouped(plan, arrays)
                    if self.device.type == "cuda" else None),
            tgt=tgt, tgt_sels=tuple(st.kernel_epi[1] for st in sts),
            widths=widths, heads=tuple(st.head for st in sts),
            adapts=tuple(st.adapt for st in sts), sig=sig)
        self._mega_packs[subset] = pack
        return pack

    def _get_mega_step(self, subset: Tuple[int, ...],
                       length: int) -> Tuple[Callable, _MegaPack]:
        """The one-launch step for a ready subset and block length, cached
        on ``(pack.sig, length)``: equal-geometry subsets share one
        closure, and the pack (arenas, targets, kernel layout) is its
        runtime operand."""
        pack = self._mega_pack(subset)
        cache_key = (pack.sig, length)
        step = self._mega_steps.get(cache_key)
        if step is not None:
            return step, pack
        backend = self._backend
        w = self._units[subset[0]].window
        f = self.n_features

        def _mega(arena, calibs, countss, block, pos, thrs, pack):
            # arena: (G, S, W, F) rings, updated in place; block: (G, S, L,
            # F) pending readings.  Same trim-then-write contract as the
            # per-group body, batched over the group axis: co-firing units
            # of one window share their ring position.
            g, s = arena.shape[:2]
            rings = arena.view(g * s, w, f)
            length_ = block.shape[2]
            off = max(length_ - w, 0)
            _ring_write(rings, block.reshape(g * s, length_, f)[:, off:],
                        (pos + off) % w)
            end = (pos + length_) % w
            win = torch.cat((rings[:, end:], rings[:, :end]), dim=1) \
                .reshape(g, s, w * f)
            # Epilogue targets: the window fills the plan's k0 = w * f lanes
            # (a head whose model eats fewer, forecast, meets zero weight
            # rows); the target is the window, or its newest reading.
            tgt = pack.tgt
            n_out = tgt.shape[2]
            for k, sel in enumerate(pack.tgt_sels):
                if sel == "window":
                    n = min(n_out, w * f)
                    tgt[k, :, :n] = win[k, :, :n]
                elif sel == "tail":
                    n = min(n_out, f)
                    tgt[k, :, :n] = win[k, :, w * f - f:w * f - f + n]
            payload = ops.grouped_apply(win, pack.plan, pack.arrays, tgt,
                                        backend=backend,
                                        prepared=pack.kernel)
            for k, adapt in enumerate(pack.adapts):
                if adapt is not None:
                    pack.heads[k].calib_update(
                        calibs[k], countss[k], payload[k][:, :1], thrs[k],
                        adapt.headroom)
            return payload

        self._mega_steps[cache_key] = _mega
        return _mega, pack

    def _dispatch_mega(self, key: Tuple) -> Tuple[torch.Tensor, _MegaPack]:
        """Build the operands of a stackable ready-combination, advance the
        units' serving state and launch its one-launch step.  Returns
        (payload, pack)."""
        sts = [self._units[gi] for gi, _ in key]
        subset = tuple(gi for gi, _ in key)
        length = key[0][1]
        full = np.stack(self._pending[-length:], axis=1)   # (streams, L, F)
        blocks, poss = [], set()
        for st in sts:
            span = self._count - st.consumed
            blocks.append(self._shard_block(full, st))
            poss.add((st.pos + (span - length)) % st.window)
            st.pos = (st.pos + span) % st.window
            st.consumed = self._count
            st.fires += 1
        (pos,) = poss       # one window, one readiness schedule, one position
        step, pack = self._get_mega_step(subset, length)
        payload = step(self._arenas[subset],
                       [self._calibs[gi] for gi in subset],
                       [self._counts[gi] for gi in subset],
                       to_device(np.stack(blocks), self.device), pos,
                       [self._thr(st) for st in sts], pack)
        return payload, pack

    def _mega_example_args(self, key: Tuple) -> Tuple[Callable, Tuple]:
        """(step, scratch operands) for a ready-combination's mega step, as
        :meth:`warmup` runs it.  Serving state is not touched."""
        subset = tuple(gi for gi, _ in key)
        length = key[0][1]
        step, pack = self._get_mega_step(subset, length)
        sts = [self._units[gi] for gi in subset]
        states = [self._calib_state(st) for st in sts]
        block = torch.zeros((len(sts), sts[0].rows, length,
                             self.n_features), dtype=torch.float32,
                            device=self.device)
        return step, (torch.zeros_like(self._arenas[subset]),
                      [c for c, _ in states], [n for _, n in states], block,
                      0, [self._thr(st) for st in sts], pack)

    # -- readiness schedule ------------------------------------------------

    def _ready(self, st: _UnitState, count: int) -> bool:
        return (count >= st.window
                and (count - st.window) % self.stride == 0)

    def _schedule_keys(self) -> List[Tuple]:
        """Every distinct ready-combination key the serve loop will hit: the
        window fill-in plus one full steady-state stride period."""
        keys: List[Tuple] = []
        consumed = {i: 0 for i in range(len(self._units))}
        for count in range(1, self.max_window + self.stride + 1):
            key = []
            for gi, st in enumerate(self._units):
                if self._ready(st, count):
                    span = count - consumed[gi]
                    key.append((gi, min(span, st.window)))
                    consumed[gi] = count
            if key and tuple(key) not in keys:
                keys.append(tuple(key))
        return keys

    def warmup(self) -> None:
        """Run every step shape the readiness schedule can produce on
        scratch state, outside the serve clock: builds and loads the
        kernels, and warms the allocator and the libraries the step uses.
        Serving state is left untouched.  Routing mirrors :meth:`ingest`:
        stackable multi-unit keys run the mega step, the others each ready
        unit's step.  Under a mesh each rank runs its shard's shapes (their
        model gathers included, every rank of the mesh in the same order)
        and one data gather, which sets up the communicator; the warmup's
        gathers are not counted."""
        if not self._in_mesh:
            return
        for key in self._schedule_keys():
            if self._mega_applicable(key):
                step, args = self._mega_example_args(key)
                step(*args)
                continue
            for gi, length in key:
                st = self._units[gi]
                ring = torch.zeros_like(self._rings[gi])
                calib, counts = self._calib_state(st)
                block = torch.zeros((st.rows, length, self.n_features),
                                    dtype=torch.float32, device=self.device)
                st.body(ring, calib, counts, block, 0, self._thr(st))
        if self.mesh is not None:
            _gather(torch.zeros((1,), device=self.device), self._data_group,
                    self.n_shards)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- ingestion ---------------------------------------------------------

    def ingest(self, readings: np.ndarray) -> List[Verdict]:
        """One scan cycle of fleet readings -> verdicts (usually empty).

        ``readings`` is ``(n_streams, n_features)`` raw sensor values over
        the whole fleet; the engine applies the PLC-side normalization.
        Synchronous mode returns this boundary's verdicts; under
        ``async_depth=1`` a ready boundary returns the previous boundary's
        verdicts and leaves its own step in flight.
        """
        t0 = time.perf_counter()
        readings = np.asarray(readings, np.float32)
        if readings.shape != (self.n_streams, self.n_features):
            raise ValueError(
                f"expected ({self.n_streams}, {self.n_features}) readings, "
                f"got {readings.shape}")
        if not self._in_mesh:
            self.stats.cycles += 1
            return []
        self._pending.append((readings - self._mean) / self._std)
        # Readings older than the last `max_window` can never land in any
        # ring: drop them here so host memory and uploads stay capped.
        if len(self._pending) > self.max_window:
            del self._pending[:len(self._pending) - self.max_window]
        self._count += 1
        self.stats.cycles += 1

        ready = [(gi, st) for gi, st in enumerate(self._units)
                 if self._ready(st, self._count)]
        if not ready:
            self.stats.wall_s += time.perf_counter() - t0
            return []

        # Async: harvest BEFORE dispatching, so the live threshold the new
        # step reads is recalibrated exactly as in the sync loop.
        verdicts = self._harvest() if self.async_depth else []

        mega_key = tuple((gi, min(self._count - st.consumed, st.window))
                         for gi, st in ready)
        if self._mega_applicable(mega_key):
            # One grouped kernel launch for the whole ready subset.
            payload, pack = self._dispatch_mega(mega_key)
            self.stats.dispatches += 1
            self.stats.steps += 1
            if self.mesh is None:
                flight = _InFlight(mega_key, [payload], self._count - 1, t0,
                                   pack.unpack)
                return self._land(flight, verdicts, t0)
            outs = [payload[k, :, :w] for k, w in enumerate(pack.widths)]
            return self._land(self._gathered(mega_key, outs, t0), verdicts,
                              t0)

        key, outs = [], []
        for gi, st in ready:
            # span = cycles since the unit's last step; the pending tail
            # holds at least the last min(span, window) readings.
            span = self._count - st.consumed
            length = min(span, st.window)
            block = self._shard_block(
                np.stack(self._pending[-length:], axis=1), st)  # (rows, L, F)
            # The ring write always ends at (pos + span - 1) mod window;
            # host-side trimming of long spans shifts the start to match.
            eff_pos = (st.pos + (span - length)) % st.window
            outs.append(st.body(self._rings[gi], self._calibs[gi],
                                self._counts[gi],
                                to_device(block, self.device), eff_pos,
                                self._thr(st)))
            key.append((gi, length))
            st.pos = (st.pos + span) % st.window
            st.consumed = self._count
            st.fires += 1
            self.stats.dispatches += st.dispatch_cost
            self.stats.collectives["model"] += st.model_gathers
        self.stats.steps += 1
        if self.mesh is None:
            flight = _InFlight(tuple(key), outs, self._count - 1, t0)
        else:
            flight = self._gathered(tuple(key), outs, t0)
        return self._land(flight, verdicts, t0)

    def _shard_block(self, full: np.ndarray, st: _UnitState) -> np.ndarray:
        """This rank's rows of a unit's pending block: the unit's streams
        ``[row0, row0 + rows)`` of ``full`` (the fleet's ``(streams, L,
        F)``), zero pad streams past the unit's end."""
        lo = min(st.row0, st.n_streams)
        hi = min(st.row0 + st.rows, st.n_streams)
        block = full[st.offset + lo:st.offset + hi]
        if hi - lo < st.rows:
            block = np.pad(block, ((0, st.rows - (hi - lo)), (0, 0), (0, 0)))
        return block

    def _gathered(self, key: Tuple, outs: Sequence[torch.Tensor],
                  t0: float) -> _InFlight:
        """A mesh step's flight: ONE gather over the ``"data"`` group of
        this rank's rows of every ready unit's outputs and of the adaptive
        units' calibration state, each then cut to the unit's real
        streams."""
        parts = list(outs)
        adaptive = [gi for gi, _ in key if self._units[gi].adapt is not None]
        for gi in adaptive:
            parts += [self._calibs[gi], self._counts[gi].to(torch.float32)]
        flat = torch.cat([p.reshape(-1) for p in parts])
        full = _gather(flat, self._data_group, self.n_shards) \
            .view(self.n_shards, -1)
        self.stats.collectives["data"] += 1
        cut, at = [], 0
        # Each part holds its unit's rows: parts follow key's order, then
        # the adaptive units' (calib, counts) pairs.
        owners = [gi for gi, _ in key] + [gi for gi in adaptive
                                          for _ in range(2)]
        for gi, p in zip(owners, parts):
            n = p.numel()
            rows = full[:, at:at + n].reshape((-1,) + tuple(p.shape[1:]))
            cut.append(rows[:self._units[gi].n_streams])
            at += n
        outs, rest = cut[:len(key)], cut[len(key):]
        states = {gi: (rest[2 * k], rest[2 * k + 1].to(torch.int32))
                  for k, gi in enumerate(adaptive)}
        return _InFlight(key, outs, self._count - 1, t0, states=states)

    def _land(self, flight: _InFlight, verdicts: List[Verdict],
              t0: float) -> List[Verdict]:
        """Finish an ingest that dispatched ``flight``: leave it in flight
        (async, ``verdicts`` holds the previous step's) or turn it into
        verdicts now (sync)."""
        if self.async_depth:
            # Dispatch-and-return: the harvest at the next ready boundary
            # (or flush) turns the step into verdicts.
            self._inflight = flight
        else:
            verdicts = self._finalize(flight)
        self.stats.wall_s += time.perf_counter() - t0
        return verdicts

    def _harvest(self) -> List[Verdict]:
        """Finalize the in-flight step, if any (async_depth=1)."""
        flight, self._inflight = self._inflight, None
        return [] if flight is None else self._finalize(flight)

    def _finalize(self, flight: _InFlight) -> List[Verdict]:
        """Wait for a dispatched step's outputs on the host and turn them
        into verdicts (+ harvest-side accounting + adapt recalibration).
        Shared by the sync path and the async harvest, so verdict content is
        identical across modes."""
        outs = flight.host_outputs()
        latency = time.perf_counter() - flight.t0
        miss = latency > self.deadline_s
        verdicts: List[Verdict] = []
        for (gi, _), out in zip(flight.key, outs):
            st = self._units[gi]
            self.last_outputs[st.name] = out
            # Streaming recalibration: the offline score-then-quantile
            # sequence re-hosted on the rolling state.  In async mode this
            # runs before the NEXT dispatch, so the state read here is
            # exactly this step's.
            if st.adapt is not None and st.fires % st.adapt.every == 0:
                calib, counts = (
                    (t.numpy() for t in flight.states[gi])
                    if gi in flight.states else
                    (self._calibs[gi].cpu().numpy(),
                     self._counts[gi].cpu().numpy()))
                thr = st.head.streaming_threshold(
                    calib, counts, min_count=st.adapt.min_count)
                if thr is not None:
                    st.live_threshold = thr
            pred, prob, score, thr = st.head.host_verdicts(
                out, threshold=st.live_threshold)
            for i in range(st.n_streams):
                verdicts.append(Verdict(
                    stream=st.offset + i, cycle=flight.cycle,
                    pred=int(pred[i]),
                    prob=None if prob is None else float(prob[i]),
                    latency_s=latency, deadline_miss=miss,
                    score=None if score is None else float(score[i]),
                    threshold=thr, group=st.name))
            st.windows += st.n_streams
            self.stats.windows += st.n_streams
            self.stats.deadline_misses += int(miss) * st.n_streams
        self.stats.latencies_s.append(latency)
        return verdicts

    def flush(self) -> List[Verdict]:
        """Drain the in-flight verdict step (``async_depth=1``); returns
        ``[]`` when nothing is in flight (always, in sync mode)."""
        t0 = time.perf_counter()
        verdicts = self._harvest()
        self.stats.wall_s += time.perf_counter() - t0
        return verdicts

    def run(self, streams: Sequence[Any], n_cycles: int,
            on_verdict: Optional[Callable[[Verdict], None]] = None,
            ) -> List[Verdict]:
        """Drive a fleet of ``PlantStream``-likes for ``n_cycles`` cycles.

        Each stream's ``step()`` must yield an object with ``tb0_meas`` /
        ``wd_meas`` attributes (simulation cost is not counted into the
        engine's serve stats — only ingest time is).  Under ``async_depth=1``
        the final step stays in flight until :meth:`flush`.
        """
        if len(streams) != self.n_streams:
            raise ValueError(
                f"fleet size {len(streams)} != engine streams "
                f"{self.n_streams}")
        if self.n_features != 2:
            raise ValueError("run() reads the MSF (tb0_meas, wd_meas) "
                             "layout; use ingest() directly for other "
                             "feature sets")
        out: List[Verdict] = []
        readings = np.zeros((self.n_streams, self.n_features), np.float32)
        for _ in range(n_cycles):
            for i, s in enumerate(streams):
                r = s.step()
                readings[i, 0] = r.tb0_meas
                readings[i, 1] = r.wd_meas
            for v in self.ingest(readings):
                out.append(v)
                if on_verdict is not None:
                    on_verdict(v)
        return out
