"""The fleet-serving core behind ``StreamEngine``: the single-device path of
``repro.serving.core`` in PyTorch.

**The unit model.**  A serving core drives a list of *units*: contiguous
stream-axis slices, each with its own model, detector head, window geometry,
fused/per-layer forward and optional drift adaptation.  ``StreamEngine`` is
the one-unit case (its unit is anonymous, so verdicts keep ``group=None``).
Per verdict cadence the core runs one step for each ready unit: the ring
scatter of the pending readings, the oldest-first window unroll, the head's
``prepare``, the forward and the head's device epilogue.

**The ring arena** of each unit is one tensor preallocated on the device and
updated in place, the counterpart of the reference's donated
``donate_argnums=(0, 1, 2)`` step (the ring and the adaptation state are
never reallocated).  Readings accumulate on the host between cadences and
are uploaded once per step, so a stride-10 fleet touches the device once per
verdict cadence.

**The forward** is ``ops.fused_forward``: the whole Dense stack as ONE
``fused_mlp`` kernel launch on the card, SINT requantizing in-kernel.  With
``fused=False`` (or a stack that does not fuse) it is the per-layer loop
:func:`_dense_batched`, where each SINT layer is one ``qmatmul`` launch.

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

Fleet meshes (stream and model sharding) and the grouped megakernel are not
ported yet (ROADMAP items 9 and 12).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import msf_detector as spec
from repro_torch.core.layers import ACTIVATIONS
from repro_torch.core.model import Model, ParamTree
from repro_torch.device import Device, resolve_device, to_device
from repro_torch.kernels import ops
from repro_torch.sim.heads import ClassifierHead, DetectorHead, ScoreHead

NOT_PORTED_MESH = ("fleet meshes and the grouped megakernel are not ported "
                   "to PyTorch yet (ROADMAP items 9 and 12)")


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

    ``dispatches`` counts forward launches: 1 per step for a fused unit, one
    per Dense layer for a per-layer unit (a ``qmatmul`` launch for each SINT
    layer, a plain matmul for the others).  Under ``async_depth=1``
    ``steps`` counts at dispatch and ``windows``/``deadline_misses``/
    ``latencies_s`` at harvest.
    """

    steps: int                       # detector steps executed
    cycles: int                      # scan cycles ingested
    windows: int                     # verdicts emitted (streams x steps)
    deadline_misses: int
    wall_s: float                    # total time spent inside ingest()
    dispatches: int = 0              # forward launches issued
    latencies_s: LatencyReservoir = dataclasses.field(
        default_factory=LatencyReservoir)

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

    __slots__ = ("name", "head", "window", "offset", "n_streams", "body",
                 "pos", "consumed", "use_fused", "windows", "adapt",
                 "live_threshold", "fires", "dispatch_cost")

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
    ``done`` marks their completion on the stream."""

    __slots__ = ("key", "outs", "cycle", "t0", "done")

    def __init__(self, key, outs: Sequence[torch.Tensor], cycle, t0):
        self.key = key                # ((unit index, block length), ...)
        self.cycle = cycle            # boundary cycle the windows completed at
        self.t0 = t0                  # dispatch wall-clock (latency origin)
        self.outs = [o.to("cpu", non_blocking=True) for o in outs]
        self.done = None
        if any(o.is_cuda for o in outs):
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(outs[0].device))

    def host_outputs(self) -> List[np.ndarray]:
        if self.done is not None:
            self.done.synchronize()
        return [o.numpy() for o in self.outs]


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
    machine without CUDA; params must already live there.
    """

    def __init__(self, units: Sequence[ServingUnit], *,
                 n_features: int = spec.N_FEATURES,
                 stride: int = spec.STRIDE,
                 deadline_s: float = spec.DEADLINE_S,
                 norm_mean: Sequence[float] = spec.NORM_MEAN,
                 norm_std: Sequence[float] = spec.NORM_STD,
                 backend: str = "auto",
                 mesh: Any = None,
                 async_depth: int = 0,
                 device: Device = "cuda"):
        if mesh is not None:
            raise NotImplementedError(NOT_PORTED_MESH)
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
            use_fused = fusable if u.fused is None else u.fused
            st = _UnitState(u.name, head, window, offset, u.n_streams)
            st.use_fused = use_fused
            st.dispatch_cost = 1 if use_fused else len(stack)
            st.adapt = _resolve_adapt(u.adapt, head, what=u.what)
            st.live_threshold = (head.threshold
                                 if isinstance(head, ScoreHead) else None)
            st.body = self._make_body(stack, head, use_fused, window,
                                      st.adapt)
            self._units.append(st)
            self._rings.append(torch.zeros(
                (u.n_streams, window, n_features), dtype=torch.float32,
                device=self.device))
            calib, counts = self._calib_state(st)
            self._calibs.append(calib)
            self._counts.append(counts)
            offset += u.n_streams
        self.max_window = max(st.window for st in self._units)

        self._count = 0
        self._pending: List[np.ndarray] = []
        self._inflight: Optional[_InFlight] = None
        self.last_outputs: Dict[Optional[str], np.ndarray] = {}
        self.stats = StreamStats(steps=0, cycles=0, windows=0,
                                 deadline_misses=0, wall_s=0.0)

    # -- construction helpers ----------------------------------------------

    def _calib_state(self, st: _UnitState) -> Tuple[
            Optional[torch.Tensor], Optional[torch.Tensor]]:
        """A unit's rolling calibration state; (None, None) when it does not
        adapt."""
        if st.adapt is None:
            return None, None
        return st.head.calib_state(st.n_streams, st.adapt.capacity,
                                   self.device)

    @staticmethod
    def _thr(st: _UnitState) -> float:
        """The unit's live threshold as the step's scalar operand (0.0 for
        heads with no threshold — the body never reads it then)."""
        return 0.0 if st.live_threshold is None else float(st.live_threshold)

    def _make_body(self, stack, head, use_fused, window, adapt_cfg):
        """One unit's device step: ring scatter, oldest-first unroll, the
        head's ``prepare`` view, the forward, the head's device epilogue
        and, when the unit adapts, the rolling calibration-state write.
        Ring and calibration state are updated in place."""
        backend = self._backend
        w = window
        # Laid out for the kernel once: the launch descriptor carries the
        # activation scales by value, read from the device here and never
        # again on the serving path.
        fused = ops.prepare_fused(stack) if use_fused else None

        def forward(x):
            if fused is not None:
                return ops.fused_forward(x, fused, backend=backend)
            for p, act in stack:
                x = _dense_batched(x, p, act, backend)
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

        return body

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
        Serving state is left untouched."""
        for key in self._schedule_keys():
            for gi, length in key:
                st = self._units[gi]
                ring = torch.zeros_like(self._rings[gi])
                calib, counts = self._calib_state(st)
                block = torch.zeros((st.n_streams, length, self.n_features),
                                    dtype=torch.float32, device=self.device)
                st.body(ring, calib, counts, block, 0, self._thr(st))
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

        key, outs = [], []
        for gi, st in ready:
            # span = cycles since the unit's last step; the pending tail
            # holds at least the last min(span, window) readings.
            span = self._count - st.consumed
            length = min(span, st.window)
            block = np.stack(self._pending[-length:], axis=1)     # (S, L, F)
            block = block[st.offset:st.offset + st.n_streams]
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
        self.stats.steps += 1

        flight = _InFlight(tuple(key), outs, self._count - 1, t0)
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
                thr = st.head.streaming_threshold(
                    self._calibs[gi].cpu().numpy(),
                    self._counts[gi].cpu().numpy(),
                    min_count=st.adapt.min_count)
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
