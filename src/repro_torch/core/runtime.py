"""Scan-cycle runtime and multipart inference (§3.3, §6.3), the counterpart
of ``repro.core.runtime``.

PLCs run a hard-periodic *scan cycle*: read inputs → control logic → write
outputs.  Inference must fit in the slack left after the control task, so
ICSML supports **multipart inference**: the linear layer schedule is split
into segments and one segment executes per cycle; the model output appears
after ``n_segments`` cycles (the paper runs a MobileNet at a 90 ms cycle with
1.17 s output latency this way).

Here:

* segments run eagerly on the params' device, each one
  ``Model.apply_segment`` over the inference's arena, which :meth:`
  MultipartInference.start` allocates there and every segment updates in
  place (like dataMem on the PLC);
* segment boundaries are chosen ahead of time to balance per-segment FLOPs
  (integers on the host, identical to the reference's), so each cycle's
  inference cost is predictable — the property the scan cycle needs;
* :class:`ScanCycleRuntime` simulates the PLC loop: control task + at most
  one inference segment per cycle, with per-cycle wall-time accounting used
  by the non-intrusiveness study (§7.2).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import memory as memlib
from repro_torch.core.model import Model, ParamTree
from repro_torch.device import params_device, to_device


def segment_boundaries(model: Model, n_segments: int) -> List[Tuple[int, int]]:
    """Split the linear schedule into ``n_segments`` contiguous FLOP-balanced
    segments.  Returned as [start, stop) node-index ranges."""
    n_nodes = len(model.graph.nodes)
    n_segments = max(1, min(n_segments, n_nodes))
    flops = list(model.node_flops().values())
    total = sum(flops) or 1
    target = total / n_segments
    bounds: List[Tuple[int, int]] = []
    start, acc = 0, 0.0
    for i, f in enumerate(flops):
        acc += f
        remaining_nodes = n_nodes - (i + 1)
        remaining_segs = n_segments - len(bounds) - 1
        if (acc >= target and remaining_segs > 0) or remaining_nodes == remaining_segs:
            if remaining_segs > 0:
                bounds.append((start, i + 1))
                start, acc = i + 1, 0.0
    bounds.append((start, n_nodes))
    if len(bounds) != n_segments:
        raise AssertionError(f"{bounds} is not {n_segments} segments")
    return bounds


@dataclasses.dataclass
class MultipartState:
    """In-flight inference: the arena plus progress bookkeeping."""

    arena: torch.Tensor
    x: torch.Tensor
    next_segment: int

    def finished(self, n_segments: int) -> bool:
        return self.next_segment >= n_segments


class MultipartInference:
    """Multipart inference executor (§6.3).

    Runs on the device of ``params`` (``"cuda"`` when the tree holds no
    tensor, which raises without a card)."""

    def __init__(self, model: Model, params: ParamTree, n_segments: int):
        self.model = model
        self.params = params
        self.device = params_device(params)
        self.plan = model.memory_plan()
        self.bounds = segment_boundaries(model, n_segments)
        self.n_segments = len(self.bounds)

    # -- lifecycle -----------------------------------------------------------
    def start(self, x) -> MultipartState:
        """A fresh arena on the device, and ``x`` moved there."""
        x = (x.to(self.device) if isinstance(x, torch.Tensor)
             else to_device(np.asarray(x), self.device))
        return MultipartState(arena=memlib.new_arena(self.plan, self.device),
                              x=x, next_segment=0)

    def step(self, state: MultipartState) -> MultipartState:
        """Run exactly one segment (one scan cycle's worth of inference)."""
        if state.finished(self.n_segments):
            raise RuntimeError("inference already complete; call start() again")
        a, b = self.bounds[state.next_segment]
        arena = self.model.apply_segment(self.params, state.arena, state.x,
                                         a, b, self.plan)
        return MultipartState(arena=arena, x=state.x,
                              next_segment=state.next_segment + 1)

    def output(self, state: MultipartState) -> torch.Tensor:
        if not state.finished(self.n_segments):
            raise RuntimeError("inference not complete")
        return self.model.read_output(state.arena, self.plan)

    def run_all(self, x) -> torch.Tensor:
        state = self.start(x)
        while not state.finished(self.n_segments):
            state = self.step(state)
        return self.output(state)

    def segment_flops(self) -> List[int]:
        flops = list(self.model.node_flops().values())
        return [sum(flops[a:b]) for a, b in self.bounds]


# ---------------------------------------------------------------------------
# Scan-cycle simulation
# ---------------------------------------------------------------------------

ControlTask = Callable[[np.ndarray, Any], Tuple[np.ndarray, Any]]


@dataclasses.dataclass
class CycleLog:
    """Per-cycle record produced by the runtime (→ §7.2 non-intrusiveness)."""

    cycle_times_s: List[float] = dataclasses.field(default_factory=list)
    control_outputs: List[np.ndarray] = dataclasses.field(default_factory=list)
    detections: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # (cycle index when inference finished, predicted class)
    inference_latency_cycles: List[int] = dataclasses.field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        ct = np.asarray(self.cycle_times_s)
        out = np.asarray(self.control_outputs)
        return {
            "cycles": len(ct),
            "cycle_time_mean_s": float(ct.mean()) if ct.size else 0.0,
            "cycle_time_p99_s": float(np.percentile(ct, 99)) if ct.size else 0.0,
            "control_output_mean": float(out.mean()) if out.size else 0.0,
            "control_output_std": float(out.std()) if out.size else 0.0,
            "n_inferences": len(self.inference_latency_cycles),
        }


class SlidingWindowDetector:
    """The case-study defense: a classifier over the last W sensor readings,
    evaluated multipart so at most one segment runs per scan cycle (§7).

    The window ring stays on the host; when an inference starts, the window
    goes to the engine's device, and when it ends the logits come back —
    the only two transfers."""

    def __init__(
        self,
        model: Model,
        params: ParamTree,
        window: int,
        n_features: int,
        n_segments: int = 1,
    ):
        self.window = window
        self.n_features = n_features
        self.engine = MultipartInference(model, params, n_segments)
        self._buffer = np.zeros((window, n_features), np.float32)
        self._filled = 0
        self._state: Optional[MultipartState] = None
        self._started_at_cycle = -1

    def push(self, reading: np.ndarray) -> None:
        self._buffer = np.roll(self._buffer, -1, axis=0)
        self._buffer[-1] = reading
        self._filled = min(self._filled + 1, self.window)

    @property
    def ready(self) -> bool:
        return self._filled >= self.window

    def tick(self, cycle: int) -> Optional[Tuple[int, int, int]]:
        """Advance inference by one segment.  Returns (cycle, prediction,
        latency_cycles) when an inference completes, else None."""
        if self._state is None:
            if not self.ready:
                return None
            # Feature layout matches §7: ordered readings, features interleaved.
            self._state = self.engine.start(self._buffer.reshape(-1))
            self._started_at_cycle = cycle
        self._state = self.engine.step(self._state)
        if self._state.finished(self.engine.n_segments):
            logits = self.engine.output(self._state).cpu().numpy()
            pred = int(logits.argmax())
            latency = cycle - self._started_at_cycle + 1
            self._state = None
            return (cycle, pred, latency)
        return None


class ScanCycleRuntime:
    """Simulated PLC scan-cycle loop: sense → control → (defense) → actuate."""

    def __init__(
        self,
        control_task: ControlTask,
        detector: Optional[SlidingWindowDetector] = None,
        cycle_budget_s: float = 0.1,
    ):
        self.control_task = control_task
        self.detector = detector
        self.cycle_budget_s = cycle_budget_s

    def run(
        self,
        sensor_stream: Sequence[np.ndarray],
        control_state: Any = None,
    ) -> CycleLog:
        log = CycleLog()
        for cycle, reading in enumerate(sensor_stream):
            t0 = time.perf_counter()
            # 1. control logic (the PLC's primary task — must never be starved)
            output, control_state = self.control_task(reading, control_state)
            # 2. defense: push reading, advance inference by one segment
            if self.detector is not None:
                self.detector.push(np.asarray(reading, np.float32))
                result = self.detector.tick(cycle)
                if result is not None:
                    done_cycle, pred, latency = result
                    log.inference_latency_cycles.append(latency)
                    if pred != 0:
                        log.detections.append((done_cycle, pred))
            log.cycle_times_s.append(time.perf_counter() - t0)
            log.control_outputs.append(np.asarray(output))
        return log
