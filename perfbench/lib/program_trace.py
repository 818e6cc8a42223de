"""What the program's own tracer (``repro_torch.trace``) says of one engine
call, read with the same call's device trace.

The tracer's ``drain()`` gives spans (name, id, parent, uid, host start
and end on ``perf_counter_ns``, device time from CUDA events), counters
and two clock anchors; the device trace (``profiling.trace``) gives the
card's records in µs on the profiler's clock.  A span's host times are
put on the profiler's clock by interpolating between the anchors.  This
module imports nothing of the program: it reads the drained dict.

Readings (each ``None`` when the call has nothing to read):

- ``admit_ms``: mean device time of ``engine.admit``;
- ``step_device_ms``: mean device time of ``engine.step`` (the stream's
  time between the span's events: in a host-bound stretch it holds the
  launch gaps inside the step);
- ``step_busy_ms``: mean over ``engine.step`` spans of the union of the
  device's records inside the span's host interval, mapped onto the
  profiler's clock: the step's work without its gaps (it also holds the
  tail of an admission's kernels that run on into the step);
- ``moe_share``: Σ device time of ``model.moe`` inside ``engine.step`` over
  Σ device time of ``engine.step``, %;
- ``linear_share``: Σ device time of ``model.linear`` inside
  ``engine.prefill`` over Σ device time of ``engine.prefill``, %;
- ``slot_occupancy``: ``engine.active_slot_steps / engine.slot_steps``, %;
- ``idle_in_model`` / ``idle_in_engine``: the card's idle time inside
  ``engine.serve`` (the gaps in the union of its records) that overlaps a
  ``model.forward`` span / that overlaps none, over ``engine.serve``'s
  length, %.  The two add up to the call's own idle share.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, Iterable, List, Optional, Tuple

from perfbench.lib import profiling

Interval = Tuple[float, float]

# The spans whose device time the readings of each engine's calls read, each
# with the span it is read inside (the tracer's ``device_spans``): it records
# CUDA events for these alone (each event costs the host time, and tens of
# µs under torch.profiler).
DEVICE_SPANS = {
    "continuous": {"engine.admit": None, "engine.step": None,
                   "model.moe": "engine.step"},
    "wave": {"engine.prefill": None, "model.linear": "engine.prefill"}}


def wall_us(anchors, perf_ns: float) -> float:
    """A ``perf_counter_ns`` reading on the profiler's clock (µs of
    CLOCK_REALTIME), interpolated between the drain's two anchors."""
    (p0, w0), (p1, w1) = anchors
    rate = (w1 - w0) / (p1 - p0) if p1 != p0 else 1.0
    return (w0 + (perf_ns - p0) * rate) / 1e3


def span_us(doc: Dict[str, Any], s: Dict[str, Any]) -> Interval:
    return (wall_us(doc["anchors"], s["start_ns"]),
            wall_us(doc["anchors"], s["end_ns"]))


def named(doc: Dict[str, Any], name: str,
          inside: Optional[str] = None) -> List[Dict[str, Any]]:
    """The spans called ``name``; with ``inside``, only those that have an
    ancestor called ``inside``."""
    spans = [s for s in doc["spans"] if s["name"] == name]
    if inside is None:
        return spans
    by_id = {s["id"]: s for s in doc["spans"]}

    def has_ancestor(s):
        while s["parent"] is not None:
            s = by_id.get(s["parent"])
            if s is None:
                return False
            if s["name"] == inside:
                return True
        return False
    return [s for s in spans if has_ancestor(s)]


def _device_ms(spans: Iterable[Dict[str, Any]]) -> List[float]:
    return [s["device_ms"] for s in spans if s["device_ms"] is not None]


def mean_device_ms(doc, name: str) -> Optional[float]:
    ms = _device_ms(named(doc, name))
    return sum(ms) / len(ms) if ms else None


def device_share(doc, part: str, whole: str) -> Optional[float]:
    """Σ device time of ``part`` spans inside ``whole`` spans over Σ device
    time of the ``whole`` spans, %."""
    total = sum(_device_ms(named(doc, whole)))
    if not total:
        return None
    return 100.0 * sum(_device_ms(named(doc, part, inside=whole))) / total


def occupancy(doc) -> Optional[float]:
    c = doc["counters"]
    slots = c.get("engine.slot_steps", 0)
    if not slots:
        return None
    return 100.0 * c.get("engine.active_slot_steps", 0) / slots


def _merged(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _covered(gap: Interval, cover: List[Interval], starts: List[float]
             ) -> float:
    """Length of ``gap`` that the merged, sorted ``cover`` overlaps."""
    lo, hi = gap
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    got = 0.0
    while i < len(cover) and cover[i][0] < hi:
        got += max(0.0, min(hi, cover[i][1]) - max(lo, cover[i][0]))
        i += 1
    return got


def idle_split(doc, device: List[Interval]
               ) -> Optional[Tuple[float, float, float]]:
    """(idle in the engine, idle in the model, ``engine.serve``'s length),
    in µs: the gaps of the union of the ``device`` records (µs, the
    profiler's clock) inside each ``engine.serve`` span, each split by
    its overlap with ``model.forward`` spans."""
    serves = named(doc, "engine.serve")
    if not serves:
        return None
    cover = _merged(span_us(doc, s) for s in named(doc, "model.forward"))
    starts = [c[0] for c in cover]
    engine = model = length = 0.0
    for s in serves:
        window = span_us(doc, s)
        length += window[1] - window[0]
        for gap in profiling.gaps(device, window):
            inside = _covered(gap, cover, starts)
            model += inside
            engine += gap[1] - gap[0] - inside
    return engine, model, length


def mean_busy_ms(doc, device: List[Interval], name: str
                 ) -> Optional[float]:
    """Mean over the spans called ``name`` of the union of the ``device``
    records (µs, the profiler's clock) inside each span's mapped host
    interval, ms."""
    spans = named(doc, name)
    if not spans:
        return None
    cover = _merged(device)
    starts = [c[0] for c in cover]
    busy = sum(_covered(span_us(doc, s), cover, starts) for s in spans)
    return busy / len(spans) / 1e3


def readings(doc, device: List[Interval]) -> Dict[str, float]:
    """Every reading of the module docstring that the call gives."""
    out = {"admit_ms": mean_device_ms(doc, "engine.admit"),
           "step_device_ms": mean_device_ms(doc, "engine.step"),
           "step_busy_ms": mean_busy_ms(doc, device, "engine.step"),
           "moe_share": device_share(doc, "model.moe", "engine.step"),
           "linear_share": device_share(doc, "model.linear",
                                        "engine.prefill"),
           "slot_occupancy": occupancy(doc)}
    split = idle_split(doc, device)
    if split is not None and split[2] > 0:
        engine, model, length = split
        out["idle_in_engine"] = 100.0 * engine / length
        out["idle_in_model"] = 100.0 * model / length
    return {k: v for k, v in out.items() if v is not None}
