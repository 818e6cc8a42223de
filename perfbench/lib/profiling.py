"""Device traces of a piece of work, and what the benchmark reads from them.

``trace`` is a frozen copy of ``chip_smoke.py``'s ``device_events`` /
``_device_events_once``: an empty torch.profiler session first, then a
session that opens with ``LEAD_IN`` of PyTorch's spin kernels (left out by
name), since a session loses its first device records once the process
has aged; a session that lost records of a kernel the caller counts is
taken again, up to ``PROFILE_TRIES`` times.  Unlike the original it keeps
each record's interval, so that the busy time is the union of the
device's intervals (overlapping records count once); it reads kineto's
raw records (the device's kernels, copies and sets, not the annotations
that mirror host ranges on the device); and it traces the device alone
unless asked for the host's ops, which slow a call of many small ops
about twofold (a traced Jamba chat call: 28.5 s against ~15 s).
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

LEAD_IN, LEAD_IN_KERNEL = 64, "spin_kernel"
PROFILE_TRIES = 3
WINDOW_MARK = "perfbench.traced_window"
# Host ops that only launch or wait: a gap is named by the op around them.
_RUNTIME_PREFIXES = ("cu", "Memcpy", "Memset")
# Kernel names are cut to this length in the breakdown (templates run long).
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    """One traced call: device records (and with ``host`` the host's
    ops), in µs on the profiler's clock; the call's length by the host's
    clock, and with ``host`` its interval on the profiler's clock."""
    device: List[Tuple[str, float, float]]      # (name, start, end)
    window_s: float                             # perf_counter around fn
    host: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)
    window: Optional[Tuple[float, float]] = None

    def kernel_records(self, name: str) -> List[Tuple[float, float]]:
        """(start, end) of every device record whose name holds ``name``,
        in time order."""
        return sorted((s, e) for n, s, e in self.device if name in n)


def _session(fn: Callable[[], None], host: bool):
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _once(fn: Callable[[], None], host: bool) -> Trace:
    import torch
    _session(lambda: None, host)
    wall = {}

    def lead_then_fn():
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW_MARK):
            fn()
            torch.cuda.synchronize()
        wall["s"] = time.perf_counter() - t0

    prof = _session(lead_then_fn, host)
    # The raw records (kineto's), not prof.events(): building the event
    # tree of a call of some 10^6 records takes minutes.
    device, ops, window = [], [], None
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == cuda:
            if LEAD_IN_KERNEL not in name and not e.is_user_annotation() \
                    and name != WINDOW_MARK:
                device.append((name, start, end))
        elif name == WINDOW_MARK:
            window = (start, end)
        else:
            ops.append((name, start, end))
    if window is not None:
        lo, hi = window
        device = [(n, s, e) for n, s, e in device if e > lo and s < hi]
    elif host:
        raise RuntimeError(f"the profiler lost the {WINDOW_MARK} record")
    return Trace(device=device, window_s=wall["s"], host=ops, window=window)


def trace(fn: Callable[[], None],
          expect: Optional[Callable[[], Dict[str, int]]] = None,
          host: bool = False) -> Trace:
    """Trace ``fn``: the device's records only (the profiler then costs
    the host little, so the call keeps its own pace), or with ``host``
    the host's ops too (which slows the host's side of the call: read its
    gaps by what the host was doing, not by their length).  ``expect``,
    called after each session, maps a kernel's name to the records that
    session must hold; a session that holds fewer is taken again (``fn``
    run again)."""
    got = None
    for _ in range(PROFILE_TRIES):
        got = _once(fn, host)
        if expect is None or all(
                len(got.kernel_records(name)) == count
                for name, count in expect().items()):
            break
    return got


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals in µs, as seconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def gaps(intervals: List[Tuple[float, float]], window: Tuple[float, float]
         ) -> List[Tuple[float, float]]:
    """The stretches of ``window`` that no interval covers."""
    out, at = [], window[0]
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, window[1])))
        at = max(at, e)
        if at >= window[1]:
            break
    if at < window[1]:
        out.append((at, window[1]))
    return [(s, e) for s, e in out if e > s]


def busy_and_window(t: Trace) -> Tuple[float, float]:
    """(busy_s, window_s): the union of the device's records in the traced
    call, and the call's length by the host's clock."""
    return union_seconds([(s, e) for _, s, e in t.device]), t.window_s


def _host_op_at(host_sorted, starts, when: float) -> str:
    """The innermost host op (latest start) running at ``when``, runtime
    calls left out; "python" when none is."""
    i = bisect.bisect_right(starts, when)
    for j in range(i - 1, max(i - 4000, -1), -1):
        name, s, e = host_sorted[j]
        if s <= when <= e and not name.startswith(_RUNTIME_PREFIXES):
            return name
    return "python"


def breakdown(t: Trace, labels: Trace, top: int = 10
              ) -> Dict[str, List[List]]:
    """The device ops of ``t`` that took the most time (summed by name),
    and the idle time of ``labels`` (a trace with the host's ops) summed
    by the host op that was running in each gap (the longest gaps first),
    at most ``top`` entries each, in seconds."""
    by_name: Dict[str, float] = {}
    for name, s, e in t.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host_sorted = sorted(labels.host, key=lambda h: h[1])
    starts = [h[1] for h in host_sorted]
    idle: Dict[str, float] = {}
    # Name the longest gaps; the rest are launch-sized.
    longest = sorted(gaps([(s, e) for _, s, e in labels.device],
                          labels.window),
                     key=lambda g: g[0] - g[1])[:5000]
    for s, e in longest:
        label = _host_op_at(host_sorted, starts, (s + e) / 2)
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gap_list]}
