"""The port's tracer: spans and counters recorded where the work runs, off
by default.

``enable()`` turns it on and ``disable()`` off; nothing else does (no
environment variable, no file).  Everything stays in memory until
``drain()`` returns it.  There is one tracer a process, in this module's
state: its sites sit deep in model code that no tracer object could reach
without a new argument on every layer.

Off, :func:`span` returns one shared no-op context manager and
:func:`count` returns at once: no allocation, no clock read, no CUDA event
and never a device synchronisation.

On, a span records its name, its host start and end
(``time.perf_counter_ns``), its id, the id of the span that was innermost
open when it opened (its parent; spans nest on one thread) and an optional
request id (``uid``).  A span opened with a CUDA ``device`` (a
``torch.device`` or a tensor on one) also records a pair of
``torch.cuda.Event(enable_timing=True)``, one as it opens and one as it
closes, all on one stream: the one current when the first of them is
recorded after ``enable()`` (the program's work runs on one stream, and
looking the stream up for every event costs more than recording it).  The
hot path never waits on them: ``drain()`` resolves them, after the
caller's own read-back has synchronised.  ``enable(device_spans={name:
inside})`` records events only for the spans named there, and of those
with an ``inside`` name only for the ones opened inside an open span of
that name (a chat step holds ~30 ``model.linear`` spans, and under
torch.profiler every event recorded costs the host tens of µs).  A span's
device time is the stream's time between its two events, so where the
host feeds the card slower than the card works (a host-bound stretch) it
includes the launch gaps inside the span, not only its kernels; on an
idle stream the first event completes as soon as it is recorded, so the
span's device time also holds the launch of its first kernel.

``drain()`` also returns two clock anchors, each a ``(perf_counter_ns,
time_ns)`` pair: one taken at ``enable()`` (or at the previous drain) and
one at this drain.  A reader maps a span's host times onto the wall clock
(CLOCK_REALTIME, the clock torch.profiler stamps its records with) by
interpolating between the two (``perfbench/lib/program_trace.py``'s
``wall_us``), which keeps a slewing wall clock out of the mapping.

Sites (each read by ``perfbench/lib/program_trace.py``, PERF.md §3): ``engine.serve``,
``engine.prefill``, ``engine.admit``, ``engine.step`` in
``serving/engine.py`` and ``serving/continuous.py``; ``model.forward`` in
``models/api.py``; ``model.moe`` in ``models/moe.py``; ``model.linear``
in ``models/common.py``; the counters ``engine.slot_steps`` and
``engine.active_slot_steps`` in ``serving/continuous.py``.  The counter
``model.norm_codes`` in ``kernels/ops.py`` counts the ``norm_codes``
launches (a Mamba-2 block's pre-norm or gated norm writing its projection's
codes); no reader takes it yet.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Tuple

_on = False
_spans: List["_Span"] = []
_open: List["_Span"] = []          # the open spans, innermost last
_counters: Dict[str, int] = {}
_anchor: Optional[Tuple[int, int]] = None
_ids = itertools.count()
_stream: Any = None                # the stream events are recorded on
# span name -> the name of a span it must be inside (None: anywhere) for
# its device time to be recorded; None records it for every span
_device_spans: Optional[Dict[str, Optional[str]]] = None


class _Off:
    """The span handed out while tracing is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _event_stream():
    global _stream
    if _stream is None:
        import torch
        _stream = torch.cuda.current_stream()
    return _stream


class _Span:
    __slots__ = ("name", "uid", "id", "parent", "start_ns", "end_ns",
                 "events")

    def __init__(self, name: str, uid: Optional[int], cuda: bool):
        self.name, self.uid, self.id = name, uid, next(_ids)
        if cuda:
            import torch
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        else:
            self.events = None

    def __enter__(self):
        self.parent = _open[-1].id if _open else None
        _open.append(self)
        self.start_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[0].record(_event_stream())
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(_event_stream())
        self.end_ns = time.perf_counter_ns()
        _open.pop()
        _spans.append(self)
        return False


def _is_cuda(device: Any) -> bool:
    return device is not None and getattr(
        getattr(device, "device", device), "type", None) == "cuda"


def span(name: str, *, uid: Optional[int] = None, device: Any = None):
    """A context manager timing the work it encloses: host times always,
    device time too when ``device`` (a ``torch.device`` or a tensor) is a
    CUDA one.  The shared no-op when tracing is off."""
    if not _on:
        return _OFF
    return _Span(name, uid, _is_cuda(device) and _wants_device(name))


def _wants_device(name: str) -> bool:
    if _device_spans is None:
        return True
    if name not in _device_spans:
        return False
    inside = _device_spans[name]
    return inside is None or any(s.name == inside for s in _open)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (only when tracing is on)."""
    if _on:
        _counters[name] = _counters.get(name, 0) + int(n)


def enabled() -> bool:
    return _on


def _anchor_now() -> Tuple[int, int]:
    return time.perf_counter_ns(), time.time_ns()


def enable(device_spans: Optional[Dict[str, Optional[str]]] = None) -> None:
    """Start recording; takes the first clock anchor.  ``device_spans``:
    the span names that record device time, each with the name of the span
    it must be inside to record it, or None (every span records it when
    ``device_spans`` is None)."""
    global _on, _anchor, _stream, _device_spans
    _stream = None
    _device_spans = None if device_spans is None else dict(device_spans)
    _on, _anchor = True, _anchor_now()


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain()``."""
    global _on
    _on = False


def drain() -> Dict[str, Any]:
    """Return and clear what was recorded since ``enable()`` or the last
    drain: ``spans`` (dicts of ``name``, ``id``, ``parent``, ``uid``,
    ``start_ns``, ``end_ns`` on ``perf_counter_ns``, and ``device_ms``,
    None for a span without events), ``counters`` and ``anchors`` (the
    pair a reader interpolates between).  Waits for the device when a
    span recorded events: call it after the traced work."""
    global _anchor
    now = _anchor_now()
    spans, _spans[:] = list(_spans), []
    if any(s.events is not None for s in spans):
        import torch
        torch.cuda.synchronize()
    out = []
    for s in spans:
        ms = None
        if s.events is not None:
            ms = s.events[0].elapsed_time(s.events[1])
        out.append({"name": s.name, "id": s.id, "parent": s.parent,
                    "uid": s.uid, "start_ns": s.start_ns,
                    "end_ns": s.end_ns, "device_ms": ms})
    counters = dict(_counters)
    _counters.clear()
    anchors = [_anchor if _anchor is not None else now, now]
    _anchor = now
    return {"spans": out, "counters": counters, "anchors": anchors}
