"""What the program's own spans say about the window (host clock)."""

from __future__ import annotations

from typing import Optional


def wave_prefill_s(run) -> Optional[float]:
    """Mean ``Completion.prefill_s`` of the wave engine's waves (one value
    per wave: the prefill and its first token read back)."""
    waves = {(id(c), d.finished_s): d.prefill_s for c in run.calls
             if c.kind == "wave" for d in c.done}
    return sum(waves.values()) / len(waves) if waves else None


def step_s(run) -> Optional[float]:
    """The continuous engine's ``ServeStats.wall_s`` less its admissions'
    ``prefill_s``, over ``ServeStats.steps``."""
    calls = [c for c in run.calls if c.kind == "continuous" and c.stats]
    steps = sum(c.stats.steps for c in calls)
    if not steps:
        return None
    return sum(c.stats.wall_s - sum(d.prefill_s for d in c.done)
               for c in calls) / steps
