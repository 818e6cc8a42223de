"""Named attack scenarios over the MSF plant — the fleet workload library.

The §7 dataset exercises seven attack families one at a time on one canned
plant.  Fleet-scale serving needs a *heterogeneous* workload: this module
composes the families into named scenarios (family x onset x intensity x
duration, plus multi-attack sequences) and adds per-plant physical-parameter
jitter, so a fleet of :class:`~repro_torch.sim.msf.PlantStream` instances exercises
the detector on plants that differ in dynamics, attack timing and magnitude.

Scenario semantics: events are scheduled in absolute scan cycles; when events
overlap the earliest-listed one wins (one adversary at the controls at a
time).  Jitter perturbs the plant's *physical* constants (thermal time
constant, steam/flash gains, noise floors) — never the Wd setpoint, which the
operator fixes fleet-wide — so normal operation stays near the nominal point
the detector was calibrated on while transients differ per plant.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim.msf import (ATTACK_NAMES, AttackEvent, ParamDrift, PlantParams,
                           PlantStream, jitter_params)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, reproducible attack schedule for one plant.

    ``drift`` optionally creeps the plant's physical constants over the run
    (:class:`~repro_torch.sim.msf.ParamDrift`) — benign, so a drift-only scenario
    has no onset and its verdict stream counts toward false-positive rate,
    not detection."""

    name: str
    description: str
    events: Tuple[AttackEvent, ...] = ()
    jitter: float = 0.01          # relative physical-parameter jitter
    drift: Optional[ParamDrift] = None

    @property
    def families(self) -> Tuple[int, ...]:
        return tuple(sorted({e.attack_id for e in self.events}))

    @property
    def composed(self) -> bool:
        return len(self.events) >= 2

    @property
    def onset(self) -> Optional[int]:
        """First attacked cycle (None for a benign scenario)."""
        return min((e.start for e in self.events), default=None)


def _s(name: str, description: str, *events: AttackEvent,
       jitter: float = 0.01, drift: Optional[ParamDrift] = None) -> Scenario:
    return Scenario(name=name, description=description, events=tuple(events),
                    jitter=jitter, drift=drift)


# One scenario per family at §7 magnitudes, plus intensity/duration variants
# and composed multi-attack sequences.  Onsets leave ≥1 full detector window
# (200 cycles) of normal operation first.
_ALL = [
    _s("baseline", "benign operation, jittered plant"),
    _s("steam-throttle", "steam valve scaled down (family 1)",
       AttackEvent(1, start=400)),
    _s("recycle-starve", "recycle brine flow cut (family 2)",
       AttackEvent(2, start=400)),
    _s("reject-flood", "water rejection forced up (family 3)",
       AttackEvent(3, start=400)),
    _s("tb0-spoof", "TB0 sensor false-data injection (family 4)",
       AttackEvent(4, start=400)),
    _s("wd-spoof", "Wd sensor false-data injection (family 5)",
       AttackEvent(5, start=400)),
    _s("valve-flutter", "oscillatory steam valve (family 6)",
       AttackEvent(6, start=400)),
    _s("stealth-drift", "slow recycle-efficiency ramp (family 7)",
       AttackEvent(7, start=300)),
    _s("steam-pulse", "short, hard steam throttle burst",
       AttackEvent(1, start=400, duration=200, intensity=1.5)),
    _s("gentle-starve", "low-intensity recycle cut (stealthier family 2)",
       AttackEvent(2, start=500, intensity=0.5)),
    _s("spoof-then-starve", "TB0 spoof burst, then a recycle cut",
       AttackEvent(4, start=300, duration=300),
       AttackEvent(2, start=800)),
    _s("flutter-then-throttle", "valve flutter probing, then a throttle",
       AttackEvent(6, start=300, duration=400, intensity=0.8),
       AttackEvent(1, start=900)),
    _s("drift-then-spoof", "stealth ramp handing off to a Wd spoof",
       AttackEvent(7, start=200, duration=600),
       AttackEvent(5, start=900)),
    _s("full-gauntlet", "three families back to back with recovery gaps",
       AttackEvent(1, start=300, duration=200),
       AttackEvent(3, start=700, duration=200),
       AttackEvent(5, start=1100, duration=200)),
    # Drifting plants (time-varying physical constants, NOT attacks): the
    # flash-gain decay moves the PID-held TB0 operating point by ~2 sigma of
    # the detector normalization — the benign-score creep that floods a
    # fixed threshold and that streaming recalibration must absorb.
    _s("seasonal-drift",
       "benign flash-gain decay + warming seawater; no attack",
       drift=ParamDrift({"k_flash": -0.08, "t_sea": 0.04},
                        start=300, ramp=1200)),
    _s("drift-then-throttle",
       "steam throttle landing on an already-drifted plant",
       AttackEvent(1, start=1300),
       drift=ParamDrift({"k_flash": -0.08}, start=300, ramp=800)),
]

SCENARIOS: Dict[str, Scenario] = {s.name: s for s in _ALL}
assert len(SCENARIOS) == len(_ALL), "duplicate scenario name"
_BUILTIN = frozenset(SCENARIOS)     # the library core, never unregistrable


def list_scenarios() -> List[str]:
    return list(SCENARIOS)


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {', '.join(SCENARIOS)}")


def register_scenario(scenario: Scenario) -> Scenario:
    """Add a user-defined scenario to the library (name must be fresh).

    Registration mutates the process-global ``SCENARIOS`` dict; pair it
    with :func:`unregister_scenario`, or use the :func:`registered` context
    manager so the entry cannot leak across tests and sessions.
    """
    if scenario.name in SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


def unregister_scenario(name: str) -> Scenario:
    """Remove a previously registered scenario and return it.

    Built-in library scenarios are protected — the fleet builders and the
    example CLI assume they exist for the life of the process.
    """
    if name in _BUILTIN:
        raise ValueError(f"scenario {name!r} is a built-in library scenario "
                         "and cannot be unregistered")
    try:
        return SCENARIOS.pop(name)
    except KeyError:
        raise KeyError(
            f"scenario {name!r} is not registered; known: "
            f"{', '.join(SCENARIOS)}")


@contextlib.contextmanager
def registered(*scenarios: Scenario):
    """Scoped registration: the scenarios exist inside the ``with`` block
    and are removed on exit — even on error, and even if the block itself
    already unregistered some of them.  The sanctioned way for tests and
    ad-hoc drivers to extend the library without leaking global state."""
    added: List[str] = []
    try:
        for sc in scenarios:
            register_scenario(sc)
            added.append(sc.name)
        yield scenarios[0] if len(scenarios) == 1 else scenarios
    finally:
        for name in added:
            SCENARIOS.pop(name, None)


def build_fleet(
    names: Optional[Sequence[str]] = None,
    n_plants: Optional[int] = None,
    *,
    seed: int = 0,
    jitter: Optional[float] = None,
    base_params: Optional[PlantParams] = None,
    drift: Optional[ParamDrift] = None,
) -> List[PlantStream]:
    """A fleet of plant streams, scenarios assigned round-robin.

    ``names`` defaults to the full library; ``n_plants`` defaults to one plant
    per name.  ``jitter`` overrides every scenario's own jitter; ``drift``
    overrides every scenario's own drift (fleet-wide seasonal/wear drift on
    top of any attack schedule).  Each plant gets a distinct seed (process
    noise and jitter draws decorrelate), and its ``name`` records
    ``{scenario}#{index}`` for verdict attribution.
    """
    names = list(names) if names is not None else list(SCENARIOS)
    if not names:
        raise ValueError("need at least one scenario name")
    n_plants = n_plants if n_plants is not None else len(names)
    base = base_params or PlantParams()
    fleet: List[PlantStream] = []
    for i in range(n_plants):
        sc = get_scenario(names[i % len(names)])
        rel = sc.jitter if jitter is None else jitter
        params = jitter_params(base, rel, np.random.default_rng(seed + 7919 * i))
        fleet.append(PlantStream(params, events=sc.events, seed=seed + i,
                                 name=f"{sc.name}#{i}",
                                 drift=sc.drift if drift is None else drift))
    return fleet


def fleet_readings(
    n_streams: int,
    n_cycles: int,
    *,
    names: Optional[Sequence[str]] = None,
    seed: int = 0,
    jitter: Optional[float] = None,
    drift: Optional[ParamDrift] = None,
) -> np.ndarray:
    """A ``(n_cycles, n_streams, 2)`` raw ``(tb0_meas, wd_meas)`` matrix from
    a scenario fleet — the pre-generated reading block the detection bench
    and the sharded-parity tests drive engines with (simulation cost stays
    out of the serve clock)."""
    fleet = build_fleet(names, n_streams, seed=seed, jitter=jitter,
                        drift=drift)
    out = np.zeros((n_cycles, n_streams, 2), np.float32)
    for c in range(n_cycles):
        for i, s in enumerate(fleet):
            r = s.step()
            out[c, i] = (r.tb0_meas, r.wd_meas)
    return out


def scenario_table() -> str:
    """Human-readable library summary (used by examples/detect_fleet.py).

    ``onsets``/``durations`` list *every* scheduled event — a composed
    multi-attack scenario shows each attack's start cycle and length
    (``rest`` = persists to the end of the run), not just the first one.
    """
    rows = [f"{'name':<24} {'families':<9} {'onsets':<13} {'durations':<13} "
            "events"]
    for s in SCENARIOS.values():
        fams = ",".join(str(f) for f in s.families) or "-"
        onsets = ",".join(str(e.start) for e in s.events) or "-"
        durs = ",".join("rest" if e.duration is None else str(e.duration)
                        for e in s.events) or "-"
        evs = "; ".join(
            f"{ATTACK_NAMES[e.attack_id]}@{e.start}"
            + (f"+{e.duration}" if e.duration is not None else "")
            + (f" x{e.intensity:g}" if e.intensity != 1.0 else "")
            for e in s.events) or "(benign)"
        if s.drift is not None:
            drifted = ",".join(f"{k}{v:+.0%}" for k, v in s.drift.shifts)
            evs += (f" [drift {drifted}@{s.drift.start}"
                    f"+{s.drift.ramp}]")
        rows.append(f"{s.name:<24} {fams:<9} {onsets:<13} {durs:<13} {evs}")
    return "\n".join(rows)
