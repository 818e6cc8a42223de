"""Multi-Stage Flash desalination plant simulation + process-aware attacks.

Stand-in for the paper's MATLAB/Simulink HITL setup (§7): a reduced-order
thermal model of an MSF plant (validated against the qualitative behaviour in
Ali 2002 / Rajput 2019 that the paper builds on), a cascading PID controller
(the PLC's control task), an ADC model reproducing the quantization effects
the paper observes in Fig. 7, and the seven process-aware attack families of
the §7 dataset.

State (per 100 ms scan cycle):
  TB0  — top/initial brine temperature (°C), driven by steam flow Ws
  Wd   — distillate product flow (tons/min), a function of flash range
Control: cascading PID — outer loop holds Wd at its setpoint by adjusting the
TB0 setpoint; inner loop drives Ws to track TB0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import msf_detector as spec

SCAN_DT = 0.1  # 100 ms scan cycle (§7)


@dataclasses.dataclass
class PlantParams:
    t_sea: float = 35.0          # seawater temperature (°C)
    tb0_init: float = 89.667     # initial brine temperature (settled)
    tau_tb: float = 60.0         # brine thermal time constant (s)
    k_steam: float = 9.5         # °C per (ton/min) steam at steady state
    k_flash: float = 0.42        # distillate yield per °C of flash range
    t_flash_min: float = 44.0    # minimum flash temperature
    recycle: float = 1.0         # recycle brine flow factor (attack target)
    reject: float = 0.0          # water-rejection disturbance (attack target)
    noise_tb0: float = 0.002     # process noise std
    noise_wd: float = 0.0005
    wd_setpoint: float = 19.18   # tons/min (paper's §7.2 mean)


def jitter_params(base: PlantParams, rel: float,
                  rng: np.random.Generator) -> PlantParams:
    """Perturb the plant's *physical* constants by a relative uniform jitter
    (never the Wd setpoint, which the operator fixes fleet-wide)."""
    if rel <= 0.0:
        return dataclasses.replace(base)

    def j(v: float) -> float:
        return float(v * (1.0 + rng.uniform(-rel, rel)))

    return dataclasses.replace(
        base,
        tau_tb=j(base.tau_tb),
        k_steam=j(base.k_steam),
        k_flash=j(base.k_flash),
        noise_tb0=j(base.noise_tb0),
        noise_wd=j(base.noise_wd),
    )


# Physical constants a benign drift may creep — jitter_params' set plus the
# environment-driven ones; never the Wd setpoint (operator-fixed).
DRIFTABLE = frozenset({"t_sea", "tau_tb", "k_steam", "k_flash",
                       "t_flash_min", "recycle", "noise_tb0", "noise_wd"})


@dataclasses.dataclass(frozen=True)
class ParamDrift:
    """Benign time-varying plant drift — ``jitter_params`` made time-varying.

    NOT an attack: labels stay 0.  This is the threshold-killer the ICS
    surveys describe — sensor recalibration, seasonal seawater temperature,
    fouling/wear — creeping the benign operating point away from where the
    detector's threshold was calibrated.

    ``shifts`` maps physical-constant names (:data:`DRIFTABLE`) to the total
    relative change reached at the end of the ramp: field ``f`` at cycle
    ``c`` is ``base.f * (1 + shift * frac(c))``, where ``frac`` ramps
    linearly from 0 at ``start`` to 1 at ``start + ramp`` and holds there.
    A dict passed as ``shifts`` is normalized to a sorted tuple of pairs so
    the dataclass stays hashable/frozen.
    """

    shifts: Tuple[Tuple[str, float], ...]
    start: int = 0
    ramp: int = 1000

    def __post_init__(self):
        s = self.shifts
        items = sorted(s.items()) if isinstance(s, dict) else list(s)
        shifts = tuple((str(k), float(v)) for k, v in items)
        if not shifts:
            raise ValueError("ParamDrift needs at least one shifted field")
        for k, v in shifts:
            if k not in DRIFTABLE:
                raise ValueError(
                    f"cannot drift {k!r}; driftable fields: "
                    f"{sorted(DRIFTABLE)}")
            if v <= -1.0:
                raise ValueError(
                    f"shift for {k!r} must be > -1 (a physical constant "
                    f"cannot drift through zero), got {v}")
        if self.ramp < 1:
            raise ValueError(f"ramp must be >= 1 cycle, got {self.ramp}")
        object.__setattr__(self, "shifts", shifts)

    def fraction(self, cycle: int) -> float:
        """Ramp progress in [0, 1] at ``cycle``."""
        if cycle <= self.start:
            return 0.0
        return min((cycle - self.start) / self.ramp, 1.0)

    def apply(self, base: PlantParams, cycle: int) -> PlantParams:
        """The drifted parameter set at ``cycle`` (``base`` if pre-onset)."""
        f = self.fraction(cycle)
        if f == 0.0:
            return base
        return dataclasses.replace(
            base, **{k: getattr(base, k) * (1.0 + v * f)
                     for k, v in self.shifts})


@dataclasses.dataclass
class PIDGains:
    kp: float
    ki: float
    kd: float
    out_min: float
    out_max: float


class PID:
    def __init__(self, g: PIDGains):
        self.g = g
        self.i = 0.0
        self.prev_err: Optional[float] = None

    def step(self, err: float, dt: float) -> float:
        self.i += err * dt
        d = 0.0 if self.prev_err is None else (err - self.prev_err) / dt
        self.prev_err = err
        out = self.g.kp * err + self.g.ki * self.i + self.g.kd * d
        return float(np.clip(out, self.g.out_min, self.g.out_max))


class CascadePID:
    """Outer: Wd -> TB0 setpoint.  Inner: TB0 -> steam flow Ws.

    Integrators are warm-started at the plant's steady state (the paper's
    HITL runs likewise start from an initialized desalination process, §7.2)
    so traces begin settled rather than with a cold-start transient."""

    def __init__(self, warm_start: bool = True):
        self.outer = PID(PIDGains(kp=8.0, ki=0.15, kd=0.0,
                                  out_min=70.0, out_max=110.0))
        self.inner = PID(PIDGains(kp=0.6, ki=0.05, kd=0.0,
                                  out_min=0.0, out_max=25.0))
        if warm_start:
            # steady state: Wd*=19.18 -> TB0*=89.667 -> Ws*=5.7544
            self.outer.i = 89.667 / self.outer.g.ki
            self.inner.i = 5.7544 / self.inner.g.ki

    def step(self, wd_meas: float, tb0_meas: float, wd_sp: float,
             dt: float = SCAN_DT) -> float:
        tb0_sp = self.outer.step(wd_sp - wd_meas, dt)
        return self.inner.step(tb0_sp - tb0_meas, dt)


def adc(value: float, lo: float, hi: float, bits: int = 12) -> float:
    """PLC ADC model: clamp + uniform quantization (Fig. 7 step artefacts)."""
    levels = (1 << bits) - 1
    x = np.clip((value - lo) / (hi - lo), 0.0, 1.0)
    return lo + np.round(x * levels) / levels * (hi - lo)


# ---------------------------------------------------------------------------
# Attacks (7 families, §7): actuator tampering + false data injection.
# Each returns (ws_eff, params_override, sensor_bias) per cycle.
# ---------------------------------------------------------------------------

AttackFn = Callable[[int, float], Tuple[float, Dict[str, float], Tuple[float, float]]]

ATTACK_NAMES: Dict[int, str] = {
    1: "steam_scale", 2: "recycle_cut", 3: "reject_boost", 4: "tb0_fdi",
    5: "wd_fdi", 6: "oscillate", 7: "ramp",
}


def make_attack(attack_id: int, intensity: float = 1.0) -> AttackFn:
    """One attack family, scaled by ``intensity`` (1.0 = the §7 magnitudes).

    Returns function(cycle_in_attack, ws_cmd) -> (ws_eff, params_override,
    (tb0_bias, wd_bias)).  id 0 is reserved for 'no attack'.
    """
    i = intensity

    def a1_steam_scale(t, ws):      # actuator: steam valve scaled down
        return ws * (1.0 - 0.45 * i), {}, (0.0, 0.0)

    def a2_recycle_cut(t, ws):      # actuator: recycle brine reduced
        return ws, {"recycle": 1.0 - 0.38 * i}, (0.0, 0.0)

    def a3_reject_boost(t, ws):     # actuator: water rejection increased
        return ws, {"reject": 6.5 * i}, (0.0, 0.0)

    def a4_tb0_fdi(t, ws):          # sensor FDI: TB0 reads high
        return ws, {}, (3.5 * i, 0.0)

    def a5_wd_fdi(t, ws):           # sensor FDI: Wd reads high
        return ws, {}, (0.0, 0.9 * i)

    def a6_oscillate(t, ws):        # actuator: oscillatory steam valve
        return ws * (1.0 + 0.45 * i * np.sin(2 * np.pi * t / 80.0)), {}, (0.0, 0.0)

    def a7_ramp(t, ws):             # stealthy ramp on recycle efficiency
        frac = min(t / 1200.0, 1.0)
        return ws, {"recycle": 1.0 - 0.35 * i * frac}, (0.0, 0.0)

    fns = {1: a1_steam_scale, 2: a2_recycle_cut, 3: a3_reject_boost,
           4: a4_tb0_fdi, 5: a5_wd_fdi, 6: a6_oscillate, 7: a7_ramp}
    if attack_id not in fns:
        raise ValueError(f"unknown attack id {attack_id}; pick from 1..7")
    return fns[attack_id]


def make_attacks(rng: Optional[np.random.Generator] = None,
                 intensity: float = 1.0) -> Dict[int, AttackFn]:
    """Attack id -> AttackFn for all seven families (§7 magnitudes)."""
    return {k: make_attack(k, intensity) for k in ATTACK_NAMES}


@dataclasses.dataclass(frozen=True)
class AttackEvent:
    """One scheduled attack: family x onset x duration x intensity.

    ``duration=None`` means the attack persists to the end of the run.  The
    per-cycle attack clock (what ``AttackFn`` sees) restarts at ``start``.
    """

    attack_id: int
    start: int
    duration: Optional[int] = None
    intensity: float = 1.0

    def active(self, cycle: int) -> bool:
        if cycle < self.start:
            return False
        return self.duration is None or cycle < self.start + self.duration


# ---------------------------------------------------------------------------
# Plant
# ---------------------------------------------------------------------------


class MSFPlant:
    """Reduced-order MSF dynamics stepped at the scan cycle."""

    def __init__(self, params: PlantParams, seed: int = 0):
        self.p = dataclasses.replace(params)
        self.base = params
        self.tb0 = params.tb0_init
        self.rng = np.random.default_rng(seed)

    def step(self, ws: float, dt: float = SCAN_DT) -> Tuple[float, float]:
        """Advance one cycle with steam flow `ws`; returns true (TB0, Wd)."""
        p = self.p
        t_target = p.t_sea - p.reject + p.k_steam * ws
        self.tb0 += (t_target - self.tb0) * dt / p.tau_tb
        self.tb0 += self.rng.normal(0.0, p.noise_tb0)
        flash_range = max(self.tb0 - p.t_flash_min, 0.0)
        wd = p.k_flash * flash_range * p.recycle
        wd += self.rng.normal(0.0, p.noise_wd)
        return self.tb0, wd

    def apply_overrides(self, overrides: Dict[str, float],
                        base: Optional[PlantParams] = None) -> None:
        """Rebuild the effective params from ``base`` (default: the
        construction-time params — a drifting stream passes the drifted set)
        plus the attack's overrides."""
        base = self.base if base is None else base
        self.p = dataclasses.replace(base, **overrides) if overrides else \
            dataclasses.replace(base)


@dataclasses.dataclass
class SimTrace:
    tb0_meas: np.ndarray     # what the PLC ADC read
    wd_meas: np.ndarray
    tb0_true: np.ndarray     # simulation ground truth
    wd_true: np.ndarray
    ws_cmd: np.ndarray
    label: np.ndarray        # 0 normal, k = attack id


@dataclasses.dataclass
class CycleReading:
    """One scan cycle's observables from a :class:`PlantStream`."""

    tb0_meas: float
    wd_meas: float
    tb0_true: float
    wd_true: float
    ws_cmd: float
    label: int               # 0 normal, k = attack id active this cycle


class PlantStream:
    """One plant + cascading PID + attack schedule, stepped one scan cycle at
    a time — the streaming core behind both :func:`simulate` (offline traces)
    and the fleet serving path (`repro_torch.serving.streams.StreamEngine`).

    ``events`` is a sequence of :class:`AttackEvent`; when several are active
    at once the earliest-listed one wins (no superposition — one adversary at
    the controls at a time).  ``drift`` is an optional :class:`ParamDrift`
    creeping the plant's physical constants over time — benign (labels stay
    0) and composable with attacks: the attack's parameter overrides apply
    on top of the drifted base.
    """

    def __init__(self, params: Optional[PlantParams] = None, *,
                 events: Sequence[AttackEvent] = (), seed: int = 0,
                 name: str = "", drift: Optional[ParamDrift] = None):
        self.params = params or PlantParams()
        self.plant = MSFPlant(self.params, seed=seed)
        self.pid = CascadePID()
        self.events = tuple(events)
        self._fns = [make_attack(e.attack_id, e.intensity) for e in self.events]
        self.name = name
        self.drift = drift
        self.cycle = 0
        # settle readings at the operating point before the loop
        self.tb0_true = self.params.tb0_init
        self.wd_true = self.params.wd_setpoint

    def _active(self, cycle: int) -> Tuple[Optional[AttackEvent], Optional[AttackFn]]:
        for e, fn in zip(self.events, self._fns):
            if e.active(cycle):
                return e, fn
        return None, None

    def step(self) -> CycleReading:
        """Advance one scan cycle: sense -> control -> actuate."""
        cycle = self.cycle
        event, fn = self._active(cycle)

        # -- sense (through the ADC, with FDI biases if attacked)
        bias_tb0, bias_wd = 0.0, 0.0
        if event is not None:
            _, _, (bias_tb0, bias_wd) = fn(cycle - event.start, 0.0)
        tb0_meas = adc(self.tb0_true + bias_tb0, 40.0, 120.0)
        wd_meas = adc(self.wd_true + bias_wd, 0.0, 40.0)

        # -- control (the PLC's primary task)
        ws = self.pid.step(wd_meas, tb0_meas, self.params.wd_setpoint)

        # -- actuate (attack may tamper with actuators / plant params;
        #    benign drift creeps the base the overrides apply on top of)
        overrides: Dict[str, float] = {}
        ws_eff = ws
        if event is not None:
            ws_eff, overrides, _ = fn(cycle - event.start, ws)
        base = self.params if self.drift is None \
            else self.drift.apply(self.params, cycle)
        self.plant.apply_overrides(overrides, base=base)
        self.tb0_true, self.wd_true = self.plant.step(ws_eff)

        self.cycle += 1
        return CycleReading(
            tb0_meas=tb0_meas, wd_meas=wd_meas,
            tb0_true=self.tb0_true, wd_true=self.wd_true,
            ws_cmd=ws, label=event.attack_id if event is not None else 0,
        )


def simulate(
    n_cycles: int,
    *,
    attack_id: int = 0,
    attack_start: Optional[int] = None,
    seed: int = 0,
    defense_hook: Optional[Callable[[int, np.ndarray], None]] = None,
    events: Optional[Sequence[AttackEvent]] = None,
    params: Optional[PlantParams] = None,
    drift: Optional[ParamDrift] = None,
) -> SimTrace:
    """Run the closed loop for n_cycles; optionally inject attacks.

    ``attack_id``/``attack_start`` keep the original single-attack interface;
    ``events`` takes a full :class:`AttackEvent` schedule (mutually exclusive
    with the former).  ``drift`` applies benign parameter drift.
    """
    if events is None:
        events = ([AttackEvent(attack_id, attack_start)]
                  if attack_id != 0 and attack_start is not None else [])
    elif attack_id != 0 or attack_start is not None:
        raise ValueError("pass either attack_id/attack_start or events, not both")
    stream = PlantStream(params, events=events, seed=seed, drift=drift)

    out = {k: np.zeros(n_cycles) for k in
           ("tb0_meas", "wd_meas", "tb0_true", "wd_true", "ws_cmd", "label")}

    for cycle in range(n_cycles):
        r = stream.step()
        if defense_hook is not None:
            defense_hook(cycle, np.array([r.tb0_meas, r.wd_meas], np.float32))
        out["tb0_meas"][cycle] = r.tb0_meas
        out["wd_meas"][cycle] = r.wd_meas
        out["tb0_true"][cycle] = r.tb0_true
        out["wd_true"][cycle] = r.wd_true
        out["ws_cmd"][cycle] = r.ws_cmd
        out["label"][cycle] = r.label

    return SimTrace(**{k: v for k, v in out.items()})


# ---------------------------------------------------------------------------
# Dataset formation (§7: 2 features x 10 readings/s x 20 s = 400 inputs)
# ---------------------------------------------------------------------------


def build_dataset(
    *,
    window: int = 200,
    stride: int = 10,
    normal_cycles: int = 42_000,
    attack_cycles: int = 5_700,
    seed: int = 0,
    attack_param_scale: float = 1.0,
    jitter: float = 0.0,
    jitter_plants: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Windows of (TB0, Wd) readings -> binary labels (attack in window tail).

    Defaults approximate the paper's 22h45m dataset proportions scaled down;
    `attack_param_scale` perturbs attack magnitudes so evaluation can use
    parameters unseen in training (§7.1).  ``jitter``/``jitter_plants`` add
    normal traces from physically-jittered plants so a fleet-serving detector
    (heterogeneous plants, see ``repro_torch.sim.scenarios``) learns that per-plant
    operating-point spread is benign.
    """
    xs: List[np.ndarray] = []
    ys: List[int] = []

    def add_windows(trace: SimTrace):
        feats = np.stack([trace.tb0_meas, trace.wd_meas], axis=1).astype(np.float32)
        # standardize around the nominal operating point (the PLC-side
        # normalization the paper's porting flow bakes into data collection)
        feats -= np.asarray(spec.NORM_MEAN, np.float32)
        feats /= np.asarray(spec.NORM_STD, np.float32)
        for start in range(0, len(feats) - window, stride):
            w = feats[start:start + window]
            lab = trace.label[start:start + window]
            xs.append(w.reshape(-1))
            ys.append(int(lab[-window // 4:].max() > 0))

    add_windows(simulate(normal_cycles, seed=seed))
    if jitter > 0.0 and jitter_plants > 0:
        per_plant = max(normal_cycles // jitter_plants, window + stride)
        for j in range(jitter_plants):
            p = jitter_params(PlantParams(), jitter,
                              np.random.default_rng(seed + 600 + j))
            add_windows(simulate(per_plant, seed=seed + 300 + j, params=p))
    for attack_id in range(1, 8):
        tr = simulate(attack_cycles, attack_id=attack_id,
                      attack_start=attack_cycles // 5, seed=seed + 10 + attack_id)
        if attack_param_scale != 1.0:
            pass  # scale applied through seeds; kept for interface clarity
        add_windows(tr)

    x = np.stack(xs)
    y = np.asarray(ys, np.int64)
    rng = np.random.default_rng(seed + 99)
    perm = rng.permutation(len(x))
    return x[perm], y[perm]
