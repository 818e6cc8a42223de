"""Fleet-scale anomaly detection over the MSF scenario library, on the card
(``examples/detect_fleet.py``'s counterpart).

Trains a detector (established-framework stage), ports it to the ICSML
core (§4.3), optionally quantizes it (§6.1), then serves a heterogeneous
fleet of simulated plants — each running a named scenario from
``repro_torch.sim.scenarios`` — through the batched ``StreamEngine``:
per-stream ring-buffer windows, one detector step per verdict cadence (one
``fused_mlp`` launch on the card), per-window latency/deadline accounting.

``--detector`` picks the workload: ``mlp`` is the paper's supervised
400-64-32-16-2 classifier; ``ae`` is the unsupervised 400-64-16-64-400
autoencoder — trained on benign windows only, anomaly score = per-window
reconstruction error, verdict threshold calibrated to
``spec.AE_TARGET_FPR`` false positives on held-out normal traces (and
re-calibrated on the quantized model when ``--quant`` is not REAL, so the
served scores match the served arithmetic).

``--mixed`` serves a *heterogeneous model-group fleet* instead: the plants
are partitioned into four model groups — supervised classifier,
reconstruction autoencoder, one-class margin detector, next-step
forecaster — each group carrying its own trained model, verdict head,
calibrated threshold and quantization scales, all batched by ONE
``GroupedStreamEngine`` (one ``grouped_fused_mlp`` launch a step on the
card).

``--devices N`` trains once in this process, then serves over N ranks
(``repro_torch.launch.mesh.spawn``), each on ``make_fleet_mesh(N)``: NCCL
with one rank per card where there are N cards, gloo otherwise (ranks that
share a card, or CPU ranks).  Every rank serves the whole fleet's verdicts
(the port's mesh contract); rank 0's are printed.  The trained params cross
to the ranks as numpy arrays (``bridge.params_to_numpy``).

``--async`` serves double-buffered (``async_depth=1``): verdicts
bit-identical to synchronous serving, one ready boundary later
(``flush()`` drains the last in-flight step).  After the serve it prints a
sync-vs-async sustained windows/s comparison on fresh engines.

``--drift`` overlays fleet-wide benign parameter drift (flash-gain decay +
warming seawater, the ``seasonal-drift`` physics) on every plant's scenario
and switches score-head detectors to online threshold recalibration
(``adapt=True``).  The pooled quantile assumes a mostly-benign fleet; the
drift demo is the mostly-benign + sharp-attack mix below.

``--device`` (default ``cuda``) is where training and serving run; without
a card it raises.  ``--device cpu`` runs the plain PyTorch path.

Run:
  PYTHONPATH=src python -m repro_torch.examples.detect_fleet --list
  PYTHONPATH=src python -m repro_torch.examples.detect_fleet --scenarios stealth-drift
  PYTHONPATH=src python -m repro_torch.examples.detect_fleet --plants 16 --quant SINT
  PYTHONPATH=src python -m repro_torch.examples.detect_fleet --plants 64 --devices 4
  PYTHONPATH=src python -m repro_torch.examples.detect_fleet --mixed --fast --plants 16
  PYTHONPATH=src python -m repro_torch.examples.detect_fleet --async --fast --plants 16
  PYTHONPATH=src python -m repro_torch.examples.detect_fleet --detector ae --drift \\
      --scenarios baseline,seasonal-drift,tb0-spoof,wd-spoof --plants 16
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import msf_detector as spec
from repro_torch.core import porting, quantize
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_fleet_mesh, spawn
from repro_torch.serving import (GroupedStreamEngine, ModelGroup,
                                 StreamEngine, StreamStats, Verdict)
from repro_torch.sim import (ParamDrift, build_dataset, recalibrate_threshold,
                             train_autoencoder, train_detector,
                             train_forecaster, train_one_class)
from repro_torch.sim.msf import SCAN_DT
from repro_torch.sim.scenarios import (SCENARIOS, build_fleet, get_scenario,
                                       scenario_table)

# The mixed fleet's model groups, in stream order.
MIXED_GROUPS = ("mlp", "ae", "margin", "forecast")


def _budget(fast: bool, smoke: bool):
    """(normal_cycles, attack_cycles, epochs, patience) for a training run.
    ``--smoke`` is the CI-subprocess budget: just enough data/steps to prove
    the pipeline end to end in seconds, not a useful detector."""
    if smoke:
        # Floor: the score heads refuse to train/calibrate on < 768 benign
        # windows, and the mixed fleet trains an autoencoder too.
        return 5_200, 800, 2, 2
    scale = 0.2 if fast else 0.5
    return int(42_000 * scale), int(5_700 * scale), 30 if fast else 60, 8


def _dataset(normal: int, attack: int):
    # jittered normal plants in training: the fleet is heterogeneous, and
    # per-plant operating-point spread must read as benign
    return build_dataset(normal_cycles=normal, attack_cycles=attack,
                         stride=8, seed=0, jitter=0.015, jitter_plants=4)


def train_and_port(fast: bool, quant: str, detector: str, smoke: bool = False,
                   *, device="cuda"):
    """Train one detector on ``device``, port it (§4.3) and quantize it
    (§6.1): ``(model, params, head)``, ``head`` None for the classifier."""
    dev = resolve_device(device)
    normal, attack, epochs, patience = _budget(fast, smoke)
    print("== dataset + training (established-framework stage) ==")
    x, y = _dataset(normal, attack)
    head = None
    if detector == "ae":
        model, res = train_autoencoder(x, y, epochs=epochs,
                                       patience=patience, lr=1e-3,
                                       device=dev)
        head = res.head
        print(f"val mse {res.best_val_mse:.6f}  threshold {res.threshold:.6f}"
              f"  calib FPR {res.calib_fpr:.4f}"
              f"  attack-window detection {res.test_detection_rate:.4f}")
    else:
        model, res = train_detector(x, y, epochs=epochs,
                                    patience=patience, lr=1e-3, device=dev)
        print(f"val acc {res.best_val_acc:.4f}  test acc {res.test_acc:.4f}")
    print("== porting to ICSML (§4.3) ==")
    model, params, head = _port_and_quantize(model, res, head, quant, x, y,
                                             dev)
    if quant != "REAL":
        print(f"== quantizing to {quant} (§6.1) ==")
        if head is not None:
            print(f"re-calibrated {quant} threshold {head.threshold:.6f}")
    return model, params, head


def _port_and_quantize(model, res, head, quant, x, y, device):
    """Shared §4.3 port + §6.1 quantize + (score heads) threshold
    re-calibration against the quantized arithmetic."""
    with tempfile.TemporaryDirectory() as tmp:
        model, params = porting.port_mlp(model, res.params, tmp)
    if quant != "REAL":
        # Activation scales from benign-trace ranges (weight absmax alone
        # leaves the AE decoder's scales wildly off).
        calib = quantize.calibration_samples(x, y, device=device)
        if head is not None:
            # Heads with non-identity window geometry (the forecaster) eat a
            # slice of the window; quantization scales must see the same view.
            calib = [head.prepare(c) for c in calib]
        params = quantize.quantize_params(model, params, quant,
                                          calibration=calib)
        if head is not None:
            # Re-calibrate the verdict threshold against the *quantized*
            # model's scores, on the held-out normal windows the REAL
            # threshold came from.
            head, _ = recalibrate_threshold(model, params, res.calib_windows,
                                            head=head, device=device)
    return model, params, head


def train_mixed(fast: bool, quant: str, smoke: bool = False, *,
                device="cuda"):
    """Train/port/quantize all four detector types for the grouped fleet:
    ``[(name, model, params, head), ...]`` in :data:`MIXED_GROUPS` order."""
    dev = resolve_device(device)
    normal, attack, epochs, patience = _budget(fast, smoke)
    print("== dataset + training x4 (mixed model-group fleet) ==")
    x, y = _dataset(normal, attack)
    trained = []
    model, res = train_detector(x, y, epochs=epochs, patience=patience,
                                lr=1e-3, device=dev)
    print(f"  mlp:      val acc {res.best_val_acc:.4f}  "
          f"test acc {res.test_acc:.4f}")
    trained.append(("mlp", model, res, None))
    for name, trainer in (("ae", train_autoencoder),
                          ("margin", train_one_class),
                          ("forecast", train_forecaster)):
        model, res = trainer(x, y, epochs=epochs, patience=patience, lr=1e-3,
                             device=dev)
        print(f"  {name + ':':<9} threshold {res.threshold:.6f}  "
              f"calib FPR {res.calib_fpr:.4f}  "
              f"attack-window detection {res.test_detection_rate:.4f}")
        trained.append((name, model, res, res.head))
    print("== porting to ICSML (§4.3)"
          + (f" + quantizing to {quant} (§6.1)" if quant != "REAL" else "")
          + " ==")
    out = []
    for name, model, res, head in trained:
        model, params, head = _port_and_quantize(model, res, head, quant, x,
                                                 y, dev)
        if head is not None and quant != "REAL":
            print(f"  {name}: re-calibrated {quant} threshold "
                  f"{head.threshold:.6f}")
        out.append((name, model, params, head))
    return out


def train(args: argparse.Namespace):
    """The detectors ``args`` asks for: :func:`train_mixed`'s list under
    ``--mixed``, else :func:`train_and_port`'s ``(model, params, head)``."""
    if args.mixed:
        return train_mixed(args.fast, args.quant, args.smoke,
                           device=args.device)
    return train_and_port(args.fast, args.quant, args.detector, args.smoke,
                          device=args.device)


def sustained_side_by_side(make_engine, n_streams, n_cycles=800):
    """Sync-vs-async sustained windows/s under continuous per-cycle arrival:
    ``{0: sync, 1: async}``.

    Fresh engines (built by ``make_engine(async_depth)``), synthetic normal
    readings (serving throughput is content-independent), ring fill
    untimed, ``flush()`` inside the timed region so every dispatched window
    is also harvested."""
    readings = (np.asarray(spec.NORM_MEAN, np.float32)
                + np.random.default_rng(0)
                .normal(size=(n_cycles, n_streams, spec.N_FEATURES))
                .astype(np.float32) * np.asarray(spec.NORM_STD, np.float32))
    wps = {}
    for depth in (0, 1):
        eng = make_engine(depth)
        eng.warmup()
        for c in range(min(spec.WINDOW, n_cycles)):
            eng.ingest(readings[c])
        eng.flush()
        w0 = eng.stats.windows
        t0 = time.perf_counter()
        for c in range(n_cycles):
            eng.ingest(readings[c])
        eng.flush()
        wps[depth] = (eng.stats.windows - w0) / (time.perf_counter() - t0)
    return wps


def format_sustained(wps: Dict[int, float], n_cycles: int = 800) -> List[str]:
    return [f"\nsustained throughput ({n_cycles} cycles, continuous arrival):",
            f"  sync   {wps[0]:>8.0f} windows/s",
            f"  async  {wps[1]:>8.0f} windows/s ({wps[1] / wps[0]:.2f}x, "
            f"double-buffered: ingest of cycle N+1 overlaps step N)"]


# -- the per-plant table ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlantRow:
    """One plant's line of the table: its scenario's attack onset (None for
    a benign scenario), the first attack verdict at or after it (None: a
    miss), the latency between them in seconds, and the attack verdicts
    before the onset (every attack verdict, for a benign scenario)."""

    plant: str
    group: Optional[str]
    onset: Optional[int]
    first_flag: Optional[int]
    latency_s: Optional[float]
    fps: int


def plant_table(fleet: Sequence[Any], verdicts: Sequence[Any],
                groups: Optional[Sequence[Tuple[str, int, int]]] = None,
                ) -> List[PlantRow]:
    """The per-plant rows of ``verdicts`` (anything with ``stream``,
    ``cycle`` and ``pred``, in emission order) over ``fleet`` (plants named
    ``{scenario}#{index}``); ``groups`` is a grouped engine's
    ``(name, first_stream, n_streams)`` list, None for one model."""
    flagged = collections.defaultdict(list)   # stream -> attack-verdict cycles
    for v in verdicts:
        if v.pred != 0:
            flagged[v.stream].append(v.cycle)
    group_of = {}
    for gname, off, n in groups or ():
        for s in range(off, off + n):
            group_of[s] = gname
    rows = []
    for i, plant in enumerate(fleet):
        onset = get_scenario(plant.name.split("#")[0]).onset
        cycles = flagged.get(i, [])
        group = group_of.get(i)
        if onset is None:
            rows.append(PlantRow(plant.name, group, None, None, None,
                                 len(cycles)))
            continue
        hits = [c for c in cycles if c >= onset]
        fps = len([c for c in cycles if c < onset])
        first = hits[0] if hits else None
        lat = (first - onset) * SCAN_DT if first is not None else None
        rows.append(PlantRow(plant.name, group, onset, first, lat, fps))
    return rows


def format_table(rows: Sequence[PlantRow], mixed: bool) -> List[str]:
    """The table's printed lines, header first."""
    gcol = f"{'group':<9} " if mixed else ""
    lines = [f"{'plant':<26} {gcol}{'onset':>6} {'first-flag':>10} "
             f"{'latency':>9} {'pre-onset FPs':>13}"]
    for r in rows:
        g = f"{r.group:<9} " if mixed else ""
        if r.onset is None:
            lines.append(f"{r.plant:<26} {g}{'-':>6} {'-':>10} {'-':>9} "
                         f"{r.fps:>13}")
            continue
        lat = f"{r.latency_s:.1f}s" if r.first_flag is not None else "miss"
        first = r.first_flag if r.first_flag is not None else "miss"
        lines.append(f"{r.plant:<26} {g}{r.onset:>6} "
                     f"{first:>10} {lat:>9} {r.fps:>13}")
    return lines


# -- serving ----------------------------------------------------------------


@dataclasses.dataclass
class FleetRun:
    """One serve of the fleet: the verdicts in emission order, the engine's
    stats and groups (a mixed fleet's ``(name, first_stream, n_streams)``,
    else None), verdicts per group, the live thresholds after the serve
    (``live_threshold`` and ``offline_threshold`` for one model,
    ``live_thresholds`` by group), and the sync/async windows/s of
    :func:`sustained_side_by_side` under ``--async``."""

    verdicts: List[Verdict]
    stats: StreamStats
    groups: Optional[List[Tuple[str, int, int]]] = None
    group_windows: Optional[Dict[str, int]] = None
    live_threshold: Optional[float] = None
    offline_threshold: Optional[float] = None
    live_thresholds: Optional[Dict[str, Optional[float]]] = None
    sustained: Optional[Dict[int, float]] = None


def model_groups(args: argparse.Namespace, detectors) -> List[ModelGroup]:
    """The mixed fleet's groups: ``args.plants`` split as evenly as it goes,
    the first groups one plant larger."""
    base, extra = divmod(args.plants, len(detectors))
    return [ModelGroup(name, model, params, base + (1 if i < extra else 0),
                       head, adapt=args.drift and head is not None)
            for i, (name, model, params, head) in enumerate(detectors)]


def engine_factory(args: argparse.Namespace, detectors, *, mesh=None,
                   backend: str = "auto") -> Callable[[int], Any]:
    """``make_engine(async_depth)`` for the fleet ``args`` describes, on
    ``args.device``; ``mesh`` shards it (None pins sharding off)."""
    dev = resolve_device(args.device)
    shard_kw = {"mesh": mesh} if mesh is not None else {"shard": False}
    if args.mixed:
        groups = model_groups(args, detectors)
        return lambda depth: GroupedStreamEngine(
            groups, async_depth=depth, backend=backend, device=dev,
            **shard_kw)
    model, params, head = detectors
    return lambda depth: StreamEngine(
        model, params, n_streams=args.plants, head=head,
        adapt=args.drift and head is not None or None, async_depth=depth,
        backend=backend, device=dev, **shard_kw)


def _drift(args: argparse.Namespace) -> Optional[ParamDrift]:
    # Fleet-wide benign drift: the seasonal-drift physics overlaid on every
    # plant's scenario (attacks compose on top of the drifted base).
    return (ParamDrift({"k_flash": -0.08, "t_sea": 0.04}, start=300,
                       ramp=1200) if args.drift else None)


def make_fleet(args: argparse.Namespace):
    """The plant streams ``args`` names (fresh: a plant steps as it is
    read)."""
    return build_fleet(scenario_names(args), args.plants,
                       seed=args.seed + 1000, jitter=args.jitter,
                       drift=_drift(args))


def run_fleet(args: argparse.Namespace, engine) -> FleetRun:
    """Serve ``args.plants`` fresh plants for ``args.cycles`` cycles on a
    warmed-up engine and drain its in-flight step."""
    verdicts = engine.run(make_fleet(args), args.cycles)
    verdicts += engine.flush()   # async: drain the final in-flight step
    run = FleetRun(verdicts=verdicts, stats=engine.stats)
    if args.mixed:
        run.groups = engine.groups
        run.group_windows = engine.group_windows()
        run.live_thresholds = engine.live_thresholds()
    else:
        run.live_threshold = engine.live_threshold
        run.offline_threshold = getattr(engine.head, "threshold", None)
    return run


def serve_fleet(args: argparse.Namespace, detectors, *,
                mesh=None) -> FleetRun:
    """The fleet on this process's engine (sharded over ``mesh`` when
    given): warm up, :func:`run_fleet`, then under ``--async`` the
    sync-vs-async side-by-side on fresh engines."""
    make_engine = engine_factory(args, detectors, mesh=mesh)
    engine = make_engine(1 if args.async_serve else 0)
    engine.warmup()
    run = run_fleet(args, engine)
    if args.async_serve:
        run.sustained = sustained_side_by_side(make_engine, args.plants)
    return run


def _detectors_to(detectors, mixed: bool, to: Callable):
    if mixed:
        return [(name, model, to(params), head)
                for name, model, params, head in detectors]
    model, params, head = detectors
    return model, to(params), head


def _serve_rank(rank: int, world: int, args: argparse.Namespace,
                detectors) -> Optional[FleetRun]:
    """One rank of :func:`serve_sharded`: the host params onto this rank's
    device, the fleet mesh over every rank, the serve; rank 0's run comes
    back (every rank serves the whole fleet's verdicts)."""
    dev = resolve_device(args.device)
    detectors = _detectors_to(detectors, args.mixed,
                              lambda p: params_from_numpy(p, dev))
    mesh = make_fleet_mesh(world, device_type=dev.type)
    run = serve_fleet(args, detectors, mesh=mesh)
    return run if rank == 0 else None


def serve_sharded(args: argparse.Namespace, detectors) -> FleetRun:
    """:func:`serve_fleet` over ``args.devices`` spawned ranks: NCCL with
    one rank per card where there are enough cards, gloo otherwise.
    Returns rank 0's run."""
    dev = resolve_device(args.device)
    comm = ("nccl" if dev.type == "cuda"
            and torch.cuda.device_count() >= args.devices else "gloo")
    host = _detectors_to(detectors, args.mixed, params_to_numpy)
    return spawn(_serve_rank, args.devices, comm, args, host)[0]


def serve(args: argparse.Namespace, detectors) -> FleetRun:
    """The fleet served as ``--devices`` says: in this process for 1, over
    spawned ranks for more."""
    if args.devices > 1:
        return serve_sharded(args, detectors)
    return serve_fleet(args, detectors)


def serve_header(args: argparse.Namespace, detectors) -> str:
    shard_note = (f", sharded over {args.devices} devices "
                  f"({-(-args.plants // args.devices)} streams/device)"
                  if args.devices > 1 else "")
    drift_note = ", drifting+adaptive" if args.drift else ""
    async_note = ", async double-buffered" if args.async_serve else ""
    if args.mixed:
        split = " + ".join(f"{g.n_streams}x{g.name}"
                           for g in model_groups(args, detectors))
        what = f"mixed: {split} / {args.quant}"
    else:
        what = f"{args.detector}/{args.quant}"
    return (f"== serving {args.plants} plants x {args.cycles} cycles "
            f"({what}{shard_note}{drift_note}{async_note}) ==")


def report(args: argparse.Namespace, run: FleetRun) -> List[PlantRow]:
    """Print the per-plant table and the serve's summary; returns the
    table's rows."""
    rows = plant_table(make_fleet(args), run.verdicts, run.groups)
    for line in format_table(rows, args.mixed):
        print(line)
    if args.mixed:
        print("\nper-group verdicts: "
              + "  ".join(f"{k}={v}" for k, v in run.group_windows.items()))
    if args.drift:
        if args.mixed:
            moved = "  ".join(f"{k}={v:.6f}"
                              for k, v in run.live_thresholds.items()
                              if v is not None)
            if moved:
                print(f"live thresholds after drift: {moved}")
        elif run.live_threshold is not None:
            print(f"live threshold after drift: {run.live_threshold:.6f} "
                  f"(offline calibration: {run.offline_threshold:.6f})")
    st = run.stats
    print(f"\nserve stats: {st.steps} detector steps, {st.windows} windows, "
          f"{st.windows_per_s():.0f} windows/s | verdict latency "
          f"p50={st.latency_p(50) * 1e3:.1f}ms "
          f"p99={st.latency_p(99) * 1e3:.1f}ms "
          f"| deadline({spec.DEADLINE_S * 1e3:.0f}ms) misses: "
          f"{st.deadline_misses}/{st.windows}")
    if run.sustained is not None:
        for line in format_sustained(run.sustained):
            print(line)
    return rows


def scenario_names(args: argparse.Namespace) -> List[str]:
    names = (list(SCENARIOS) if args.scenarios == "all"
             else [s.strip() for s in args.scenarios.split(",")])
    for n in names:
        get_scenario(n)   # fail fast on typos
    return names


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.detect_fleet")
    ap.add_argument("--scenarios", default="all",
                    help="comma-separated scenario names, or 'all'")
    ap.add_argument("--plants", type=int, default=spec.FLEET_STREAMS)
    ap.add_argument("--cycles", type=int, default=1600)
    ap.add_argument("--quant", default="SINT",
                    choices=("REAL",) + quantize.SCHEMES)
    ap.add_argument("--detector", default="mlp", choices=("mlp", "ae"),
                    help="mlp: supervised §7 classifier; ae: unsupervised "
                         "reconstruction-error autoencoder")
    ap.add_argument("--mixed", action="store_true",
                    help="serve a heterogeneous model-group fleet "
                         "(classifier + autoencoder + margin + forecast "
                         "groups in one GroupedStreamEngine)")
    ap.add_argument("--jitter", type=float, default=None,
                    help="override per-scenario plant jitter")
    ap.add_argument("--drift", action="store_true",
                    help="overlay fleet-wide benign parameter drift and "
                         "enable streaming threshold recalibration on "
                         "score-head detectors")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fast", action="store_true", help="small training budget")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-subprocess budget: tiny dataset, 2 epochs, and "
                         "(unless overridden) 4 plants x 240 cycles — proves "
                         "the pipeline, not the detector")
    ap.add_argument("--devices", type=int, default=1,
                    help="serve the fleet over this many ranks, one mesh "
                         "shard each (one card each where there are enough "
                         "cards, else sharing them)")
    ap.add_argument("--async", dest="async_serve", action="store_true",
                    help="serve double-buffered (async_depth=1: verdicts "
                         "arrive one ready boundary late, bit-identical) "
                         "and print sync-vs-async sustained windows/s")
    ap.add_argument("--list", action="store_true",
                    help="print the scenario library and exit")
    ap.add_argument("--device", default="cuda",
                    help="where training and serving run (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.smoke:
        if args.plants == spec.FLEET_STREAMS:
            args.plants = 4
        if args.cycles == 1600:
            args.cycles = 240
    if args.mixed and args.plants < len(MIXED_GROUPS):
        ap.error(f"--mixed needs at least {len(MIXED_GROUPS)} plants")
    return args


def main(argv: Optional[Sequence[str]] = None):
    """Run as ``argv`` says; returns the detectors served and the serve's
    :class:`FleetRun` (None under ``--list``)."""
    args = parse_args(argv)
    if args.list:
        print(scenario_table())
        return None
    resolve_device(args.device)
    scenario_names(args)
    detectors = train(args)
    if args.drift and not args.mixed and detectors[2] is None:
        print("note: --drift serves a drifting fleet, but the "
              "classifier has no score threshold to recalibrate "
              "(use --detector ae for adaptation)")
    print(serve_header(args, detectors))
    run = serve(args, detectors)
    report(args, run)
    return detectors, run


if __name__ == "__main__":
    main()
