"""Export a detector to IEC 61131-3 Structured Text and prove it serves
(``examples/export_st.py``'s counterpart).

The paper's deployment artifact end to end: train (or, under ``--smoke``,
just initialize) a detector on ``--device``, port it to the ICSML core
(§4.3), quantize it (§6.1), calibrate the verdict head, emit one
self-contained ``FUNCTION_BLOCK`` (``repro_torch.codegen.st``) with the
serving engines' ingest normalization baked in — then *verify the export
before anything ships*: ``repro_torch.codegen.verify_export`` serves the
raw readings of attack-scenario plants through a ``StreamEngine`` on
``--device`` (one ``fused_mlp`` launch a verdict step on the card) while
the in-suite ST emulator replays every window through the emitted block,
and every per-window verdict is compared.

The verification contract (exit code 1 on any violation):

* SINT exports are **bit-exact against the reference semantics**: model
  outputs bit-match the eager two-op §6.1 oracle (``numpy_mlp_ref``),
  classifier ``CONF`` bit-matches the host softmax over those oracle
  logits, and score-head ``SCORE`` bit-matches the sequential-f32 MSE
  oracle.  Versus the live engine, ``PRED`` and ``THRESHOLD`` must agree
  exactly, and the f32 tails (``CONF``/``SCORE``) to 1e-4 relative.
* REAL exports: everything holds to epsilon (1e-4 relative), and verdicts
  may legitimately differ only when a score sits within epsilon of the
  threshold (reassociation error — reported, not failed).

Threshold calibration uses benign windows from the SAME simulated plants
over a DISJOINT later time range: the realistic held-out-trace workflow.

Run:
  PYTHONPATH=src python -m repro_torch.examples.export_st --smoke --detector mlp
  PYTHONPATH=src python -m repro_torch.examples.export_st --smoke --detector ae --quant REAL
  PYTHONPATH=src python -m repro_torch.examples.export_st --detector ae --fast
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.codegen import export_st, stream_windows, verify_export
from repro_torch.configs import msf_detector as spec
from repro_torch.core import porting, quantize
from repro_torch.device import resolve_device
from repro_torch.sim import (ClassifierHead, build_autoencoder,
                             build_dataset, build_detector,
                             recalibrate_threshold, train_autoencoder,
                             train_detector)
from repro_torch.sim.scenarios import fleet_readings, get_scenario


def calibration_windows(n_streams, replay_cycles, seed, stride):
    """Benign calibration windows from the replay's own plants (same fleet
    seed) over a disjoint later time range — held-out normal traces."""
    horizon = replay_cycles + 60 + spec.WINDOW + 8 * stride
    raw = fleet_readings(n_streams, horizon,
                         names=["baseline"] * n_streams, seed=seed)
    norm = ((np.asarray(raw, np.float32)
             - np.asarray(spec.NORM_MEAN, np.float32))
            / np.asarray(spec.NORM_STD, np.float32))
    tail = norm[replay_cycles + 60:]
    return np.concatenate([stream_windows(tail[:, s, :], spec.WINDOW, stride)
                           for s in range(n_streams)])


def smoke_detector(kind, quant, calib_wins, *, device="cuda"):
    """Untrained (init-params) detector — the CI path: export correctness
    is a property of the arithmetic, not of detection quality.  The
    classifier draws from generator seed 0, the autoencoder from seed 1."""
    dev = resolve_device(device)
    model = build_detector() if kind == "mlp" else build_autoencoder()
    params = model.init_params(
        torch.Generator().manual_seed(0 if kind == "mlp" else 1), device=dev)
    if quant != "REAL":
        params = quantize.quantize_params(
            model, params, quant,
            calibration=quantize.calibration_samples(calib_wins, k=16,
                                                     device=dev))
    if kind == "mlp":
        return model, params, ClassifierHead()
    head, _ = recalibrate_threshold(model, params, calib_wins, device=dev)
    return model, params, head


def trained_detector(kind, quant, calib_wins, fast, *, device="cuda"):
    """The real workflow: train -> port -> quantize -> calibrate on the
    held-out benign scenario windows."""
    dev = resolve_device(device)
    scale = 0.2 if fast else 0.5
    x, y = build_dataset(normal_cycles=int(42_000 * scale),
                         attack_cycles=int(5_700 * scale), stride=8, seed=0,
                         jitter=0.015, jitter_plants=4)
    epochs = 30 if fast else 60
    if kind == "ae":
        model, res = train_autoencoder(x, y, epochs=epochs, patience=8,
                                       lr=1e-3, device=dev)
    else:
        model, res = train_detector(x, y, epochs=epochs, patience=8, lr=1e-3,
                                    device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        model, params = porting.port_mlp(model, res.params, tmp)
    if quant != "REAL":
        params = quantize.quantize_params(
            model, params, quant,
            calibration=quantize.calibration_samples(x, y, device=dev))
    if kind == "mlp":
        return model, params, ClassifierHead()
    head, _ = recalibrate_threshold(model, params, calib_wins, device=dev)
    return model, params, head


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.export_st")
    ap.add_argument("--detector", default="mlp", choices=("mlp", "ae"))
    ap.add_argument("--quant", default="SINT", choices=("REAL", "SINT"))
    ap.add_argument("--scenarios",
                    default="baseline,tb0-spoof,drift-then-spoof,steam-pulse",
                    help="comma-separated replay scenarios (one stream each;"
                         " includes a composed multi-attack by default)")
    ap.add_argument("--cycles", type=int, default=460,
                    help="replay length (default wraps the serving ring "
                         "more than twice)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out-dir", default="st-out",
                    help="directory the .st file is written into")
    ap.add_argument("--smoke", action="store_true",
                    help="skip training: export an init-params detector "
                         "(the arithmetic contract is training-independent)")
    ap.add_argument("--fast", action="store_true",
                    help="small training budget (ignored with --smoke)")
    ap.add_argument("--device", default="cuda",
                    help="where training and the verifying engine run "
                         "(cuda or cpu)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Build, export, write and verify the detector ``args`` describes;
    prints the report and returns ``verify_export``'s counts with the
    export's ``path``, ``scheme`` and ``lines``."""
    dev = resolve_device(args.device)
    names = [s.strip() for s in args.scenarios.split(",")]
    for nm in names:
        get_scenario(nm)
    stride = spec.STRIDE
    raw = fleet_readings(len(names), args.cycles, names=names,
                         seed=args.seed)

    print("== calibration (held-out benign windows, same plants) ==")
    calib = calibration_windows(len(names), args.cycles, args.seed, stride)
    print(f"{calib.shape[0]} windows x {calib.shape[1]}")

    if args.smoke:
        print(f"== init-params {args.detector} ({args.quant}, --smoke) ==")
        model, params, head = smoke_detector(args.detector, args.quant,
                                             calib, device=dev)
    else:
        print(f"== training {args.detector} ({args.quant}) ==")
        model, params, head = trained_detector(args.detector, args.quant,
                                               calib, args.fast, device=dev)
    if getattr(head, "threshold", None) is not None:
        print(f"calibrated threshold {head.threshold:.6g}")

    fb_name = f"{args.detector}_{args.quant}".upper()
    export = export_st(model, params, head=head, name=fb_name,
                       normalize=(spec.NORM_MEAN, spec.NORM_STD))
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"{fb_name.lower()}.st")
    with open(path, "w") as f:
        f.write(export.text)
    print(f"== emitted {path} ==")
    print(f"{export.scheme} scheme, {len(export.text.splitlines())} lines, "
          f"window {export.window} readings, verdict outputs "
          f"{export.verdict_outputs}")

    print(f"== replaying {len(names)} streams x {args.cycles} cycles "
          f"through engine + ST emulator ==")
    t0 = time.time()
    res = verify_export(export, model, params, head, raw, stride, device=dev)
    contract = ("bit-exact (SINT)" if export.scheme == "SINT"
                else "epsilon (REAL, 1e-4 rel)")
    print(f"windows compared : {res['windows']} "
          f"({res['anomalous']} anomalous verdicts)")
    print(f"max body |diff|  : {res['max_body_diff']:.3g}")
    print(f"borderline       : {res['borderline']} "
          f"(REAL-only: score within epsilon of threshold)")
    print(f"verdict parity   : {res['windows'] - res['failures']}"
          f"/{res['windows']} under the {contract} contract "
          f"[{time.time() - t0:.1f}s]")
    return {**res, "path": path, "scheme": export.scheme,
            "lines": len(export.text.splitlines())}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Export, verify and report; returns :func:`run`'s result, or exits
    with code 1 if any window violates the contract."""
    res = run(parse_args(argv))
    if res["failures"]:
        print(f"FAILED: {res['failures']} windows violate the contract")
        sys.exit(1)
    print("OK: exported ST serves identically to the fleet engine")
    return res


if __name__ == "__main__":
    main()
