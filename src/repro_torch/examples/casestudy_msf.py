"""§7 case study, end to end, on the card (``examples/casestudy_msf.py``'s
counterpart): ML-based anomaly detection for an MSF desalination plant,
running *on the controller* via the ICSML runtime.

Pipeline (paper §4.3 + §7):
  1. HITL data collection: simulate the plant + cascading PID, record the
     PLC's ADC readings.
  2. Train the 400-64-32-16-2 ReLU classifier in the 'established framework'
     (``sim.train_detector`` on ``--device``).
  3. Extract weights -> binary files -> statically reconstruct in ICSML ->
     BINARR load (``port_mlp``), optionally with SINT quantization (§6.1).
     The trained and the ported model run the fused batched forward
     (``sim.detector.batched_forward``: one ``fused_mlp`` launch on the
     card) and must agree exactly.
  4. Deploy in the scan-cycle runtime as a sliding-window detector with
     multipart inference (§6.3) and inject an unseen attack: measure
     detection latency (paper: injected cycle 436, detected 486).  The
     detector runs on the params' device, one layer segment per cycle.
  5. Non-intrusiveness (§7.2): compare Wd statistics with/without defense.

Run:  PYTHONPATH=src python -m repro_torch.examples.casestudy_msf [--fast] \\
          [--quant SINT] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import SlidingWindowDetector, porting, quantize
from repro_torch.core.runtime import MultipartInference
from repro_torch.device import params_device, resolve_device
from repro_torch.sim import build_dataset, simulate, train_detector
from repro_torch.sim.detector import batched_forward
from repro_torch.sim.msf import SCAN_DT

# The paper's reference numbers, printed beside this run's.
PAPER_TEST_ACC = 0.9368
PAPER_LATENCY_S = 5.0
WINDOW, N_FEATURES = 200, 2
# The deployment's attack (id and seed never used by the dataset), its
# start cycle, and the benign plant of the Wd check.
ATTACK_ID, ATTACK_SEED, ATTACK_START, WD_SEED = 2, 777, 800, 123


def normalize(reading: np.ndarray) -> np.ndarray:
    """A raw ``(TB0, Wd)`` reading normalized like ``build_dataset``."""
    return np.array([(reading[0] - 89.6) / 2.0,
                     (reading[1] - 19.18) / 0.5], np.float32)


def train_casestudy(fast: bool, *, device="cuda"):
    """Steps 1 and 2: the dataset and the trained classifier,
    ``(model, result, x, y)``."""
    dev = resolve_device(device)
    scale = 0.25 if fast else 1.0
    print("== building dataset (HITL simulation) ==")
    x, y = build_dataset(normal_cycles=int(42_000 * scale),
                         attack_cycles=int(5_700 * scale),
                         stride=8, seed=0)
    print(f"dataset: {x.shape[0]} windows of {x.shape[1]} features, "
          f"{y.mean():.1%} attack")

    print("== training detector (established-framework stage) ==")
    model, res = train_detector(x, y, epochs=40 if fast else 120,
                                patience=10 if fast else 15, lr=1e-3,
                                device=dev)
    print(f"val acc {res.best_val_acc:.4f}  test acc {res.test_acc:.4f} "
          f"(paper: ~{PAPER_TEST_ACC})")
    return model, res, x, y


def port(model, params, x: np.ndarray):
    """Step 3: the §4.3 round trip onto the params' device; the ported
    model's outputs on the first 8 windows must equal the trained one's."""
    print("== porting to ICSML (extract -> binary -> reconstruct -> load) ==")
    with tempfile.TemporaryDirectory() as tmp:
        ported_model, ported_params = porting.port_mlp(model, params, tmp)
    dev = params_device(params)
    xq = torch.from_numpy(np.ascontiguousarray(x[:8])).to(dev)
    with torch.no_grad():
        ref_out = batched_forward(model, params, xq).cpu().numpy()
        port_out = batched_forward(ported_model, ported_params,
                                   xq).cpu().numpy()
    assert np.allclose(ref_out, port_out), "port mismatch"
    print("ported model output bit-identical to trained model ✓")
    return ported_model, ported_params


def quantize_ported(model, params, x: np.ndarray, y: np.ndarray,
                    scheme: str):
    """§6.1 on the ported model, calibrated on every 8th of the first 256
    windows: ``(params, accuracy on the last 512 windows)``."""
    print(f"== quantizing ported model to {scheme} (§6.1) ==")
    dev = params_device(params)
    calib = [torch.from_numpy(np.asarray(x[i], np.float32)).to(dev)
             for i in range(0, 256, 8)]
    params = quantize.quantize_params(model, params, scheme,
                                      calibration=calib)
    tail = torch.from_numpy(np.ascontiguousarray(x[-512:])).to(dev)
    with torch.no_grad():
        pred = batched_forward(model, params, tail).argmax(-1).cpu().numpy()
    qacc = float(np.mean(pred == y[-512:]))
    print(f"quantized accuracy on tail split: {qacc:.4f}")
    return params, qacc


def attack_run(model, params, segments: int, *, n_cycles: int = 1600,
               attack_start: int = ATTACK_START
               ) -> List[Tuple[int, int, int]]:
    """Step 4: one plant under an attack with parameters unseen in training,
    the detector deployed as a
    ``segments``-part :class:`SlidingWindowDetector` in the scan loop: every
    completed inference as ``(done_cycle, pred, latency_cycles)``."""
    detector = SlidingWindowDetector(model, params, window=WINDOW,
                                     n_features=N_FEATURES,
                                     n_segments=segments)
    results = []

    def hook(cycle, reading):
        detector.push(normalize(reading))
        result = detector.tick(cycle)
        if result is not None:
            results.append(result)

    simulate(n_cycles, attack_id=ATTACK_ID, attack_start=attack_start,
             seed=ATTACK_SEED, defense_hook=hook)
    return results


def first_detection(results: Sequence[Tuple[int, int, int]]
                    ) -> Optional[int]:
    """The cycle of the first attack verdict, or None."""
    return next((done for done, pred, _ in results if pred != 0), None)


def wd_run(model, params, segments: int, *, n_cycles: int = 3000
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Step 5: the measured distillate flow Wd of one benign plant without
    and with the defense in its scan loop, ``(off, on)``."""
    tr_off = simulate(n_cycles, seed=WD_SEED)
    det = SlidingWindowDetector(model, params, window=WINDOW,
                                n_features=N_FEATURES, n_segments=segments)

    def hook(cycle, reading):
        det.push(normalize(reading))
        det.tick(cycle)

    tr_on = simulate(n_cycles, seed=WD_SEED, defense_hook=hook)
    return tr_off.wd_meas, tr_on.wd_meas


def deploy(model, params, segments: int) -> dict:
    """Steps 4 and 5, printed: the first detection and its latency, the Wd
    statistics with and without the defense, the multipart cost."""
    print("== scan-cycle deployment: attack injection + detection ==")
    results = attack_run(model, params, segments)
    first = first_detection(results)
    latency = None if first is None else (first - ATTACK_START) * SCAN_DT
    if first is not None:
        print(f"attack injected at cycle {ATTACK_START}, first detection at "
              f"cycle {first} -> latency {latency:.1f}s "
              f"(paper: {PAPER_LATENCY_S}s)")
    else:
        print("attack NOT detected (unexpected)")

    print("== non-intrusiveness: Wd stats with / without defense ==")
    off, on = wd_run(model, params, segments)
    seg = slice(1500, None)
    print(f"  defense OFF: Wd mean {off[seg].mean():.4f} "
          f"std {off[seg].std():.2e}")
    print(f"  defense ON : Wd mean {on[seg].mean():.4f} "
          f"std {on[seg].std():.2e}")
    same = bool(np.allclose(off, on))
    print(f"  process output identical: {same} (defense never touches "
          f"control)")

    flops = MultipartInference(model, params, segments).segment_flops()
    print(f"multipart segments: {segments}, per-segment FLOPs {flops}")
    return {"attack_start": ATTACK_START, "first_detection": first,
            "latency_s": latency,
            "inferences": len(results),
            "attack_verdicts": sum(p != 0 for _, p, _ in results),
            "wd_off_mean": float(off[seg].mean()),
            "wd_off_std": float(off[seg].std()),
            "wd_on_mean": float(on[seg].mean()),
            "wd_on_std": float(on[seg].std()),
            "process_output_identical": same, "segment_flops": flops}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the case study; returns :func:`deploy`'s numbers with the
    dataset's size, the training's accuracies and epochs, and (under
    ``--quant``) the quantized accuracy on the tail split."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.casestudy_msf")
    ap.add_argument("--fast", action="store_true", help="smaller dataset")
    ap.add_argument("--quant", choices=("SINT", "INT", "DINT"))
    ap.add_argument("--segments", type=int, default=4,
                    help="multipart inference segments per window")
    ap.add_argument("--device", default="cuda",
                    help="where training and inference run (cuda or cpu)")
    args = ap.parse_args(argv)

    model, res, x, y = train_casestudy(args.fast, device=args.device)
    ported_model, ported_params = port(model, res.params, x)
    qacc = None
    if args.quant:
        ported_params, qacc = quantize_ported(ported_model, ported_params, x,
                                              y, args.quant)
    return {"windows": int(x.shape[0]), "epochs_run": len(res.history),
            "best_val_acc": res.best_val_acc, "test_acc": res.test_acc,
            "quantized_tail_acc": qacc,
            **deploy(ported_model, ported_params, args.segments)}


if __name__ == "__main__":
    main()
