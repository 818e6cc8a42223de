"""Quickstart: the ICSML core in five minutes, on the card
(``examples/quickstart.py``'s counterpart).

Builds a small model the ICSML way (array of layers + static memory plan),
runs planned (arena) inference, quantizes it (§6.1), prunes it (§6.2), and
executes it multipart across simulated scan cycles (§6.3).  Params and the
input are drawn from seeded CPU generators (seeds 0 and 1) and live on
``--device``.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import MultipartInference, layers as L, prune, quantize
from repro_torch.core import sequential
from repro_torch.device import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda or cpu)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. declare the model — an array of layers, sizes static (ICSML style)
    model = sequential(
        [L.Input(),
         L.Dense(units=128, activation="relu"),
         L.Dense(units=64, activation="relu"),
         L.Dense(units=10, activation="softmax")],
        input_shape=(32,))
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    print(model.summary(), "\n")

    # 2. static memory plan (the dataMem table) + planned inference
    plan = model.memory_plan()
    print(f"activation arena: {plan.arena_bytes} B "
          f"(naive layout would be {model.memory_plan(reuse=False).arena_bytes} B)")
    x = torch.randn((32,), generator=torch.Generator().manual_seed(1)).to(dev)
    y_ref = model.apply(params, x)
    y_arena = model.apply_planned(params, x)
    assert torch.equal(y_ref, y_arena)
    print("planned (arena) inference == reference inference ✓\n")

    # 3. integer quantization (§6.1)
    qparams = quantize.quantize_params(model, params, "SINT", calibration=[x])
    y_q = model.apply(qparams, x)
    print(f"SINT output max|err| = {float((y_q - y_ref).abs().max()):.4g}")
    print("512x512 layer memory (Table 2):",
          {s: quantize.memory_report(512, 512, s)["total"]
           for s in ("SINT", "INT", "DINT", "REAL")}, "\n")

    # 4. pruning (§6.2)
    pparams = prune.prune_model(model, params, 0.5)
    print(f"pruned sparsity of layer 1: "
          f"{prune.sparsity_of(pparams[1]['w']):.2f}\n")

    # 5. multipart inference (§6.3): one segment per scan cycle
    mi = MultipartInference(model, params, n_segments=3)
    state = mi.start(x)
    for cycle in range(mi.n_segments):
        state = mi.step(state)      # this cycle's inference budget
        print(f"scan cycle {cycle}: segment done "
              f"({mi.segment_flops()[cycle]} FLOPs)")
    np.testing.assert_allclose(mi.output(state).cpu().numpy(),
                               y_arena.cpu().numpy(), rtol=1e-6, atol=1e-7)
    print("multipart output identical to single-shot ✓")


if __name__ == "__main__":
    main()
