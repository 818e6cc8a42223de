#!/usr/bin/env python3
"""Phases 15 and 16 of ``chip_smoke.py`` alone, on a machine with one card
or several: the fleet served on ``torch.distributed`` meshes, runs (L)-(Q),
and the sharded LLM train step, runs (R)-(V).  With four cards the ranks of
(L)-(P) and (R)-(T) take one card each over NCCL; with fewer, four ranks
share them over gloo.  With four cards phase 16 adds the run one card
cannot hold: qwen3-8b uncut on a (1, 4) mesh
(``chip_smoke.train_mesh_uncut``).

Run from the root of a checkout: ``python3 chip_mesh.py``.  It builds the
kernels, makes ``chip_smoke.py``'s fleet models on the card (the same
builders and seeds; the four-head fleet's score thresholds are fixed here,
not calibrated) and calls ``chip_smoke.mesh_phase`` and
``chip_smoke.train_mesh_phase``, which print one JSON line per run and
raise on any mismatch.  The last line is the kernel launches of every
rank's runs, summed.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_mesh: torch.cuda.is_available() is false; this "
                 "script runs on NVIDIA GPUs")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))
    import chip_smoke as cs
    from repro_torch.configs import msf_detector as spec
    from repro_torch.core import quantize
    from repro_torch.kernels import build, ops, ref
    from repro_torch.serving import AdaptConfig, ModelGroup
    from repro_torch.sim import (ClassifierHead, ForecastHead, MarginHead,
                                 ReconstructionHead, build_autoencoder,
                                 build_detector, build_forecaster,
                                 build_margin_model, fleet_readings)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build()
    base = fleet_readings(cs.N_PLANTS, cs.N_CYCLES, seed=0)
    first = ((base[:spec.WINDOW] - np.asarray(spec.NORM_MEAN, np.float32))
             / np.asarray(spec.NORM_STD, np.float32))
    first = first.transpose(1, 0, 2).reshape(cs.N_PLANTS, -1)
    windows = torch.from_numpy(np.ascontiguousarray(first)).to(dev)

    def card_model(builder, scheme, seed):
        model = builder()
        params = model.init_params(torch.Generator().manual_seed(seed),
                                   device=dev)
        if scheme != "REAL":
            params = quantize.quantize_params(
                model, params, scheme,
                calibration=quantize.calibration_samples(
                    first[:, :model.input_shape[0]], k=32, device=dev))
        return model, params

    cls_sint = card_model(build_detector, "SINT", 2)
    cls_real = card_model(build_detector, "REAL", 2)
    ae_sint = card_model(build_autoencoder, "SINT", 3)
    recon = ref.fused_mlp_ref(windows, ops.dense_stack(*ae_sint))
    scores = torch.mean(torch.square(recon - windows), dim=-1)
    ae_head = ReconstructionHead().calibrate(scores.cpu().numpy(),
                                             spec.AE_TARGET_FPR)
    models = [card_model(b, "SINT", 4 + i) for i, b in enumerate(
        (build_detector, build_autoencoder, build_margin_model,
         build_forecaster))]
    heads = (ClassifierHead(),
             ReconstructionHead(threshold=float(scores.median()),
                                target_fpr=0.01),
             MarginHead(threshold=1.0, center=(0.0,) * 16),
             ForecastHead(threshold=1.0))
    groups = [ModelGroup(name, m, p, cs.MESH_PLANTS, h)
              for name, (m, p), h in zip(cs.GROUPS, models, heads)]
    groups[1] = dataclasses.replace(groups[1], adapt=AdaptConfig())
    smi = cs.nvidia_smi()
    launches = cs.mesh_phase(
        dev, smi, {"cls_sint": cls_sint, "cls_real": cls_real,
                   "ae_sint": ae_sint, "ae_head": ae_head,
                   "groups": groups}, base)
    del cls_sint, cls_real, ae_sint, models, groups
    torch.cuda.empty_cache()
    train = cs.train_mesh_phase(dev, smi)
    if torch.cuda.device_count() >= cs.TM_WORLD:
        uncut = cs.train_mesh_uncut(dev, smi)
        train = {k: train[k] + uncut[k] for k in train}
    print(json.dumps({"mesh_launches": launches, "train_mesh_launches": train,
                      "cards": torch.cuda.device_count()}), flush=True)


if __name__ == "__main__":
    main()
