#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from anywhere in a checkout: ``python3 chip_smoke.py``.  Needs one CUDA
card and the CUDA toolkit (nvcc); it builds the port's kernels from
``src/repro_torch/kernels/csrc`` first.  Phases, each printing JSON lines on
stdout; a failing phase raises and the script exits non-zero:

1. device  — the card's name, and its name and power limit as nvidia-smi
             reports them.
2. build   — seconds taken by the parallel nvcc build, and ptxas's
             register/shared-memory report per kernel.
3. kernels — each kernel against its plain PyTorch version on the card:
             the §7 classifier and autoencoder stacks in REAL/SINT/INT/DINT at
             M = 1024, 1000 and 37 (fused_mlp); the four classifier SINT
             layer shapes (qmatmul); the four-head §7 fleet (classifier,
             autoencoder, margin trunk, forecaster) in the four schemes at
             M = 1024, 1000 and 37 per group, a fleet whose classifier ends
             in a softmax, and a one-group fleet of the SINT autoencoder
             (the fused autoencoder's work through the grouped kernel, a
             like-for-like time) (grouped_fused_mlp).  SINT must be
             torch.equal (grouped: the logit lanes; score lanes, reductions
             summed in another order, within 1e-5 relative); REAL within
             1e-5 (and the softmax fleet); DINT within 1e-4; INT within 1e-3
             (a last-bit difference ahead of a requantize can move an INT
             code by one step).
             ``ms`` is the kernel's device time from torch.profiler;
             ``call_ms`` the time per call through the Python wrapper, back
             to back (CUDA events), which the host's launch cost can bound.
4. serve   — a 1024-plant fleet (the 128-plant scenario fleet tiled 8x)
             through StreamEngine, warmup + 400 scan cycles (21 verdict
             steps) per run: (a) SINT classifier, fused; (b) REAL classifier;
             (c) SINT autoencoder + calibrated ReconstructionHead; (d) (a)
             with fused=False; (e) (a) with async_depth=1.  Then 4 x 1024
             plants (the scenario fleet tiled 32x) through
             GroupedStreamEngine, one group per §7 head, 400 cycles each:
             (f) SINT, megakernel, the reconstruction group adaptive;
             (g) REAL, megakernel; (h) (f) with megakernel=False.  Score
             heads are calibrated through the plain path on the fleet's
             first off-cadence windows (cycles 5-204, which the engine never
             serves, so no served score sits exactly on a threshold); the
             margin center is their mean embedding.  Each run against the
             same engine with backend="ref" (and (f) against (h)): preds
             identical, SINT logits bit-equal, scores within 1e-5, REAL
             within 1e-5; kernel launch counts checked.
5. profile — 10 more verdict steps of runs (a) and (f) under
             torch.profiler: device busy share and device time by kernel.

Then the kernels summary line (``{"kernels": [...]}``, launch counts from
the serve runs), the nvidia-smi line and, last, ``{"ok": true, "device":
...}``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense) for the bounds.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
TOL = {"REAL": 1e-5, "INT": 1e-3, "DINT": 1e-4}
SCHEMES = ("REAL", "SINT", "INT", "DINT")
N_PLANTS, TILE, N_CYCLES = 128, 8, 400
GROUPS, GROUP_TILE = ("clf", "ae", "mg", "fc"), 32    # 4 x 1024 plants


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps):
    """Mean time per call of ``fn`` over ``reps`` back-to-back calls, from
    CUDA events: the device's time, or the host's time to issue a call when
    that is longer."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_events(fn):
    """(name, µs) of every device-side event (kernels, copies) while ``fn``
    runs, from torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def kernel_ms(fn, reps, name):
    """Mean device time of the kernel called ``name`` over ``reps`` calls of
    ``fn`` (None when the profiler records no such kernel)."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            fn()

    times = [us for n, us in device_events(calls) if name in n]
    return sum(times) / len(times) / 1e3 if times else None


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, op_seconds):
    """(bound_ms, bound_by): the larger of the byte time and the op time."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (max(t_bytes, op_seconds) * 1e3,
            "bytes" if t_bytes >= op_seconds else "operations")


def fused_bound(x, prepared):
    layers = prepared.layers
    ops_s = sum(2 * x.shape[0] * l.w.shape[0] * l.w.shape[1]
                / (INT8_OPS_PER_S if l.w.dtype == torch.int8
                   else F32_FLOPS_PER_S) for l in layers)
    moved = nbytes(x) + x.shape[0] * prepared.n_out * 4 + sum(
        nbytes(l.w, l.bias, l.scale) for l in layers)
    return bound(moved, ops_s)


def _weight(p):
    return p["qw"] if "qw" in p else p["w"]


def grouped_bound(x, out, plan, arrays):
    """Bytes: each group's true input lanes of x, the target lanes its
    epilogue reads (a score group's first n_out lanes; none for a logits
    group, kind 0) and every arena read once, the payload written once.
    Operations: each group's true-width products at its type's peak (int8 on
    the tensor cores' int8 rate, f32 otherwise)."""
    m = x.shape[1]
    ops_s = sum(2 * m * _weight(p).shape[0] * _weight(p).shape[1]
                / (INT8_OPS_PER_S if _weight(p).dtype == torch.int8
                   else F32_FLOPS_PER_S)
                for stack in arrays["stacks"] for p in stack)
    lanes = sum(k0 + (n_out if kind else 0) for k0, n_out, kind
                in zip(plan.true_k0s, plan.n_outs, plan.kinds))
    arenas = [t for key in ("w", "scale", "bias", "x_scale")
              for t in arrays[key]] + [arrays["meta"]]
    return bound(m * lanes * x.element_size() + nbytes(out, *arenas), ops_s)


def qmatmul_bound(xq, wq, scale, bias):
    m, k = xq.shape
    n = wq.shape[1]
    return bound(nbytes(xq, wq, scale, bias) + m * n * 4,
                 2 * m * k * n / INT8_OPS_PER_S)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs on an NVIDIA GPU")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.configs import msf_detector as spec
    from repro_torch.core import quantize
    from repro_torch.core import layers as L
    from repro_torch.core.model import sequential
    from repro_torch.kernels import build, fused_mlp, ops, qmatmul, ref
    from repro_torch.serving import (AdaptConfig, GroupedStreamEngine,
                                     ModelGroup, StreamEngine)
    from repro_torch.sim import (ClassifierHead, ForecastHead, MarginHead,
                                 ReconstructionHead, build_autoencoder,
                                 build_detector, build_forecaster,
                                 build_margin_model, fleet_readings)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "smem" in ln]
                    for name, log in reports.items()}})

    # The fleet's readings and its first (benign) windows, normalized as
    # the engine normalizes them: realistic inputs for phase 3 and the
    # calibration data for phase 4.
    grouped_readings = np.tile(fleet_readings(N_PLANTS, N_CYCLES, seed=0),
                               (1, GROUP_TILE, 1))
    readings = grouped_readings[:, :N_PLANTS * TILE]
    n_streams = readings.shape[1]

    def normalized_windows(start):
        """The fleet's windows of cycles [start, start + WINDOW), as the
        engine normalizes and unrolls them: (4096, 400) f32 on the card."""
        w = (grouped_readings[start:start + spec.WINDOW]
             - np.asarray(spec.NORM_MEAN, np.float32)) \
            / np.asarray(spec.NORM_STD, np.float32)
        w = w.transpose(1, 0, 2).reshape(grouped_readings.shape[1], -1)
        return torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(dev)

    group_windows = normalized_windows(0)               # first windows
    windows = group_windows[:n_streams]
    first = windows.cpu().numpy()

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

    fleet_builders = (build_detector, build_autoencoder, build_margin_model,
                      build_forecaster)

    def fleet_models(scheme, seed, softmax=False):
        """(model, params) per §7 head; ``softmax`` ends the classifier in
        a softmax (the one activation the grouped kernel masks)."""
        models = [card_model(b, scheme, seed + i)
                  for i, b in enumerate(fleet_builders)]
        if softmax:
            clf = sequential(
                [L.Input()] + [L.Dense(units=h, activation="relu")
                               for h in spec.HIDDEN]
                + [L.Dense(units=spec.CLASSES, activation="softmax")],
                (spec.INPUT_SIZE,))
            models[0] = (clf, models[0][1])
        return models

    def fleet_targets(x, center):
        """The engine's epilogue targets for the four-head fleet: zeros
        (classifier), the window (autoencoder), the center (margin), the
        window's newest reading (forecaster)."""
        tgt = torch.zeros_like(x)
        tgt[1] = x[1]
        tgt[2, :, :center.shape[0]] = center
        tgt[3, :, :spec.N_FEATURES] = x[3, :, -spec.N_FEATURES:]
        return tgt

    # -- 3. kernels vs their plain versions ---------------------------------
    fused_rows, fused_err = [], 0.0
    for name, builder in (("detector", build_detector),
                          ("autoencoder", build_autoencoder)):
        for scheme in SCHEMES:
            model, params = card_model(builder, scheme, seed=1)
            stack = ops.dense_stack(model, params)
            prepared = ops.prepare_fused(stack)
            for m in (1024, 1000, 37):
                x = windows[:m].contiguous()
                got = fused_mlp.fused_mlp(x, prepared)
                want = ref.fused_mlp_ref(x, stack)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if scheme == "SINT":
                    ok = torch.equal(got, want)
                else:
                    ok = torch.allclose(got, want, rtol=TOL[scheme],
                                        atol=TOL[scheme])
                if not ok or not torch.isfinite(got).all():
                    raise AssertionError(
                        f"fused_mlp {name} {scheme} M={m}: kernel disagrees "
                        f"with the plain version (max abs err {err})")
                fused_err = max(fused_err, err)
                row = {"stack": name, "scheme": scheme, "m": m,
                       "max_abs_err": err}
                if m == 1024:
                    row["ms"] = kernel_ms(lambda: fused_mlp.fused_mlp(
                        x, prepared), 50, "fused_mlp_kernel")
                    row["call_ms"] = time_ms(lambda: fused_mlp.fused_mlp(
                        x, prepared), 200)
                    row["plain_ms"] = time_ms(lambda: ref.fused_mlp_ref(
                        x, stack), 20)
                    row["bound_ms"], row["bound_by"] = fused_bound(x,
                                                                   prepared)
                    row["bound_us"] = row["bound_ms"] * 1e3
                fused_rows.append(row)
                emit({"phase": "kernels", "kernel": "fused_mlp", **row})

    q_rows, q_err = [], 0.0
    model, params = card_model(build_detector, "SINT", seed=1)
    h = windows
    for p, act in ops.dense_stack(model, params):
        # The per-layer step's own quantization of each layer's input.
        qmax = torch.iinfo(p["qw"].dtype).max
        for m in (1024, 1000, 37):
            xq = torch.clamp(torch.round(h[:m] / p["x_scale"]), -qmax,
                             qmax).to(torch.int8).contiguous()
            scale = (p["x_scale"] * p["w_scale"]).contiguous()
            got = qmatmul.qmatmul(xq, p["qw"], scale, p["b"])
            want = ref.qmatmul_ref(xq, p["qw"], scale, p["b"])
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(
                    f"qmatmul {tuple(xq.shape)}x{tuple(p['qw'].shape)}: "
                    f"kernel disagrees with the plain version ({err})")
            q_err = max(q_err, err)
            row = {"m": m, "k": xq.shape[1], "n": p["qw"].shape[1],
                   "max_abs_err": err}
            if m == 1024:
                row["ms"] = kernel_ms(lambda: qmatmul.qmatmul(
                    xq, p["qw"], scale, p["b"]), 50, "qmatmul_kernel")
                row["call_ms"] = time_ms(lambda: qmatmul.qmatmul(
                    xq, p["qw"], scale, p["b"]), 200)
                row["plain_ms"] = time_ms(lambda: ref.qmatmul_ref(
                    xq, p["qw"], scale, p["b"]), 20)
                row["bound_ms"], row["bound_by"] = qmatmul_bound(
                    xq, p["qw"], scale, p["b"])
                row["bound_us"] = row["bound_ms"] * 1e3
            q_rows.append(row)
            emit({"phase": "kernels", "kernel": "qmatmul", **row})
        h = ref.dense_layer_ref(h, p, act)

    g_rows, g_err = [], 0.0
    gx_all = group_windows.view(len(GROUPS), n_streams, -1)
    kinds = (ops.GROUPED_KIND_LOGITS,) + (ops.GROUPED_KIND_SCORE,) * 3
    # "SINT-ae-alone": a one-group fleet of the SINT autoencoder, the same
    # work as the fused_mlp autoencoder row above, so the two kernels'
    # per-block code compares like for like.
    for scheme in SCHEMES + ("SINT-softmax", "SINT-ae-alone"):
        base = scheme.split("-")[0]
        models = fleet_models(base, seed=1, softmax=scheme == "SINT-softmax")
        stacks = [ops.dense_stack(m, p) for m, p in models]
        center = ref.fused_mlp_ref(gx_all[2], stacks[2]).mean(dim=0)
        if scheme == "SINT-ae-alone":
            stacks, fleet_kinds = stacks[1:2], kinds[1:2]
        else:
            fleet_kinds = kinds
        plan, arrays = ops.build_grouped_plan(stacks, fleet_kinds,
                                              k0=spec.INPUT_SIZE)
        prepared = ops.prepare_grouped(plan, arrays)
        plain_stacks = [list(zip(arrays["stacks"][g], plan.acts[g]))
                        for g in range(plan.n_groups)]
        ms_sizes = {"SINT-softmax": (1000,), "SINT-ae-alone": (1024,)}
        for m in ms_sizes.get(scheme, (1024, 1000, 37)):
            if scheme == "SINT-ae-alone":
                x = gx_all[1:2, :m].contiguous()
                tgt = x.clone()
            else:
                x = gx_all[:, :m].contiguous()
                tgt = fleet_targets(x, center)

            def plain():
                return ref.grouped_mlp_ref(
                    x, plain_stacks, kinds=plan.kinds,
                    true_k0s=plan.true_k0s, n_outs=plan.n_outs, tgt=tgt,
                    n_pay=plan.payload_width)

            got = fused_mlp.grouped_fused_mlp(x, prepared, tgt)
            want = plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if scheme in ("SINT", "SINT-ae-alone"):
                ok = all(torch.equal(got[g], want[g]) if k == 0 else
                         torch.allclose(got[g], want[g], rtol=1e-5, atol=0)
                         for g, k in enumerate(plan.kinds))
            else:
                tol = TOL["REAL" if scheme != base else base]
                ok = torch.allclose(got, want, rtol=tol, atol=tol)
            if not ok or not torch.isfinite(got).all():
                raise AssertionError(
                    f"grouped_fused_mlp {scheme} M={m}: kernel disagrees "
                    f"with the plain version (max abs err {err})")
            g_err = max(g_err, err)
            row = {"fleet": ("ae" if scheme == "SINT-ae-alone"
                             else "clf+ae+margin+forecast"),
                   "scheme": scheme, "m_per_group": m, "max_abs_err": err}
            if m == 1024:
                row["ms"] = kernel_ms(lambda: fused_mlp.grouped_fused_mlp(
                    x, prepared, tgt), 50, "grouped_mlp_kernel")
                row["call_ms"] = time_ms(lambda: fused_mlp.grouped_fused_mlp(
                    x, prepared, tgt), 200)
                row["plain_ms"] = time_ms(plain, 20)
                row["bound_ms"], row["bound_by"] = grouped_bound(
                    x, got, plan, arrays)
                row["bound_us"] = row["bound_ms"] * 1e3
            g_rows.append(row)
            emit({"phase": "kernels", "kernel": "grouped_fused_mlp", **row})

    # -- 4. serve: the 1024-plant fleet -------------------------------------
    def drive(engine):
        outs, verdicts = [], []
        for c in range(N_CYCLES):
            got = engine.ingest(readings[c])
            if got:
                verdicts.extend(got)
                outs.append(engine.last_logits.copy())
        verdicts.extend(engine.flush())
        if engine.async_depth:
            outs.append(engine.last_logits.copy())
        return verdicts, outs

    cls_sint = card_model(build_detector, "SINT", seed=2)
    cls_real = card_model(build_detector, "REAL", seed=2)
    ae_sint = card_model(build_autoencoder, "SINT", seed=3)
    ae_stack = ops.dense_stack(*ae_sint)
    recon = ref.fused_mlp_ref(windows, ae_stack)
    scores = torch.mean(torch.square(recon - windows), dim=-1)
    ae_head = ReconstructionHead().calibrate(scores.cpu().numpy(),
                                             spec.AE_TARGET_FPR)
    runs = {
        "a_sint_classifier_fused": (cls_sint, "SINT", {}),
        "b_real_classifier_fused": (cls_real, "REAL", {}),
        "c_sint_autoencoder_fused": (ae_sint, "SINT", {"head": ae_head}),
        "d_sint_classifier_per_layer": (cls_sint, "SINT", {"fused": False}),
        "e_sint_classifier_fused_async": (cls_sint, "SINT",
                                          {"async_depth": 1}),
    }
    launches = {"fused_mlp": 0, "qmatmul": 0, "grouped_mlp": 0}

    def reset_counts():
        fused_mlp.launches = qmatmul.launches = 0
        fused_mlp.grouped_launches = 0

    def read_counts():
        return {"fused_mlp": fused_mlp.launches, "qmatmul": qmatmul.launches,
                "grouped_mlp": fused_mlp.grouped_launches}

    for run, ((model, params), scheme, kw) in runs.items():
        engine = StreamEngine(model, params, n_streams=n_streams, **kw)
        engine.warmup()
        reset_counts()
        verdicts, outs = drive(engine)
        counts = read_counts()
        for k in launches:
            launches[k] += counts[k]
        steps = engine.stats.steps
        want_counts = ({"fused_mlp": 0, "qmatmul": 4 * steps,
                        "grouped_mlp": 0}
                       if kw.get("fused") is False
                       else {"fused_mlp": steps, "qmatmul": 0,
                             "grouped_mlp": 0})
        if steps != 21 or counts != want_counts:
            raise AssertionError(f"{run}: {steps} steps, launches {counts}, "
                                 f"expected {want_counts}")
        plain = StreamEngine(model, params, n_streams=n_streams,
                             backend="ref", **kw)
        plain.warmup()
        plain_verdicts, plain_outs = drive(plain)
        if [v.pred for v in verdicts] != [v.pred for v in plain_verdicts]:
            raise AssertionError(f"{run}: preds differ from the plain path")
        if len(outs) != len(plain_outs) or len(outs) != steps:
            raise AssertionError(f"{run}: {len(outs)} outputs, {steps} steps")
        for got, want in zip(outs, plain_outs):
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"{run}: bad output {got.shape}")
            if scheme == "SINT":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=TOL["REAL"],
                                           atol=TOL["REAL"])
        stats = engine.stats
        emit({"phase": "serve", "run": run, "streams": n_streams,
              "cycles": stats.cycles, "steps": steps,
              "windows": stats.windows,
              "windows_per_s": stats.windows_per_s(),
              "p50_ms": stats.latency_p(50) * 1e3,
              "p99_ms": stats.latency_p(99) * 1e3,
              "deadline_misses": stats.deadline_misses,
              "dispatches": stats.dispatches, "launches": counts,
              "anomalous_verdicts": int(sum(v.pred for v in verdicts)),
              "plain_windows_per_s": plain.stats.windows_per_s(),
              "plain_p99_ms": plain.stats.latency_p(99) * 1e3})
        if run == "a_sint_classifier_fused":
            profiled = engine

    # The heterogeneous fleet: 4 groups x 1024 plants, one per §7 head.
    calib_windows = normalized_windows(spec.STRIDE // 2).view(
        len(GROUPS), n_streams, -1)

    def fleet_groups(scheme, seed):
        """ModelGroups with heads calibrated through the plain path on the
        off-cadence windows (module docstring)."""
        models = fleet_models(scheme, seed)
        stacks = [ops.dense_stack(m, p) for m, p in models]
        cx = calib_windows
        recon = ref.fused_mlp_ref(cx[1], stacks[1])
        emb = ref.fused_mlp_ref(cx[2], stacks[2])
        center = emb.mean(dim=0)
        fc_in = spec.INPUT_SIZE - spec.N_FEATURES
        pred = ref.fused_mlp_ref(cx[3][:, :fc_in].contiguous(), stacks[3])

        def calibrated(head, out, target):
            scores = torch.mean(torch.square(out - target), dim=-1)
            return head.calibrate(scores.cpu().numpy(), spec.AE_TARGET_FPR)

        heads = (ClassifierHead(),
                 calibrated(ReconstructionHead(), recon, cx[1]),
                 calibrated(MarginHead(center=tuple(
                     float(c) for c in center.cpu().numpy())), emb, center),
                 calibrated(ForecastHead(), pred, cx[3][:, fc_in:]))
        return [ModelGroup(name, model, params, n_streams, head)
                for name, (model, params), head in zip(GROUPS, models, heads)]

    def drive_grouped(engine):
        outs, verdicts = [], []
        for c in range(N_CYCLES):
            got = engine.ingest(grouped_readings[c])
            if got:
                verdicts.extend(got)
                outs.append({k: v.copy() for k, v in
                             engine.last_outputs.items()})
        return verdicts, outs

    def same_outputs(run, scheme, got_steps, want_steps):
        if len(got_steps) != len(want_steps):
            raise AssertionError(f"{run}: {len(got_steps)} vs "
                                 f"{len(want_steps)} steps of outputs")
        for got, want in zip(got_steps, want_steps):
            for name in GROUPS:
                a, b = got[name], want[name]
                if a.shape != b.shape or not np.isfinite(a).all():
                    raise AssertionError(f"{run}: bad {name} output "
                                         f"{a.shape}")
                if scheme == "SINT" and name == "clf":
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a, b, rtol=TOL["REAL"],
                                               atol=TOL["REAL"])

    sint_groups = fleet_groups("SINT", seed=4)
    sint_groups[1] = dataclasses.replace(sint_groups[1], adapt=AdaptConfig())
    grouped_runs = {
        "f_sint_fleet_mega_adaptive": (sint_groups, "SINT", {}),
        "g_real_fleet_mega": (fleet_groups("REAL", seed=4), "REAL", {}),
        "h_sint_fleet_per_group": (sint_groups, "SINT",
                                   {"megakernel": False}),
    }
    grouped_results = {}
    for run, (groups, scheme, kw) in grouped_runs.items():
        engine = GroupedStreamEngine(groups, **kw)
        engine.warmup()
        reset_counts()
        verdicts, outs = drive_grouped(engine)
        counts = read_counts()
        for k in launches:
            launches[k] += counts[k]
        steps = engine.stats.steps
        want_counts = ({"fused_mlp": 4 * steps, "qmatmul": 0,
                        "grouped_mlp": 0}
                       if kw.get("megakernel") is False
                       else {"fused_mlp": 0, "qmatmul": 0,
                             "grouped_mlp": steps})
        if steps != 21 or counts != want_counts:
            raise AssertionError(f"{run}: {steps} steps, launches {counts}, "
                                 f"expected {want_counts}")
        if engine.mega_reason is not None:
            raise AssertionError(f"{run}: fleet does not pack: "
                                 f"{engine.mega_reason}")
        plain = GroupedStreamEngine(groups, backend="ref", **kw)
        plain.warmup()
        plain_verdicts, plain_outs = drive_grouped(plain)
        if [v.pred for v in verdicts] != [v.pred for v in plain_verdicts]:
            raise AssertionError(f"{run}: preds differ from the plain path")
        same_outputs(run, scheme, outs, plain_outs)
        thresholds = engine.live_thresholds()
        np.testing.assert_allclose(
            [t for t in thresholds.values() if t is not None],
            [t for t in plain.live_thresholds().values() if t is not None],
            rtol=TOL["REAL"])
        grouped_results[run] = (verdicts, outs)
        stats = engine.stats
        emit({"phase": "serve", "run": run, "streams": engine.n_streams,
              "groups": len(groups), "cycles": stats.cycles, "steps": steps,
              "windows": stats.windows,
              "windows_per_s": stats.windows_per_s(),
              "p50_ms": stats.latency_p(50) * 1e3,
              "p99_ms": stats.latency_p(99) * 1e3,
              "deadline_misses": stats.deadline_misses,
              "dispatches": stats.dispatches, "launches": counts,
              "anomalous_verdicts": {
                  name: int(sum(v.pred for v in verdicts if v.group == name))
                  for name in GROUPS},
              "live_thresholds": thresholds,
              "plain_windows_per_s": plain.stats.windows_per_s(),
              "plain_p99_ms": plain.stats.latency_p(99) * 1e3})
        if run.startswith("f_"):
            profiled_fleet = engine
    mega, per_group = (grouped_results["f_sint_fleet_mega_adaptive"],
                       grouped_results["h_sint_fleet_per_group"])
    if [v.pred for v in mega[0]] != [v.pred for v in per_group[0]]:
        raise AssertionError("(f) and (h): preds differ between the "
                             "megakernel and the per-group path")
    same_outputs("(f) vs (h)", "SINT", mega[1], per_group[1])
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"{k} was never launched on the main path")

    # -- 5. profile: where a serving step's device time goes ----------------
    def profile(run, engine, fleet_readings_, kernel):
        def ten_steps():
            for c in range(spec.WINDOW, spec.WINDOW + 10 * spec.STRIDE):
                engine.ingest(fleet_readings_[c])
            engine.flush()

        t0 = time.perf_counter()
        events = device_events(ten_steps)
        wall = time.perf_counter() - t0
        by_name = {}
        for name, us in events:
            by_name[name] = by_name.get(name, 0.0) + us
        busy_us = sum(by_name.values())
        kernel_events = sum(1 for name, _ in events if kernel in name)
        if events and kernel_events != 10:
            raise AssertionError(f"profile {run}: {kernel_events} {kernel}s "
                                 "in 10 verdict steps, expected one per step")
        emit({"phase": "profile", "run": run, "steps": 10,
              "kernel": kernel, "kernel_launches": kernel_events,
              "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
              "device_busy_share": busy_us / 1e6 / wall,
              "device_events_per_step": len(events) / 10,
              "top_device_us": sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:10]})

    profile("a_sint_classifier_fused", profiled, readings, "fused_mlp_kernel")
    profile("f_sint_fleet_mega_adaptive", profiled_fleet, grouped_readings,
            "grouped_mlp_kernel")

    # -- summary ------------------------------------------------------------
    def ms(row):
        # The profiler's kernel time; the per-call time where the profiler
        # saw no kernel (the summary says which).
        return row["call_ms"] if row["ms"] is None else row["ms"]

    fused_head = next(r for r in fused_rows if r["stack"] == "detector"
                      and r["scheme"] == "SINT" and r["m"] == 1024)
    q_main = [r for r in q_rows if r["m"] == 1024]
    g_head = next(r for r in g_rows if r["scheme"] == "SINT"
                  and r["m_per_group"] == 1024)
    source = ("torch.profiler" if fused_head["ms"] is not None
              and all(r["ms"] is not None for r in q_main) else "call_ms")
    kernels = [
        {"name": "fused_mlp", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_mlp.cu",
         "replaces": "src/repro/kernels/fused_mlp.py:234",
         "launches": launches["fused_mlp"], "max_abs_err": fused_err,
         "ms": ms(fused_head), "ms_source": source,
         "call_ms": fused_head["call_ms"], "plain_ms": fused_head["plain_ms"],
         "bound_ms": fused_head["bound_ms"],
         "bound_us": fused_head["bound_us"],
         "bound_by": fused_head["bound_by"], "library_ms": None,
         "shape": "detector SINT, M=1024 (400-64-32-16-2)",
         "timed": [r for r in fused_rows if r["m"] == 1024]},
        {"name": "qmatmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qmatmul.cu",
         "replaces": "src/repro/kernels/qmatmul.py:69",
         "launches": launches["qmatmul"], "max_abs_err": q_err,
         "ms": sum(ms(r) for r in q_main), "ms_source": source,
         "call_ms": sum(r["call_ms"] for r in q_main),
         "plain_ms": sum(r["plain_ms"] for r in q_main),
         "bound_ms": sum(r["bound_ms"] for r in q_main),
         "bound_us": sum(r["bound_us"] for r in q_main),
         "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                    for r in q_main) else "operations",
         "library_ms": None,
         "shape": "the four detector SINT layers at M=1024, summed "
                  "(one per-layer step)",
         "timed": q_main},
        {"name": "grouped_fused_mlp", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/grouped_mlp.cu",
         "replaces": "src/repro/kernels/fused_mlp.py:473",
         "launches": launches["grouped_mlp"], "max_abs_err": g_err,
         "ms": ms(g_head),
         "ms_source": ("torch.profiler" if g_head["ms"] is not None
                       else "call_ms"),
         "call_ms": g_head["call_ms"], "plain_ms": g_head["plain_ms"],
         "bound_ms": g_head["bound_ms"], "bound_us": g_head["bound_us"],
         "bound_by": g_head["bound_by"], "library_ms": None,
         "shape": "four-head §7 fleet SINT (400-64-32-16-2, 400-64-16-64-400, "
                  "400-64-32-16, 398-64-32-2), M=1024 per group",
         "timed": [r for r in g_rows if r["m_per_group"] == 1024]},
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
