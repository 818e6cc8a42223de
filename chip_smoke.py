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
             M = 1024, 1000 and 37 (fused_mlp), and the four classifier SINT
             layer shapes (qmatmul).  SINT must be torch.equal; REAL within
             1e-5; DINT within 1e-4; INT within 1e-3 (a last-bit difference
             ahead of a requantize can move an INT code by one step).
             ``ms`` is the kernel's device time from torch.profiler;
             ``call_ms`` the time per call through the Python wrapper, back
             to back (CUDA events), which the host's launch cost can bound.
4. serve   — a 1024-plant fleet (the 128-plant scenario fleet tiled 8x)
             through StreamEngine, warmup + 400 scan cycles (21 verdict
             steps) per run: (a) SINT classifier, fused; (b) REAL classifier;
             (c) SINT autoencoder + calibrated ReconstructionHead; (d) (a)
             with fused=False; (e) (a) with async_depth=1.  Each against the
             same engine with backend="ref": preds identical, SINT outputs
             bit-equal, REAL within 1e-5; kernel launch counts checked.
5. profile — 10 more verdict steps of run (a) under torch.profiler: device
             busy share and device time by kernel.

Then the kernels summary line (``{"kernels": [...]}``, launch counts from
the serve runs), the nvidia-smi line and, last, ``{"ok": true, "device":
...}``.
"""

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
    from repro_torch.kernels import build, fused_mlp, ops, qmatmul, ref
    from repro_torch.serving import StreamEngine
    from repro_torch.sim import (ReconstructionHead, build_autoencoder,
                                 build_detector, fleet_readings)

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
    readings = np.tile(fleet_readings(N_PLANTS, N_CYCLES, seed=0),
                       (1, TILE, 1))
    n_streams = readings.shape[1]
    first = (readings[:spec.WINDOW] - np.asarray(spec.NORM_MEAN, np.float32)) \
        / np.asarray(spec.NORM_STD, np.float32)
    first = np.ascontiguousarray(first.transpose(1, 0, 2)
                                 .reshape(n_streams, -1), dtype=np.float32)
    windows = torch.from_numpy(first).to(dev)

    def card_model(builder, scheme, seed):
        model = builder()
        params = model.init_params(torch.Generator().manual_seed(seed),
                                   device=dev)
        if scheme != "REAL":
            params = quantize.quantize_params(
                model, params, scheme,
                calibration=quantize.calibration_samples(first, k=32,
                                                         device=dev))
        return model, params

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
    launches = {"fused_mlp": 0, "qmatmul": 0}
    for run, ((model, params), scheme, kw) in runs.items():
        engine = StreamEngine(model, params, n_streams=n_streams, **kw)
        engine.warmup()
        fused_mlp.launches = qmatmul.launches = 0
        verdicts, outs = drive(engine)
        counts = {"fused_mlp": fused_mlp.launches,
                  "qmatmul": qmatmul.launches}
        for k in launches:
            launches[k] += counts[k]
        steps = engine.stats.steps
        want_counts = ({"fused_mlp": 0, "qmatmul": 4 * steps}
                       if kw.get("fused") is False
                       else {"fused_mlp": steps, "qmatmul": 0})
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
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"{k} was never launched on the main path")

    # -- 5. profile: where a serving step's device time goes ----------------
    def ten_steps():
        for c in range(spec.WINDOW, spec.WINDOW + 10 * spec.STRIDE):
            profiled.ingest(readings[c])
        profiled.flush()

    t0 = time.perf_counter()
    events = device_events(ten_steps)
    wall = time.perf_counter() - t0
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_us = sum(by_name.values())
    kernel_events = sum(1 for name, _ in events if "fused_mlp_kernel" in name)
    if events and kernel_events != 10:
        raise AssertionError(f"profile: {kernel_events} fused_mlp kernels in "
                             "10 verdict steps, expected one per step")
    emit({"phase": "profile", "run": "a_sint_classifier_fused", "steps": 10,
          "fused_mlp_kernels": kernel_events,
          "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e6 / wall,
          "device_events_per_step": len(events) / 10,
          "top_device_us": sorted(by_name.items(), key=lambda kv: -kv[1])[:10]})

    # -- summary ------------------------------------------------------------
    def ms(row):
        # The profiler's kernel time; the per-call time where the profiler
        # saw no kernel (the summary says which).
        return row["call_ms"] if row["ms"] is None else row["ms"]

    fused_head = next(r for r in fused_rows if r["stack"] == "detector"
                      and r["scheme"] == "SINT" and r["m"] == 1024)
    q_main = [r for r in q_rows if r["m"] == 1024]
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
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
