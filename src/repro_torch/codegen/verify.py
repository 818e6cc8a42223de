"""Verification harness: exported ST vs. the serving engine, the
counterpart of ``repro.codegen.verify``.

The deployment story only holds if the PLC-side block decides exactly what
the fleet engine decides, so this module owns the replay machinery the test
suite and ``examples/export_st.py`` share:

* :func:`window_starts` / :func:`stream_windows` — the serving ring's window
  schedule replayed in plain numpy: a window completes at cycle ``c`` (the
  0-based index of its last reading) when ``c + 1 >= window`` and
  ``(c + 1 - window) % stride == 0`` — exactly when ``ServingCore`` fires —
  and spans ``readings[c + 1 - window : c + 1]`` oldest-first with features
  interleaved per reading, the unrolled-ring layout the engine feeds the
  model.
* :func:`emulate_stream` — raw readings of one stream, or of several,
  through the emulated FUNCTION_BLOCK: one batched interpreter pass over all
  of their windows.
* :func:`sequential_f32_mse` — the **score contract** oracle.  A PLC sums
  the squared errors sequentially in f32; the engine's row reduction
  reassociates, so the two agree only to epsilon even over bit-identical
  inputs.  The
  suite therefore asserts three things about a SINT score-head export: the
  emulated score bit-matches THIS oracle over the bit-exact SINT model
  outputs, the verdict (strict ``score > threshold``) matches the engine
  exactly, and the engine's own score agrees to tight relative tolerance.
* :func:`run_engine` — the `StreamEngine` side of the comparison: drive raw
  fleet readings cycle by cycle through the port's engine on ``device``
  (on the card the verdict step is one ``fused_mlp`` launch) and collect
  the per-window `Verdict`s.
* :func:`verify_export` — the whole check of ``examples/export_st.py``:
  the engine serves the fleet, :func:`emulate_stream` replays every window
  of the chosen plants in one batched call, and each window is held to the
  SINT bit contract or the REAL epsilon.

Everything but :func:`run_engine` is numpy; parameters may be torch
tensors on any device and are read to the host where a numpy oracle needs
them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.codegen.emulator import STFunctionBlock
from repro_torch.codegen.st import STExport, _host_leaf
from repro_torch.device import Device
from repro_torch.kernels.ops import dense_stack
from repro_torch.sim.heads import softmax_np


def window_starts(n_cycles: int, window: int, stride: int) -> List[int]:
    """Cycles (0-based last-reading index) at which a verdict window
    completes — `ServingCore`'s ready schedule (``Verdict.cycle`` values)."""
    return [c for c in range(n_cycles)
            if c + 1 >= window and (c + 1 - window) % stride == 0]


def stream_windows(readings: np.ndarray, window: int,
                   stride: int) -> np.ndarray:
    """All completed windows of one stream's ``(n_cycles, F)`` readings as a
    ``(n_windows, window * F)`` batch — oldest reading first, features
    interleaved per reading (the engine's unrolled-ring model input)."""
    readings = np.asarray(readings, np.float32)
    n_cycles, n_features = readings.shape
    rows = [readings[c + 1 - window:c + 1].reshape(-1)
            for c in window_starts(n_cycles, window, stride)]
    return (np.stack(rows) if rows
            else np.zeros((0, window * n_features), np.float32))


def normalize_windows(windows: np.ndarray, mean, std) -> np.ndarray:
    """The engines' host-side ingest normalization, replayed per reading:
    ``(x - mean) / std`` elementwise in f32 (two IEEE ops, the same two the
    exported block applies when normalization is baked in)."""
    windows = np.asarray(windows, np.float32)
    f = len(mean)
    shaped = windows.reshape(windows.shape[0], -1, f)
    out = (shaped - np.asarray(mean, np.float32)) / np.asarray(std,
                                                               np.float32)
    return out.reshape(windows.shape).astype(np.float32)


def sequential_f32_mse(y: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Per-row mean squared error accumulated SEQUENTIALLY in f32 — the
    arithmetic a scan-cycle FOR loop performs, and the score oracle SINT
    score-head exports are bit-checked against."""
    y = np.asarray(y, np.float32)
    target = np.asarray(target, np.float32)
    acc = np.zeros(y.shape[0], np.float32)
    for i in range(y.shape[1]):
        t = (y[:, i] - target[:, i]).astype(np.float32)
        acc = (acc + t * t).astype(np.float32)
    return (acc / np.float32(y.shape[1])).astype(np.float32)


def _np_act(act: str, y: np.ndarray) -> np.ndarray:
    if act == "relu":
        return np.maximum(y, np.float32(0.0))
    if act == "linear":
        return y
    if act == "sigmoid":
        return (np.float32(1.0)
                / (np.float32(1.0) + np.exp(-y))).astype(np.float32)
    if act == "tanh":
        return np.tanh(y).astype(np.float32)
    raise ValueError(f"activation {act!r} has no numpy reference here")


def numpy_mlp_ref(x: np.ndarray, stack) -> np.ndarray:
    """The per-layer §6.1 reference in pure numpy — the **bit-oracle** for
    SINT exports.

    Semantics are ``ref.dense_layer_ref`` run eagerly: requantize is two
    separately-rounded f32 ops (``f32(acc) * f32(x_scale * w_scale)`` then
    ``+ b``).  A PLC executes the two-op form, so this is the arithmetic the
    emitted ST is held bit-exact to; the port's kernels keep the two ops
    separate too (an FMA-contracted program agrees only to an ulp).
    """
    out = np.asarray(x, np.float32)
    for p, act in stack:
        p = {k: _host_leaf(v) for k, v in p.items()}
        if "qw" in p:
            qw = p["qw"]
            if qw.dtype != np.int8:
                raise ValueError(
                    "numpy_mlp_ref covers REAL and SINT stacks only (INT/"
                    "DINT accumulate in f32 on the served side)")
            xs = np.float32(p["x_scale"])
            t = (out / xs).astype(np.float32)
            xq = np.clip(np.rint(t), -127, 127).astype(np.int32)
            acc = xq @ qw.astype(np.int32)
            s = (xs * p["w_scale"].astype(np.float32)).astype(np.float32)
            y = (acc.astype(np.float32) * s).astype(np.float32)
        else:
            y = (out @ p["w"].astype(np.float32)).astype(np.float32)
        if p.get("b") is not None:
            y = (y + p["b"].astype(np.float32)).astype(np.float32)
        out = _np_act(act, y)
    return out


def emulate_stream(export: STExport, readings: np.ndarray, *, stride: int,
                   fb: Optional[STFunctionBlock] = None,
                   ) -> Dict[str, np.ndarray]:
    """Replay one stream's raw ``(n_cycles, F)`` readings, or several
    streams' ``(n_cycles, S, F)``, through the emulated block: every
    completed window in one batched FB pass.

    Returns the block's VAR_OUTPUTs batched over windows, stream-major
    (each stream's windows in cycle order), plus ``"cycle"`` (the engine
    cycle each window completed at — `Verdict.cycle`).  The export must have
    ingest normalization baked in if the engine the result is compared
    against normalizes (it does) — pass raw readings either way.
    """
    readings = np.asarray(readings, np.float32)
    per_stream = readings[:, None] if readings.ndim == 2 else readings
    n_cycles, n_streams, _ = per_stream.shape
    wins = np.concatenate([stream_windows(per_stream[:, s], export.window,
                                          stride) for s in range(n_streams)])
    cycles = window_starts(n_cycles, export.window, stride)
    if fb is None:
        fb = STFunctionBlock(export.text)
    out = fb.call({"X": wins}) if len(wins) else {
        d.name: np.zeros((0,) if d.lo is None else (0, d.size))
        for d in fb.outputs}
    out["cycle"] = np.tile(np.asarray(cycles, np.int64), n_streams)
    return out


def _serve(model, params, readings: np.ndarray, *, stride: int, head,
           backend: str, device: Device):
    """:func:`run_engine`'s verdicts, and each verdict step's host outputs
    (``StreamEngine.last_logits``: the model's outputs under a classifier
    head, the scores under a score head) keyed by the step's cycle."""
    from repro_torch.serving.streams import StreamEngine

    readings = np.asarray(readings, np.float32)
    n_cycles, n_streams, n_features = readings.shape
    engine = StreamEngine(model, params, n_streams=n_streams,
                          n_features=n_features, stride=stride, head=head,
                          backend=backend, device=device)
    verdicts, outputs = [], {}
    for t in range(n_cycles):
        step = engine.ingest(readings[t])
        if step:
            verdicts.extend(step)
            outputs[step[0].cycle] = np.array(engine.last_logits)
    return verdicts, outputs


def run_engine(model, params, readings: np.ndarray, *, stride: int,
               head=None, backend: str = "auto",
               device: Device = "cuda") -> list:
    """Drive the port's `StreamEngine` over ``(n_cycles, S, F)`` raw fleet
    readings cycle by cycle (synchronous — the bit-reference serving
    configuration) on ``device``, where ``params`` must live, and return
    every `Verdict` in emission order."""
    return _serve(model, params, readings, stride=stride, head=head,
                  backend=backend, device=device)[0]


def verify_export(export: STExport, model, params, head, raw: np.ndarray,
                  stride: int, *, streams: Optional[Sequence[int]] = None,
                  device: Device = "cuda") -> dict:
    """Serve ``(n_cycles, S, F)`` raw fleet readings through the port's
    `StreamEngine` on ``device`` and replay every window of ``streams``
    (default: all) through the emulated block; return the counts of
    ``examples/export_st.py::verify_export`` (``failures`` must be 0) and
    the emulator's seconds.

    The contract: the emulated block's SINT model outputs bit-equal to
    :func:`numpy_mlp_ref`, ``CONF`` bit-equal to the host softmax of those
    logits and ``SCORE`` to :func:`sequential_f32_mse` of them; against the
    engine, ``PRED`` and ``THRESHOLD`` exactly and ``CONF``/``SCORE`` within
    1e-4 relative.  Under a classifier head the engine's own step outputs
    (its logits: on the card, ``fused_mlp``'s) are held to the oracle too,
    bit-equal under SINT (``max_engine_diff``; None under a score head,
    whose engine step returns only the score).  REAL: everything to
    epsilon, and a verdict may differ only when the score sits within
    epsilon of the threshold (``borderline``).  The block must have the
    engines' ingest normalization baked in (``normalize=``); the oracle
    normalizes with the same constants.
    """
    if export.normalize is None:
        raise ValueError("verify_export needs an export with the engines' "
                         "ingest normalization baked in (normalize=)")
    raw = np.asarray(raw, np.float32)
    n_cycles, n_streams, _ = raw.shape
    streams = list(range(n_streams)) if streams is None else sorted(streams)
    sint = export.scheme == "SINT"
    classifier = export.head_name == "classifier"
    engine_verdicts, engine_outputs = _serve(
        model, params, raw, stride=stride, head=head, backend="auto",
        device=device)
    cycles = np.asarray(window_starts(n_cycles, export.window, stride),
                        np.int64)
    per = len(cycles)
    t0 = time.perf_counter()
    out = emulate_stream(export, raw[:, streams], stride=stride)
    emulator_s = time.perf_counter() - t0
    norm_wins = normalize_windows(
        np.concatenate([stream_windows(raw[:, s], export.window, stride)
                        for s in streams]), *export.normalize)
    oracle = numpy_mlp_ref(norm_wins, dense_stack(model, params))
    # Elementwise f32 steps, so one pass over all rows is the per-row oracle.
    seq_scores = (sequential_f32_mse(oracle, norm_wins)
                  if sint and not classifier else None)
    row = {s: i * per for i, s in enumerate(streams)}

    failures = borderline = n = 0
    max_body = 0.0
    max_engine = 0.0 if classifier else None
    for v in engine_verdicts:
        if v.stream not in row:
            continue
        idx = int(np.searchsorted(cycles, v.cycle))
        if idx >= per or cycles[idx] != v.cycle:
            raise AssertionError(f"engine verdict at cycle {v.cycle} has no "
                                 "window in the replay schedule")
        r = row[v.stream] + idx
        n += 1
        y = oracle[r]
        tol = 0.0 if sint else 1e-5 * (1.0 + float(np.abs(y).max()))
        ydiff = float(np.abs(np.float32(out["Y"][r]) - y).max())
        max_body = max(max_body, ydiff)
        if not ydiff <= tol:           # a NaN fails too
            failures += 1
            continue
        if classifier:
            ediff = float(np.abs(engine_outputs[v.cycle][v.stream] - y).max())
            max_engine = max(max_engine, ediff)
            if not ediff <= tol:
                failures += 1
                continue
            oracle_conf = np.float32(softmax_np(y[None])[0, int(np.argmax(y))])
            conf = np.float32(out["CONF"][r])
            if int(out["PRED"][r]) != v.pred:
                failures += 1
            elif sint and conf != oracle_conf:
                failures += 1          # bit contract vs the oracle logits
            elif not np.isclose(float(conf), v.prob, rtol=1e-4):
                failures += 1          # epsilon vs the engine's softmax
        else:
            sc = float(out["SCORE"][r])
            thr_ok = float(np.float32(out["THRESHOLD"][r])) == np.float32(
                v.threshold)
            if not thr_ok or not np.isclose(sc, v.score, rtol=1e-4):
                failures += 1
                continue
            if sint and np.float32(sc) != seq_scores[r]:
                failures += 1
                continue
            if int(out["PRED"][r]) != v.pred:
                if sint or abs(sc - v.threshold) > 1e-5 * v.threshold:
                    failures += 1
                else:
                    borderline += 1
    return {"windows": n, "failures": failures, "borderline": borderline,
            "max_body_diff": max_body, "max_engine_diff": max_engine,
            "anomalous": sum(v.pred != 0 for v in engine_verdicts),
            "engine_windows": len(engine_verdicts),
            "emulator_s": emulator_s}
