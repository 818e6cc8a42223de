"""The port's fleet StreamEngine against the JAX reference engine, on the CPU.

Both engines ingest the same raw scenario readings, cycle by cycle, over
runs long enough for the ring to wrap several times.  Verdict labels must
match exactly.  Outputs are compared to a tolerance: the reference engine's
step is jitted, and XLA contracts its requantize mul+add into an FMA (one
ulp, ``codegen/verify.numpy_mlp_ref``'s docstring), while the port's SINT
outputs are held bit-exact to that numpy oracle.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.codegen.verify import (normalize_windows, numpy_mlp_ref,
                                  run_engine, stream_windows)
from repro.core import layers as JL
from repro.core import sequential as jsequential
from repro.kernels import ops as jops
from repro.serving import StreamEngine as JStreamEngine
from repro.sim import ReconstructionHead as JReconstructionHead
from repro.sim import fleet_readings
from repro_torch.configs import msf_detector as spec
from repro_torch.core import layers as TL
from repro_torch.core import sequential as tsequential
from repro_torch.serving import StreamEngine
from repro_torch.sim.heads import ReconstructionHead
from test_torch_core import model_pair, small_pair, to_torch

torch.set_num_threads(1)

# Outputs of the jitted reference engine vs the port (see module docstring).
# A live threshold is an order statistic of such scores, so it inherits the
# same last-bit differences.
OUT_TOL = dict(rtol=1e-5, atol=1e-6)


def serve(engine, readings, flush=False):
    verdicts = []
    for c in range(readings.shape[0]):
        verdicts.extend(engine.ingest(readings[c]))
    if flush:
        verdicts.extend(engine.flush())
    return verdicts


def verdict_key(v):
    """Everything a verdict says except its timing."""
    return (v.stream, v.cycle, v.pred, v.prob, v.score, v.threshold, v.group)


def assert_parity(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.stream, g.cycle, g.pred, g.group) == \
            (w.stream, w.cycle, w.pred, w.group)
        for field in ("prob", "score", "threshold"):
            a, b = getattr(g, field), getattr(w, field)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, **OUT_TOL)


@pytest.mark.parametrize("scheme", ("REAL", "SINT"))
def test_classifier_verdicts_match_reference_engine(scheme):
    # 8-reading window (16 inputs), stride 3, 40 cycles: 11 steps, and the
    # ring write position wraps four times.
    jm, jp, tm, tp = small_pair([12, 8, 2], ["relu", "relu", "linear"], 16,
                                scheme, seed=2)
    readings = fleet_readings(3, 40, seed=5)
    want = run_engine(jm, jp, readings, stride=3)
    engine = StreamEngine(tm, tp, n_streams=3, stride=3, device="cpu")
    assert_parity(serve(engine, readings), want)
    assert engine.stats.steps == 11


def test_reconstruction_verdicts_match_reference_engine():
    jm, jp, tm, tp = small_pair([8, 16], ["relu", "linear"], 16, "SINT",
                                seed=4)
    readings = fleet_readings(3, 40, seed=5)
    probe = run_engine(jm, jp, readings, stride=3,
                       head=JReconstructionHead(threshold=np.inf))
    thr = float(np.median([v.score for v in probe]))
    want = run_engine(jm, jp, readings, stride=3,
                      head=JReconstructionHead(threshold=thr))
    engine = StreamEngine(tm, tp, n_streams=3, stride=3, device="cpu",
                          head=ReconstructionHead(threshold=thr))
    got = serve(engine, readings)
    assert_parity(got, want)
    assert 0 < sum(v.pred for v in got) < len(got)     # both sides of thr
    assert engine.last_logits.shape == (3, 1)


def test_sint_detector_outputs_bit_exact_vs_numpy_oracle():
    """The full-size §7 classifier over a wrapping 200-reading ring: every
    step's outputs equal numpy_mlp_ref on the normalized stream windows."""
    jm, jp, tm, tp = model_pair("detector", "SINT", seed=1)
    n_streams, n_cycles = 3, 231
    readings = fleet_readings(n_streams, n_cycles, seed=3)
    engine = StreamEngine(tm, tp, n_streams=n_streams, device="cpu")
    steps = []
    for c in range(n_cycles):
        if engine.ingest(readings[c]):
            steps.append(engine.last_logits.copy())
    assert len(steps) == 4
    stack = jops.dense_stack(jm, jp)
    for s in range(n_streams):
        wins = normalize_windows(
            stream_windows(readings[:, s], spec.WINDOW, spec.STRIDE),
            spec.NORM_MEAN, spec.NORM_STD)
        want = numpy_mlp_ref(wins, stack)
        np.testing.assert_array_equal(np.stack([o[s] for o in steps]), want)


@pytest.mark.parametrize("scheme", ("REAL", "SINT"))
def test_fused_and_per_layer_steps_agree(scheme):
    _, _, tm, tp = small_pair([12, 8, 2], ["relu", "relu", "linear"], 16,
                              scheme, seed=6)
    readings = fleet_readings(4, 30, seed=1)
    outs = {}
    for fused in (True, False):
        engine = StreamEngine(tm, tp, n_streams=4, stride=2, device="cpu",
                              fused=fused)
        verdicts = serve(engine, readings)
        outs[fused] = ([verdict_key(v) for v in verdicts],
                       engine.last_logits, engine.stats)
    assert outs[True][0] == outs[False][0]
    np.testing.assert_array_equal(outs[True][1], outs[False][1])
    fused_stats, layer_stats = outs[True][2], outs[False][2]
    assert fused_stats.dispatches == fused_stats.steps == 12
    assert layer_stats.dispatches == 3 * layer_stats.steps


def test_async_depth_1_bit_identical_one_boundary_late():
    _, _, tm, tp = small_pair([12, 8, 2], ["relu", "relu", "linear"], 16,
                              "SINT", seed=2)
    readings = fleet_readings(3, 26, seed=4)     # ready at cycles 7, 10, ..
    kw = dict(n_streams=3, stride=3, device="cpu")
    sync = StreamEngine(tm, tp, **kw)
    asy = StreamEngine(tm, tp, async_depth=1, **kw)
    boundaries = {}
    sync_verdicts, async_verdicts = [], []
    for c in range(readings.shape[0]):
        sync_verdicts.extend(sync.ingest(readings[c]))
        got = asy.ingest(readings[c])
        if got:
            boundaries[c] = sorted({v.cycle for v in got})
        async_verdicts.extend(got)
    assert boundaries == {10: [7], 13: [10], 16: [13], 19: [16], 22: [19],
                          25: [22]}
    assert asy.stats.steps == 7 and asy.stats.windows == 6 * 3
    async_verdicts.extend(asy.flush())
    assert asy.flush() == []
    assert [verdict_key(v) for v in async_verdicts] == \
        [verdict_key(v) for v in sync_verdicts]
    np.testing.assert_array_equal(asy.last_logits, sync.last_logits)
    assert sync.flush() == []


def energy_pair(window, n_features):
    """Zero-weight single-Dense 'autoencoder': its score is the window's
    mean square, so the live threshold tracks the readings' energy."""
    size = window * n_features
    jm = jsequential([JL.Input(), JL.Dense(units=size, activation="linear")],
                     (size,))
    tm = tsequential([TL.Input(), TL.Dense(units=size, activation="linear")],
                     (size,))
    jp = jax.tree_util.tree_map(jnp.zeros_like,
                                jm.init_params(jax.random.PRNGKey(0)))
    return jm, jp, tm, to_torch(jp)


def test_adaptive_threshold_tracks_reference():
    window, stride, n = 5, 2, 3
    jm, jp, tm, tp = energy_pair(window, 1)
    rng = np.random.default_rng(8)
    # Benign energy creeping upward, with one attacked stream late on.
    readings = (rng.normal(size=(60, n, 1))
                * np.linspace(1.0, 2.0, 60)[:, None, None]).astype(np.float32)
    readings[45:, 1] += 8.0
    kw = dict(n_streams=n, n_features=1, window=window, stride=stride,
              norm_mean=(0.0,), norm_std=(1.0,), adapt=True)
    head = dict(threshold=0.7, target_fpr=0.1)
    ref = JStreamEngine(jm, jp, head=JReconstructionHead(**head), shard=False,
                        **kw)
    port = StreamEngine(tm, tp, head=ReconstructionHead(**head),
                        device="cpu", **kw)
    trajectory = []
    for c in range(readings.shape[0]):
        want = ref.ingest(readings[c])
        got = port.ingest(readings[c])
        assert len(got) == len(want)
        if want:
            assert_parity(got, want)
        trajectory.append((port.live_threshold, ref.live_threshold))
    got, want = np.array(trajectory).T
    assert len(set(got)) > 3                     # the threshold did adapt
    np.testing.assert_allclose(got, want, **OUT_TOL)


def test_engine_contract_errors():
    _, _, tm, tp = small_pair([8, 2], ["relu", "softmax"], 16, "REAL", 0)
    with pytest.raises(ValueError, match="cannot fuse"):
        StreamEngine(tm, tp, n_streams=2, device="cpu", fused=True)
    # An unfusable stack still serves per layer.
    assert StreamEngine(tm, tp, n_streams=2, device="cpu").fused is False
    with pytest.raises(ValueError, match="needs a 'data' axis"):
        StreamEngine(tm, tp, n_streams=2, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="shard=False contradicts"):
        StreamEngine(tm, tp, n_streams=2, device="cpu", shard=False,
                     mesh=object())
    with pytest.raises(ValueError, match="async_depth"):
        StreamEngine(tm, tp, n_streams=2, device="cpu", async_depth=2)
    with pytest.raises(ValueError, match="output width"):
        StreamEngine(tm, tp, n_streams=2, device="cpu",
                     head=ReconstructionHead(threshold=1.0))
    engine = StreamEngine(tm, tp, n_streams=2, device="cpu")
    with pytest.raises(ValueError, match="readings"):
        engine.ingest(np.zeros((3, 2), np.float32))
