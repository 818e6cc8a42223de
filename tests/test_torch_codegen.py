"""The port's IEC 61131-3 Structured Text export against the JAX package's,
on the CPU.

* The emitted ``FUNCTION_BLOCK`` text is byte-equal to the reference's
  export of the same weights (bridged through numpy) but for the module its
  header comment names as its author, for the full-width
  SINT classifier, the SINT and REAL autoencoders, the margin and forecast
  heads, bare bodies and baked-in ingest normalization.
* The port's export, run through the port's copy of the emulator, is
  bit-equal to ``numpy_mlp_ref`` under SINT and within 1e-5 under REAL.
* Everything the reference refuses, the port refuses with
  ``STExportError``.
* End to end: a narrow detector serves the scenario plants through the
  port's ``StreamEngine`` on the CPU while the emulated block replays every
  window (``codegen.verify.verify_export``): 0 failures, 0 borderline
  windows, body difference 0.0 under SINT, and the engine's own classifier
  logits bit-equal to the oracle.  Verdict diversity is not
  asserted for the SINT classifier: random weights need not flag anything.
"""

import numpy as np
import pytest
import torch

from repro.codegen import export_st as jexport_st
from repro.sim.heads import ClassifierHead as JClassifierHead
from repro.sim.heads import ForecastHead as JForecastHead
from repro.sim.heads import MarginHead as JMarginHead
from repro.sim.heads import ReconstructionHead as JReconstructionHead
from repro.core import sequential as jsequential
from repro.core import layers as JL
from repro.sim import build_autoencoder as jbuild_autoencoder
from repro.sim import build_detector as jbuild_detector
from repro_torch.bridge import params_to_numpy
from repro.codegen import emulate_stream as jemulate_stream
from repro.codegen import normalize_windows as jnormalize_windows
from repro_torch.codegen import (STExportError, STFunctionBlock,
                                 emulate_stream, export_st, normalize_windows,
                                 numpy_mlp_ref, sequential_f32_mse,
                                 stream_windows, verify_export, window_starts)
from repro_torch.configs import msf_detector as spec
from repro_torch.core import layers as TL
from repro_torch.core import quantize as tquant
from repro_torch.core import sequential as tsequential
from repro_torch.kernels import ops
from repro_torch.sim import (ClassifierHead, ForecastHead, MarginHead,
                             ReconstructionHead, build_autoencoder,
                             build_detector, fleet_readings)

from _hyp import given, settings, st

torch.set_num_threads(1)

NORMALIZE = (spec.NORM_MEAN, spec.NORM_STD)
EXPORT_FIELDS = ("name", "scheme", "head_name", "verdict_outputs",
                 "window", "window_width", "in_width", "n_outputs",
                 "n_features", "threshold", "normalize")
# Each package's block names its own exporter in its first comment.
AUTHOR = ("auto-generated by repro.codegen.st ",
          "auto-generated by repro_torch.codegen.st ")


def jittered(params, seed, scale=0.1):
    """Nonzero biases and perturbed weights, in place."""
    rng = np.random.default_rng(seed)
    for p in params.values():
        for k, v in p.items():
            v += scale * torch.from_numpy(
                rng.standard_normal(tuple(v.shape)).astype(np.float32))
    return params


def sint(model, params, x, k=16):
    return tquant.quantize_params(
        model, params, "SINT",
        calibration=tquant.calibration_samples(x, k=k, device="cpu"))


def assert_same_export(tmodel, tparams, jmodel, thead=None, jhead=None,
                       **kw):
    """The port's export of the params equals the reference's export of the
    same params as numpy arrays, field for field, and byte for byte but for
    the exporter's module name in the header comment."""
    got = export_st(tmodel, tparams, head=thead, **kw)
    want = jexport_st(jmodel, params_to_numpy(tparams), head=jhead, **kw)
    assert want.text.count(AUTHOR[0]) == 1
    assert got.text == want.text.replace(*AUTHOR)
    for f in EXPORT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    return got


def windows(n, width, seed=2026):
    return np.random.default_rng(seed).standard_normal(
        (n, width)).astype(np.float32)


# ---------------------------------------------------------------------------
# Byte-equal text


def test_sint_classifier_export_byte_equal():
    model = build_detector()
    params = sint(model, jittered(model.init_params(
        torch.Generator().manual_seed(0), device="cpu"), 0),
        windows(64, spec.INPUT_SIZE))
    export = assert_same_export(model, params, jbuild_detector(),
                                ClassifierHead(), JClassifierHead(),
                                name="GOLDEN_CLASSIFIER", normalize=NORMALIZE)
    assert export.scheme == "SINT" and export.window == spec.WINDOW
    assert export.verdict_outputs == ("PRED", "CONF")


def autoencoder(scheme, seed=1):
    model = build_autoencoder()
    params = jittered(model.init_params(torch.Generator().manual_seed(seed),
                                        device="cpu"), seed, 0.02)
    calib = windows(64, spec.INPUT_SIZE)
    if scheme == "SINT":
        params = sint(model, params, calib)
    recon = model.apply(params, torch.from_numpy(calib))
    scores = torch.mean(torch.square(recon - torch.from_numpy(calib)),
                        dim=-1).numpy()
    head = ReconstructionHead().calibrate(scores, spec.AE_TARGET_FPR)
    return model, params, head


@pytest.mark.parametrize("scheme", ["SINT", "REAL"])
def test_autoencoder_export_byte_equal(scheme):
    model, params, head = autoencoder(scheme)
    jhead = JReconstructionHead(threshold=head.threshold,
                                target_fpr=head.target_fpr)
    export = assert_same_export(model, params, jbuild_autoencoder(), head,
                                jhead, name=f"AE_{scheme}",
                                normalize=NORMALIZE)
    assert export.scheme == scheme
    assert export.threshold == float(np.float32(head.threshold))


def small_pair(widths, acts, in_width):
    return (tsequential([TL.Dense(units=w, activation=a)
                         for w, a in zip(widths, acts)], (in_width,)),
            jsequential([JL.Dense(units=w, activation=a)
                         for w, a in zip(widths, acts)], (in_width,)))


def test_margin_head_export_byte_equal_and_scores():
    tm, jm = small_pair((6, 4), ("relu", "linear"), 8)
    params = jittered(tm.init_params(torch.Generator().manual_seed(5),
                                     device="cpu"), 5)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((9, 8)).astype(np.float32)
    center = tuple(float(c) for c in rng.standard_normal(4))
    y = numpy_mlp_ref(x, ops.dense_stack(tm, params))
    scores = np.mean(np.square(y - np.asarray(center, np.float32)), axis=-1)
    thr = float(np.sort(scores)[3:5].mean())
    export = assert_same_export(
        tm, params, jm, MarginHead(center=center, threshold=thr),
        JMarginHead(center=center, threshold=thr), n_features=1,
        name="MARGIN")
    out = STFunctionBlock(export.text).call({"X": x})
    assert np.allclose(out["SCORE"], scores, rtol=1e-4)
    # The block's score is the sequential f32 sum over its own outputs.
    np.testing.assert_array_equal(
        out["SCORE"].astype(np.float32),
        sequential_f32_mse(out["Y"], np.broadcast_to(
            np.asarray(center, np.float32), y.shape)))
    assert np.array_equal(out["PRED"], (out["SCORE"].astype(np.float32)
                                        > np.float32(thr)).astype(
                                            out["PRED"].dtype))
    assert 0 < int(out["PRED"].sum()) < len(scores)


def test_forecast_head_export_byte_equal_and_ring_asymmetry():
    tm, jm = small_pair((6, 2), ("relu", "linear"), 8)
    params = jittered(tm.init_params(torch.Generator().manual_seed(6),
                                     device="cpu"), 6)
    export = assert_same_export(tm, params, jm, ForecastHead(threshold=0.5),
                                JForecastHead(threshold=0.5), n_features=2,
                                name="FORECAST")
    assert export.window == 5 and export.window_width == 10
    x = np.random.default_rng(12).standard_normal((7, 10)).astype(np.float32)
    out = STFunctionBlock(export.text).call({"X": x})
    y = numpy_mlp_ref(x[:, :8], ops.dense_stack(tm, params))
    assert np.allclose(out["SCORE"], np.mean(np.square(y - x[:, 8:]),
                                             axis=-1), rtol=1e-4)


@pytest.mark.parametrize("scheme", ["SINT", "REAL"])
def test_bare_body_and_normalize_byte_equal(scheme):
    tm, jm = small_pair((5, 3), ("relu", "linear"), 6)
    params = jittered(tm.init_params(torch.Generator().manual_seed(7),
                                     device="cpu"), 7)
    x = windows(8, 6, seed=3)
    if scheme == "SINT":
        params = sint(tm, params, x, k=4)
    for kw in ({"n_features": 1}, {"n_features": 2},
               {"n_features": 2, "normalize": ((0.5, -1.0), (2.0, 0.25))}):
        export = assert_same_export(tm, params, jm, name="BODY", **kw)
        assert export.verdict_outputs == ()
    out = STFunctionBlock(export.text).call({"X": x})
    nx = ((x.reshape(8, 3, 2) - np.float32([0.5, -1.0]))
          / np.float32([2.0, 0.25])).reshape(8, 6).astype(np.float32)
    want = numpy_mlp_ref(nx, ops.dense_stack(tm, params))
    if scheme == "SINT":
        np.testing.assert_array_equal(out["Y"].astype(np.float32), want)
    else:
        np.testing.assert_allclose(out["Y"], want, rtol=1e-5, atol=1e-5)


def test_export_reads_parameters_once_in_their_dtype():
    # bfloat16 REAL leaves go through f32, as the bridge carries them.
    tm, jm = small_pair((3,), ("linear",), 4)
    params = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    as_bf16 = {u: {k: v.to(torch.bfloat16) for k, v in p.items()}
               for u, p in params.items()}
    want = {u: {k: v.to(torch.bfloat16).to(torch.float32)
                for k, v in p.items()} for u, p in params.items()}
    assert export_st(tm, as_bf16, n_features=1).text == \
        export_st(tm, want, n_features=1).text


# ---------------------------------------------------------------------------
# Emulated port exports against the numpy oracle


def random_stack(widths, seed, scheme, acts_pool):
    rng = np.random.default_rng(seed)
    in_width = int(rng.integers(1, 13))
    acts = [str(rng.choice(acts_pool)) for _ in widths]
    tm, jm = small_pair(widths, acts, in_width)
    params = jittered(tm.init_params(torch.Generator().manual_seed(seed),
                                     device="cpu"), seed + 1)
    x = rng.standard_normal((5, in_width)).astype(np.float32) * 2.0
    if scheme == "SINT":
        params = sint(tm, params, x, k=4)
    return tm, jm, params, x


@settings(max_examples=20, deadline=None)
@given(widths=st.lists(st.integers(1, 12), min_size=1, max_size=4),
       seed=st.integers(0, 10_000))
def test_fuzz_sint_export_bit_matches_oracle(widths, seed):
    tm, jm, params, x = random_stack(widths, seed, "SINT", ("relu", "linear"))
    export = assert_same_export(tm, params, jm, n_features=1, name="FUZZ")
    out = STFunctionBlock(export.text).call({"X": x})["Y"]
    want = numpy_mlp_ref(x, ops.dense_stack(tm, params))
    np.testing.assert_array_equal(out.astype(np.float32), want)
    # The port's own SINT forward is the same arithmetic.
    np.testing.assert_array_equal(
        tm.apply(params, torch.from_numpy(x)).numpy(), want)


@settings(max_examples=20, deadline=None)
@given(widths=st.lists(st.integers(1, 12), min_size=1, max_size=4),
       seed=st.integers(0, 10_000))
def test_fuzz_real_export_epsilon_matches_oracle(widths, seed):
    tm, jm, params, x = random_stack(widths, seed, "REAL",
                                     ("relu", "linear", "sigmoid", "tanh"))
    export = assert_same_export(tm, params, jm, n_features=1, name="FUZZ")
    out = STFunctionBlock(export.text).call({"X": x})["Y"].astype(np.float32)
    want = numpy_mlp_ref(x, ops.dense_stack(tm, params))
    assert np.abs(out - want).max() <= 1e-5 * (1.0 + np.abs(want).max())


# ---------------------------------------------------------------------------
# Rejections (the reference's, tests/test_st_export.py)


def test_export_rejects_non_dense_graph():
    model = tsequential([TL.Flatten(), TL.Dense(units=2)], (4,))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(STExportError, match="all-Dense"):
        export_st(model, params, n_features=1)


def test_export_rejects_unsupported_activation():
    model = tsequential([TL.Dense(units=2, activation="softmax")], (4,))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(STExportError, match="not exportable"):
        export_st(model, params, n_features=1)


@pytest.mark.parametrize("scheme", ["INT", "DINT"])
def test_export_rejects_f32_emulated_int_schemes(scheme):
    model = tsequential([TL.Dense(units=3, activation="relu")], (4,))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    qparams = tquant.quantize_params(model, params, scheme)
    with pytest.raises(STExportError, match="quantized"):
        export_st(model, qparams, n_features=1)


def test_export_rejects_uncalibrated_score_head():
    model = tsequential([TL.Dense(units=4, activation="linear")], (4,))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(STExportError, match="threshold"):
        export_st(model, params, head=ReconstructionHead(), n_features=1)


def test_export_rejects_ragged_input_for_feature_count():
    model = tsequential([TL.Dense(units=2)], (5,))
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(STExportError, match="whole number"):
        export_st(model, params, n_features=2)


# ---------------------------------------------------------------------------
# End to end on the CPU: the port's engine against the emulated block


SCENARIO_NAMES = ["baseline", "tb0-spoof", "drift-then-spoof", "steam-pulse"]
E2E_CYCLES = 460
NARROW_WINDOW = 20        # readings: a 40-input body


def narrow_model(kind, L=TL, sequential=tsequential):
    width = NARROW_WINDOW * spec.N_FEATURES
    out = spec.CLASSES if kind == "mlp" else width
    return sequential([L.Input(), L.Dense(units=8, activation="relu"),
                       L.Dense(units=out, activation="linear")], (width,))


def narrow_model_ref(kind):
    return narrow_model(kind, JL, jsequential)


@pytest.fixture(scope="module")
def e2e():
    n = len(SCENARIO_NAMES)
    raw = fleet_readings(n, E2E_CYCLES, names=SCENARIO_NAMES, seed=7)
    # Benign calibration windows from the same plants over a disjoint later
    # range (the reference example's held-out traces).
    horizon = E2E_CYCLES + 60 + NARROW_WINDOW + 8 * spec.STRIDE
    later = fleet_readings(n, horizon, names=["baseline"] * n, seed=7)
    norm = ((later - np.asarray(spec.NORM_MEAN, np.float32))
            / np.asarray(spec.NORM_STD, np.float32))[E2E_CYCLES + 60:]
    calib = np.concatenate([stream_windows(norm[:, s, :], NARROW_WINDOW,
                                           spec.STRIDE) for s in range(n)])
    return raw, calib.astype(np.float32)


def e2e_detector(kind, scheme, calib):
    model = narrow_model(kind)
    params = model.init_params(torch.Generator().manual_seed(
        0 if kind == "mlp" else 1), device="cpu")
    if scheme == "SINT":
        params = sint(model, params, calib)
    if kind == "mlp":
        return model, params, ClassifierHead()
    recon = model.apply(params, torch.from_numpy(calib))
    scores = torch.mean(torch.square(recon - torch.from_numpy(calib)),
                        dim=-1).numpy()
    return model, params, ReconstructionHead().calibrate(
        scores, spec.AE_TARGET_FPR)


@pytest.mark.parametrize("kind,scheme", [("mlp", "SINT"), ("ae", "SINT"),
                                         ("ae", "REAL")])
def test_e2e_scenario_verdict_parity(kind, scheme, e2e):
    raw, calib = e2e
    model, params, head = e2e_detector(kind, scheme, calib)
    export = export_st(model, params, head=head,
                       name=f"E2E_{kind.upper()}_{scheme}",
                       normalize=NORMALIZE)
    res = verify_export(export, model, params, head, raw, spec.STRIDE,
                        device="cpu")
    n_wins = len(SCENARIO_NAMES) * len(
        window_starts(E2E_CYCLES, NARROW_WINDOW, spec.STRIDE))
    assert res["windows"] == res["engine_windows"] == n_wins
    assert res["failures"] == 0
    if scheme == "SINT":
        assert res["borderline"] == 0
        assert res["max_body_diff"] == 0.0          # bit-exact model outputs
    if kind == "mlp":
        assert res["max_engine_diff"] == 0.0        # the engine's own logits
    else:
        assert res["max_engine_diff"] is None       # the step returns scores
    if kind == "ae":
        # The calibrated threshold flags some windows, not all of them.
        assert 0 < res["anomalous"] < res["windows"]


def test_verify_export_replays_a_sample_of_plants(e2e):
    raw, calib = e2e
    model, params, head = e2e_detector("mlp", "SINT", calib)
    export = export_st(model, params, head=head, normalize=NORMALIZE)
    res = verify_export(export, model, params, head, raw, spec.STRIDE,
                        streams=[3, 1], device="cpu")
    per_stream = len(window_starts(E2E_CYCLES, NARROW_WINDOW, spec.STRIDE))
    assert res["windows"] == 2 * per_stream
    assert res["engine_windows"] == len(SCENARIO_NAMES) * per_stream
    assert res["failures"] == 0 and res["max_body_diff"] == 0.0
    assert res["max_engine_diff"] == 0.0


def test_verify_export_needs_baked_normalization(e2e):
    raw, calib = e2e
    model, params, head = e2e_detector("mlp", "SINT", calib)
    export = export_st(model, params, head=head)
    with pytest.raises(ValueError, match="normalize"):
        verify_export(export, model, params, head, raw, spec.STRIDE,
                      device="cpu")


def test_emulate_stream_matches_reference(e2e):
    """The port's replay of one stream equals the reference's, and a batch
    of streams is their single-stream replays stacked stream-major."""
    raw, calib = e2e
    model, params, head = e2e_detector("ae", "SINT", calib)
    export = export_st(model, params, head=head, normalize=NORMALIZE)
    jexport = jexport_st(narrow_model_ref("ae"), params_to_numpy(params),
                         head=JReconstructionHead(threshold=head.threshold),
                         normalize=NORMALIZE)
    singles = []
    for s in range(raw.shape[1]):
        got = emulate_stream(export, raw[:, s], stride=spec.STRIDE)
        want = jemulate_stream(jexport, raw[:, s], stride=spec.STRIDE)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        singles.append(got)
    both = emulate_stream(export, raw[:, [2, 0]], stride=spec.STRIDE)
    for k in both:
        np.testing.assert_array_equal(
            both[k], np.concatenate([singles[2][k], singles[0][k]]))
    wins = stream_windows(raw[:, 1], NARROW_WINDOW, spec.STRIDE)
    np.testing.assert_array_equal(normalize_windows(wins, *NORMALIZE),
                                  jnormalize_windows(wins, *NORMALIZE))
