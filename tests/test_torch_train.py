"""The port's §7 detector training against the JAX reference, on the CPU.

Each head's objective (``loss``, ``metric``, ``scores``) on the same numpy
outputs, and each of the four trainers on the same data at the §7 widths.
The reference starts from the port's init, bridged through numpy by patching
``repro.core.model.Model.init_params`` in the test; the minibatch order
(``np.random.default_rng(seed)``) and the Adam arithmetic are the same on
both sides, so the runs differ only in the summation order of f32
products.  Tolerances: per-epoch train losses and validation metrics within
1e-5 relative (accuracy equal), the returned params within 1e-5 of the
largest weight, thresholds within 1e-5 relative; accuracies, calibrated
FPRs, detection rates and the held-out calibration windows equal.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.model import Model as JModel
from repro.sim import detector as jdetector
from repro.sim import heads as jheads
from repro_torch.bridge import params_to_numpy
from repro_torch.sim import detector as tdetector
from repro_torch.sim import heads as theads
from repro_torch.sim import build_dataset

torch.set_num_threads(1)

RTOL = 1e-5
EPOCHS = 3
# The classifier trains on all 632 training windows in batches of 128; a
# score head only on the 350 benign ones, which need batches of at most
# 350 // 3 (the trainers' train/val/calibrate floor): 64.
BATCH = {"detector": 128, "autoencoder": 64, "one_class": 64,
         "forecaster": 64}

TRAINERS = {
    "detector": (tdetector.train_detector, jdetector.train_detector,
                 tdetector.build_detector),
    "autoencoder": (tdetector.train_autoencoder, jdetector.train_autoencoder,
                    tdetector.build_autoencoder),
    "one_class": (tdetector.train_one_class, jdetector.train_one_class,
                  tdetector.build_margin_model),
    "forecaster": (tdetector.train_forecaster, jdetector.train_forecaster,
                   tdetector.build_forecaster),
}


@pytest.fixture(scope="module")
def data():
    """875 labeled windows at the §7 window width, 350 of them benign."""
    return build_dataset(normal_cycles=3000, attack_cycles=800, stride=8,
                         seed=0)


def run_both(kind, data, monkeypatch, *, seed=0, lr=1e-3, epochs=EPOCHS):
    """(port result, reference result) of one trainer from the port's
    init, bridged into the reference."""
    port_train, ref_train, builder = TRAINERS[kind]
    x, y = data
    init = params_to_numpy(builder().init_params(
        torch.Generator().manual_seed(seed), device="cpu"))
    bridged = jax.tree.map(jnp.asarray, init)
    monkeypatch.setattr(JModel, "init_params", lambda self, key: bridged)
    kw = dict(epochs=epochs, batch_size=BATCH[kind], lr=lr, seed=seed)
    _, got = port_train(x, y, device="cpu", **kw)
    _, want = ref_train(x, y, **kw)
    return got, want


def assert_histories_close(got, want, *, accuracy):
    assert [e for e, _, _ in got] == [e for e, _, _ in want]
    np.testing.assert_allclose([l for _, l, _ in got],
                               [l for _, l, _ in want], rtol=RTOL)
    got_val, want_val = [v for _, _, v in got], [v for _, _, v in want]
    if accuracy:
        assert got_val == want_val
    else:
        np.testing.assert_allclose(got_val, want_val, rtol=RTOL)


def assert_params_close(got, want):
    got = params_to_numpy(got)
    want = jax.tree.map(np.asarray, want)
    assert got.keys() == want.keys()
    largest = max(float(np.abs(v).max()) for p in want.values()
                  for v in p.values())
    for uid in want:
        assert got[uid].keys() == want[uid].keys()
        for k in want[uid]:
            assert got[uid][k].dtype == np.float32
            np.testing.assert_allclose(got[uid][k], want[uid][k], rtol=0,
                                       atol=RTOL * largest)


# -- heads ------------------------------------------------------------------

def head_pairs():
    center = tuple(float(c) for c in np.linspace(-0.5, 0.5, 16))
    return {
        "classifier": (theads.ClassifierHead(), jheads.ClassifierHead(), 2),
        "reconstruction": (theads.ReconstructionHead(),
                           jheads.ReconstructionHead(), 400),
        "margin": (theads.MarginHead(center=center),
                   jheads.MarginHead(center=center), 16),
        "forecast": (theads.ForecastHead(), jheads.ForecastHead(), 2),
    }


@pytest.mark.parametrize("name", ["classifier", "reconstruction", "margin",
                                  "forecast"])
def test_head_objectives_match_reference(name):
    thead, jhead, n_out = head_pairs()[name]
    rng = np.random.default_rng(3)
    out = rng.standard_normal((64, n_out)).astype(np.float32)
    x = rng.standard_normal((64, 400)).astype(np.float32)
    y = rng.integers(0, 2, 64).astype(np.int64)
    t_out = torch.from_numpy(out).requires_grad_()
    t_x, t_y = torch.from_numpy(x), torch.from_numpy(y)
    loss = thead.loss(t_out, t_x, t_y)
    want = float(jhead.loss(jnp.asarray(out), jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-6)
    # Differentiable: the gradient reaches the outputs.
    (grad,) = torch.autograd.grad(loss, t_out)
    want_grad = jax.grad(lambda o: jhead.loss(o, jnp.asarray(x),
                                              jnp.asarray(y)))(
        jnp.asarray(out))
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-8)
    metric = float(thead.metric(t_out.detach(), t_x, t_y))
    want_metric = float(jhead.metric(jnp.asarray(out), jnp.asarray(x),
                                     jnp.asarray(y)))
    if name == "classifier":
        assert metric == want_metric
    else:
        np.testing.assert_allclose(metric, want_metric, rtol=1e-6)
        np.testing.assert_allclose(
            thead.batch_scores(t_out.detach(), t_x).numpy(),
            np.asarray(jhead.batch_scores(jnp.asarray(out), jnp.asarray(x))),
            rtol=1e-6)


def test_reconstruction_scores_and_sparse_ce_match_reference():
    rng = np.random.default_rng(4)
    recon = rng.standard_normal((32, 400)).astype(np.float32)
    x = rng.standard_normal((32, 400)).astype(np.float32)
    got = theads.ReconstructionHead().scores(torch.from_numpy(recon),
                                             torch.from_numpy(x))
    want = jheads.ReconstructionHead().scores(jnp.asarray(recon),
                                              jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    logits = rng.standard_normal((32, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 32)
    np.testing.assert_allclose(
        float(tdetector.sparse_ce(torch.from_numpy(logits),
                                  torch.from_numpy(labels))),
        float(jdetector.sparse_ce(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)


def test_base_head_has_no_objective():
    head = theads.DetectorHead()
    with pytest.raises(NotImplementedError):
        head.loss(torch.zeros(1, 2), torch.zeros(1, 2), None)
    with pytest.raises(NotImplementedError):
        head.metric(torch.zeros(1, 2), torch.zeros(1, 2), None)


# -- trainers ---------------------------------------------------------------

def test_train_detector_matches_reference(data, monkeypatch):
    got, want = run_both("detector", data, monkeypatch)
    assert_histories_close(got.history, want.history, accuracy=True)
    assert got.best_val_acc == want.best_val_acc
    assert got.test_acc == want.test_acc
    assert_params_close(got.params, want.params)
    for leaf in (v for p in got.params.values() for v in p.values()):
        assert leaf.device.type == "cpu" and not leaf.requires_grad


def test_checkpoint_best_returns_epoch_zero_params(data, monkeypatch):
    """At these settings the classifier's validation accuracy never improves
    after epoch 0, so both packages return the epoch-0 params — not the
    final ones, which the optimizer went on updating in place."""
    got, want = run_both("detector", data, monkeypatch)
    vals = [v for _, _, v in got.history]
    assert len(vals) == EPOCHS and max(vals[1:]) <= vals[0]
    assert_params_close(got.params, want.params)
    _, one_epoch = tdetector.train_detector(
        *data, epochs=1, batch_size=BATCH["detector"], lr=1e-3, device="cpu")
    for uid, p in one_epoch.params.items():
        for k, v in p.items():
            assert torch.equal(got.params[uid][k], v)


@pytest.mark.parametrize("kind", ["autoencoder", "one_class", "forecaster"])
def test_score_trainers_match_reference(kind, data, monkeypatch):
    got, want = run_both(kind, data, monkeypatch)
    assert_histories_close(got.history, want.history, accuracy=False)
    best = "best_val_mse" if kind == "autoencoder" else "best_val"
    np.testing.assert_allclose(getattr(got, best), getattr(want, best),
                               rtol=RTOL)
    assert_params_close(got.params, want.params)
    np.testing.assert_allclose(got.threshold, want.threshold, rtol=RTOL)
    assert got.head.threshold == got.threshold
    assert got.head.target_fpr == want.head.target_fpr
    assert got.calib_fpr == want.calib_fpr
    assert got.calib_fpr <= got.head.target_fpr
    assert got.test_detection_rate == want.test_detection_rate
    np.testing.assert_array_equal(got.calib_windows, want.calib_windows)
    assert isinstance(got.calib_windows, np.ndarray)
    assert type(got.head).__name__ == type(want.head).__name__
    if kind == "one_class":
        np.testing.assert_allclose(got.head.center, want.head.center,
                                   rtol=RTOL, atol=1e-6)


def test_score_windows_and_recalibration_match_reference(data, monkeypatch):
    got, want = run_both("autoencoder", data, monkeypatch, epochs=1)
    model = tdetector.build_autoencoder()
    jmodel = jdetector.build_autoencoder()
    windows = got.calib_windows
    t_scores = tdetector.score_windows(model, got.params,
                                       theads.ReconstructionHead(), windows,
                                       device="cpu")
    j_scores = jdetector.score_windows(jmodel, want.params,
                                       jheads.ReconstructionHead(), windows)
    assert t_scores.dtype == np.float32
    np.testing.assert_allclose(t_scores, j_scores, rtol=RTOL)
    head, scores = tdetector.recalibrate_threshold(model, got.params, windows,
                                                   target_fpr=0.05,
                                                   device="cpu")
    jhead, _ = jdetector.recalibrate_threshold(jmodel, want.params, windows,
                                               target_fpr=0.05)
    np.testing.assert_array_equal(scores, t_scores)
    np.testing.assert_allclose(head.threshold, jhead.threshold, rtol=RTOL)
    assert head.target_fpr == 0.05
    # A tensor of windows scores as its array does; params elsewhere refuse.
    np.testing.assert_array_equal(
        tdetector.score_windows(model, got.params,
                                theads.ReconstructionHead(),
                                torch.from_numpy(windows), device="cpu"),
        t_scores)
    with pytest.raises(ValueError, match="params live on"):
        tdetector.score_windows(model, got.params,
                                theads.ReconstructionHead(), windows,
                                device="meta")


def test_too_few_benign_windows_refused_as_reference():
    x = np.zeros((20, 400), np.float32)
    y = np.zeros(20, np.int64)
    with pytest.raises(ValueError) as got:
        tdetector._split_benign(x, y, 8, "the test head")
    with pytest.raises(ValueError) as want:
        jdetector._split_benign(x, y, 8, "the test head")
    assert str(got.value) == str(want.value)
    for kind in ("autoencoder", "one_class", "forecaster"):
        port_train, ref_train, _ = TRAINERS[kind]
        with pytest.raises(ValueError) as got:
            port_train(x, y, batch_size=16, device="cpu")
        with pytest.raises(ValueError) as want:
            ref_train(x, y, batch_size=16)
        assert str(got.value) == str(want.value)


def test_trainer_signatures_match_reference():
    for name in ("train_detector", "train_autoencoder", "train_one_class",
                 "train_forecaster", "score_windows",
                 "recalibrate_threshold"):
        got = inspect.signature(getattr(tdetector, name)).parameters
        want = inspect.signature(getattr(jdetector, name)).parameters
        assert list(got) == list(want) + ["device"], name
        assert got["device"].default == "cuda"
        for p in want:
            assert got[p].default == want[p].default, (name, p)
    for cls in ("TrainResult", "AETrainResult", "ScoreTrainResult"):
        got = [f.name for f in dataclasses.fields(getattr(tdetector, cls))]
        want = [f.name for f in dataclasses.fields(getattr(jdetector, cls))]
        assert got == want, cls
