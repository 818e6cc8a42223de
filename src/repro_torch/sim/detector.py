"""Head-generic training/eval for the §7 detection workloads.

The counterpart of ``repro.sim.detector``: the model bodies (node uids
identical to the reference's), their batched forward, and the shared §7
training recipe — Adam, checkpoint-best weight saving, patience early
stopping — parameterized by a :mod:`repro_torch.sim.heads` head:

* **Classifier** (§7): 400-64-32-16-2 on labeled windows, sparse CE
  (:func:`train_detector`).
* **Autoencoder**, **one-class margin** and **forecaster**: trained on benign
  windows only, verdict threshold calibrated to a target false-positive rate
  on a held-out normal split (:func:`train_autoencoder`,
  :func:`train_one_class`, :func:`train_forecaster`).

Gradients are autograd over :meth:`Model.apply` (IEEE f32 products: TF32 is
off where training runs); validation, scoring and calibration run the fused
whole-MLP forward, one ``fused_mlp`` launch on the card.  Every trainer runs
on the card unless the caller asks for the CPU (``device="cpu"``); the
minibatch order, the init draws and the Adam arithmetic are the reference's,
so the CPU path follows it epoch for epoch.  The trained model ports through
``repro_torch.core.porting.port_mlp``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import msf_detector as spec
from repro_torch.core import layers as L
from repro_torch.core.model import Model, ParamTree, sequential
from repro_torch.device import Device, params_device, resolve_device, to_device
from repro_torch.kernels import ops
from repro_torch.sim.heads import (ClassifierHead, DetectorHead, ForecastHead,
                                   MarginHead, ReconstructionHead, ScoreHead)

History = List[Tuple[int, float, float]]


def build_detector() -> Model:
    """The §7 supervised classifier body: 400-64-32-16-2."""
    hidden = [L.Dense(units=h, activation="relu") for h in spec.HIDDEN]
    return sequential(
        [L.Input()] + hidden + [L.Dense(units=spec.CLASSES, activation="linear")],
        (spec.INPUT_SIZE,),
    )


def build_margin_model() -> Model:
    """The one-class margin body: 400 -> 64 -> 32 -> 16 embedding."""
    hidden = [L.Dense(units=h, activation="relu") for h in spec.HIDDEN[:-1]]
    return sequential(
        [L.Input()] + hidden
        + [L.Dense(units=spec.MARGIN_EMBED, activation="linear")],
        (spec.INPUT_SIZE,),
    )


def build_forecaster() -> Model:
    """The next-step-prediction body: (W-1) x F = 398 inputs -> one
    F-feature forecast of the next reading."""
    hidden = [L.Dense(units=h, activation="relu")
              for h in spec.FORECAST_HIDDEN]
    return sequential(
        [L.Input()] + hidden
        + [L.Dense(units=spec.N_FEATURES, activation="linear")],
        ((spec.WINDOW - 1) * spec.N_FEATURES,),
    )


def build_autoencoder() -> Model:
    """The unsupervised reconstruction body: 400-64-16-64-400."""
    hidden = [L.Dense(units=h, activation="relu") for h in spec.AE_HIDDEN]
    return sequential(
        [L.Input()] + hidden
        + [L.Dense(units=spec.INPUT_SIZE, activation="linear")],
        (spec.INPUT_SIZE,),
    )


def batched_forward(model: Model, params: ParamTree, x: torch.Tensor, *,
                    backend: str = "auto") -> torch.Tensor:
    """Whole-batch detector outputs: ``(M, in) -> (M, out)``.

    All-Dense stacks run through the fused whole-MLP path (one kernel launch
    on the card); other models run the value-table ``model.apply``, whose
    layers act on the batch's last axis.
    """
    stack = ops.dense_stack(model, params)
    if ops.model_fusable(model, stack):
        return ops.fused_forward(x, stack, backend=backend)
    return model.apply(params, x)


def sparse_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return ClassifierHead().loss(logits, None, labels)


@dataclasses.dataclass
class TrainResult:
    params: ParamTree
    history: History                          # (epoch, train_loss, val_metric)
    best_val_acc: float
    test_acc: float


@dataclasses.dataclass
class AETrainResult:
    params: ParamTree
    history: History                          # (epoch, train_mse, -val_mse)
    best_val_mse: float
    head: ReconstructionHead                  # threshold-calibrated
    threshold: float
    calib_fpr: float                          # realized FPR on the calib split
    test_detection_rate: float                # attack windows over threshold
    calib_windows: np.ndarray                 # the held-out normal split —
                                              # re-calibrate on THESE (e.g.
                                              # post-quantization), never on
                                              # training windows


@contextlib.contextmanager
def _ieee_f32_matmul(device: torch.device) -> Iterator[None]:
    """cuBLAS's TF32 off for training's f32 products on the card, whatever
    the caller set, and the caller's setting back afterwards."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _windows(x, device: torch.device) -> torch.Tensor:
    """Windows as an f32 tensor on ``device`` (host arrays uploaded once)."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return to_device(np.asarray(x, np.float32), device)


def _labels(y, device: torch.device) -> Optional[torch.Tensor]:
    return None if y is None else to_device(np.asarray(y, np.int64), device)


def _snapshot(params: ParamTree) -> ParamTree:
    """A detached copy of ``params``: nothing the optimizer updates in place
    afterwards reaches it."""
    return {uid: {k: v.detach().clone() for k, v in p.items()}
            for uid, p in params.items()}


def _detached(params: ParamTree) -> ParamTree:
    """``params`` without autograd (views of the same storage)."""
    return {uid: {k: v.detach() for k, v in p.items()}
            for uid, p in params.items()}


def _adam_step(leaves, moments, grads, t: int, lr: float) -> None:
    """One Adam update of every leaf in place, in the reference's f32 op
    order (each product and sum rounded on its own)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    # The reference's jitted step raises a weak-f32 b1 to the int32 step
    # count: an f32 power.
    c1 = float(np.float32(1) - np.float32(b1) ** t)
    c2 = float(np.float32(1) - np.float32(b2) ** t)
    with torch.no_grad():
        for p, (m, v), g in zip(leaves, moments, grads):
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))


def _fit_head(
    model: Model,
    head: DetectorHead,
    x_train: np.ndarray,
    y_train: Optional[np.ndarray],
    x_val: np.ndarray,
    y_val: Optional[np.ndarray],
    *,
    epochs: int,
    batch_size: int,
    lr: float,
    patience: int,
    seed: int,
    device: torch.device,
) -> Tuple[ParamTree, History, float]:
    """The shared §7 training recipe, parameterized by the head's loss and
    model-selection metric (greater is better): Adam, checkpoint-best weight
    saving, patience early stopping.  Returns (best_params, history,
    best_val_metric), the params on ``device``."""
    params = model.init_params(torch.Generator().manual_seed(seed),
                               device=device)
    leaves = [leaf.requires_grad_() for p in params.values()
              for leaf in p.values()]
    moments = [(torch.zeros_like(leaf), torch.zeros_like(leaf))
               for leaf in leaves]
    # The training split goes to the device once; each minibatch is a
    # gather from it in the reference's permutation order.
    xt, yt = _windows(x_train, device), _labels(y_train, device)
    xv, yv = _windows(x_val, device), _labels(y_val, device)
    rng = np.random.default_rng(seed)
    history: History = []
    best_val, best_params, since_best = -np.inf, _snapshot(params), 0
    n_train = len(x_train)
    t = 0

    with _ieee_f32_matmul(device):
        for epoch in range(epochs):
            perm = torch.from_numpy(rng.permutation(n_train)).to(device)
            losses = []
            for i in range(0, n_train - batch_size + 1, batch_size):
                idx = perm[i:i + batch_size]
                xb = xt[idx]
                yb = None if yt is None else yt[idx]
                t += 1
                # head.prepare is the model-input view of the windows (the
                # identity for every head but forecast) — the same transform
                # the serving step applies, so train and serve see the same
                # model inputs.
                loss = head.loss(model.apply(params, head.prepare(xb)),
                                 xb, yb)
                grads = torch.autograd.grad(loss, leaves)
                _adam_step(leaves, moments, grads, t, lr)
                losses.append(loss.detach())
            # Evaluation goes through the fused whole-MLP path (training's
            # gradient path stays on model.apply above).
            with torch.no_grad():
                val = float(head.metric(batched_forward(
                    model, _detached(params), head.prepare(xv)), xv, yv))
            # One read of the epoch's losses: the same f32 values the
            # reference reads step by step.
            step_losses = torch.stack(losses).tolist() if losses else []
            history.append((epoch, float(np.mean(step_losses)), val))
            if val > best_val:                # checkpoint-best (§7)
                best_val, best_params, since_best = val, _snapshot(params), 0
            else:
                since_best += 1
                if since_best >= patience:    # early stopping (§7)
                    break

    return best_params, history, best_val


def train_detector(
    x: np.ndarray,
    y: np.ndarray,
    *,
    epochs: int = 60,
    batch_size: int = 256,
    lr: float = 3e-4,
    patience: int = 8,
    seed: int = 0,
    splits: Tuple[float, float, float] = (0.7225, 0.1275, 0.15),  # §7
    device: Device = "cuda",
) -> Tuple[Model, TrainResult]:
    """The supervised §7 classifier: labeled windows, CE loss, argmax."""
    dev = resolve_device(device)
    model = build_detector()
    head = ClassifierHead()

    n = len(x)
    n_train = int(splits[0] * n)
    n_val = int(splits[1] * n)
    x_train, y_train = x[:n_train], y[:n_train]
    x_val, y_val = x[n_train:n_train + n_val], y[n_train:n_train + n_val]
    x_test, y_test = x[n_train + n_val:], y[n_train + n_val:]

    params, history, best_val = _fit_head(
        model, head, x_train, y_train, x_val, y_val, epochs=epochs,
        batch_size=batch_size, lr=lr, patience=patience, seed=seed,
        device=dev)

    with torch.no_grad():
        test_acc = float(head.metric(
            batched_forward(model, params, _windows(x_test, dev)), None,
            _labels(y_test, dev)))
    return model, TrainResult(params=params, history=history,
                              best_val_acc=best_val, test_acc=test_acc)


def score_windows(
    model: Model,
    params: ParamTree,
    head: ScoreHead,
    windows,
    *,
    backend: str = "auto",
    device: Device = "cuda",
) -> np.ndarray:
    """Per-window anomaly scores of ``head`` over batched ``windows`` —
    the head's prepare -> fused batched forward -> batch_scores sequence,
    shared by calibration, detection-rate reporting and tests.  Runs on
    ``device``, where ``params`` must live."""
    dev = resolve_device(device)
    if params_device(params) != dev:
        raise ValueError(f"params live on {params_device(params)}, not on "
                         f"the requested device {dev}")
    w = _windows(windows, dev)
    with torch.no_grad():
        scores = head.batch_scores(
            batched_forward(model, params, head.prepare(w), backend=backend),
            w)
    return scores.cpu().numpy()


def recalibrate_threshold(
    model: Model,
    params: ParamTree,
    windows,
    *,
    head: Optional[ScoreHead] = None,
    target_fpr: float = spec.AE_TARGET_FPR,
    backend: str = "auto",
    device: Device = "cuda",
) -> Tuple[ScoreHead, np.ndarray]:
    """Calibrate a :class:`ScoreHead` threshold against THIS model/params'
    anomaly scores on held-out **normal** windows.

    The single source of the score-then-quantile sequence: initial training
    calibration and every re-calibration (post-quantization, post-porting)
    go through here, so the held-out-windows invariant — never calibrate on
    training windows, they score optimistically and bias the quantile low —
    lives in one place for every score head.  ``head`` defaults to an
    uncalibrated :class:`ReconstructionHead`.  Returns ``(calibrated_head,
    scores)``.
    """
    head = ReconstructionHead() if head is None else head
    scores = score_windows(model, params, head, windows, backend=backend,
                           device=device)
    return head.calibrate(scores, target_fpr), scores


@dataclasses.dataclass
class ScoreTrainResult:
    """Result of the generic unsupervised (score-head) trainer."""

    params: ParamTree
    history: History                          # (epoch, train_score, -val)
    best_val: float                           # best validation mean score
    head: ScoreHead                           # threshold-calibrated
    threshold: float
    calib_fpr: float                          # realized FPR on the calib split
    test_detection_rate: float                # attack windows over threshold
    calib_windows: np.ndarray                 # the held-out normal split —
                                              # re-calibrate on THESE (e.g.
                                              # post-quantization), never on
                                              # training windows


def _split_benign(x, y, batch_size, what):
    if y is not None:
        normal = x[np.asarray(y) == 0]
        attacks = x[np.asarray(y) != 0]
    else:
        normal, attacks = x, None
    if len(normal) < 3 * batch_size:
        raise ValueError(
            f"need >= {3 * batch_size} benign windows to train/val/calibrate "
            f"{what}, got {len(normal)}")
    return normal, attacks


def _train_score_head(
    model: Model,
    head: ScoreHead,
    x: np.ndarray,
    y: Optional[np.ndarray],
    *,
    epochs: int,
    batch_size: int,
    lr: float,
    patience: int,
    seed: int,
    splits: Tuple[float, float, float],
    target_fpr: float,
    device: torch.device,
) -> ScoreTrainResult:
    """The shared unsupervised recipe: fit ``head``'s score objective on
    **benign windows only** (labels, when given, solely drop attack windows),
    calibrate the verdict threshold to ``target_fpr`` on a held-out normal
    split the optimizer never saw, and report the detection rate over the
    dropped attacks."""
    normal, attacks = _split_benign(x, y, batch_size, f"the {head.name} head")
    n = len(normal)
    n_train = int(splits[0] * n)
    n_val = int(splits[1] * n)
    x_train = normal[:n_train]
    x_val = normal[n_train:n_train + n_val]
    x_calib = normal[n_train + n_val:]        # held-out normal traces

    params, history, best_val = _fit_head(
        model, head, x_train, None, x_val, None, epochs=epochs,
        batch_size=batch_size, lr=lr, patience=patience, seed=seed,
        device=device)

    # Threshold calibration: the conservative (1 - target_fpr) quantile of
    # anomaly score on held-out normal windows the optimizer never touched.
    head, calib_scores = recalibrate_threshold(
        model, params, x_calib, head=head, target_fpr=target_fpr,
        device=device)
    calib_fpr = float(np.mean(calib_scores > head.threshold))

    detection = 0.0
    if attacks is not None and len(attacks):
        attack_scores = score_windows(model, params, head, attacks,
                                      device=device)
        detection = float(np.mean(attack_scores > head.threshold))

    return ScoreTrainResult(
        params=params, history=history, best_val=-best_val, head=head,
        threshold=head.threshold, calib_fpr=calib_fpr,
        test_detection_rate=detection, calib_windows=x_calib)


def train_autoencoder(
    x: np.ndarray,
    y: Optional[np.ndarray] = None,
    *,
    epochs: int = 60,
    batch_size: int = 256,
    lr: float = 1e-3,
    patience: int = 8,
    seed: int = 0,
    splits: Tuple[float, float, float] = (0.7225, 0.1275, 0.15),
    target_fpr: float = spec.AE_TARGET_FPR,
    device: Device = "cuda",
) -> Tuple[Model, AETrainResult]:
    """The unsupervised reconstruction detector: the 400-64-16-64-400
    autoencoder under the shared score-head recipe (benign-only MSE,
    held-out FPR calibration — :func:`_train_score_head`).

    Returns the model plus an :class:`AETrainResult` whose ``head`` is the
    calibrated :class:`ReconstructionHead` to serve with.
    """
    dev = resolve_device(device)
    model = build_autoencoder()
    res = _train_score_head(
        model, ReconstructionHead(), x, y, epochs=epochs,
        batch_size=batch_size, lr=lr, patience=patience, seed=seed,
        splits=splits, target_fpr=target_fpr, device=dev)
    return model, AETrainResult(
        params=res.params, history=res.history, best_val_mse=res.best_val,
        head=res.head, threshold=res.threshold, calib_fpr=res.calib_fpr,
        test_detection_rate=res.test_detection_rate,
        calib_windows=res.calib_windows)


def train_one_class(
    x: np.ndarray,
    y: Optional[np.ndarray] = None,
    *,
    epochs: int = 60,
    batch_size: int = 256,
    lr: float = 1e-3,
    patience: int = 8,
    seed: int = 0,
    splits: Tuple[float, float, float] = (0.7225, 0.1275, 0.15),
    target_fpr: float = spec.AE_TARGET_FPR,
    device: Device = "cuda",
) -> Tuple[Model, ScoreTrainResult]:
    """The one-class margin detector (Deep-SVDD-style): embed windows with
    the §7 trunk (:func:`build_margin_model`), fix the center at the mean
    *initial* embedding of the benign training windows (a trainable center
    collapses), then minimize the mean squared distance of benign embeddings
    from it.  The calibrated threshold is the margin radius.
    """
    dev = resolve_device(device)
    model = build_margin_model()
    normal, _ = _split_benign(x, y, batch_size, "the margin head")
    # Center from the untrained embedding of benign windows; freezing it
    # before optimization is what makes "pull everything to the center" a
    # non-degenerate objective.
    n_train = int(splits[0] * len(normal))
    init_params = model.init_params(torch.Generator().manual_seed(seed),
                                    device=dev)
    with torch.no_grad():
        emb = batched_forward(model, init_params,
                              _windows(normal[:n_train], dev))
    center = tuple(float(c) for c in emb.mean(dim=0).cpu().numpy())
    res = _train_score_head(
        model, MarginHead(center=center), x, y, epochs=epochs,
        batch_size=batch_size, lr=lr, patience=patience, seed=seed,
        splits=splits, target_fpr=target_fpr, device=dev)
    return model, res


def train_forecaster(
    x: np.ndarray,
    y: Optional[np.ndarray] = None,
    *,
    epochs: int = 60,
    batch_size: int = 256,
    lr: float = 1e-3,
    patience: int = 8,
    seed: int = 0,
    splits: Tuple[float, float, float] = (0.7225, 0.1275, 0.15),
    target_fpr: float = spec.AE_TARGET_FPR,
    device: Device = "cuda",
) -> Tuple[Model, ScoreTrainResult]:
    """The next-step-prediction detector: :func:`build_forecaster` maps each
    window's first W-1 readings to a forecast of the W-th (the
    :class:`~repro_torch.sim.heads.ForecastHead` owns the slicing), trained
    on benign windows so attacks surface as unforecastable transitions.

    ``x`` rows are FULL ``spec.INPUT_SIZE`` windows — the same dataset the
    other detectors train on; the head carves input and target out of each.
    """
    dev = resolve_device(device)
    model = build_forecaster()
    res = _train_score_head(
        model, ForecastHead(n_features=spec.N_FEATURES), x, y, epochs=epochs,
        batch_size=batch_size, lr=lr, patience=patience, seed=seed,
        splits=splits, target_fpr=target_fpr, device=dev)
    return model, res
