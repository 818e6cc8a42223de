"""The §7 detection workloads' model bodies, and their batched forward.

The counterpart of the model-building half of ``repro.sim.detector``: the
400-64-32-16-2 classifier, the margin trunk, the forecaster and the
400-64-16-64-400 autoencoder, with node uids identical to the reference's.
Training is not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.configs import msf_detector as spec
from repro_torch.core import layers as L
from repro_torch.core.model import Model, ParamTree, sequential
from repro_torch.kernels import ops


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
