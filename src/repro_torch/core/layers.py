"""ICSML layer set in PyTorch: the counterpart of ``repro.core.layers``.

The slice of the paper's layers (§4.1) that the §7 detector needs: the input
copy layer and the fully connected layer, with all eight parameterizable
activation functions.  Layers keep the reference's static contract — shapes
are known ahead of time (``out_shape``) and evaluation is a pure function of
explicitly passed parameters (``apply``) — and act on the last axis, so one
``apply`` serves a single sample or a batch of them.

Quantized evaluation (§6.1) follows the reference's arithmetic exactly:
weights are stored as int8/int16/int32 with REAL (f32) scales, the input is
quantized on the fly with a symmetric clip, SINT accumulates in integers and
INT/DINT are emulated in f32, and the rescale and the bias add are two
separately rounded f32 operations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Shape = Tuple[int, ...]


# ---------------------------------------------------------------------------
# Activation functions (§4.1: Binary Step, ELU, ReLU, Leaky ReLU, Sigmoid,
# Softmax, Swish, Tanh).
# ---------------------------------------------------------------------------


def binary_step(x: torch.Tensor) -> torch.Tensor:
    return (x >= 0).to(x.dtype)


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * x)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "binary_step": binary_step,
    "elu": elu,
    "relu": torch.relu,
    "leaky_relu": leaky_relu,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "swish": swish,
    "tanh": torch.tanh,
    "linear": lambda x: x,
}

# IEC 61131-3 integer types used for quantization (§6.1 / Table 2).
IEC_INT_TYPES: Dict[str, np.dtype] = {
    "SINT": np.dtype(np.int8),    # 8-bit
    "INT": np.dtype(np.int16),    # 16-bit
    "DINT": np.dtype(np.int32),   # 32-bit
}

TORCH_INT_TYPES: Dict[str, torch.dtype] = {
    "SINT": torch.int8,
    "INT": torch.int16,
    "DINT": torch.int32,
}


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of integer-valued tensors, as int32.

    Runs as a float64 matmul of the codes: integer matmul exists only on the
    CPU, and f32 would round once a partial sum passes 2**24, while every
    partial sum of the int8 products here (|sum| <= K * 127**2) is an integer
    far below 2**53, so float64 is exact in any summation order.
    """
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layer:
    """Base class for ICSML layers."""

    name: str = dataclasses.field(default="", kw_only=True)

    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator,
                    in_shapes: List[Shape]) -> Params:
        return {}

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Input(Layer):
    """Input copy layer — ICSML's input layer 'performs a simple copy' (§5.2)."""

    features: Tuple[int, ...] = ()

    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        return tuple(self.features) if self.features else in_shapes[0]

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        return inputs[0]


@dataclasses.dataclass(frozen=True)
class Dense(Layer):
    """Fully connected layer: ``y = act(x @ W + b)``.

    Evaluates quantized when params come from
    :func:`repro_torch.core.quantize.quantize_params` (``qw``, ``w_scale``,
    ``x_scale`` and ``b``).
    """

    units: int = 0
    activation: str = "linear"
    use_bias: bool = True

    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        return (self.units,)

    def init_params(self, generator: torch.Generator,
                    in_shapes: List[Shape]) -> Params:
        (in_features,) = in_shapes[0]
        limit = math.sqrt(6.0 / (in_features + self.units))  # Glorot uniform
        w = torch.empty((in_features, self.units), dtype=torch.float32)
        w.uniform_(-limit, limit, generator=generator)
        params = {"w": w}
        if self.use_bias:
            params["b"] = torch.zeros((self.units,), dtype=torch.float32)
        return params

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        x = inputs[0]
        if "qw" in params:
            y = quantized_matvec(x, params)
        else:
            y = x @ params["w"]
            if self.use_bias:
                y = y + params["b"]
        return ACTIVATIONS[self.activation](y)


def quantized_matvec(x: torch.Tensor, params: Params) -> torch.Tensor:
    """Paper-faithful quantized dense evaluation (§6.1), as
    ``repro.core.layers._quantized_matvec``.

    The activation clip is symmetric (``[-qmax, qmax]``, matching
    ``quantize_tensor``); SINT runs an exact integer dot; INT/DINT stay in
    f32 on the integer grid (int32's qmax is not f32-representable, so a
    round trip through the int dtype would overflow at the clip rail).
    """
    qw = params["qw"]
    qmax = torch.iinfo(qw.dtype).max
    xq = torch.clamp(torch.round(x / params["x_scale"]), -qmax, qmax)
    if qw.dtype == torch.int8:
        acc = int_matmul(xq, qw).to(torch.float32)
    else:
        acc = xq @ qw.to(torch.float32)
    y = acc * (params["x_scale"] * params["w_scale"])
    if "b" in params:
        y = y + params["b"]
    return y
