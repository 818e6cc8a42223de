"""ICSML layer set in PyTorch: the counterpart of ``repro.core.layers``.

The paper's layer set (§4.1): the input copy layer, Dense, Activation,
Concat, Add, Flatten, the CNN parts (Conv2D, DepthwiseConv2D, BatchNorm,
GlobalAvgPool) and the custom Lambda, with all eight parameterizable
activation functions.  Layers keep the reference's static contract — shapes
are known ahead of time (``out_shape``), evaluation is a pure function of
explicitly passed parameters (``apply``), and every layer reports its
parameter bytes and arithmetic cost (``param_bytes``, ``flops``) so that the
memory planner and the multipart scheduler (§6.3) plan without executing
anything.  Dense, Activation, Concat, Add and BatchNorm act on the last axis
and the spatial layers on the last three (H, W, C), so one ``apply`` serves
a single sample or a batch of them; Flatten, like the reference's, takes one
sample.

Convolutions keep the reference's layouts: the sample is NHWC-ordered
``(H, W, C)`` and the weight HWIO ``(kh, kw, cin, cout)`` (depthwise
``(kh, kw, 1, cin)``), permuted to PyTorch's NCHW/OIHW at the call.
"SAME" padding is XLA's (``lo = total // 2``, ``hi = total - lo``), applied
explicitly, since PyTorch's own "same" refuses strides above 1.  They run
IEEE f32 on the card whatever cuDNN's TF32 flag says.

Quantized evaluation (§6.1) follows the reference's arithmetic exactly:
weights are stored as int8/int16/int32 with REAL (f32) scales, the input is
quantized on the fly with a symmetric clip, SINT accumulates in integers and
INT/DINT are emulated in f32, and the rescale and the bias add are two
separately rounded f32 operations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def _prod(xs: Sequence[int]) -> int:
    return int(math.prod(xs)) if xs else 1


def _glorot(generator: torch.Generator, shape: Shape, fan_in: int,
            fan_out: int) -> torch.Tensor:
    """A Glorot-uniform f32 draw from ``generator``."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, dtype=torch.float32)
    return w.uniform_(-limit, limit, generator=generator)


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

    def param_bytes(self, in_shapes: List[Shape]) -> int:
        return 0

    def flops(self, in_shapes: List[Shape]) -> int:
        """Approximate arithmetic ops for one evaluation (multipart planning)."""
        return _prod(self.out_shape(in_shapes))

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
        params = {"w": _glorot(generator, (in_features, self.units),
                               in_features, self.units)}
        if self.use_bias:
            params["b"] = torch.zeros((self.units,), dtype=torch.float32)
        return params

    def param_bytes(self, in_shapes: List[Shape]) -> int:
        (in_features,) = in_shapes[0]
        total = in_features * self.units * 4
        if self.use_bias:
            total += self.units * 4
        return total

    def flops(self, in_shapes: List[Shape]) -> int:
        (in_features,) = in_shapes[0]
        return 2 * in_features * self.units

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


@dataclasses.dataclass(frozen=True)
class Activation(Layer):
    """Standalone activation layer (§4.1)."""

    fn: str = "relu"

    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        return in_shapes[0]

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        return ACTIVATIONS[self.fn](inputs[0])


@dataclasses.dataclass(frozen=True)
class Concat(Layer):
    """Concatenation layer — enables branching models and RNNs (§4.1, §8.2)."""

    axis: int = -1

    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        axis = self.axis % len(in_shapes[0])
        out = list(in_shapes[0])
        out[axis] = sum(s[axis] for s in in_shapes)
        for s in in_shapes:
            for d, (a, b) in enumerate(zip(s, in_shapes[0])):
                if d != axis and a != b:
                    raise ValueError(f"concat shape mismatch: {in_shapes}")
        return tuple(out)

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat(inputs, dim=self.axis)


@dataclasses.dataclass(frozen=True)
class Add(Layer):
    """Elementwise residual add — building block for ResNets (§4.1)."""

    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        return in_shapes[0]

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return out


@dataclasses.dataclass(frozen=True)
class Flatten(Layer):
    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        return (_prod(in_shapes[0]),)

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        return inputs[0].reshape(-1)


@contextlib.contextmanager
def _ieee_f32(x: torch.Tensor) -> Iterator[None]:
    """cuDNN's TF32 off for a convolution on a CUDA tensor, whatever the
    caller set, and the caller's setting back afterwards."""
    if x.device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _spatial_out(size: int, k: int, s: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // s)
    return (size - k) // s + 1


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (lo, hi)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_nhwc(x: torch.Tensor, w_hwio: torch.Tensor,
               strides: Tuple[int, int], padding: str,
               groups: int) -> torch.Tensor:
    """``lax.conv_general_dilated`` with ("NHWC", "HWIO", "NHWC") numbers on
    one (H, W, C) sample or a (..., H, W, C) batch."""
    lead = x.shape[:-3]
    xb = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    if padding == "SAME":
        top, bottom = _same_pads(xb.shape[2], kh, strides[0])
        left, right = _same_pads(xb.shape[3], kw, strides[1])
        xb = F.pad(xb, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    with _ieee_f32(xb):
        y = F.conv2d(xb, w_hwio.permute(3, 2, 0, 1), stride=tuple(strides),
                     groups=groups)
    y = y.permute(0, 2, 3, 1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


@dataclasses.dataclass(frozen=True)
class Conv2D(Layer):
    """2-D convolution over an (H, W, C) sample."""

    filters: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (1, 1)
    padding: str = "SAME"
    activation: str = "linear"
    use_bias: bool = True

    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        h, w, _ = in_shapes[0]
        kh, kw = self.kernel_size
        sh, sw = self.strides
        return (_spatial_out(h, kh, sh, self.padding),
                _spatial_out(w, kw, sw, self.padding), self.filters)

    def init_params(self, generator: torch.Generator,
                    in_shapes: List[Shape]) -> Params:
        _, _, cin = in_shapes[0]
        kh, kw = self.kernel_size
        params = {"w": _glorot(generator, (kh, kw, cin, self.filters),
                               kh * kw * cin, self.filters)}
        if self.use_bias:
            params["b"] = torch.zeros((self.filters,), dtype=torch.float32)
        return params

    def param_bytes(self, in_shapes: List[Shape]) -> int:
        _, _, cin = in_shapes[0]
        kh, kw = self.kernel_size
        return (kh * kw * cin * self.filters
                + (self.filters if self.use_bias else 0)) * 4

    def flops(self, in_shapes: List[Shape]) -> int:
        _, _, cin = in_shapes[0]
        oh, ow, _ = self.out_shape(in_shapes)
        kh, kw = self.kernel_size
        return 2 * oh * ow * kh * kw * cin * self.filters

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        y = _conv_nhwc(inputs[0], params["w"], self.strides, self.padding, 1)
        if self.use_bias:
            y = y + params["b"]
        return ACTIVATIONS[self.activation](y)


@dataclasses.dataclass(frozen=True)
class DepthwiseConv2D(Layer):
    """Depthwise convolution (MobileNet ConvDW blocks — §6.3 multipart demo)."""

    kernel_size: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (1, 1)
    padding: str = "SAME"
    activation: str = "linear"
    use_bias: bool = True

    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        h, w, c = in_shapes[0]
        kh, kw = self.kernel_size
        sh, sw = self.strides
        return (_spatial_out(h, kh, sh, self.padding),
                _spatial_out(w, kw, sw, self.padding), c)

    def init_params(self, generator: torch.Generator,
                    in_shapes: List[Shape]) -> Params:
        _, _, cin = in_shapes[0]
        kh, kw = self.kernel_size
        params = {"w": _glorot(generator, (kh, kw, 1, cin), kh * kw, 1)}
        if self.use_bias:
            params["b"] = torch.zeros((cin,), dtype=torch.float32)
        return params

    def param_bytes(self, in_shapes: List[Shape]) -> int:
        _, _, cin = in_shapes[0]
        kh, kw = self.kernel_size
        return (kh * kw * cin + (cin if self.use_bias else 0)) * 4

    def flops(self, in_shapes: List[Shape]) -> int:
        oh, ow, c = self.out_shape(in_shapes)
        kh, kw = self.kernel_size
        return 2 * oh * ow * kh * kw * c

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        x = inputs[0]
        y = _conv_nhwc(x, params["w"], self.strides, self.padding,
                       x.shape[-1])
        if self.use_bias:
            y = y + params["b"]
        return ACTIVATIONS[self.activation](y)


@dataclasses.dataclass(frozen=True)
class BatchNorm(Layer):
    """Inference-mode batch norm: a static scale/shift (folded statistics)."""

    epsilon: float = 1e-3
    activation: str = "linear"

    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        return in_shapes[0]

    def init_params(self, generator: torch.Generator,
                    in_shapes: List[Shape]) -> Params:
        c = in_shapes[0][-1]
        return {"gamma": torch.ones((c,), dtype=torch.float32),
                "beta": torch.zeros((c,), dtype=torch.float32),
                "mean": torch.zeros((c,), dtype=torch.float32),
                "var": torch.ones((c,), dtype=torch.float32)}

    def param_bytes(self, in_shapes: List[Shape]) -> int:
        return in_shapes[0][-1] * 4 * 4

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        # The reference's order: the scale first, then shift and scale.
        inv = torch.rsqrt(params["var"] + self.epsilon) * params["gamma"]
        return ACTIVATIONS[self.activation](
            (inputs[0] - params["mean"]) * inv + params["beta"])


@dataclasses.dataclass(frozen=True)
class GlobalAvgPool(Layer):
    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        return (in_shapes[0][-1],)

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        return inputs[0].mean(dim=(-3, -2))


@dataclasses.dataclass(frozen=True)
class Lambda(Layer):
    """Custom-functionality layer — ICSML's interface-template answer to the
    Keras lambda layer (§4.2.2).  ``fn`` is a pure torch function of the
    layer's inputs; ``out`` declares the output shape (static planning
    requires it, exactly like implementing the ST interface template)."""

    fn: Optional[Callable[..., torch.Tensor]] = None
    out: Tuple[int, ...] = ()

    def out_shape(self, in_shapes: List[Shape]) -> Shape:
        return tuple(self.out) if self.out else in_shapes[0]

    def apply(self, params: Params, inputs: List[torch.Tensor]) -> torch.Tensor:
        if self.fn is None:
            raise ValueError("Lambda layer requires fn")
        return self.fn(*inputs)
