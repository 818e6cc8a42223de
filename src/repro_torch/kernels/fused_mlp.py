"""Hopper kernel wrapper: a whole Dense stack in ONE launch.

Replaces ``src/repro/kernels/fused_mlp.py::fused_mlp`` (the Pallas TPU
kernel behind ``ops.fused_forward``); the kernel is ``csrc/fused_mlp.cu``,
whose header gives the design, the numerics and what bounds it.  Every
layer's weights are read from device memory (L2-resident for the detector),
the activations of the current and the next layer live in the block's
shared memory, SINT layers requantize in-kernel and only the last layer's
rows are written back.

A stack is described once (:class:`FusedStack`: device tensors plus the
fixed-size descriptor array the launch passes by value) and launched many
times by :func:`fused_mlp`, which runs on CUDA tensors only.  The ``backend``
contract and the plain version live in ``ops.fused_forward`` and
``ref.fused_mlp_ref``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.layers import ACTIVATIONS
from repro_torch.kernels import build

# Softmax normalizes across the row, so it is not element-wise; every other
# §4.1 activation runs in the kernel.
FUSED_ACTIVATIONS = frozenset(ACTIVATIONS) - {"softmax"}

# Activation ids of csrc/fused_mlp.cu's `enum Act`.
ACT_IDS = {"linear": 0, "relu": 1, "sigmoid": 2, "tanh": 3, "elu": 4,
           "leaky_relu": 5, "swish": 6, "binary_step": 7}
assert set(ACT_IDS) == FUSED_ACTIVATIONS

# Weight dtype -> csrc/fused_mlp.cu's `enum Mode`.
MODES = {torch.float32: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3}

MAX_LAYERS = 8          # the descriptor array's fixed length (MAX_LAYERS)
BLOCK_M = 16            # rows per thread block
# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_PER_BLOCK = 232_448

# Kernel launches since import (or since a caller last reset it): the proof
# that a serving path really went through the kernel.
launches = 0


class FusedLayer(NamedTuple):
    """One Dense layer laid out for the fused kernel.

    ``w``: (K, N) f32 weights, or int8/int16/int32 quantized weights.
    ``bias``: (N,) f32 (zeros when the layer has no bias).
    ``scale``: (N,) f32 combined ``x_scale * w_scale`` — quantized only.
    ``x_scale``: the activation scale as a Python float — quantized only.
    ``act``: activation name from ``FUSED_ACTIVATIONS``.
    """

    w: torch.Tensor
    bias: torch.Tensor
    scale: Optional[torch.Tensor]
    x_scale: Optional[float]
    act: str

    @property
    def quantized(self) -> bool:
        return self.scale is not None


def _layer_mode(dtype: torch.dtype) -> str:
    if dtype == torch.float32:
        return "real"
    if dtype == torch.int8:
        return "int8"
    if dtype in (torch.int16, torch.int32):
        return "emu"
    raise ValueError(f"unsupported fused-layer weight dtype {dtype}")


def smem_bytes(widths: Sequence[int], block_m: int = BLOCK_M) -> int:
    """The kernel's shared-memory bill per block: two f32 activation tiles
    (the current layer's input and its output) of ``block_m`` rows by the
    widest of ``widths`` (the stack's input width and every layer's output
    width)."""
    return 2 * block_m * max(widths) * 4


class _LayerDesc(ctypes.Structure):
    """csrc/fused_mlp.cu's `struct LayerDesc`, field for field."""

    _fields_ = [("w", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("x_scale", ctypes.c_float),
                ("k", ctypes.c_int), ("n", ctypes.c_int),
                ("mode", ctypes.c_int), ("act", ctypes.c_int),
                ("qmax", ctypes.c_float)]


class _MlpDesc(ctypes.Structure):
    """csrc/fused_mlp.cu's `struct MlpDesc`."""

    _fields_ = [("n_layers", ctypes.c_int),
                ("layers", _LayerDesc * MAX_LAYERS)]


class FusedStack:
    """A validated stack of :class:`FusedLayer` plus its launch descriptor.

    The descriptor holds raw device pointers; this object keeps the tensors
    they point into alive.  ``source`` is the param stack the layers were
    laid out from (what the plain version runs), when there is one.
    """

    def __init__(self, layers: Sequence[FusedLayer], source=None):
        if not layers:
            raise ValueError("fused_mlp needs at least one layer")
        if len(layers) > MAX_LAYERS:
            raise ValueError(f"fused_mlp takes at most {MAX_LAYERS} layers, "
                             f"got {len(layers)}")
        device = layers[0].w.device
        prev = layers[0].w.shape[0]
        desc = _MlpDesc(n_layers=len(layers))
        for i, layer in enumerate(layers):
            k, n = layer.w.shape
            if k != prev:
                raise ValueError(f"layer {i}: K {k} != previous width {prev}")
            if layer.act not in FUSED_ACTIVATIONS:
                raise ValueError(
                    f"activation {layer.act!r} is not fusable; pick from "
                    f"{sorted(FUSED_ACTIVATIONS)}")
            tensors = [layer.w, layer.bias] + (
                [layer.scale] if layer.quantized else [])
            for t in tensors:
                if t.device != device or not t.is_contiguous():
                    raise ValueError(f"layer {i}: every tensor must be "
                                     f"contiguous on {device}")
            if layer.bias.shape != (n,) or layer.bias.dtype != torch.float32:
                raise ValueError(f"layer {i}: bias must be (N,) f32")
            quantized = _layer_mode(layer.w.dtype) != "real"
            if quantized != layer.quantized:
                raise ValueError(f"layer {i}: {layer.w.dtype} weights need "
                                 f"{'a' if quantized else 'no'} scale")
            if quantized and (layer.scale.shape != (n,)
                              or layer.scale.dtype != torch.float32):
                raise ValueError(f"layer {i}: scale must be (N,) f32")
            desc.layers[i] = _LayerDesc(
                w=layer.w.data_ptr(),
                scale=layer.scale.data_ptr() if quantized else None,
                bias=layer.bias.data_ptr(),
                x_scale=layer.x_scale if quantized else 0.0,
                k=k, n=n, mode=MODES[layer.w.dtype], act=ACT_IDS[layer.act],
                qmax=float(torch.iinfo(layer.w.dtype).max) if quantized
                else 0.0)
            prev = n
        self.layers = tuple(layers)
        self.source = source
        self.desc = desc
        self.device = device
        self.k0 = layers[0].w.shape[0]
        self.n_out = prev
        self.width = max([self.k0] + [layer.w.shape[1] for layer in layers])
        self.smem_bytes = smem_bytes([self.width])
        if self.smem_bytes > SMEM_PER_BLOCK:
            raise ValueError(
                f"fused stack needs {self.smem_bytes} bytes of shared memory "
                f"per block (> {SMEM_PER_BLOCK})")


@functools.cache
def _entry():
    fn = build.library("fused_mlp").fused_mlp_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def fused_mlp(x: torch.Tensor, stack: FusedStack) -> torch.Tensor:
    """Run a whole Dense stack as ONE kernel launch.

    Args:
      x: (M, K0) contiguous f32 CUDA tensor, on the stack's device.  M is
        any size: the ragged last tile is masked in the kernel.
      stack: the :class:`FusedStack` to run.
    Returns (M, N_last) f32, on the current stream (no synchronisation).
    """
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on CUDA tensors only, got {x.device}")
    if x.device != stack.device or x.dtype != torch.float32 or x.ndim != 2 \
            or x.shape[1] != stack.k0 or not x.is_contiguous():
        raise ValueError(
            f"fused_mlp: x must be a contiguous f32 (M, {stack.k0}) tensor "
            f"on {stack.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    m = x.shape[0]
    out = torch.empty((m, stack.n_out), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    err = _entry()(x.data_ptr(), out.data_ptr(), m, BLOCK_M, stack.width,
                   ctypes.addressof(stack.desc),
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_mlp launch failed: CUDA error {err}")
    launches += 1
    return out
