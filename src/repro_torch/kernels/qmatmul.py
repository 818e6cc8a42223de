"""Hopper kernel wrapper: int8 quantized matmul with fused dequantization.

Replaces ``src/repro/kernels/qmatmul.py::qmatmul`` (the Pallas TPU kernel).
The kernel is ``csrc/qmatmul.cu``; see its header for the design and what
bounds it.  :func:`qmatmul` launches it on CUDA tensors only and raises on
anything else — ``ops.quantized_matmul`` owns the ``backend`` contract and
the plain version (``ref.qmatmul_ref``).  :func:`path` picks the kernel's
path from M.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

# Kernel launches since import (or since a caller last reset it): the proof
# that a serving path really went through the kernel.
launches = 0
# The least M that takes the int8 tensor-core path (one wgmma is 64 rows).
TENSOR_CORE_M = 64


def path(m: int) -> str:
    """``"tensor_cores"`` (wgmma, 128 x 128 tiles) for M >= 64, else
    ``"stream"`` (the weight-streaming kernel for decode-sized M)."""
    return "tensor_cores" if m >= TENSOR_CORE_M else "stream"


@functools.cache
def _entry():
    fn = build.library("qmatmul").qmatmul_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"qmatmul: {what} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def qmatmul(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``f32(xq @ wq) * scale + bias`` on the card, int32 accumulation.

    Args:
      xq: (M, K) int8 CUDA tensor.
      wq: (K, N) int8 CUDA tensor.
      scale: (N,) f32 combined ``x_scale * w_scale``.
      bias: optional (N,) f32.
    Returns (M, N) f32, on the current stream (no synchronisation).
    """
    global launches
    if xq.device.type != "cuda":
        raise ValueError(f"qmatmul runs on CUDA tensors only, got {xq.device}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"qmatmul takes int8 operands only, got {xq.dtype} "
                         f"x {wq.dtype}")
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"qmatmul shapes do not chain: {tuple(xq.shape)} @ "
                         f"{tuple(wq.shape)}")
    m, k = xq.shape
    n = wq.shape[1]
    dev = xq.device
    _check(xq, "xq", torch.int8, (m, k), dev)
    _check(wq, "wq", torch.int8, (k, n), dev)
    _check(scale, "scale", torch.float32, (n,), dev)
    if bias is not None:
        _check(bias, "bias", torch.float32, (n,), dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    err = _entry()(xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                   None if bias is None else bias.data_ptr(), out.data_ptr(),
                   m, n, k, path(m) == "tensor_cores",
                   torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"qmatmul launch failed: CUDA error {err}")
    launches += 1
    return out
