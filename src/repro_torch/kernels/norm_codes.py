"""Hopper kernel wrapper: an RMSNorm row that feeds a SINT projection,
written out as the projection's int8 input codes: a Mamba-2 block's
pre-norm, or the mixer's gated norm (its D skip and SiLU gate first).

Replaces no TPU kernel: the reference leaves the norm and the quantize to
XLA, which fuses them.  The kernel is ``csrc/norm_codes.cu``; see its header
for the design and what bounds it.  :func:`norm_codes` launches it on CUDA
tensors only and raises on anything else — ``ops.rmsnorm_codes`` owns the
``backend`` contract and the plain version (``ref.norm_codes_ref``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

# Kernel launches since import (or since a caller last reset it): the proof
# that a path really went through the kernel.
launches = 0
# Working types of the rows (the gated norm's y is f32 whatever the working
# type).
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _entry():
    fn = build.library("norm_codes").norm_codes_launch
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, i64, ptr, i64, ptr, i32, ptr, i64, ptr, ptr,
                   ctypes.c_float, ptr] + [i32] * 4 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
           device: torch.device, rows: bool = False) -> None:
    """``rows``: a (M, W) view whose columns are packed (any row stride);
    otherwise contiguous."""
    ok = (t.device == device and t.dtype == dtype
          and tuple(t.shape) == shape
          and ((t.stride(-1) == 1 or shape[-1] <= 1) if rows
               else t.is_contiguous()))
    if not ok:
        layout = "its columns packed" if rows else "contiguous"
        raise ValueError(
            f"norm_codes: {what} must be a {dtype} tensor of shape {shape} "
            f"on {device}, {layout}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}, strides {t.stride()}")


def norm_codes(x: torch.Tensor, g: torch.Tensor, x_scale: torch.Tensor, *,
               xs: Optional[torch.Tensor] = None,
               d_skip: Optional[torch.Tensor] = None,
               z: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """The int8 codes ``clamp(rint(rmsnorm(u) * g / x_scale), -127, 127)``
    of every row, in one launch.

    Args:
      x: (M, W) CUDA rows, columns packed, any row stride: f32 ``y`` for
        the gated norm, otherwise the working type (f32 or bf16), and then
        u = x.
      g: (W,) f32 norm weight, contiguous.
      x_scale: the projection's activation scale, one f32 value on the card
        (read there, never brought to the host).
      xs, d_skip, z: the gated norm's, all three or none: xs and z (M, W)
        rows in the working type, d_skip (H,) f32 with H dividing W;
        u = T(T(x + d_skip[head] * xs) * T(silu(z))), head = column //
        (W // H).
    Returns (M, W) int8, contiguous, on the current stream (no
    synchronisation).
    """
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"norm_codes runs on CUDA tensors only, got "
                         f"{x.device}")
    if x.ndim != 2:
        raise ValueError(f"norm_codes takes (M, W) rows, got "
                         f"{tuple(x.shape)}")
    gated = xs is not None
    if (d_skip is not None, z is not None) != (gated, gated):
        raise ValueError("norm_codes: the gated norm takes xs, d_skip and z "
                         "together")
    dtype = xs.dtype if gated else x.dtype
    if dtype not in DTYPES:
        raise ValueError(f"norm_codes: the working type must be one of "
                         f"{DTYPES}, got {dtype}")
    m, w = x.shape
    dev = x.device
    _check(x, "x", torch.float32 if gated else dtype, (m, w), dev, rows=True)
    _check(g, "g", torch.float32, (w,), dev)
    if x_scale.device != dev or x_scale.dtype != torch.float32 \
            or x_scale.numel() != 1:
        raise ValueError(f"norm_codes: x_scale must be one f32 value on "
                         f"{dev}, got {x_scale.dtype} "
                         f"{tuple(x_scale.shape)} on {x_scale.device}")
    headdim = 0
    if gated:
        _check(xs, "xs", dtype, (m, w), dev, rows=True)
        _check(z, "z", dtype, (m, w), dev, rows=True)
        _check(d_skip, "d_skip", torch.float32, (d_skip.shape[0],), dev)
        if d_skip.shape[0] == 0 or w % d_skip.shape[0]:
            raise ValueError(f"norm_codes: {w} columns do not split into "
                             f"{d_skip.shape[0]} heads")
        headdim = w // d_skip.shape[0]
    out = torch.empty((m, w), dtype=torch.int8, device=dev)
    if m == 0 or w == 0:
        return out
    err = _entry()(
        x.data_ptr(), x.stride(0),
        xs.data_ptr() if gated else None, xs.stride(0) if gated else 0,
        d_skip.data_ptr() if gated else None, headdim,
        z.data_ptr() if gated else None, z.stride(0) if gated else 0,
        g.data_ptr(), x_scale.data_ptr(), eps, out.data_ptr(), m, w,
        int(dtype == torch.bfloat16), int(gated),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"norm_codes launch failed: CUDA error {err}")
    launches += 1
    return out
