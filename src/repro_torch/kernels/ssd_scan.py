"""Hopper kernel wrapper: the Mamba-2 SSD chunked scan, the whole batch in
one launch.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan`` (the Pallas TPU
kernel).  The kernel is ``csrc/ssd_scan.cu``; see its header for the design
and what bounds it.  :func:`ssd_scan` launches it on CUDA tensors only and
raises on anything else — ``ops.ssd`` owns the ``backend`` contract and the
plain versions (``ref.ssd_chunked_ref``, ``ref.ssd_scan_ref``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# Kernel launches since import (or since a caller last reset it): the proof
# that a path really went through the kernel.
launches = 0
CHUNK = 128                      # the kernel's chunk length L
# (head dim P, state dim N) pairs the kernel is instantiated for:
# mamba2-370m's (64, 128), its reduced() (32, 32), and the two that the
# card tests add.
SHAPES = ((64, 128), (64, 64), (32, 128), (32, 32))


@functools.cache
def _entry():
    fn = build.library("ssd_scan").ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, what: str, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"ssd_scan: {what} must be a contiguous float32 tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Chunked SSD scan (chunk :data:`CHUNK`) over a batch of sequences.

    Args:
      x:  (B, T, H, P) f32 CUDA tensor (per-head channels).
      dt: (B, T, H) f32 positive step sizes (softplus applied).
      a:  (H,) f32 negative decay rates.
      b, c: (B, T, G, N) f32, G groups shared by H / G heads each.
    Returns y (B, T, H, P) f32, on the current stream (no synchronisation).
    Any T: the kernel treats steps past T as dt = 0.
    """
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA tensors only, got {x.device}")
    if x.ndim != 4 or b.ndim != 4:
        raise ValueError(f"ssd_scan takes x (B, T, H, P) and b/c (B, T, G, N), "
                         f"got {tuple(x.shape)} and {tuple(b.shape)}")
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (p, n) not in SHAPES:
        raise ValueError(f"ssd_scan has no kernel for P={p}, N={n} "
                         f"(instantiated (P, N): {SHAPES})")
    if g == 0 or h % g:
        raise ValueError(f"ssd_scan: {h} heads do not split into {g} groups")
    dev = x.device
    _check(x, "x", (bsz, t, h, p), dev)
    _check(dt, "dt", (bsz, t, h), dev)
    _check(a, "a", (h,), dev)
    _check(b, "b", (bsz, t, g, n), dev)
    _check(c, "c", (bsz, t, g, n), dev)
    y = torch.empty_like(x)
    if bsz == 0 or t == 0 or h == 0:
        return y
    err = _entry()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                   c.data_ptr(), y.data_ptr(), bsz, t, h, g, p, n,
                   torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    launches += 1
    return y
