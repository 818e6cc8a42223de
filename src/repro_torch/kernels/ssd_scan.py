"""Hopper kernel wrapper: the Mamba-2 SSD chunked scan, the whole batch in
one launch, with the final SSM state as a second output.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan`` (the Pallas TPU
kernel).  The kernel is ``csrc/ssd_scan.cu``; see its header for the design
and what bounds it.  :func:`ssd_scan` launches it on CUDA tensors only and
raises on anything else — ``ops.ssd`` owns the ``backend`` contract and the
plain versions (``ref.ssd_chunked_ref``, ``ref.ssd_scan_ref``,
``ref.ssd_final_state_ref``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from repro_torch.kernels import build

# Kernel launches since import (or since a caller last reset it): the proof
# that a path really went through the kernel.
launches = 0
CHUNK = 128          # the chunk of the plain version ref.ssd_chunked_ref
KERNEL_CHUNK = 64    # the chunk length the kernel computes with
# (head dim P, state dim N) pairs the kernel is instantiated for:
# mamba2-370m's (64, 128), Jamba's (128, 128) (the (64, 128) instantiation
# on two column slices of each head), their reduced() (32, 32), and the two
# that the card tests add.
SHAPES = ((64, 128), (128, 128), (64, 64), (32, 128), (32, 32))
# Input types of x, B and C (converted to f32 exactly on load).
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _entry():
    fn = build.library("ssd_scan").ssd_scan_launch
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, i64, i64, ptr, ptr, ptr, i64, i64, ptr, i64, i64,
                   ptr, ptr] + [i32] * 7 + [ptr]
    fn.restype = ctypes.c_int
    return fn


def reads(v: torch.Tensor) -> bool:
    """Whether the kernel reads the 4-d x, B or C view ``v`` where it lies:
    its last two dimensions packed, and its base and batch and step strides
    16-byte aligned (every row a whole number of 16-byte copies)."""
    size = v.element_size()
    return (v.stride(3) == 1 and v.stride(2) == v.shape[3]
            and v.data_ptr() % 16 == 0
            and (v.shape[3] * size) % 16 == 0
            and all((s * size) % 16 == 0 for s in v.stride()[:2]))


def _check(t: torch.Tensor, what: str, shape: tuple, device: torch.device,
           dtype: torch.dtype = torch.float32, view: bool = False) -> None:
    ok = (t.device == device and t.dtype == dtype
          and tuple(t.shape) == shape
          and (reads(t) if view else t.is_contiguous()))
    if not ok:
        layout = ("its last two dimensions packed and rows 16-byte aligned"
                  if view else "contiguous")
        raise ValueError(
            f"ssd_scan: {what} must be a {dtype} tensor of shape {shape} on "
            f"{device}, {layout}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}, strides {t.stride()}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, return_state: bool = False
             ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Chunked SSD scan over a batch of sequences.

    Args:
      x:  (B, T, H, P) CUDA tensor (per-head channels), f32 or bf16.
      dt: (B, T, H) f32 positive step sizes (softplus applied), contiguous.
      a:  (H,) f32 negative decay rates.
      b, c: (B, T, G, N), x's type, G groups shared by H / G heads each.
      return_state: also return the final state S_T.
    x, b and c may be strided views (the conv output's channels) as long as
    :func:`reads` takes them.  Returns y (B, T, H, P) f32, and with
    ``return_state`` ``(y, state)`` with state (B, H, P, N) f32, on the
    current stream (no synchronisation).  Any T: the kernel treats steps
    past T as dt = 0.
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
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan reads x, b and c in {DTYPES}, got "
                         f"{x.dtype}")
    dev = x.device
    _check(x, "x", (bsz, t, h, p), dev, x.dtype, view=True)
    _check(dt, "dt", (bsz, t, h), dev)
    _check(a, "a", (h,), dev)
    _check(b, "b", (bsz, t, g, n), dev, x.dtype, view=True)
    _check(c, "c", (bsz, t, g, n), dev, x.dtype, view=True)
    y = torch.empty((bsz, t, h, p), dtype=torch.float32, device=dev)
    state = None
    if return_state:    # T = 0 leaves the zero state
        state = (torch.empty if t else torch.zeros)(
            (bsz, h, p, n), dtype=torch.float32, device=dev)
    if bsz and t and h:
        err = _entry()(
            x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(),
            a.data_ptr(), b.data_ptr(), b.stride(0), b.stride(1),
            c.data_ptr(), c.stride(0), c.stride(1), y.data_ptr(),
            state.data_ptr() if return_state else None,
            int(x.dtype == torch.bfloat16), bsz, t, h, g, p, n,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
        launches += 1
    return (y, state) if return_state else y
