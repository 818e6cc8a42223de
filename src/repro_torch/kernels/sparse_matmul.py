"""Hopper kernel wrapper: block-sparse f32 matmul over the nonzero tiles.

Replaces ``src/repro/kernels/sparse_matmul.py::sparse_matmul`` (the Pallas
TPU kernel).  The kernel is ``csrc/sparse_matmul.cu``; see its header for the
design and what bounds it.  :func:`sparse_matmul` launches it on CUDA tensors
only and raises on anything else — ``ops.sparse_dense`` owns the ``backend``
contract and the plain version (``ref.sparse_matmul_ref``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.prune import BlockSparseWeight
from repro_torch.kernels import build

# Kernel launches since import (or since a caller last reset it): the proof
# that a path really went through the kernel.
launches = 0
# Block shapes the kernel is instantiated for (csrc/sparse_matmul.cu).
BLOCKS = ((128, 128), (64, 64))


@functools.cache
def _entry():
    fn = build.library("sparse_matmul").sparse_matmul_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def sparse_matmul(x: torch.Tensor, w: BlockSparseWeight) -> torch.Tensor:
    """``x @ w`` on the card, visiting only ``w``'s nonzero tiles.

    Args:
      x: (M, K) f32 CUDA tensor, K = ``w.shape[0]``.
      w: the plan-time block-sparse weight, on the same card.
    Returns (M, N) f32, on the current stream (no synchronisation); columns
    of a block-column pruned whole are exact zeros.
    """
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"sparse_matmul runs on CUDA tensors only, got "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"sparse_matmul takes (M, {w.shape[0]}) f32 x, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if tuple(w.block) not in BLOCKS:
        raise ValueError(f"sparse_matmul has no kernel for block {w.block} "
                         f"(instantiated: {BLOCKS})")
    for name in ("col_values", "col_rows", "col_offsets"):
        if getattr(w, name).device != x.device:
            raise ValueError(f"sparse_matmul: w.{name} lies on "
                             f"{getattr(w, name).device}, x on {x.device}")
    if w.col_values.dtype != torch.float32:
        raise ValueError(f"sparse_matmul takes f32 tiles, got "
                         f"{w.col_values.dtype}")
    x = x.contiguous()
    m = x.shape[0]
    out = torch.empty((m, w.shape[1]), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    bk, bn = w.block
    err = _entry()(x.data_ptr(), w.col_values.data_ptr(),
                   w.col_rows.data_ptr(), w.col_offsets.data_ptr(),
                   out.data_ptr(), m, w.shape[0], w.shape[1], bk, bn,
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sparse_matmul launch failed: CUDA error {err}")
    launches += 1
    return out
