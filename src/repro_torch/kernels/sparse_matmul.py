"""Hopper kernel wrapper: block-sparse f32 matmul over the nonzero tiles.

Replaces ``src/repro/kernels/sparse_matmul.py::sparse_matmul`` (the Pallas
TPU kernel).  The kernel is ``csrc/sparse_matmul.cu``; see its header for the
design and what bounds it.  :func:`sparse_matmul` launches it on CUDA tensors
only and raises on anything else — ``ops.sparse_dense`` owns the ``backend``
contract and the plain version (``ref.sparse_matmul_ref``).  :func:`plan`
picks the kernel's path from M and gives the grid the launcher derives.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.prune import BlockSparseWeight
from repro_torch.kernels import build

# Kernel launches since import (or since a caller last reset it): the proof
# that a path really went through the kernel.
launches = 0
# Block shapes the kernel is instantiated for (csrc/sparse_matmul.cu).
BLOCKS = ((128, 128), (64, 64))
# The largest M that takes the small-M path (csrc/sparse_matmul.cu).
SMALL_M_MAX = 32


def _tiles() -> Dict[str, Tuple[int, int]]:
    """(columns, rows of x) per thread block of each path, read from the
    one place they are set: the SMALL_/LARGE_COLS and _ROWS defines of
    csrc/sparse_matmul.cu."""
    source = (build.CSRC / "sparse_matmul.cu").read_text()
    value = {name: int(v) for name, v in
             re.findall(r"^#define (\w+) (\d+)", source, re.M)}
    return {path: (value[f"{path.upper()}_COLS"],
                   value[f"{path.upper()}_ROWS"])
            for path in ("small", "large")}


TILES = _tiles()


class Launch(NamedTuple):
    """One call's schedule.  ``"small"``: block (x, y) writes columns
    ``[x * cols, (x + 1) * cols)`` of rows ``[y * rows, (y + 1) * rows)``,
    summing its block-column's whole run of tiles.  ``"large"``: block
    (x, y) takes piece ``x // slices`` of the work list
    (``BlockSparseWeight.col_pieces``) and column slice ``x % slices`` of
    that piece's block-column, for rows ``[y * rows, (y + 1) * rows)``; a
    column whose run is cut into pieces is summed by its last block."""
    path: str                 # "small" or "large"
    cols: int
    rows: int
    grid: Tuple[int, int]


def plan(m: int, w: BlockSparseWeight) -> Launch:
    """The path and grid of an (m, K) @ ``w`` call: ``"small"`` (4-column
    slices, the run's rows split across the threads) up to
    :data:`SMALL_M_MAX` rows, ``"large"`` (64 x 64 register-blocked tiles
    over the work list's pieces) above."""
    path = "small" if m <= SMALL_M_MAX else "large"
    cols, rows = TILES[path]
    n, bn = w.shape[1], w.block[1]
    slices = n // cols if path == "small" else \
        len(w.col_pieces) * (bn // cols)
    return Launch(path, cols, rows, (slices, -(-m // rows)))


# Per (device, stream): the large path's split-run counters, kept at 0
# between calls (the kernel resets what it counts), grown when a call needs
# more.  Calls on one stream run one after another, so they never share
# counters while they run; calls on two streams get two buffers.  A kernel
# that faults leaves the CUDA context unusable, so counters it left
# non-zero are never read by a later call: that call raises instead.
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _counters_for(stream: torch.cuda.Stream, size: int) -> torch.Tensor:
    key = (stream.device, stream.cuda_stream)
    held = _counters.get(key)
    if held is None or held.numel() < size:
        with torch.cuda.stream(stream):
            held = _counters[key] = torch.zeros(max(size, 1024),
                                                dtype=torch.int32,
                                                device=stream.device)
    return held


@functools.cache
def _entry():
    fn = build.library("sparse_matmul").sparse_matmul_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
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
    for name in ("col_values", "col_rows", "col_offsets", "col_pieces"):
        if getattr(w, name).device != x.device:
            raise ValueError(f"sparse_matmul: w.{name} lies on "
                             f"{getattr(w, name).device}, x on {x.device}")
    if w.col_values.dtype != torch.float32:
        raise ValueError(f"sparse_matmul takes f32 tiles, got "
                         f"{w.col_values.dtype}")
    x = x.contiguous()
    if x.data_ptr() % 16:           # the kernels read x as float4
        x = x.clone()
    m = x.shape[0]
    out = torch.empty((m, w.shape[1]), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    (bk, bn), launch = w.block, plan(m, w)
    stream = torch.cuda.current_stream(x.device)
    partial = counters = None
    if launch.path == "large":
        gy = launch.grid[1]
        partial = torch.empty(len(w.col_pieces) * gy * launch.rows * bn,
                              dtype=torch.float32, device=x.device)
        counters = _counters_for(stream, w.shape[1] // launch.cols * gy)
    err = _entry()(x.data_ptr(), w.col_values.data_ptr(),
                   w.col_rows.data_ptr(), w.col_offsets.data_ptr(),
                   w.col_pieces.data_ptr(),
                   None if partial is None else partial.data_ptr(),
                   None if counters is None else counters.data_ptr(),
                   out.data_ptr(), m, w.shape[0], w.shape[1], bk, bn,
                   launch.path == "large", len(w.col_pieces),
                   stream.cuda_stream)
    if err:
        raise RuntimeError(f"sparse_matmul launch failed: CUDA error {err}")
    launches += 1
    return out
