"""Hopper kernel wrappers: a whole Dense stack, or a whole heterogeneous
fleet of them, in ONE launch.

Replaces ``src/repro/kernels/fused_mlp.py::fused_mlp`` (the Pallas TPU
kernel behind ``ops.fused_forward``); the kernel is ``csrc/fused_mlp.cu``,
whose header gives the design, the numerics and what bounds it.  A block
owns a tile of rows, reads its input once and keeps every activation on
chip; only the last layer's rows are written back.  Two paths, chosen at
plan time (:func:`path`): ``INT8_MMA`` when every layer is int8 (SINT):
int8 codes in shared memory, products on the tensor cores from a K-major,
zero-padded int8 copy of each weight made here once, epilogues that
requantize in registers; ``F32_TILE`` otherwise: f32 tiles and CUDA-core
dots.

A stack is described once (:class:`FusedStack`: device tensors, the K-major
copies and the fixed-size descriptor array the launch passes by value) and
launched many times by :func:`fused_mlp`, which runs on CUDA tensors only.
The ``backend`` contract and the plain version live in ``ops.fused_forward``
and ``ref.fused_mlp_ref``.

The grouped kernel (``csrc/grouped_mlp.cu``, replacing the reference's
``grouped_fused_mlp``) runs a G-group fleet the same way, each group at its
true widths: a fleet is laid out once (:class:`GroupedStack`: per-position
(G, K, N) arenas, their K-major copies, the per-group ``meta`` table with
the true widths and the descriptor) and launched by
:func:`grouped_fused_mlp`; ``ops.grouped_apply`` holds its ``backend``
contract and ``ref.grouped_mlp_ref`` its plain version.
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

# Activation ids of csrc/grouped_mlp.cu's `enum GroupedAct`: every
# activation, softmax included (legal as a group's final layer, where the
# kernel masks it to the group's true width), numbered in sorted order as
# the reference's table is.
GROUPED_ACT_IDS = {name: i for i, name in enumerate(sorted(ACTIVATIONS))}

# Grouped-payload kinds: what the kernel's epilogue writes per group.
GROUPED_KIND_LOGITS = 0     # classifier: the final activations themselves
GROUPED_KIND_SCORE = 1      # score head: mean squared error vs the target

# Weight dtype -> csrc/mlp_common.cuh's `enum Mode`.
MODES = {torch.float32: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3}

MAX_LAYERS = 8          # the descriptor arrays' fixed length
BLOCK_M = 8             # rows per thread block (csrc/mlp_common.cuh)
GROUPED_ROWS = 16       # rows per block of the grouped int8_mma kernel
MMA_K, MMA_N = 32, 8    # mma.sync m16n8k32: the depth and width granules
# The int8 code tiles' row padding: a row stride of round32(K) + 16 bytes
# puts the 8 rows of an A fragment on distinct shared-memory banks.
CODE_PAD = 16

# Static shared memory of the int8 kernels: their step tables, one 56-byte
# Step (csrc/mlp_common.cuh) per layer or position.
STEPS_BYTES = MAX_LAYERS * 56

# The two paths (:func:`path`).
INT8_MMA = "int8_mma"   # every layer int8: tensor-core products, int8 codes
F32_TILE = "f32_tile"   # any REAL/INT16/INT32 layer: f32 tiles, CUDA cores
# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_PER_BLOCK = 232_448

# Kernel launches since import (or since a caller last reset them): the
# proof that a serving path really went through the kernel.
launches = 0            # fused_mlp
grouped_launches = 0    # grouped_fused_mlp


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


def _round_up(v: int, granule: int) -> int:
    return -(-v // granule) * granule


def path(stack) -> str:
    """The kernel path a stack runs: :data:`INT8_MMA` when every layer (or
    layer position) has int8 weights, else :data:`F32_TILE`.  ``stack`` is a
    :class:`FusedStack`, a :class:`GroupedStack`, or the weight dtypes of
    its layers (the plan-time gates' form).  A routing choice made in the
    open, like ``qmatmul.path(m)``: both paths are hand-written kernels."""
    if isinstance(stack, (FusedStack, GroupedStack)):
        dtypes = [layer.w.dtype for layer in stack.layers]
    else:
        dtypes = list(stack)
    return INT8_MMA if all(d == torch.int8 for d in dtypes) else F32_TILE


def code_stride(widths: Sequence[int]) -> int:
    """Row stride in bytes of the int8 code tiles for layers whose input
    widths are ``widths``: the widest, rounded up to the MMA depth, plus
    :data:`CODE_PAD`."""
    return _round_up(max(widths), MMA_K) + CODE_PAD


def smem_bytes(widths: Sequence[int], path: str = F32_TILE) -> int:
    """The fused kernel's shared-memory bill per block, for ``widths`` (the
    stack's input width, then every layer's output width).

    :data:`F32_TILE`: two f32 activation tiles (the current layer's input
    and its output) of :data:`BLOCK_M` rows by the widest width.
    :data:`INT8_MMA`: two int8 code tiles of :data:`BLOCK_M` rows by
    :func:`code_stride` of the layers' input widths (all but the last
    width: the last layer writes f32 from registers), and the step table."""
    if path == INT8_MMA:
        return 2 * BLOCK_M * code_stride(widths[:-1]) + STEPS_BYTES
    return 2 * BLOCK_M * max(widths) * 4


def kmajor_int8(w: torch.Tensor) -> torch.Tensor:
    """The tensor cores' copy of an int8 weight (or arena): ``(..., K, N)``
    -> ``(..., round8(N), round32(K))``, transposed so that each output
    column's K codes are contiguous (the B fragments' layout), and zero in
    every pad (rows past N, lanes past K), so a padded product adds exact
    zeros."""
    *lead, k, n = w.shape
    out = w.new_zeros((*lead, _round_up(n, MMA_N), _round_up(k, MMA_K)))
    out[..., :n, :k] = w.transpose(-1, -2)
    return out


class _LayerDesc(ctypes.Structure):
    """csrc/fused_mlp.cu's `struct LayerDesc`, field for field."""

    _fields_ = [("w", ctypes.c_void_p), ("wt", ctypes.c_void_p),
                ("scale", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("x_scale", ctypes.c_float), ("k", ctypes.c_int),
                ("n", ctypes.c_int), ("mode", ctypes.c_int),
                ("act", ctypes.c_int), ("qmax", ctypes.c_float)]


class _MlpDesc(ctypes.Structure):
    """csrc/fused_mlp.cu's `struct MlpDesc`."""

    _fields_ = [("n_layers", ctypes.c_int),
                ("layers", _LayerDesc * MAX_LAYERS)]


class FusedStack:
    """A validated stack of :class:`FusedLayer` plus its launch descriptor.

    ``path`` is the kernel path (:func:`path`); on :data:`INT8_MMA`, ``wt``
    holds each layer's :func:`kmajor_int8` copy (None on :data:`F32_TILE`).
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
        self.path = path([layer.w.dtype for layer in layers])
        self.wt = tuple(kmajor_int8(layer.w) if self.path == INT8_MMA
                        else None for layer in layers)
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
                wt=None if self.wt[i] is None else self.wt[i].data_ptr(),
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
        widths = [self.k0] + [layer.w.shape[1] for layer in layers]
        self.width = max(widths)
        # The tile row stride the launch passes: bytes of int8 codes, or
        # f32 lanes.
        self.ld = (code_stride(widths[:-1]) if self.path == INT8_MMA
                   else self.width)
        self.smem_bytes = smem_bytes(widths, self.path)
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
    err = _entry()(x.data_ptr(), out.data_ptr(), m,
                   int(stack.path == INT8_MMA), stack.ld,
                   ctypes.addressof(stack.desc),
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_mlp launch failed: CUDA error {err}")
    launches += 1
    return out


# ---------------------------------------------------------------------------
# Grouped kernel: a whole heterogeneous fleet in ONE launch
# ---------------------------------------------------------------------------


class GroupedLayer(NamedTuple):
    """One layer *position* of the packed fleet (``ops.build_grouped_plan``'s
    arenas, the reference's layout).

    ``w``: (G, K, N) weights, one dtype per position (f32/int8/int16/int32).
    ``bias``: (G, 1, N) f32; ``scale``: (G, 1, N) f32 combined
    ``x_scale * w_scale`` (zeros on real and skip slots); ``x_scale``: (G, 1)
    f32 activation scales (ones on real and skip slots).
    """

    w: torch.Tensor
    bias: torch.Tensor
    scale: torch.Tensor
    x_scale: torch.Tensor


def grouped_smem_bytes(k0: int, widths: Sequence[int], path: str = F32_TILE,
                       n_out: Optional[int] = None) -> int:
    """The grouped kernel's shared-memory bill per block, for the fleet's
    union input width ``k0`` and every position's union output width.

    :data:`F32_TILE`: two f32 activation tiles of :data:`BLOCK_M` rows by
    the widest union width.  :data:`INT8_MMA`: two int8 code tiles of
    :data:`GROUPED_ROWS` rows by :func:`code_stride` of the positions' union
    input widths, one f32 tile of :data:`GROUPED_ROWS` rows by ``n_out``
    (the widest group's true output width; default the last union width)
    that each group's last layer writes for the head epilogue, and the step
    table."""
    if path == INT8_MMA:
        fld = widths[-1] if n_out is None else n_out
        return (2 * GROUPED_ROWS * code_stride([k0, *widths[:-1]])
                + GROUPED_ROWS * fld * 4 + STEPS_BYTES)
    return smem_bytes([k0, *widths])


class _PositionDesc(ctypes.Structure):
    """csrc/grouped_mlp.cu's `struct PositionDesc`, field for field."""

    _fields_ = [("w", ctypes.c_void_p), ("wt", ctypes.c_void_p),
                ("scale", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("x_scale", ctypes.c_void_p), ("k", ctypes.c_int),
                ("n", ctypes.c_int), ("mode", ctypes.c_int),
                ("qmax", ctypes.c_float)]


class _GroupedDesc(ctypes.Structure):
    """csrc/grouped_mlp.cu's `struct GroupedDesc`."""

    _fields_ = [("n_layers", ctypes.c_int), ("n_pay", ctypes.c_int),
                ("meta", ctypes.c_void_p),
                ("pos", _PositionDesc * MAX_LAYERS)]


class GroupedStack:
    """A validated packed fleet plus its launch descriptor.

    ``layers``: one :class:`GroupedLayer` per position; ``meta``: the
    (G, 2 + 4L) int32 kernel table ``[kind, n_out, act_id x L, skip x L,
    k x L, n x L]`` per group (``GROUPED_ACT_IDS``, ``GROUPED_KIND_*``; k and
    n are the group's true widths per position: ``ops.build_grouped_plan``'s
    ``kernel_meta``); ``n_pay``: payload lanes per row.  ``path`` is the
    kernel path (:func:`path`); on :data:`INT8_MMA`, ``wt`` holds each
    position's :func:`kmajor_int8` arena copy.  The descriptor holds raw
    device pointers; this object keeps the tensors they point into alive.
    """

    def __init__(self, layers: Sequence[GroupedLayer], meta: torch.Tensor,
                 n_pay: int):
        if not layers:
            raise ValueError("grouped_fused_mlp needs at least one position")
        if len(layers) > MAX_LAYERS:
            raise ValueError(f"grouped_fused_mlp takes at most {MAX_LAYERS} "
                             f"positions, got {len(layers)}")
        device = layers[0].w.device
        n_groups, k0, _ = layers[0].w.shape
        n_layers = len(layers)
        if meta.shape != (n_groups, 2 + 4 * n_layers) \
                or meta.dtype != torch.int32 or meta.device != device \
                or not meta.is_contiguous():
            raise ValueError(
                f"meta must be a contiguous int32 ({n_groups}, "
                f"{2 + 4 * n_layers}) tensor on {device}, got {meta.dtype} "
                f"{tuple(meta.shape)} on {meta.device}")
        desc = _GroupedDesc(n_layers=n_layers, n_pay=n_pay,
                            meta=meta.data_ptr())
        self.path = path([layer.w.dtype for layer in layers])
        self.wt = tuple(kmajor_int8(layer.w) if self.path == INT8_MMA
                        else None for layer in layers)
        prev = k0
        for l, layer in enumerate(layers):
            g, k, n = layer.w.shape
            if g != n_groups or k != prev:
                raise ValueError(f"position {l}: arena {tuple(layer.w.shape)}"
                                 f" does not follow ({n_groups}, {prev}, N)")
            if layer.w.dtype not in MODES:
                raise ValueError(f"position {l}: weight dtype "
                                 f"{layer.w.dtype} has no kernel mode")
            for name, t, shape in (("bias", layer.bias, (g, 1, n)),
                                   ("scale", layer.scale, (g, 1, n)),
                                   ("x_scale", layer.x_scale, (g, 1))):
                if t.shape != shape or t.dtype != torch.float32:
                    raise ValueError(f"position {l}: {name} must be f32 "
                                     f"{shape}, got {t.dtype} "
                                     f"{tuple(t.shape)}")
            for t in layer:
                if t.device != device or not t.is_contiguous():
                    raise ValueError(f"position {l}: every tensor must be "
                                     f"contiguous on {device}")
            quantized = _layer_mode(layer.w.dtype) != "real"
            desc.pos[l] = _PositionDesc(
                w=layer.w.data_ptr(),
                wt=None if self.wt[l] is None else self.wt[l].data_ptr(),
                scale=layer.scale.data_ptr(),
                bias=layer.bias.data_ptr(), x_scale=layer.x_scale.data_ptr(),
                k=k, n=n, mode=MODES[layer.w.dtype],
                qmax=float(torch.iinfo(layer.w.dtype).max) if quantized
                else 0.0)
            prev = n
        if not 1 <= n_pay <= prev:
            raise ValueError(f"n_pay must be in [1, {prev}], got {n_pay}")
        self.layers = tuple(layers)
        self.meta = meta
        self.desc = desc
        self.device = device
        self.n_groups = n_groups
        self.k0 = k0
        self.n_last = prev
        self.n_pay = n_pay
        widths = [layer.w.shape[2] for layer in layers]
        self.width = max([k0] + widths)
        # The widest true output of a group (meta's n_out column): the f32
        # tile the int8 path's head epilogue reads.
        self.n_out = int(meta[:, 1].max())
        if self.path == INT8_MMA:
            self.ld = code_stride([k0, *widths[:-1]])
            self.fld = self.n_out
        else:
            self.ld, self.fld = self.width, 0
        self.smem_bytes = grouped_smem_bytes(k0, widths, self.path,
                                             self.n_out)
        if self.smem_bytes > SMEM_PER_BLOCK:
            raise ValueError(
                f"grouped fleet needs {self.smem_bytes} bytes of shared "
                f"memory per block (> {SMEM_PER_BLOCK})")



@functools.cache
def _grouped_entry():
    fn = build.library("grouped_mlp").grouped_mlp_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def grouped_fused_mlp(x: torch.Tensor, stack: GroupedStack,
                      tgt: torch.Tensor) -> torch.Tensor:
    """Run a whole packed fleet as ONE kernel launch.

    Args:
      x: (G, M, K0) contiguous f32 CUDA tensor: every group's window rows at
        the union input width.  M is any size: the ragged last tile is
        masked in the kernel.
      stack: the :class:`GroupedStack` to run.
      tgt: (G, M, N_last) contiguous f32: the score heads' targets at the
        last position's union width (zeros for classifiers).
    Returns (G, M, n_pay) f32 payloads, on the current stream (no
    synchronisation): a logits group's final activations (zeros past its
    true width), a score group's masked mean squared error in lane 0.
    """
    global grouped_launches
    if x.device.type != "cuda":
        raise ValueError(
            f"grouped_fused_mlp runs on CUDA tensors only, got {x.device}")
    g, m = stack.n_groups, x.shape[1] if x.ndim == 3 else -1
    for name, t, width in (("x", x, stack.k0), ("tgt", tgt, stack.n_last)):
        if t.device != stack.device or t.dtype != torch.float32 \
                or tuple(t.shape) != (g, m, width) or not t.is_contiguous():
            raise ValueError(
                f"grouped_fused_mlp: {name} must be a contiguous f32 "
                f"({g}, M, {width}) tensor on {stack.device} (M from x), "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((g, m, stack.n_pay), dtype=torch.float32,
                      device=x.device)
    if m == 0:
        return out
    err = _grouped_entry()(
        x.data_ptr(), tgt.data_ptr(), out.data_ptr(), m, g,
        int(stack.path == INT8_MMA), stack.ld, stack.fld,
        ctypes.addressof(stack.desc),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"grouped_fused_mlp launch failed: CUDA error {err}")
    grouped_launches += 1
    return out
