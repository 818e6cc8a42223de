"""Public wrappers around the port's kernels: the ``repro.kernels.ops``
counterpart for the fleet detector's two kernels.

The ``backend`` contract:

* ``"auto"`` launches the kernel for CUDA tensors and runs the plain version
  (``ref``) for CPU tensors;
* ``"kernel"`` launches the kernel and raises on CPU tensors (a CUDA kernel
  has no interpret mode);
* ``"ref"`` runs the plain version on either device.

A CUDA tensor under ``"auto"`` launches the kernel or raises: nothing falls
back quietly.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.layers import Dense, Input
from repro_torch.kernels import fused_mlp, qmatmul, ref
from repro_torch.kernels.fused_mlp import FusedLayer, FusedStack

LayerStack = Sequence[Tuple[Dict[str, torch.Tensor], str]]
BACKENDS = ("auto", "kernel", "ref")


def _use_kernel(t: torch.Tensor, backend: str, kernel: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "ref":
        return False
    if t.device.type == "cuda":
        return True
    if backend == "kernel":
        raise ValueError(
            f"backend='kernel' needs CUDA tensors: the {kernel} kernel has no "
            f"CPU mode (got a tensor on {t.device}); use backend='auto' or "
            "'ref' for the plain version")
    return False


def _per_column(v, n: int, device: torch.device) -> torch.Tensor:
    """A scalar or (n,) value as a contiguous (n,) f32 tensor on device."""
    return torch.as_tensor(v, dtype=torch.float32, device=device) \
        .broadcast_to((n,)).contiguous()


# ---------------------------------------------------------------------------
# Quantized matmul
# ---------------------------------------------------------------------------


def quantized_matmul(
    xq: torch.Tensor,
    wq: torch.Tensor,
    scale,
    bias: Optional[torch.Tensor] = None,
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """``(xq @ wq) * scale + bias`` with int accumulation, f32 out.

    Runs where ``xq`` lies.  The kernel takes int8 only; the caller quantizes
    (``serving.core._dense_batched``).
    """
    if not _use_kernel(xq, backend, "qmatmul"):
        return ref.qmatmul_ref(xq, wq, scale, bias)
    n, dev = wq.shape[1], xq.device
    return qmatmul.qmatmul(
        xq.contiguous(), wq.contiguous(), _per_column(scale, n, dev),
        None if bias is None else _per_column(bias, n, dev))


# ---------------------------------------------------------------------------
# Fused whole-MLP forward (the detector's single-launch verdict step)
# ---------------------------------------------------------------------------


def dense_stack(model, params) -> list:
    """(params, activation) per Dense node in schedule order — the
    layer-stack layout shared by ``StreamEngine``, ``sim.detector`` and
    :func:`fused_forward`."""
    return [(params[n.uid], n.layer.activation)
            for n in model.graph.nodes if isinstance(n.layer, Dense)]


def model_fusable(model, stack: LayerStack) -> bool:
    """True when ``stack`` (built from ``model``) can run as one fused
    launch: every node is Input/Dense and the stack passes :func:`can_fuse`."""
    return (all(isinstance(n.layer, (Input, Dense))
                for n in model.graph.nodes)
            and can_fuse(stack))


def _weight(p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return p["qw"] if "qw" in p else p["w"]


def fuse_reason(stack: LayerStack) -> Optional[str]:
    """None when a layer stack can run as one fused launch, else why not.

    The gate is the port kernel's own bill, not the TPU's VMEM budget or its
    lane/row granules: at most ``fused_mlp.MAX_LAYERS`` layers, element-wise
    activations, weight dtypes the kernel reads, and two f32 activation tiles
    of ``fused_mlp.BLOCK_M`` rows by the widest layer within Hopper's
    232,448 bytes of shared memory per block.
    """
    if not stack:
        return "empty layer stack"
    if len(stack) > fused_mlp.MAX_LAYERS:
        return (f"{len(stack)} layers exceed the kernel's descriptor array "
                f"of {fused_mlp.MAX_LAYERS}")
    widths = []
    for i, (p, act) in enumerate(stack):
        if act not in fused_mlp.FUSED_ACTIVATIONS:
            return (f"layer {i} activation {act!r} is not element-wise "
                    f"(fusable: {sorted(fused_mlp.FUSED_ACTIVATIONS)})")
        if "qw" in p:
            if p["qw"].ndim != 2 or "w_scale" not in p or "x_scale" not in p:
                return (f"layer {i} quantized params are malformed "
                        "(need 2-D qw with w_scale and x_scale)")
        elif "w" not in p or p["w"].ndim != 2:
            return f"layer {i} has no 2-D dense weight"
        w = _weight(p)
        if w.dtype not in fused_mlp.MODES:
            return f"layer {i} weight dtype {w.dtype} has no kernel mode"
        k, n = w.shape
        if widths and k != widths[-1]:
            return f"layer {i} takes {k} inputs but layer {i - 1} gives {widths[-1]}"
        widths += [k, n] if not widths else [n]
    smem = fused_mlp.smem_bytes(widths)
    if smem > fused_mlp.SMEM_PER_BLOCK:
        return (f"the fused kernel needs {smem} bytes of shared memory per "
                f"block (two f32 activation tiles of {fused_mlp.BLOCK_M} rows "
                f"x {max(widths)} lanes), over Hopper's "
                f"{fused_mlp.SMEM_PER_BLOCK} bytes per block")
    return None


def can_fuse(stack: LayerStack) -> bool:
    """True when a layer stack can run as one fused launch
    (:func:`fuse_reason` is the diagnosable form)."""
    return fuse_reason(stack) is None


def prepare_fused(stack: LayerStack) -> FusedStack:
    """Lay a fusable stack out for the kernel: per-column f32 bias and
    combined ``x_scale * w_scale``, the activation scale as a float, and the
    launch descriptor.  Costs a device-to-host read per quantized layer, so
    a caller that launches repeatedly (the serving engine) prepares once."""
    reason = fuse_reason(stack)
    if reason is not None:
        raise ValueError(f"layer stack is not fusable: {reason}")
    layers = []
    for p, act in stack:
        w = _weight(p)
        n, dev = w.shape[1], w.device
        bias = _per_column(p["b"] if "b" in p else 0.0, n, dev)
        if "qw" in p:
            layers.append(FusedLayer(
                w=w.contiguous(), bias=bias,
                scale=_per_column(p["x_scale"] * p["w_scale"], n, dev),
                x_scale=float(p["x_scale"]), act=act))
        else:
            layers.append(FusedLayer(
                w=w.to(torch.float32).contiguous(), bias=bias, scale=None,
                x_scale=None, act=act))
    return FusedStack(layers, source=stack)


def fused_forward(
    x: torch.Tensor,
    stack: Union[LayerStack, FusedStack],
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """Whole Dense stack in ONE launch: ``x -> outputs`` (M, N_last).

    ``stack`` is ``[(layer_params, activation), ...]`` in schedule order
    (float ``w`` or §6.1-quantized ``qw``/``w_scale``/``x_scale`` per
    layer), or that stack already laid out by :func:`prepare_fused`.  Runs
    where ``x`` lies: the ``fused_mlp`` kernel on the card, the plain
    ``ref.fused_mlp_ref`` on the CPU (see the module docstring for
    ``backend``).
    """
    prepared = stack if isinstance(stack, FusedStack) else None
    source = stack if prepared is None else prepared.source
    if prepared is None:
        reason = fuse_reason(source)
        if reason is not None:
            raise ValueError(f"layer stack is not fusable: {reason}")
    if not _use_kernel(x, backend, "fused_mlp"):
        return ref.fused_mlp_ref(x, source)
    if prepared is None:
        prepared = prepare_fused(source)
    return fused_mlp.fused_mlp(x.to(torch.float32).contiguous(), prepared)
