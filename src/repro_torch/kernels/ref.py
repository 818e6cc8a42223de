"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``'s
counterpart).

Each ``*_ref`` is the transparent implementation a kernel must match.  They
are what ``backend='ref'`` and every CPU tensor run, and what the card's
kernels are held against.  SINT products are exact (float64 matmul of the
codes, :func:`~repro_torch.core.layers.int_matmul`), and every rescale and
bias add is its own eagerly dispatched op, so nothing contracts them into an
FMA.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.layers import ACTIVATIONS, int_matmul, quantized_matvec


def qmatmul_ref(
    xq: torch.Tensor,
    wq: torch.Tensor,
    scale,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Integer matmul + REAL rescale + bias, f32 out (§6.1 arithmetic)."""
    acc = int_matmul(xq, wq)
    out = acc.to(torch.float32) * torch.as_tensor(
        scale, dtype=torch.float32, device=acc.device)
    if bias is not None:
        out = out + bias
    return out


def dense_layer_ref(x: torch.Tensor, p: Dict[str, torch.Tensor],
                    act: str) -> torch.Tensor:
    """One Dense layer over an (M, K) batch, float or quantized (§6.1,
    :func:`~repro_torch.core.layers.quantized_matvec`'s semantics)."""
    if "qw" in p:
        y = quantized_matvec(x, p)
    else:
        y = x @ p["w"]
        if "b" in p:
            y = y + p["b"]
    return ACTIVATIONS[act](y)


def fused_mlp_ref(
    x: torch.Tensor,
    stack: Sequence[Tuple[Dict[str, torch.Tensor], str]],
) -> torch.Tensor:
    """Whole Dense stack, layer by layer — the fused kernel's plain version.
    ``stack`` is ``[(layer_params, activation_name), ...]`` in schedule
    order."""
    for p, act in stack:
        x = dense_layer_ref(x, p, act)
    return x
