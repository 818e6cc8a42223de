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


def grouped_mlp_ref(
    x: torch.Tensor,
    stacks: Sequence[Sequence[Tuple[Dict[str, torch.Tensor], str]]],
    *,
    kinds: Sequence[int],
    true_k0s: Sequence[int],
    n_outs: Sequence[int],
    tgt: torch.Tensor,
    n_pay: int,
) -> torch.Tensor:
    """The grouped kernel's plain version: per-group true-dimension math.

    Each group's rows ``x[g]`` are cut to the group's true input width and
    run through its OWN stack with :func:`dense_layer_ref` (a softmax runs
    at the true width), then reduced by the head epilogue: ``kind`` 0
    (logits) passes the final activations through, ``kind`` 1 (score)
    writes ``mean((h - tgt)^2)`` over the group's true output lanes into
    payload lane 0.  Returns (G, M, n_pay) f32, zero-padded lanes.  The op
    sequence is the per-group serving path's, so it matches it bit for bit.
    """
    pays = []
    for g, stack in enumerate(stacks):
        h = x[g][:, :true_k0s[g]]
        for p, act in stack:
            h = dense_layer_ref(h, p, act)
        if kinds[g] == 0:
            pay = h
        else:
            pay = torch.mean(torch.square(h - tgt[g][:, :n_outs[g]]),
                             dim=-1)[:, None]
        pays.append(torch.nn.functional.pad(pay, (0, n_pay - pay.shape[1])))
    return torch.stack(pays)
