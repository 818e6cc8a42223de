"""Shared primitives of the LLM/SSM families (``repro.models.common``'s
counterpart), as far as the Mamba-2 path needs them.

Conventions, as in the reference: params are nested dicts of tensors, with
per-layer params **stacked** on a leading layer axis; activations compute in
``cfg.dtype`` (bf16), norms and logits in f32; every linear layer goes
through :func:`linear`, which takes the paper's §6.1 integer path when the
params carry quantized weights (SINT through ``ops.quantized_matmul``, the
``qmatmul`` kernel).  Attention, RoPE, MLP and MoE arrive with their
families (ROADMAP item 14).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.layers import TORCH_INT_TYPES
from repro_torch.core.quantize import quantize_tensor
from repro_torch.kernels import ops as kops

Params = Dict[str, Any]


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """Activation-sharding hook: the identity until meshes are ported
    (ROADMAP item 12)."""
    return x


# ---------------------------------------------------------------------------
# Linear / norm / embedding
# ---------------------------------------------------------------------------


def linear_init(generator: torch.Generator, d_in: int, d_out: int, *,
                bias: bool, quant: Optional[str],
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """One linear layer, ``N(0, 1 / d_in)`` weights drawn from ``generator``
    (on its device), quantized per channel when ``quant`` names an IEC
    integer type."""
    std = 1.0 / np.sqrt(d_in)
    w = (torch.randn((d_in, d_out), generator=generator,
                     device=generator.device) * std).to(dtype)
    if quant is None:
        p = {"w": w}
    else:
        qt = quantize_tensor(w.to(torch.float32), quant)
        p = {"qw": qt.q, "w_scale": qt.scale,
             "x_scale": torch.tensor(1.0 / 127.0, dtype=torch.float32,
                                     device=w.device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=w.device)
    return p


def linear(p: Params, x: torch.Tensor, *, backend: kops.Backend = "auto"
           ) -> torch.Tensor:
    """Apply a (possibly integer-quantized) linear layer to (..., d_in)."""
    if "qw" in p:
        qw = p["qw"]
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        # Symmetric clip, matching quantize_tensor's weight range.
        qmax = float(torch.iinfo(qw.dtype).max)
        xq = torch.clamp(torch.round(x2 / p["x_scale"]), -qmax, qmax)
        scale = p["x_scale"] * p["w_scale"]
        if qw.dtype == TORCH_INT_TYPES["SINT"]:
            # SINT: int8 x int8 -> int32 products (the qmatmul kernel).
            y = kops.quantized_matmul(xq.to(qw.dtype), qw, scale, p.get("b"),
                                      backend=backend)
        else:
            # INT/DINT: emulated in f32 on the integer grid (int16/int32
            # products would overflow int32 accumulation), as the reference.
            y = xq @ qw.to(torch.float32) * scale
            if p.get("b") is not None:
                y = y + p["b"]
        return y.reshape(*lead, qw.shape[-1]).to(x.dtype)
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(d: int, device: torch.device) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * p["g"]).to(x.dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.bfloat16) -> Params:
    return {"emb": (torch.randn((vocab, d), generator=generator,
                                device=generator.device) * 0.02).to(dtype)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["emb"][tokens]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits in f32 for a stable softmax."""
    return torch.einsum("bsd,vd->bsv", x, p["emb"]).to(torch.float32)
