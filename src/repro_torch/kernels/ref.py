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
from repro_torch.core.prune import BlockSparseWeight


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


def sparse_matmul_ref(x: torch.Tensor, w: BlockSparseWeight) -> torch.Tensor:
    """Dense reference for the block-sparse matmul: ``x @ densify(w)``."""
    return x @ w.to_dense()


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Sequential (step-by-step) SSD recurrence — the ground-truth scan.

      S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * (x_t ⊗ B_t);  y_t = C_t · S_t

    x (..., T, H, P), dt (..., T, H), a (H,), b/c (..., T, H, N): one
    sequence, or a batch of them stepped together (any leading dims);
    returns y (..., T, H, P).
    """
    h, p = x.shape[-2:]
    state = torch.zeros(x.shape[:-3] + (h, p, b.shape[-1]),
                        dtype=torch.float32, device=x.device)
    ys = []
    for i in range(x.shape[-3]):
        state, y = ssd_update_ref(state, x[..., i, :, :], dt[..., i, :], a,
                                  b[..., i, :, :], c[..., i, :, :])
        ys.append(y)
    return torch.stack(ys, dim=-3)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor,
                    chunk: int = 128) -> torch.Tensor:
    """Chunk-parallel SSD over one sequence (the kernel's math, eager torch).

    The intra-chunk work is batched matmuls over all chunks at once; only a
    (H, P, N) state crosses chunks, in a short loop.  T must divide by
    ``chunk``.
    """
    t, h, p = x.shape
    n = b.shape[-1]
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of chunk={chunk}")
    nc = t // chunk
    xc = x.reshape(nc, chunk, h, p)
    dtc = dt.reshape(nc, chunk, h)
    bc = b.reshape(nc, chunk, h, n)
    cc = c.reshape(nc, chunk, h, n)

    alpha = dtc * a                                   # (nc, L, H)
    s = torch.cumsum(alpha, dim=1)                    # (nc, L, H)
    s_tot = s[:, -1]                                  # (nc, H)

    # Intra-chunk (no state dependency: all chunks at once).  Masked to
    # -inf before the exponent, so the upper triangle is exactly 0.
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ds = s[:, :, None, :] - s[:, None, :, :]
    decay = torch.exp(torch.where(mask[None, :, :, None], ds,
                                  torch.tensor(float("-inf"),
                                               device=x.device)))
    cb = torch.einsum("clhn,cmhn->clmh", cc, bc)
    y_intra = torch.einsum("clmh,cmh,cmhp->clhp", decay * cb, dtc, xc)

    # Chunk contributions to the carried state.
    w = torch.exp(s_tot[:, None, :] - s) * dtc        # (nc, L, H)
    contrib = torch.einsum("clh,clhp,clhn->chpn", w, xc, bc)

    state = torch.zeros((h, p, n), dtype=torch.float32, device=x.device)
    y_inter = []
    for i in range(nc):
        # inter-chunk output: the prior state read through the decayed C
        y_inter.append(torch.exp(s[i])[..., None] * torch.einsum(
            "lhn,hpn->lhp", cc[i], state))
        state = torch.exp(s_tot[i])[:, None, None] * state + contrib[i]
    return (y_intra + torch.stack(y_inter)).reshape(t, h, p)


def ssd_final_state_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """The final SSM state S_T of a batch of scans — the plain version of
    the kernel's second output.

    The recurrence's contribution sum (exact, O(T)):
    S_T = sum_τ exp(sum_{σ>τ} dt_σ A) dt_τ (x_τ ⊗ B_τ), contracted per group
    (no repeat of B to heads).  x (B, T, H, P), dt (B, T, H), a (H,),
    b (B, T, G, N), f32; returns (B, H, P, N).  Steps with dt = 0 (a
    zero-padded tail) leave it unchanged.
    """
    bsz, t, h, p = x.shape
    g, n = b.shape[2:]
    alpha = dt * a                                          # (B, T, H)
    srev = torch.flip(torch.cumsum(torch.flip(alpha, (1,)), dim=1), (1,))
    w = torch.exp(srev - alpha) * dt                        # exp(Σ_{σ>τ} α) dt_τ
    r = h // g
    return torch.einsum("bsgr,bsgrp,bsgn->bgrpn", w.reshape(bsz, t, g, r),
                        x.reshape(bsz, t, g, r, p), b).reshape(bsz, h, p, n)


def ssd_update_ref(state: torch.Tensor, xt: torch.Tensor, dtt: torch.Tensor,
                   a: torch.Tensor, bt: torch.Tensor, ct: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD step (the decode path): returns ``(new_state, y_t)``.

    state (..., H, P, N), xt (..., H, P), dtt (..., H), a (H,), bt/ct
    (..., H, N): any leading batch dimensions.
    """
    decay = torch.exp(dtt * a)[..., None, None]
    state = decay * state + (dtt[..., None] * xt)[..., None] \
        * bt[..., None, :]
    yt = torch.einsum("...hpn,...hn->...hp", state, ct)
    return state, yt


def norm_codes_ref(x: torch.Tensor, g: torch.Tensor, x_scale: torch.Tensor,
                   *, xs: Optional[torch.Tensor] = None,
                   d_skip: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None,
                   eps: float = 1e-6) -> torch.Tensor:
    """The int8 SINT codes (M, W) of an RMSNorm that feeds a projection, as
    the eager ops compose them (``common.rmsnorm`` then ``common.linear``'s
    quantize, or ``models.mamba2._gated_out``): u = x (..., W) in the
    working type or, for the gated norm (``xs``, ``d_skip`` and ``z``
    together), ``(x + d_skip * xs) * silu(z)`` (``x`` f32, ``d_skip`` (H,)
    one value per head of W / H columns, the sum cast to xs's type); then
    ``n = rmsnorm(u) * g`` cast back and ``clamp(round(n / x_scale), -127,
    127)``."""
    if xs is not None:
        lead, h = x.shape[:-1], d_skip.shape[0]
        x = (x.reshape(*lead, h, -1) + d_skip[:, None]
             * xs.reshape(*lead, h, -1)).reshape(x.shape).to(xs.dtype)
        x = x * torch.nn.functional.silu(z)
    xf = x.to(torch.float32)
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    n = (n * g).to(x.dtype)
    codes = torch.round(n.reshape(-1, n.shape[-1]).to(torch.float32)
                        / x_scale)
    return torch.clamp(codes, -127.0, 127.0).to(torch.int8)
