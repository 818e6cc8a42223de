"""Mamba-2 (SSD) blocks and the attention-free mamba2-370m model
[arXiv:2405.21060]: ``repro.models.mamba2``'s counterpart.

Block: in_proj → causal depthwise conv (xBC) → SSD scan → gated RMSNorm →
out_proj.  The full-sequence passes (:func:`forward_logits`, :func:`prefill`)
run the SSD through ``ops.ssd`` — the hand-written ``ssd_scan`` kernel on the
card, one launch per layer for the whole batch, reading x, B and C in place
from the conv output; :func:`prefill` takes each layer's final SSM state
from that same launch.  Decode carries (conv, ssm)
state per sequence and runs plain tensor ops (the reference's
``ssd_update_ref``, no kernel).  The in/out projections are quantizable
(§6.1) through ``common.linear``; the scan stays f32.

The layer stack is a Python loop over layers whose params are stacked on a
leading ``n_layers`` axis (the reference's tree, so ``repro_torch.bridge``
loads it leaf for leaf); each layer reads views of its slice.  ``backend``
(``ops.Backend``) is passed to every kernel wrapper on the path.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import common as cm

Params = Dict[str, Any]


def _dims(cfg: ArchConfig):
    d_inner = cfg.d_inner
    h = cfg.ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    conv_dim = d_inner + 2 * g * n
    proj_out = 2 * d_inner + 2 * g * n + h   # z, xBC, dt
    return d_inner, h, g, n, conv_dim, proj_out


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float
             ) -> torch.Tensor:
    return torch.rand((n,), generator=generator, device=generator.device) \
        * (hi - lo) + lo


def mamba_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    """One mixer's params, drawn from ``generator`` on its device."""
    d_inner, h, g, n, conv_dim, proj_out = _dims(cfg)
    dev = generator.device
    return {
        "in_proj": cm.linear_init(generator, cfg.d_model, proj_out,
                                  bias=False, quant=cfg.quant,
                                  dtype=cfg.dtype),
        "conv_w": (torch.randn((cfg.conv_kernel, conv_dim),
                               generator=generator, device=dev)
                   / np.sqrt(cfg.conv_kernel)).to(cfg.dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32, device=dev),
        # softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1]
        "dt_bias": torch.log(torch.expm1(torch.exp(
            _uniform(generator, h, np.log(1e-3), np.log(1e-1))))),
        "a_log": torch.log(torch.exp(_uniform(generator, h, 0.0,
                                              np.log(16.0)))),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm": cm.rmsnorm_init(d_inner, dev),
        "out_proj": cm.linear_init(generator, d_inner, cfg.d_model,
                                   bias=False, quant=cfg.quant,
                                   dtype=cfg.dtype),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    d_inner, h, g, n, conv_dim, _ = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xbc, dt


def _causal_conv(p: Params, xbc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C): left pad K - 1, one filter per
    channel (a cross-correlation, as ``lax.conv_general_dilated``).  The
    result is (B, S, C) contiguous: the bias add writes it so, and the SSD
    then reads its channels in place."""
    if isinstance(xbc, DTensor):
        # No two batch rows meet in the conv: each rank takes its own.
        return kops.rowwise(
            lambda x, w, b: _causal_conv({"conv_w": w, "conv_b": b}, x),
            (xbc,), (p["conv_w"], p["conv_b"]))
    k, c = p["conv_w"].shape
    w = p["conv_w"].to(xbc.dtype).t().unsqueeze(1)        # (C, 1, K)
    y = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)), w, groups=c)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xbc, p["conv_w"], p["conv_b"])):
        # Autograd takes neither an out= argument nor an in-place SiLU of
        # the tensor its backward reads: the same values, out of place.
        return F.silu(y.transpose(1, 2) + p["conv_b"].to(xbc.dtype))
    out = torch.empty(xbc.shape, dtype=xbc.dtype, device=xbc.device)
    torch.add(y.transpose(1, 2), p["conv_b"].to(xbc.dtype), out=out)
    return F.silu(out, inplace=True)


def _mixer_inputs(p: Params, cfg: ArchConfig, xbc: torch.Tensor,
                  dt_raw: torch.Tensor):
    """(xs, B, C, dt, A) of the SSD from the conv's output: xs, B and C are
    views of it in its own type (``ops.ssd`` reads them where they lie),
    dt and A f32."""
    d_inner, h, g, n, _, _ = _dims(cfg)
    b, s, _ = xbc.shape
    xs = xbc[..., :d_inner].reshape(b, s, h, cfg.ssm_headdim)
    bmat = xbc[..., d_inner:d_inner + g * n].reshape(b, s, g, n)
    cmat = xbc[..., d_inner + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    return xs, bmat, cmat, dt, a


def _gated_out(p: Params, cfg: ArchConfig, y: torch.Tensor,
               xs: torch.Tensor, z: torch.Tensor, backend: kops.Backend
               ) -> torch.Tensor:
    """D skip, gated RMSNorm and out_proj over the SSD's output (f32 ``y``;
    ``xs`` in the working type, promoted exactly to f32 by the skip)."""
    b, s = z.shape[:2]
    y = y + p["d_skip"][None, None, :, None] * xs
    y = y.reshape(b, s, cfg.d_inner).to(cfg.dtype)
    y = cm.rmsnorm(p["norm"], y * F.silu(z))
    return cm.linear(p["out_proj"], y, backend=backend)


def mamba_forward(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                  backend: kops.Backend = "auto") -> torch.Tensor:
    """Full-sequence mixer: x (B, S, d_model) -> (B, S, d_model)."""
    zxbcdt = cm.linear(p["in_proj"], x, backend=backend)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    xs, bmat, cmat, dt, a = _mixer_inputs(p, cfg, _causal_conv(p, xbc),
                                          dt_raw)
    y = kops.ssd(xs, dt, a, bmat, cmat, backend=backend)
    return _gated_out(p, cfg, y, xs, z, backend)


def _mamba_forward_state(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                         backend: kops.Backend = "auto"
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`mamba_forward` that also returns the final (conv, ssm) state."""
    s = x.shape[1]
    zxbcdt = cm.linear(p["in_proj"], x, backend=backend)
    z, xbc_pre, dt_raw = _split_proj(cfg, zxbcdt)
    # The conv state is the last K - 1 inputs, front-padded with zeros for
    # prompts shorter than the kernel (the stepwise decode's initial state).
    k1 = cfg.conv_kernel - 1
    pad = max(k1 - s, 0)
    conv_state = cm.pad(xbc_pre[:, -k1:, :], (0, 0, pad, 0))
    xs, bmat, cmat, dt, a = _mixer_inputs(p, cfg, _causal_conv(p, xbc_pre),
                                          dt_raw)
    # The final SSM state comes out of the scan itself.
    y, ssm_state = kops.ssd(xs, dt, a, bmat, cmat, backend=backend,
                            return_state=True)
    return (_gated_out(p, cfg, y, xs, z, backend),
            {"conv": conv_state, "ssm": ssm_state})


def mamba_cache_spec(cfg: ArchConfig, batch: int) -> Dict[str, torch.Tensor]:
    """Shape and dtype stand-ins (``meta`` tensors) of one mixer's decode
    state: conv (B, K - 1, C) in ``cfg.dtype`` and ssm (B, H, P, N) f32."""
    d_inner, h, g, n, conv_dim, _ = _dims(cfg)
    return {
        "conv": torch.empty((batch, cfg.conv_kernel - 1, conv_dim),
                            dtype=cfg.dtype, device="meta"),
        "ssm": torch.empty((batch, h, cfg.ssm_headdim, n),
                           dtype=torch.float32, device="meta"),
    }


def mamba_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], *,
                 backend: kops.Backend = "auto"
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token step: x (B, 1, d_model); ``cache`` carries the conv and
    ssm state.  Returns the output and the new state (fresh tensors)."""
    d_inner, h, g, n, _, _ = _dims(cfg)
    b = x.shape[0]
    zxbcdt = cm.linear(p["in_proj"], x, backend=backend)
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)            # (B, 1, ·)

    window = torch.cat([cache["conv"], xbc], dim=1)      # (B, K, C)
    conv_state = window[:, 1:]
    y = torch.einsum("bkc,kc->bc", window.to(torch.float32),
                     p["conv_w"].to(torch.float32))
    xbc1 = F.silu(y + p["conv_b"])                       # (B, C) f32

    xs = xbc1[:, :d_inner].reshape(b, h, cfg.ssm_headdim)
    r = h // g
    bmat = torch.repeat_interleave(
        xbc1[:, d_inner:d_inner + g * n].reshape(b, g, n), r, dim=1)
    cmat = torch.repeat_interleave(
        xbc1[:, d_inner + g * n:].reshape(b, g, n), r, dim=1)
    dt = F.softplus(dt_raw[:, 0].to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    update = _ssd_update_sharded if isinstance(cache["ssm"], DTensor) \
        else kref.ssd_update_ref
    new_state, yt = update(cache["ssm"], xs, dt, a, bmat, cmat)
    yt = yt + p["d_skip"][None, :, None] * xs
    yt = yt.reshape(b, 1, d_inner).to(cfg.dtype)
    yt = cm.rmsnorm(p["norm"], yt * F.silu(z))
    out = cm.linear(p["out_proj"], yt, backend=backend)
    return out, {"conv": conv_state, "ssm": new_state}


def _ssd_update_sharded(state: DTensor, xt, dtt, a, bt, ct):
    """``kref.ssd_update_ref`` of a state laid out by ``cache_shardings``
    (rows on ``"data"``, heads on ``"model"``), per shard: no two rows or
    heads meet in a step."""
    mesh = state.device_mesh
    pl = tuple(Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(1)
               else Replicate() for p in state.placements)
    a_pl = tuple(Shard(0) if p.is_shard(1) else Replicate() for p in pl)
    xt, dtt, a, bt, ct = (cm.replicated_like(t, state)
                          for t in (xt, dtt, a, bt, ct))
    return local_map(kref.ssd_update_ref, out_placements=(pl, pl),
                     in_placements=(pl, pl, pl, a_pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        state, xt, dtt, a, bt, ct)


# ---------------------------------------------------------------------------
# Full mamba2 model (norm → mixer → residual, no separate FFN)
# ---------------------------------------------------------------------------


_layer = cm.layer_slice


def model_init(generator: torch.Generator, cfg: ArchConfig, *,
               device: torch.device) -> Params:
    """Random params drawn from ``generator`` (on its device), placed on
    ``device``: ``{"embed", "blocks" (stacked over layers), "final_norm"}``,
    the blocks drawn and stacked layer by layer."""
    emb = cm.embed_init(generator, cfg.vocab, cfg.d_model, cfg.dtype)
    blocks = cm.stack_layers(
        lambda: {"ln": cm.rmsnorm_init(cfg.d_model, generator.device),
                 "mixer": mamba_init(generator, cfg)},
        cfg.n_layers, device)
    return {"embed": {"emb": emb["emb"].to(device)}, "blocks": blocks,
            "final_norm": cm.rmsnorm_init(cfg.d_model, device)}


def forward_logits(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
                   backend: kops.Backend = "auto") -> torch.Tensor:
    """Teacher-forced logits (B, S, vocab) f32; each layer rematerialised
    under autograd when ``cfg.remat == "layer"``."""
    x = cm.embed(params["embed"], tokens).to(cfg.dtype)

    def body(blk, h):
        h = h + mamba_forward(blk["mixer"], cfg, cm.rmsnorm(blk["ln"], h),
                              backend=backend)
        return cm.constrain(h, "btd")

    for blk in cm.unstack(params["blocks"], cfg.n_layers):
        x = cm.remat(cfg.remat, body, blk, x)
    x = cm.rmsnorm(params["final_norm"], x)
    return cm.unembed(params["embed"], x)


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, backend: kops.Backend = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels``)."""
    return cm.cross_entropy(
        forward_logits(params, cfg, batch["tokens"], backend=backend),
        batch["labels"])


def cache_spec(cfg: ArchConfig, batch: int, cache_len: int
               ) -> Dict[str, torch.Tensor]:
    """Shape and dtype stand-ins (tensors on the ``meta`` device) of the
    decode state arena: :func:`mamba_cache_spec` stacked over layers, conv
    (L, B, K - 1, C) and ssm (L, B, H, P, N).  O(1) in ``cache_len``."""
    return cm.stacked_spec(mamba_cache_spec(cfg, batch), (cfg.n_layers,))


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """The decode state arena of :func:`cache_spec`, zeros, on ``device``."""
    return cm.zeros_like_spec(cache_spec(cfg, batch, cache_len), device)


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int, *, backend: kops.Backend = "auto"
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Full forward over the prompt, keeping each layer's final (conv, ssm)
    state.  Returns ``(states, logits of the last position (B, 1, vocab))``;
    the states are stacked over layers as :func:`init_cache` lays them out."""
    h = cm.embed(params["embed"], tokens).to(cfg.dtype)
    convs, ssms = [], []
    for layer in range(cfg.n_layers):
        blk = _layer(params["blocks"], layer)
        out, state = _mamba_forward_state(
            blk["mixer"], cfg, cm.rmsnorm(blk["ln"], h), backend=backend)
        h = h + out
        convs.append(state["conv"])
        ssms.append(state["ssm"])
    h = cm.rmsnorm(params["final_norm"], h)
    logits = cm.unembed(params["embed"], h[:, -1:])
    return {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}, logits


def decode_step(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, pos, *, backend: kops.Backend = "auto"
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One token per row.  Updates ``cache`` IN PLACE (each layer's new
    state is copied into its slice of the arena: the analogue of the
    reference's donated cache) and returns it with the logits (B, 1, vocab).
    ``pos`` is unused: the SSM state is recurrent, positions never index
    it."""
    x = cm.embed(params["embed"], tokens).to(cfg.dtype)
    for layer in range(cfg.n_layers):
        blk = _layer(params["blocks"], layer)
        out, new = mamba_decode(
            blk["mixer"], cfg, cm.rmsnorm(blk["ln"], x),
            {"conv": cache["conv"][layer], "ssm": cache["ssm"][layer]},
            backend=backend)
        cache["conv"][layer].copy_(new["conv"])
        cache["ssm"][layer].copy_(new["ssm"])
        x = x + out
    x = cm.rmsnorm(params["final_norm"], x)
    return cache, cm.unembed(params["embed"], x)


def decode_step_multi(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                      tokens: torch.Tensor, pos, *,
                      backend: kops.Backend = "auto"
                      ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Per-slot-position decode (pos (B,)).  The SSM state is recurrent per
    batch row, so the plain step already decodes every slot independently."""
    return decode_step(params, cfg, cache, tokens, pos, backend=backend)
