"""Jamba-style hybrid: Mamba + attention 1:7 interleave with MoE
[arXiv:2403.19887] (``repro.models.hybrid``'s counterpart).

The layers are ``n_layers / attn_period`` homogeneous *super-blocks* of
``attn_period`` (8) sublayers: attention at position ``period // 2 - 1`` (3),
Mamba elsewhere; the FFN after each mixer alternates a dense MLP (even
positions) and MoE (odd positions).  The param tree is the reference's,
``blocks → {mamba, attn, mlp, moe}`` each stacked over super-blocks, and
``mamba``/``mlp``/``moe`` stacked again over their positions inside one
(``(n_super, n_inner, ...)`` leaves), so ``repro_torch.bridge`` carries it
leaf for leaf.  Python loops walk both axes, each sublayer reading views of
its slice (:func:`repro_torch.models.common.layer_slice` once per axis).

The Mamba layers run the SSD through ``ops.ssd`` (the ``ssd_scan`` kernel on
the card, one launch per layer per prefill); every projection goes through
``common.linear`` (``qmatmul`` under SINT).  The decode arena is
``{"k", "v"}`` (n_super, B, Smax, K, D) for the attention layers and
``{"mamba": {"conv", "ssm"}}`` (n_super, n_mamba, B, ...) for the Mamba
layers, updated in place by the decode steps.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as mb
from repro_torch.models import moe as moelib
from repro_torch.models.transformer import _attn_cfg, _mlp_cfg

Params = Dict[str, Any]
_take = cm.layer_slice


def _layout(cfg: ArchConfig):
    period = cfg.attn_period
    attn_pos = period // 2 - 1          # position 3 of 8 (jamba layout)
    n_super = cfg.n_layers // period
    n_mamba = period - 1
    n_moe = period // 2                 # odd positions
    n_mlp = period - n_moe
    return period, attn_pos, n_super, n_mamba, n_moe, n_mlp


def _nest(tree: Params, n_super: int, n_inner: int) -> Params:
    """Views of a tree stacked over ``n_super * n_inner`` draws as
    (n_super, n_inner, ...)."""
    if isinstance(tree, dict):
        return {k: _nest(v, n_super, n_inner) for k, v in tree.items()}
    return tree.view((n_super, n_inner) + tuple(tree.shape[1:]))


def model_init(generator: torch.Generator, cfg: ArchConfig, *,
               device: torch.device) -> Params:
    """Random params drawn from ``generator`` (on its device), placed on
    ``device``.  Each kind of sublayer is drawn layer by layer into its
    preallocated stack (``common.stack_layers``), so one sublayer's draw
    lives beside the stacks: a full-width super-block holds one copy."""
    _, _, n_super, n_mamba, n_moe, n_mlp = _layout(cfg)
    dev, d = generator.device, cfg.d_model

    def stacked(init_one, n_inner):
        return _nest(cm.stack_layers(init_one, n_super * n_inner, device),
                     n_super, n_inner)

    emb = cm.embed_init(generator, cfg.vocab, d, cfg.dtype)
    blocks = {
        "mamba": stacked(lambda: {"ln": cm.rmsnorm_init(d, dev),
                                  "mixer": mb.mamba_init(generator, cfg)},
                         n_mamba),
        "attn": cm.stack_layers(
            lambda: {"ln": cm.rmsnorm_init(d, dev),
                     "attn": cm.attn_init(generator, _attn_cfg(cfg),
                                          cfg.quant, cfg.dtype)},
            n_super, device),
        "mlp": stacked(lambda: {"ln": cm.rmsnorm_init(d, dev),
                                "mlp": cm.mlp_init(generator, _mlp_cfg(cfg),
                                                   cfg.quant, cfg.dtype)},
                       n_mlp),
        "moe": stacked(lambda: {"ln": cm.rmsnorm_init(d, dev),
                                "moe": moelib.moe_init(generator, cfg)},
                       n_moe),
    }
    return {"embed": {"emb": emb["emb"].to(device)}, "blocks": blocks,
            "final_norm": cm.rmsnorm_init(d, device)}


def _ffn(sb: Params, cfg: ArchConfig, i: int, h: torch.Tensor,
         backend: kops.Backend) -> torch.Tensor:
    """Sublayer i's FFN: MoE at odd positions, the dense MLP at even."""
    if i % 2 == 1:
        p = _take(sb["moe"], i // 2)
        return moelib.moe_forward(p["moe"], cfg, cm.rmsnorm(p["ln"], h))
    p = _take(sb["mlp"], i // 2)
    return cm.mlp_forward(p["mlp"], _mlp_cfg(cfg), cm.rmsnorm(p["ln"], h),
                          backend=backend)


def forward_logits(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
                   backend: kops.Backend = "auto") -> torch.Tensor:
    """Teacher-forced logits (B, S, vocab) f32; each super-block
    rematerialised under autograd when ``cfg.remat == "layer"``."""
    period, attn_pos, n_super, *_ = _layout(cfg)
    x = cm.embed(params["embed"], tokens).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(sb, h):
        mamba_j = 0
        for i in range(period):
            if i == attn_pos:
                hn = cm.rmsnorm(sb["attn"]["ln"], h)
                h = h + cm.attn_forward(sb["attn"]["attn"], _attn_cfg(cfg),
                                        hn, positions, backend=backend)
            else:
                p = _take(sb["mamba"], mamba_j)
                h = h + mb.mamba_forward(p["mixer"], cfg, h, ln=p["ln"],
                                         backend=backend)
                mamba_j += 1
            h = cm.constrain(h + _ffn(sb, cfg, i, h, backend), "btd")
        return h

    for sb in cm.unstack(params["blocks"], n_super):
        x = cm.remat(cfg.remat, body, sb, x)
    return cm.unembed(params["embed"], cm.rmsnorm(params["final_norm"], x))


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, backend: kops.Backend = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``,
    ``labels``)."""
    return cm.cross_entropy(
        forward_logits(params, cfg, batch["tokens"], backend=backend),
        batch["labels"])


# -- serving ---------------------------------------------------------------


def cache_spec(cfg: ArchConfig, batch: int, cache_len: int) -> Dict[str, Any]:
    """Shape and dtype stand-ins (``meta`` tensors) of the decode arena:
    the attention layers' K/V (n_super, B, cache_len, K, D) in
    ``cfg.dtype`` and ``mamba2.mamba_cache_spec`` stacked as
    (n_super, n_mamba, B, ...)."""
    _, _, n_super, n_mamba, *_ = _layout(cfg)
    kv = torch.empty((n_super, batch, cache_len, cfg.n_kv_heads, cfg.d_head),
                     dtype=cfg.dtype, device="meta")
    return {"k": kv, "v": kv,
            "mamba": cm.stacked_spec(mb.mamba_cache_spec(cfg, batch),
                                     (n_super, n_mamba))}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               device: torch.device) -> Dict[str, Any]:
    """The decode arena of :func:`cache_spec`, zeros, on ``device``."""
    return cm.zeros_like_spec(cache_spec(cfg, batch, cache_len), device)


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int, *, backend: kops.Backend = "auto"
            ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Full forward over the prompt, collecting the attention layers' K/V
    (zero-padded to ``cache_len``) and each Mamba layer's final (conv, ssm)
    state (conv in ``cfg.dtype``, ssm f32) into a fresh arena.  Returns it
    with the logits of the last position (B, 1, vocab)."""
    period, attn_pos, n_super, *_ = _layout(cfg)
    x = cm.embed(params["embed"], tokens).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    # Under a mesh the arena replicates; each write takes its layout.
    cache = cm.replicated_like(
        init_cache(cfg, x.shape[0], cache_len, device=x.device), x)
    for s in range(n_super):
        sb = _take(params["blocks"], s)
        mamba_j = 0
        for i in range(period):
            if i == attn_pos:
                h = cm.rmsnorm(sb["attn"]["ln"], x)
                a, (k, v) = cm.attn_prefill(sb["attn"]["attn"], _attn_cfg(cfg),
                                            h, positions, cache_len,
                                            backend=backend)
                cache["k"][s].copy_(k)
                cache["v"][s].copy_(v)
                x = x + a
            else:
                p = _take(sb["mamba"], mamba_j)
                out, st = mb._mamba_forward_state(
                    p["mixer"], cfg, x, ln=p["ln"], backend=backend)
                cache["mamba"]["conv"][s, mamba_j].copy_(st["conv"])
                cache["mamba"]["ssm"][s, mamba_j].copy_(st["ssm"])
                x = x + out
                mamba_j += 1
            x = x + _ffn(sb, cfg, i, x, backend)
    x = cm.rmsnorm(params["final_norm"], x)
    return cache, cm.unembed(params["embed"], x[:, -1:])


def _decode(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
            tokens: torch.Tensor, pos, multi: bool, backend: kops.Backend
            ) -> Tuple[Dict[str, Any], torch.Tensor]:
    period, attn_pos, n_super, *_ = _layout(cfg)
    attn_step = cm.attn_decode_multi if multi else cm.attn_decode
    pos = torch.as_tensor(pos, device=tokens.device)
    x = cm.embed(params["embed"], tokens).to(cfg.dtype)
    conv, ssm = cache["mamba"]["conv"], cache["mamba"]["ssm"]
    for s in range(n_super):
        sb = _take(params["blocks"], s)
        mamba_j = 0
        for i in range(period):
            if i == attn_pos:
                h = cm.rmsnorm(sb["attn"]["ln"], x)
                a, _ = attn_step(sb["attn"]["attn"], _attn_cfg(cfg), h, pos,
                                 (cache["k"][s], cache["v"][s]),
                                 backend=backend)
                x = x + a
            else:
                p = _take(sb["mamba"], mamba_j)
                out, new = mb.mamba_decode(
                    p["mixer"], cfg, cm.rmsnorm(p["ln"], x),
                    {"conv": conv[s, mamba_j], "ssm": ssm[s, mamba_j]},
                    backend=backend)
                conv[s, mamba_j].copy_(new["conv"])
                ssm[s, mamba_j].copy_(new["ssm"])
                x = x + out
                mamba_j += 1
            x = x + _ffn(sb, cfg, i, x, backend)
    x = cm.rmsnorm(params["final_norm"], x)
    return cache, cm.unembed(params["embed"], x)


def decode_step(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, pos, *, backend: kops.Backend = "auto"
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One token per row at the shared position ``pos``.  Updates ``cache``
    IN PLACE and returns it with the logits (B, 1, vocab)."""
    return _decode(params, cfg, cache, tokens, pos, False, backend)


def decode_step_multi(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                      tokens: torch.Tensor, pos: torch.Tensor, *,
                      backend: kops.Backend = "auto"
                      ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Per-slot-position decode (pos (B,)): the attention layers write and
    mask per row; the Mamba layers are position-free recurrent state."""
    return _decode(params, cfg, cache, tokens, pos, True, backend)
