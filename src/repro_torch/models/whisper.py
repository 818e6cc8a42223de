"""Whisper-style encoder-decoder backbone [arXiv:2212.04356]
(``repro.models.whisper``'s counterpart).

The mel-spectrogram and conv feature extractor are a stub: the batch
provides frame embeddings ``frames`` (B, F, d_model).  The backbone is
``cfg.n_layers`` bidirectional encoder layers over the frames and as many
causal decoder layers of self-attention, cross-attention to the encoder
output and a gelu MLP.  Positions are sinusoidal in both stacks, norms are
the repo's RMSNorm and the linears biased (``cfg.bias``; cross-attention's
``wk`` has none), as the reference.

Serving: :func:`prefill` encodes the frames once and stores every decoder
layer's cross-attention K/V (``xk``/``xv``, (L, B, F, K, D)) in the arena
beside the self-attention K/V (``k``/``v``, (L, B, Smax, K, D)); the decode
steps read ``xk``/``xv`` and write only ``k``/``v``, in place.  Every
projection goes through ``common.linear`` (``qmatmul`` under SINT).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models.transformer import _attn_cfg, _mlp_cfg

Params = Dict[str, Any]


def sinusoids(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper's sinusoidal position encoding (P, d) f32 of positions (P,)."""
    half = d // 2
    log_timescale = math.log(10000.0) / (half - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        half, dtype=torch.float32, device=positions.device))
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- cross attention ---------------------------------------------------------


def cross_attn_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    d, kv, q = cfg.d_model, cfg.n_kv_heads * cfg.d_head, cfg.quant
    widths = {"wq": (d, cfg.n_heads * cfg.d_head, cfg.bias),
              "wk": (d, kv, False),
              "wv": (d, kv, cfg.bias),
              "wo": (cfg.n_heads * cfg.d_head, d, cfg.bias)}
    return {name: cm.linear_init(generator, d_in, d_out, bias=bias, quant=q,
                                 dtype=cfg.dtype)
            for name, (d_in, d_out, bias) in widths.items()}


def cross_kv(p: Params, cfg: ArchConfig, enc: torch.Tensor, *,
             backend: kops.Backend = "auto"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    k = cm.split_heads(cm.linear(p["wk"], enc, backend=backend),
                       cfg.n_kv_heads, cfg.d_head)
    v = cm.split_heads(cm.linear(p["wv"], enc, backend=backend),
                       cfg.n_kv_heads, cfg.d_head)
    return k, v


def cross_attn_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor, *,
                     backend: kops.Backend = "auto") -> torch.Tensor:
    b, s, _ = x.shape
    q = cm.split_heads(cm.linear(p["wq"], x, backend=backend), cfg.n_heads,
                       cfg.d_head)
    mask = torch.ones((s, k.shape[1]), dtype=torch.bool, device=x.device)
    out = cm.gqa_attention(q, k, v, mask)
    return cm.linear(p["wo"], out.reshape(b, s, -1), backend=backend)


# -- params ------------------------------------------------------------------


def model_init(generator: torch.Generator, cfg: ArchConfig, *,
               device: torch.device) -> Params:
    """Random params drawn from ``generator`` (on its device), placed on
    ``device``: ``{"embed", "enc_blocks", "enc_norm", "dec_blocks",
    "final_norm"}``, both block stacks drawn layer by layer."""
    dev, d = generator.device, cfg.d_model
    acfg, mcfg = _attn_cfg(cfg), _mlp_cfg(cfg)

    def enc_block():
        return {"ln1": cm.rmsnorm_init(d, dev),
                "attn": cm.attn_init(generator, acfg, cfg.quant, cfg.dtype),
                "ln2": cm.rmsnorm_init(d, dev),
                "mlp": cm.mlp_init(generator, mcfg, cfg.quant, cfg.dtype)}

    def dec_block():
        return {"ln1": cm.rmsnorm_init(d, dev),
                "self_attn": cm.attn_init(generator, acfg, cfg.quant,
                                          cfg.dtype),
                "ln_x": cm.rmsnorm_init(d, dev),
                "cross": cross_attn_init(generator, cfg),
                "ln2": cm.rmsnorm_init(d, dev),
                "mlp": cm.mlp_init(generator, mcfg, cfg.quant, cfg.dtype)}

    emb = cm.embed_init(generator, cfg.vocab, d, cfg.dtype)
    return {"embed": {"emb": emb["emb"].to(device)},
            "enc_blocks": cm.stack_layers(enc_block, cfg.n_layers, device),
            "enc_norm": cm.rmsnorm_init(d, device),
            "dec_blocks": cm.stack_layers(dec_block, cfg.n_layers, device),
            "final_norm": cm.rmsnorm_init(d, device)}


# -- encoder ------------------------------------------------------------------


def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor, *,
           backend: kops.Backend = "auto") -> torch.Tensor:
    """frames (B, F, d_model) stub embeddings -> the encoder output."""
    b, f, _ = frames.shape
    positions = torch.arange(f, device=frames.device)
    pe = cm.replicated_like(sinusoids(positions, cfg.d_model), frames)
    x = frames.to(cfg.dtype) + pe.to(cfg.dtype)
    acfg = _attn_cfg(cfg)
    mask = torch.ones((f, f), dtype=torch.bool, device=frames.device)
    for blk in cm.unstack(params["enc_blocks"], cfg.n_layers):
        # bidirectional: every frame attends to every frame
        q, k, v = cm.attn_qkv(blk["attn"], acfg, cm.rmsnorm(blk["ln1"], x),
                              positions, backend=backend)
        x = x + cm.linear(blk["attn"]["wo"],
                          cm.gqa_attention(q, k, v, mask).reshape(b, f, -1),
                          backend=backend)
        x = x + cm.mlp_forward(blk["mlp"], _mlp_cfg(cfg),
                               cm.rmsnorm(blk["ln2"], x), backend=backend)
    return cm.rmsnorm(params["enc_norm"], x)


# -- decoder ------------------------------------------------------------------


def _embed(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
           pe: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the position encoding ``pe`` (broadcast)."""
    x = cm.embed(params["embed"], tokens).to(cfg.dtype)
    return x + cm.replicated_like(pe, x).to(cfg.dtype)


def _cross_and_mlp(blk: Params, cfg: ArchConfig, x: torch.Tensor,
                   kc: torch.Tensor, vc: torch.Tensor,
                   backend: kops.Backend) -> torch.Tensor:
    x = x + cross_attn_apply(blk["cross"], cfg, cm.rmsnorm(blk["ln_x"], x),
                             kc, vc, backend=backend)
    return x + cm.mlp_forward(blk["mlp"], _mlp_cfg(cfg),
                              cm.rmsnorm(blk["ln2"], x), backend=backend)


def forward_logits(params: Params, cfg: ArchConfig, frames: torch.Tensor,
                   tokens: torch.Tensor, *, backend: kops.Backend = "auto"
                   ) -> torch.Tensor:
    """Teacher-forced logits (B, S, vocab) f32; each decoder layer
    rematerialised under autograd when ``cfg.remat == "layer"`` (the
    encoder's are not, as in the reference)."""
    enc = encode(params, cfg, frames, backend=backend)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, cfg, tokens, sinusoids(positions, cfg.d_model))
    acfg = _attn_cfg(cfg)

    def body(blk, h, enc):
        kc, vc = cross_kv(blk["cross"], cfg, enc, backend=backend)
        h = h + cm.attn_forward(blk["self_attn"], acfg,
                                cm.rmsnorm(blk["ln1"], h), positions,
                                backend=backend)
        return _cross_and_mlp(blk, cfg, h, kc, vc, backend)

    for blk in cm.unstack(params["dec_blocks"], cfg.n_layers):
        x = cm.remat(cfg.remat, body, blk, x, enc)
    return cm.unembed(params["embed"], cm.rmsnorm(params["final_norm"], x))


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, backend: kops.Backend = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``frames``, ``tokens``,
    ``labels``)."""
    return cm.cross_entropy(
        forward_logits(params, cfg, batch["frames"], batch["tokens"],
                       backend=backend),
        batch["labels"])


# -- serving -----------------------------------------------------------------


def cache_spec(cfg: ArchConfig, batch: int, cache_len: int
               ) -> Dict[str, torch.Tensor]:
    """Shape and dtype stand-ins (``meta`` tensors) of the decode arena:
    self-attention K/V (L, B, cache_len, K, D) and the cross-attention
    K/V over the encoder's frames (L, B, encoder_frames, K, D), all in
    ``cfg.dtype``."""
    kv = torch.empty((cfg.n_layers, batch, cache_len, cfg.n_kv_heads,
                      cfg.d_head), dtype=cfg.dtype, device="meta")
    xkv = torch.empty((cfg.n_layers, batch, cfg.encoder_frames,
                       cfg.n_kv_heads, cfg.d_head), dtype=cfg.dtype,
                      device="meta")
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """The decode arena of :func:`cache_spec`, zeros, on ``device``."""
    return cm.zeros_like_spec(cache_spec(cfg, batch, cache_len), device)


def prefill(params: Params, cfg: ArchConfig, frames: torch.Tensor,
            tokens: torch.Tensor, cache_len: int, *,
            backend: kops.Backend = "auto"
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Encode ``frames`` and run the decoder over the prompt: a fresh arena
    holding each layer's self-attention K/V (zero-padded to ``cache_len``)
    and its cross-attention K/V, computed here once, and the logits of the
    last position (B, 1, vocab)."""
    enc = encode(params, cfg, frames, backend=backend)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, cfg, tokens, sinusoids(positions, cfg.d_model))
    acfg = _attn_cfg(cfg)
    # Under a mesh the arena replicates; each write takes its layout.
    cache = cm.replicated_like(
        init_cache(cfg, x.shape[0], cache_len, device=x.device), x)
    for layer in range(cfg.n_layers):
        blk = cm.layer_slice(params["dec_blocks"], layer)
        kc, vc = cross_kv(blk["cross"], cfg, enc, backend=backend)
        a, (k, v) = cm.attn_prefill(blk["self_attn"], acfg,
                                    cm.rmsnorm(blk["ln1"], x), positions,
                                    cache_len, backend=backend)
        x = _cross_and_mlp(blk, cfg, x + a, kc, vc, backend)
        for name, t in (("k", k), ("v", v), ("xk", kc), ("xv", vc)):
            cache[name][layer].copy_(t)
    x = cm.rmsnorm(params["final_norm"], x)
    return cache, cm.unembed(params["embed"], x[:, -1:])


def _decode(params: Params, cfg: ArchConfig, cache: Dict[str, torch.Tensor],
            tokens: torch.Tensor, pos, multi: bool, backend: kops.Backend
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    pos = torch.as_tensor(pos, device=tokens.device)
    attn_step = cm.attn_decode_multi if multi else cm.attn_decode
    # One position for every row, (1, d); or one per row, (B, 1, d).
    pe = (sinusoids(pos, cfg.d_model)[:, None, :] if multi
          else sinusoids(pos.reshape(1), cfg.d_model))
    x = _embed(params, cfg, tokens, pe)
    acfg = _attn_cfg(cfg)
    for layer in range(cfg.n_layers):
        blk = cm.layer_slice(params["dec_blocks"], layer)
        a, _ = attn_step(blk["self_attn"], acfg, cm.rmsnorm(blk["ln1"], x),
                         pos, (cache["k"][layer], cache["v"][layer]),
                         backend=backend)
        x = _cross_and_mlp(blk, cfg, x + a, cache["xk"][layer],
                           cache["xv"][layer], backend)
    x = cm.rmsnorm(params["final_norm"], x)
    return cache, cm.unembed(params["embed"], x)


def decode_step(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, pos, *, backend: kops.Backend = "auto"
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One token per row at the shared position ``pos``.  Writes the
    self-attention K/V into ``cache`` IN PLACE (``xk``/``xv`` untouched) and
    returns it with the logits (B, 1, vocab)."""
    return _decode(params, cfg, cache, tokens, pos, False, backend)


def decode_step_multi(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                      tokens: torch.Tensor, pos: torch.Tensor, *,
                      backend: kops.Backend = "auto"
                      ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Per-slot-position decode (pos (B,)): self-attention writes and masks
    per row; cross-attention reads each slot's encoder K/V, position-free."""
    return _decode(params, cfg, cache, tokens, pos, True, backend)
