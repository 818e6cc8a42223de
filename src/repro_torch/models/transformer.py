"""Dense GQA decoder (``repro.models.transformer``'s counterpart): qwen3,
command-r(-plus), nemotron-4, and the base the MoE models build on
(``moe.py`` swaps the FFN through the ``ffn_*`` hooks).

The reference scans the stacked layers with ``lax.scan``; here the per-layer
params are stacked on a leading ``n_layers`` axis as in the reference (so
``repro_torch.bridge`` carries a JAX tree across leaf for leaf) and a Python
loop walks the layer axis, each layer reading views of its slice.  The KV
cache is one arena, ``{"k", "v"}`` of (L, B, Smax, K, D) (plus the int8
variant's scales), that the decode steps update in place.  ``backend``
(``ops.Backend``) goes to every ``linear`` on the path (the ``qmatmul``
kernel under SINT).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm

Params = Dict[str, Any]
FfnApply = Callable[[Params, torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# Per-layer block (attention + FFN) — ffn_* hooks let moe.py substitute MoE.
# ---------------------------------------------------------------------------


def _attn_cfg(cfg: ArchConfig) -> cm.AttnConfig:
    return cm.AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        qk_norm=cfg.qk_norm,
        bias=cfg.bias,
        rope_theta=cfg.rope_theta,
        window=cfg.sliding_window,
        d_head=cfg.d_head,
    )


def _mlp_cfg(cfg: ArchConfig) -> cm.MlpConfig:
    return cm.MlpConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                        kind=cfg.mlp_kind, bias=cfg.bias)


def _dense_ffn(cfg: ArchConfig, backend: kops.Backend) -> FfnApply:
    mcfg = _mlp_cfg(cfg)
    return lambda p, h: cm.mlp_forward(p, mcfg, h, backend=backend)


def block_init(generator: torch.Generator, cfg: ArchConfig,
               ffn_init: Callable[[torch.Generator], Params]) -> Params:
    dev = generator.device
    p = {
        "ln1": cm.rmsnorm_init(cfg.d_model, dev),
        "attn": cm.attn_init(generator, _attn_cfg(cfg), cfg.quant, cfg.dtype),
        "ffn": ffn_init(generator),
    }
    if not cfg.parallel_block:
        p["ln2"] = cm.rmsnorm_init(cfg.d_model, dev)
    return p


def _residual(blk: Params, cfg: ArchConfig, x: torch.Tensor, h: torch.Tensor,
              a: torch.Tensor, ffn_apply: FfnApply) -> torch.Tensor:
    """x + attention + FFN: command-r's parallel block feeds the FFN the
    same normed input ``h``; the others norm the attention's residual."""
    if cfg.parallel_block:
        return x + a + ffn_apply(blk["ffn"], h)
    x = x + a
    return x + ffn_apply(blk["ffn"], cm.rmsnorm(blk["ln2"], x))


def block_forward(blk: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, ffn_apply: FfnApply, *,
                  backend: kops.Backend = "auto") -> torch.Tensor:
    h = cm.rmsnorm(blk["ln1"], x)
    a = cm.attn_forward(blk["attn"], _attn_cfg(cfg), h, positions,
                        backend=backend)
    return cm.constrain(_residual(blk, cfg, x, h, a, ffn_apply), "btd")


def block_prefill(blk: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, cache_len: int,
                  ffn_apply: FfnApply, *, backend: kops.Backend = "auto"
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    h = cm.rmsnorm(blk["ln1"], x)
    a, kv = cm.attn_prefill(blk["attn"], _attn_cfg(cfg), h, positions,
                            cache_len, backend=backend)
    return cm.constrain(_residual(blk, cfg, x, h, a, ffn_apply), "btd"), kv


def block_decode(blk: Params, cfg: ArchConfig, x: torch.Tensor, pos,
                 kv: Tuple[torch.Tensor, ...], ffn_apply: FfnApply, *,
                 backend: kops.Backend = "auto"
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One token per row at the shared ``pos``; ``kv`` updated in place."""
    h = cm.rmsnorm(blk["ln1"], x)
    a, kv = cm.attn_decode(blk["attn"], _attn_cfg(cfg), h, pos, kv,
                           backend=backend)
    return _residual(blk, cfg, x, h, a, ffn_apply), kv


def block_decode_multi(blk: Params, cfg: ArchConfig, x: torch.Tensor,
                       pos: torch.Tensor, kv: Tuple[torch.Tensor, ...],
                       ffn_apply: FfnApply, *, backend: kops.Backend = "auto"
                       ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """:func:`block_decode` with per-row positions pos (B,) (continuous
    batching)."""
    h = cm.rmsnorm(blk["ln1"], x)
    a, kv = cm.attn_decode_multi(blk["attn"], _attn_cfg(cfg), h, pos, kv,
                                 backend=backend)
    return _residual(blk, cfg, x, h, a, ffn_apply), kv


# ---------------------------------------------------------------------------
# Full decoder
# ---------------------------------------------------------------------------


def decoder_init(generator: torch.Generator, cfg: ArchConfig, *,
                 device: torch.device,
                 ffn_init: Optional[Callable[[torch.Generator], Params]] = None
                 ) -> Params:
    """Random params drawn from ``generator`` (on its device), placed on
    ``device``: ``{"embed", "blocks" (stacked over layers), "final_norm"}``,
    the blocks drawn and stacked layer by layer."""
    ffn_init = ffn_init or (
        lambda g: cm.mlp_init(g, _mlp_cfg(cfg), cfg.quant, cfg.dtype))
    emb = cm.embed_init(generator, cfg.vocab, cfg.d_model, cfg.dtype)
    blocks = cm.stack_layers(lambda: block_init(generator, cfg, ffn_init),
                             cfg.n_layers, device)
    return {"embed": {"emb": emb["emb"].to(device)}, "blocks": blocks,
            "final_norm": cm.rmsnorm_init(cfg.d_model, device)}


def _embed(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
           prefix_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = cm.embed(params["embed"], tokens).to(cfg.dtype)
    if prefix_embed is None:
        return x
    return torch.cat([prefix_embed.to(cfg.dtype), x], dim=1)


def decoder_hidden(params: Params, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor,
                   ffn_apply: Optional[FfnApply] = None, *,
                   backend: kops.Backend = "auto") -> torch.Tensor:
    """Run the block stack over embedded inputs x (B, S, D), each layer
    rematerialised under autograd when ``cfg.remat == "layer"``."""
    ffn_apply = ffn_apply or _dense_ffn(cfg, backend)

    def body(blk, h):
        return block_forward(blk, cfg, h, positions, ffn_apply,
                             backend=backend)

    for blk in cm.unstack(params["blocks"], cfg.n_layers):
        x = cm.remat(cfg.remat, body, blk, x)
    return cm.rmsnorm(params["final_norm"], x)


def forward_logits(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                   ffn_apply: Optional[FfnApply] = None, *,
                   prefix_embed: Optional[torch.Tensor] = None,
                   backend: kops.Backend = "auto") -> torch.Tensor:
    """Teacher-forced logits (B, S, vocab) f32.  ``prefix_embed``
    (B, P, D), when given, is prepended to the token embeddings (the VLM's
    projected image tokens) and its positions' logits are returned too."""
    x = _embed(params, cfg, tokens, prefix_embed)
    positions = torch.arange(x.shape[1], device=x.device)
    h = decoder_hidden(params, cfg, x, positions, ffn_apply, backend=backend)
    return cm.unembed(params["embed"], h)


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            ffn_apply: Optional[FfnApply] = None, *,
            backend: kops.Backend = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``;
    a ``prefix_embed`` is prepended and its positions' logits left out)."""
    prefix = batch.get("prefix_embed")
    logits = forward_logits(params, cfg, batch["tokens"], ffn_apply,
                            prefix_embed=prefix, backend=backend)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    return cm.cross_entropy(logits, batch["labels"])


# -- serving ---------------------------------------------------------------


def cache_spec(cfg: ArchConfig, batch: int, cache_len: int
               ) -> Dict[str, torch.Tensor]:
    """Shape and dtype stand-ins (tensors on the ``meta`` device) of the KV
    arena at (batch, cache_len)."""
    kv_shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.d_head)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.kv_quant:
        # §6.1 quantization applied to serving state: int8 K/V + REAL scales
        return {"k": spec(kv_shape, torch.int8),
                "v": spec(kv_shape, torch.int8),
                "k_scale": spec(kv_shape[:-1], torch.float32),
                "v_scale": spec(kv_shape[:-1], torch.float32)}
    return {"k": spec(kv_shape, cfg.dtype), "v": spec(kv_shape, cfg.dtype)}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """The KV arena, zeros, on ``device``."""
    return cm.zeros_like_spec(cache_spec(cfg, batch, cache_len), device)


def _kv_parts(cfg: ArchConfig, cache: Dict[str, torch.Tensor], layer: int
              ) -> Tuple[torch.Tensor, ...]:
    """The views of one layer's slice of the arena that attention takes."""
    names = ("k", "v", "k_scale", "v_scale") if cfg.kv_quant else ("k", "v")
    return tuple(cache[n][layer] for n in names)


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int, ffn_apply: Optional[FfnApply] = None, *,
            prefix_embed: Optional[torch.Tensor] = None,
            backend: kops.Backend = "auto"
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The prompt's KV arena at ``cache_len`` (zero-padded past the prompt;
    under kv_quant the padded K/V quantized, as the reference) and the
    logits of its last position (B, 1, vocab).  ``prefix_embed`` (B, P, D)
    is prepended to the prompt's embeddings, as in :func:`forward_logits`:
    the arena then holds P + S positions."""
    ffn_apply = ffn_apply or _dense_ffn(cfg, backend)
    x = _embed(params, cfg, tokens, prefix_embed)
    positions = torch.arange(x.shape[1], device=x.device)
    cache = init_cache(cfg, x.shape[0], cache_len, device=x.device)
    for layer in range(cfg.n_layers):
        x, (k, v) = block_prefill(cm.layer_slice(params["blocks"], layer),
                                  cfg, x, positions, cache_len, ffn_apply,
                                  backend=backend)
        if cfg.kv_quant:
            (kq, ks), (vq, vs) = cm._quantize_kv(k), cm._quantize_kv(v)
            kv = (kq, vq, ks, vs)
        else:
            kv = (k, v)
        for dst, src in zip(_kv_parts(cfg, cache, layer), kv):
            dst.copy_(src)
    h = cm.rmsnorm(params["final_norm"], x)
    return cache, cm.unembed(params["embed"], h[:, -1:])


def _decode(params: Params, cfg: ArchConfig, cache: Dict[str, torch.Tensor],
            tokens: torch.Tensor, pos: torch.Tensor, ffn_apply: FfnApply,
            block_step, backend: kops.Backend
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    x = _embed(params, cfg, tokens)
    for layer in range(cfg.n_layers):
        x, _ = block_step(cm.layer_slice(params["blocks"], layer), cfg, x,
                          pos, _kv_parts(cfg, cache, layer), ffn_apply,
                          backend=backend)
    h = cm.rmsnorm(params["final_norm"], x)
    return cache, cm.unembed(params["embed"], h)


def decode_step(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, pos, ffn_apply: Optional[FfnApply] = None,
                *, backend: kops.Backend = "auto"
                ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One decode step: tokens (B, 1) at the shared position ``pos`` (an
    int or a 0-d tensor).  Updates ``cache`` IN PLACE and returns it with
    the logits (B, 1, vocab)."""
    return _decode(params, cfg, cache, tokens,
                   torch.as_tensor(pos, device=tokens.device),
                   ffn_apply or _dense_ffn(cfg, backend), block_decode,
                   backend)


def decode_step_multi(params: Params, cfg: ArchConfig, cache: Dict[str, Any],
                      tokens: torch.Tensor, pos: torch.Tensor,
                      ffn_apply: Optional[FfnApply] = None, *,
                      backend: kops.Backend = "auto"
                      ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One decode step with per-slot positions: tokens (B, 1), pos (B,).
    Each slot advances at its own position in the shared cache — the
    decode signature continuous batching needs (serving/continuous.py)."""
    return _decode(params, cfg, cache, tokens,
                   torch.as_tensor(pos, device=tokens.device),
                   ffn_apply or _dense_ffn(cfg, backend), block_decode_multi,
                   backend)
