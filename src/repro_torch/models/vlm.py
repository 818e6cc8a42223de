"""LLaVA-NeXT-style VLM (``repro.models.vlm``'s counterpart): the vision
encoder is stubbed, the language backbone is the dense GQA decoder with an
image-token prefix.

AnyRes tiling [hf:llava-hf/llava-v1.6-*]: the (stubbed) vision tower encodes
a base view plus 4 tiles into ``cfg.num_image_tokens`` patch embeddings of
width :data:`VISION_D`, which the batch provides as ``image_emb``; the
2-layer GELU projector maps them into the language model's embedding space,
and they are prepended to the text tokens.  The projector's two linears are
plain (``quant=None``, ``x @ w + b`` in ``cfg.dtype``) even under SINT, as in
the reference; the backbone's projections go through ``common.linear``.
Decode is the transformer's: the arena holds the prefix's and the prompt's
K/V.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf

Params = Dict[str, Any]

VISION_D = 1152  # SigLIP-style vision feature width (stub)


def model_init(generator: torch.Generator, cfg: ArchConfig, *,
               device: torch.device) -> Params:
    """The decoder's params (``transformer.decoder_init``) and the
    projector's ``fc1`` (VISION_D -> d_model) and ``fc2`` (d_model ->
    d_model), both with bias, on ``device``."""
    p = tf.decoder_init(generator, cfg, device=device)
    p["projector"] = {
        name: {k: v.to(device) for k, v in cm.linear_init(
            generator, d_in, cfg.d_model, bias=True, quant=None,
            dtype=cfg.dtype).items()}
        for name, d_in in (("fc1", VISION_D), ("fc2", cfg.d_model))}
    return p


def project(p: Params, image_emb: torch.Tensor) -> torch.Tensor:
    """The projector: gelu (tanh form, ``jax.nn.gelu``'s default) between
    two plain biased linears."""
    h = F.gelu(cm.linear(p["projector"]["fc1"], image_emb),
               approximate="tanh")
    return cm.linear(p["projector"]["fc2"], h)


def forward_logits(params: Params, cfg: ArchConfig,
                   batch: Dict[str, torch.Tensor], *,
                   backend: kops.Backend = "auto") -> torch.Tensor:
    """Teacher-forced logits (B, I + S, vocab) f32 over the projected image
    prefix and the text tokens."""
    return tf.forward_logits(params, cfg, batch["tokens"],
                             prefix_embed=project(params, batch["image_emb"]),
                             backend=backend)


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, backend: kops.Backend = "auto") -> torch.Tensor:
    """The transformer's loss over the text, with the projected
    ``image_emb`` as its prefix (whose positions the loss leaves out)."""
    return tf.loss_fn(params, cfg,
                      dict(batch,
                           prefix_embed=project(params, batch["image_emb"])),
                      backend=backend)


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            cache_len: int, *, backend: kops.Backend = "auto"
            ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """The transformer's prefill with the projected ``image_emb`` as its
    prefix: ``cache_len`` must hold the I image and S text positions."""
    return tf.prefill(params, cfg, batch["tokens"], cache_len,
                      prefix_embed=project(params, batch["image_emb"]),
                      backend=backend)


cache_spec = tf.cache_spec
init_cache = tf.init_cache
decode_step = tf.decode_step
decode_step_multi = tf.decode_step_multi
