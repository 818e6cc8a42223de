"""Plain reference of the Jamba hybrid [arXiv:2403.19887] (the ``hybrid``
family): super-blocks of ``attn_period`` sublayers, attention at position
``attn_period // 2 - 1`` and a Mamba-2 mixer elsewhere, each followed by
its FFN: a top-k mixture of experts at odd positions, a dense SwiGLU MLP
at even ones; pre-norm residuals throughout, the tied unembedding.  f32,
the whole sequence at once, every routed token computed."""

from __future__ import annotations

from typing import Any, Dict

import torch

from perfbench.reference import common as rc


def hidden(get: rc.Getter, m: Dict[str, Any], prec: rc.Precision,
           tokens: torch.Tensor) -> torch.Tensor:
    """The last layer's output (B, T, D) f32 for tokens (B, T)."""
    period = m["attn_period"]
    attn_pos = period // 2 - 1
    d_inner = m["ssm_expand"] * m["d_model"]
    x = rc.embed(get, prec, tokens)
    for s in range(m["n_layers"] // period):
        j = 0
        for i in range(period):
            if i == attn_pos:
                at = ("blocks", "attn")
                h = rc.rmsnorm(x, get(at + ("ln", "g"))[s])
                x = x + rc.attention(
                    prec, get, at + ("attn",), (s,), h, heads=m["n_heads"],
                    kv_heads=m["n_kv_heads"], theta=m["rope_theta"])
            else:
                at = ("blocks", "mamba")
                h = rc.rmsnorm(x, get(at + ("ln", "g"))[s, j])
                x = x + rc.mamba_mixer(
                    prec, get, at + ("mixer",), (s, j), h, d_inner=d_inner,
                    headdim=m["ssm_headdim"], groups=m["ssm_groups"],
                    state=m["ssm_state"])
                j += 1
            if i % 2:
                at = ("blocks", "moe")
                h = rc.rmsnorm(x, get(at + ("ln", "g"))[s, i // 2])
                x = x + rc.moe(prec, get, at + ("moe",), (s, i // 2), h,
                               top_k=m["top_k"])
            else:
                at = ("blocks", "mlp")
                h = rc.rmsnorm(x, get(at + ("ln", "g"))[s, i // 2])
                x = x + rc.swiglu(prec, get, at + ("mlp",), (s, i // 2), h)
    return x
