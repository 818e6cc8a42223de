"""Plain reference of the attention-free Mamba-2 language model
[arXiv:2405.21060] (the ``ssm`` family): embedding, ``n_layers`` of
x + mixer(rmsnorm(x)), the final RMSNorm, the tied unembedding.  f32
throughout, the whole sequence at once, no state carried between calls."""

from __future__ import annotations

from typing import Any, Dict

import torch

from perfbench.reference import common as rc


def hidden(get: rc.Getter, m: Dict[str, Any], prec: rc.Precision,
           tokens: torch.Tensor) -> torch.Tensor:
    """The last layer's output (B, T, D) f32 for tokens (B, T)."""
    x = rc.embed(get, prec, tokens)
    d_inner = m["ssm_expand"] * m["d_model"]
    for layer in range(m["n_layers"]):
        h = rc.rmsnorm(x, get(("blocks", "ln", "g"))[layer])
        x = x + rc.mamba_mixer(
            prec, get, ("blocks", "mixer"), (layer,), h, d_inner=d_inner,
            headdim=m["ssm_headdim"], groups=m["ssm_groups"],
            state=m["ssm_state"])
    return x
