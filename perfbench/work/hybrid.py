"""The least time of the Jamba hybrid's work on one H100, from its shapes
(the ``hybrid`` family): the Mamba-2 mixers as ``work/ssm.py`` counts
them, the attention layer (its projections and the causal half of its
score and value products), the dense SwiGLU MLPs, and the experts' and
router's products for the routed tokens; every expert held is read once
a step at decode, as the program's dispatch runs them all."""

from __future__ import annotations

from typing import Any, Dict

from perfbench.lib import bounds as bd
from perfbench.work import ssm


def _layout(m: Dict[str, Any]):
    period = m["attn_period"]
    n_super = m["n_layers"] // period
    return n_super, n_super * (period - 1), n_super * (period // 2), \
        n_super * (period - period // 2)


def _attn_widths(m: Dict[str, Any]):
    d = m["d_model"]
    dh = d // m["n_heads"]
    return d, dh, m["n_heads"] * dh, m["n_kv_heads"] * dh


def prefill_least_s(m: Dict[str, Any], bsz: int, t: int) -> float:
    """A prefill of (bsz, t) tokens, logits at the last position."""
    q, rows = m.get("quant"), bsz * t
    n_super, n_mamba, n_moe, n_mlp = _layout(m)
    d, dh, hq, hkv = _attn_widths(m)
    f, e, k = m["d_ff"], m["n_experts"], m["top_k"]
    pairs = bsz * m["n_heads"] * t * (t + 1) // 2   # causal (query, key)
    attn = (2 * bd.linear_bound(rows, d, hq, q)[0]
            + 2 * bd.linear_bound(rows, d, hkv, q)[0]
            + bd.bound(2 * rows * (2 * hq + 2 * hkv),
                       bd.product_seconds(4 * pairs * dh, "bfloat16"))[0])
    mlp = 2 * bd.linear_bound(rows, d, f, q)[0] \
        + bd.linear_bound(rows, f, d, q)[0]
    experts = bd.bound(2 * e * 3 * d * f + 2 * rows * d * (1 + k),
                       bd.product_seconds(rows * k * 6 * d * f
                                          + 2 * rows * d * e,
                                          "bfloat16"))[0]
    return (n_mamba * ssm.mixer_prefill_s(m, bsz, t) + n_super * attn
            + n_mlp * mlp + n_moe * experts + ssm.unembed_s(m, bsz))


def decode_roofline_s(m: Dict[str, Any], slots: int, cache_len: int
                      ) -> float:
    """One decode step of ``slots`` tokens: every held weight, state and
    cache read once, the state written once (bytes), against its
    products."""
    quant = m.get("quant")
    n_super, n_mamba, n_moe, n_mlp = _layout(m)
    d, dh, hq, hkv = _attn_widths(m)
    f, e, k = m["d_ff"], m["n_experts"], m["top_k"]
    per = 1 if quant else 2
    scales = 4 if quant else 0
    attn_w = (2 * d * hq + 2 * d * hkv) * per + scales * (2 * hq + 2 * hkv)
    mlp_w = 3 * d * f * per + scales * (2 * f + d)
    moe_w = 2 * e * 3 * d * f + 4 * d * e
    kv = 2 * 2 * slots * cache_len * hkv
    moved = (n_mamba * (ssm.mixer_held_bytes(m)
                        + ssm.mixer_state_bytes(m, slots))
             + n_super * (attn_w + kv) + n_mlp * mlp_w + n_moe * moe_w
             + 2 * m["vocab"] * d)
    kind = "int8" if quant else "bfloat16"
    ops = (n_mamba * ssm.mixer_decode_flop_s(m, slots)
           + n_super * (bd.product_seconds(2 * slots * d * 2 * (hq + hkv),
                                           kind)
                        + bd.product_seconds(4 * slots * m["n_heads"]
                                             * cache_len * dh, "bfloat16"))
           + n_mlp * bd.product_seconds(6 * slots * d * f, kind)
           + n_moe * bd.product_seconds(slots * k * 6 * d * f
                                        + 2 * slots * d * e, "bfloat16")
           + bd.product_seconds(2 * slots * d * m["vocab"], "bfloat16"))
    return bd.bound(moved, ops)[0]
