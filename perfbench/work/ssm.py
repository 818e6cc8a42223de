"""The least time of the Mamba-2 model's work on one H100, from its shapes
(the ``ssm`` family): per layer in_proj, the SSD scan, out_proj; the
unembedding of the positions that give logits.  Elementwise passes (norms,
conv, gating) are not products and are not counted."""

from __future__ import annotations

from typing import Any, Dict

from perfbench.lib import bounds as bd


def dims(m: Dict[str, Any]):
    d_inner = m["ssm_expand"] * m["d_model"]
    gn = m["ssm_groups"] * m["ssm_state"]
    heads = d_inner // m["ssm_headdim"]
    proj_out = 2 * d_inner + 2 * gn + heads
    return d_inner, gn, heads, proj_out


def mixer_prefill_s(m: Dict[str, Any], bsz: int, t: int) -> float:
    """One mixer's in_proj, SSD (x, B and C read as bf16 views of the
    conv's output, the final state written) and out_proj."""
    d, q = m["d_model"], m.get("quant")
    d_inner, gn, heads, proj_out = dims(m)
    rows = bsz * t
    return (bd.linear_bound(rows, d, proj_out, q)[0]
            + bd.ssd_bound(bsz, t, heads, m["ssm_headdim"], m["ssm_groups"],
                           m["ssm_state"], "bfloat16",
                           2 * rows * (d_inner + 2 * gn), True)[0]
            + bd.linear_bound(rows, d_inner, d, q)[0])


def unembed_s(m: Dict[str, Any], rows: int) -> float:
    d, v = m["d_model"], m["vocab"]
    return bd.bound(2 * (rows * d + v * d) + 4 * rows * v,
                    bd.product_seconds(2 * rows * d * v, "bfloat16"))[0]


def prefill_least_s(m: Dict[str, Any], bsz: int, t: int) -> float:
    """A prefill of (bsz, t) tokens, logits at the last position."""
    return m["n_layers"] * mixer_prefill_s(m, bsz, t) + unembed_s(m, bsz)


def mixer_held_bytes(m: Dict[str, Any]) -> int:
    """One mixer's weights as held: int8 codes and f32 scales of the two
    projections (bf16 without quantization) and the bf16 conv filter."""
    d = m["d_model"]
    d_inner, gn, _, proj_out = dims(m)
    per = 1 if m.get("quant") else 2
    proj = (d * proj_out + d_inner * d) * per \
        + (4 * (proj_out + d) if m.get("quant") else 0)
    return proj + 2 * m["conv_kernel"] * (d_inner + 2 * gn)


def mixer_state_bytes(m: Dict[str, Any], slots: int) -> int:
    """One mixer's decode state: the f32 SSM state and the bf16 conv
    window, read and written once a step."""
    d_inner, gn, heads, _ = dims(m)
    ssm = 4 * slots * heads * m["ssm_headdim"] * m["ssm_state"]
    conv = 2 * slots * (m["conv_kernel"] - 1) * (d_inner + 2 * gn)
    return 2 * (ssm + conv)


def mixer_decode_flop_s(m: Dict[str, Any], slots: int) -> float:
    d = m["d_model"]
    d_inner, _, _, proj_out = dims(m)
    kind = "int8" if m.get("quant") else "bfloat16"
    return bd.product_seconds(2 * slots * d * (proj_out + d_inner), kind)


def decode_roofline_s(m: Dict[str, Any], slots: int, cache_len: int
                      ) -> float:
    """One decode step of ``slots`` tokens: every held weight and state
    read once, the state written once (bytes), against its products."""
    n = m["n_layers"]
    moved = (n * (mixer_held_bytes(m) + mixer_state_bytes(m, slots))
             + 2 * m["vocab"] * m["d_model"])
    ops = n * mixer_decode_flop_s(m, slots) + bd.product_seconds(
        2 * slots * m["d_model"] * m["vocab"], "bfloat16")
    return bd.bound(moved, ops)[0]
