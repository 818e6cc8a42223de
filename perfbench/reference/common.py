"""Plain PyTorch pieces shared by the reference families: float32 math with
TF32 off, no kernel, no cache.  Each sequence is a row of its own; rows
are right-padded to the longest, which a causal model never reads at the
positions compared.

The reference reads the drawn float weights through a getter,
``get(path) -> tensor`` (the leaves of ``perfbench.lib.weights``), and
works out for itself whatever the configuration derives from them: the
§6.1 SINT codes of a linear layer are per-output-channel symmetric int8
codes of its weight (``absmax / 127``), its input codes those of the
activation at the fixed scale 1/127, clipped to ±127, and the product is
the integer product times the two scales.

``Precision`` holds the configuration's stated types.  Its control steps
each of them down one: the integer weight codes to int4 (``absmax / 7``)
and every weight stated in bf16 (embedding, conv filter, experts) to fp8
e4m3, scaled per tensor into its range.  Activations stay f32 in both.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

Getter = Callable[[tuple], torch.Tensor]
F32 = torch.float32
INT_QMAX = {"SINT": 127}
CONTROL_QMAX = {"SINT": 7}       # int8 -> int4
FP8_MAX = 448.0                  # float8_e4m3fn's largest finite value


def set_exact() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """The reference's arithmetic for one configuration, or its control."""

    def __init__(self, quant: Optional[str], control: bool = False):
        self.quant = quant
        self.control = control

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A float weight in f32 (in the control: through fp8 e4m3 when it
        is stated in bf16)."""
        if self.control and w.dtype == torch.bfloat16:
            wf = w.to(F32)
            scale = torch.clamp_min(wf.abs().amax(), 1e-12) / FP8_MAX
            return (wf / scale).to(torch.float8_e4m3fn).to(F32) * scale
        return w.to(F32)

    def dense(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., d_in) f32 through a linear layer with weight (d_in,
        d_out) as drawn: the SINT integer product where the configuration
        quantizes, else the plain product."""
        if self.quant is None:
            return x @ self.weight(w)
        wf = w.to(F32)
        wmax = float((CONTROL_QMAX if self.control else INT_QMAX)[self.quant])
        w_scale = torch.clamp_min(wf.abs().amax(dim=0), 1e-12) / wmax
        wq = torch.clamp(torch.round(wf / w_scale), -wmax, wmax)
        del wf
        xmax = float(INT_QMAX[self.quant])
        x_scale = torch.tensor(1.0 / xmax, dtype=F32, device=x.device)
        xq = torch.clamp(torch.round(x / x_scale), -xmax, xmax)
        return (xq @ wq) * (x_scale * w_scale)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * g.to(F32)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv then SiLU: x (B, T, C), w (K, C), b (C,):
    out[t] = silu(sum_k w[k] x[t - K + 1 + k] + b), zeros before t = 0."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = sum(w[i] * xp[:, i:i + x.shape[1]] for i in range(k))
    return F.silu(y + b)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """The SSD recurrence S_t = exp(dt_t a) S_{t-1} + dt_t x_t b_tᵀ,
    y_t = S_t c_t, from S_0 = 0, in chunks: within a chunk the quadratic
    (attention-like) form, across chunks the carried state.  x (B, T, H,
    P), dt (B, T, H), a (H,), b and c (B, T, H, N) (already one per head);
    returns y (B, T, H, P)."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    pad = (-t) % chunk
    if pad:     # steps with dt = 0 leave the state as it is
        x, b, c = (F.pad(v, (0, 0, 0, 0, 0, pad)) for v in (x, b, c))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (t + pad) // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    bc = b.reshape(bsz, nc, chunk, h, n)
    cc = c.reshape(bsz, nc, chunk, h, n)
    dtc = dt.reshape(bsz, nc, chunk, h)
    s = torch.cumsum(dtc * a, dim=2)                          # (B,c,L,H)
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                  device=x.device))[None, None, :, :, None]
    seg = s[:, :, :, None, :] - s[:, :, None, :, :]           # (B,c,L,L,H)
    decay = torch.exp(torch.where(lower, seg, float("-inf")))
    cb = torch.einsum("bclhn,bcmhn->bclmh", cc, bc)
    y = torch.einsum("bclmh,bcmh,bcmhp->bclhp", decay * cb, dtc, xc)
    w_end = torch.exp(s[:, :, -1:, :] - s) * dtc              # (B,c,L,H)
    contrib = torch.einsum("bclh,bclhp,bclhn->bchpn", w_end, xc, bc)
    state = torch.zeros((bsz, h, p, n), dtype=F32, device=x.device)
    carried = []
    for i in range(nc):
        carried.append(torch.exp(s[:, i])[..., None] * torch.einsum(
            "blhn,bhpn->blhp", cc[:, i], state))
        state = torch.exp(s[:, i, -1])[:, :, None, None] * state \
            + contrib[:, i]
    y = y + torch.stack(carried, dim=1)
    return y.reshape(bsz, nc * chunk, h, p)[:, :t]


def mamba_mixer(prec: Precision, get: Getter, at: tuple, idx: tuple,
                x: torch.Tensor, *, d_inner: int, headdim: int,
                groups: int, state: int) -> torch.Tensor:
    """A Mamba-2 mixer [arXiv:2405.21060] over x (B, T, D) f32: in_proj
    to (z, xBC, dt), causal conv over xBC, the SSD with the D skip, the
    gated RMSNorm (norm(y * silu(z))), out_proj.  ``at`` is the path of
    the mixer's params, ``idx`` the layer's index into their stack."""
    def leaf(*name):
        return get(at + name)[idx]

    h = d_inner // headdim
    gn = groups * state
    zxbcdt = prec.dense(x, leaf("in_proj", "w"))
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * gn]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * gn:]
    conv = causal_conv(xbc, prec.weight(leaf("conv_w")),
                       leaf("conv_b").to(F32))
    bsz, t, _ = x.shape
    xs = conv[..., :d_inner].reshape(bsz, t, h, headdim)
    reps = h // groups
    bm = conv[..., d_inner:d_inner + gn].reshape(bsz, t, groups, state)
    cm = conv[..., d_inner + gn:].reshape(bsz, t, groups, state)
    bm = torch.repeat_interleave(bm, reps, dim=2)
    cm = torch.repeat_interleave(cm, reps, dim=2)
    dt = F.softplus(dt_raw + leaf("dt_bias").to(F32))
    a = -torch.exp(leaf("a_log").to(F32))
    y = ssd(xs, dt, a, bm, cm) + leaf("d_skip").to(F32)[:, None] * xs
    y = y.reshape(bsz, t, d_inner) * F.silu(z)
    y = rmsnorm(y, leaf("norm", "g"))
    return prec.dense(y, leaf("out_proj", "w"))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split form, positions 0..T-1: x (B, T, H,
    D)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=F32,
                                          device=x.device) / d))
    ang = torch.arange(x.shape[1], dtype=F32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(prec: Precision, get: Getter, at: tuple, idx: tuple,
              x: torch.Tensor, *, heads: int, kv_heads: int,
              theta: float) -> torch.Tensor:
    """Causal grouped-query attention over x (B, T, D) f32: query head j
    reads key/value head j // (heads / kv_heads); softmax of q kᵀ / sqrt(D
    head)."""
    def proj(name):
        return prec.dense(x, get(at + (name, "w"))[idx])

    bsz, t, d = x.shape
    dh = d // heads
    q = rope(proj("wq").reshape(bsz, t, heads, dh), theta)
    k = rope(proj("wk").reshape(bsz, t, kv_heads, dh), theta)
    v = proj("wv").reshape(bsz, t, kv_heads, dh)
    k = torch.repeat_interleave(k, heads // kv_heads, dim=2)
    v = torch.repeat_interleave(v, heads // kv_heads, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(dh)
    causal = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    scores = torch.where(causal, scores, float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)
    return prec.dense(out.reshape(bsz, t, d), get(at + ("wo", "w"))[idx])


def swiglu(prec: Precision, get: Getter, at: tuple, idx: tuple,
           x: torch.Tensor) -> torch.Tensor:
    """silu(x W_gate) * (x W_up), then W_down."""
    def proj(name, v):
        return prec.dense(v, get(at + (name, "w"))[idx])
    return proj("w_down", F.silu(proj("w_gate", x)) * proj("w_up", x))


def moe(prec: Precision, get: Getter, at: tuple, idx: tuple,
        x: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Top-k mixture of SwiGLU experts, every routed token computed (no
    capacity): router softmax over the experts held, the k largest (ties
    to the lower index), their weights renormalised to sum to 1."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    probs = torch.softmax(xt @ get(at + ("router",))[idx].to(F32), dim=-1)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[:, :top_k], expert[:, :top_k]
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(xt)
    for e in range(probs.shape[-1]):
        rows, slot = torch.nonzero(expert == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        wg, wu, wd = (prec.weight(get(at + (n,))[idx][e])
                      for n in ("w_gate", "w_up", "w_down"))
        xe = xt[rows]
        ye = (F.silu(xe @ wg) * (xe @ wu)) @ wd
        del wg, wu, wd
        out.index_add_(0, rows, ye * gate[rows, slot][:, None])
    return out.reshape(shape)


def logits_at(get: Getter, prec: Precision, x: torch.Tensor,
              rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The tied unembedding's logits (n, vocab) at the (row, position)
    pairs of x (B, T, D), after the final RMSNorm."""
    h = rmsnorm(x[rows, cols], get(("final_norm", "g")))
    return h @ prec.weight(get(("embed", "emb"))).t()


def embed(get: Getter, prec: Precision, tokens: torch.Tensor
          ) -> torch.Tensor:
    return prec.weight(get(("embed", "emb")))[tokens]
