"""Mixture-of-Experts FFN (``repro.models.moe``'s counterpart):
granite-moe (32 experts, top-8) and mixtral (8 experts, top-2).

Two dispatch implementations, as in the reference:

* ``einsum`` (the default): GShard one-hot dispatch and combine tensors with
  a fixed capacity per expert, in groups of ``cfg.moe_group`` tokens;
  capacity C = ceil(group · top_k / E · capacity_factor).  A token's slot k
  beyond its expert's capacity is dropped.
* ``ragged``: tokens sorted (stably) by expert, then one ``torch.matmul``
  per run of an expert's rows — the reference's ``lax.ragged_dot``, which is
  plain XLA, not a Pallas kernel.  No capacity drop.

The router's top-k breaks ties toward the lower expert index, as
``lax.top_k`` does: a stable descending sort, first k.  Its logits are
computed in the activation dtype (softmax in f32), so bf16 ties are real.
The experts' weights are plain (not §6.1-quantized), as in the reference;
the attention projections go through ``common.linear``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import trace
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf

Params = Dict[str, Any]


def moe_init(generator: torch.Generator, cfg: ArchConfig) -> Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dev = generator.device
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    return {
        "router": normal((d, e), 0.02),
        "w_gate": normal((e, d, f), s_in).to(cfg.dtype),
        "w_up": normal((e, d, f), s_in).to(cfg.dtype),
        "w_down": normal((e, f, d), s_out).to(cfg.dtype),
    }


def _capacity(group: int, cfg: ArchConfig) -> int:
    c = int(math.ceil(group * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(c, 1)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot; an index outside [0, n) gives a zero row, as
    ``jax.nn.one_hot`` (``F.one_hot`` would raise)."""
    ids = cm.replicated_like(torch.arange(n, device=idx.device), idx)
    return (idx[..., None] == ids).to(torch.float32)


def _route_parts(router: torch.Tensor, cfg: ArchConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: gate weights (G, T, K), expert indices (G, T, K) and the
    softmax (G, T, E)."""
    logits = (x @ router.to(x.dtype)).to(torch.float32)         # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the k largest, ties to the lower index.
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :cfg.top_k], idx[..., :cfg.top_k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return gate, idx, probs


def _route(p: Params, cfg: ArchConfig, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (gate weights (G, T, K), expert indices (G, T, K), the
    load-balance aux loss)."""
    gate, idx, probs = _route_parts(p["router"], cfg, x)
    # Switch-style load-balance aux loss: E * mean(frac_tokens * frac_probs).
    e = cfg.n_experts
    frac_tokens = _one_hot(idx[..., 0], e).mean(dim=(0, 1))    # top-1 counts
    frac_probs = probs.mean(dim=(0, 1))
    return gate, idx, e * torch.sum(frac_tokens * frac_probs)


def _dispatch_combine(gate: torch.Tensor, idx: torch.Tensor,
                      cfg: ArchConfig, c: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (G, T, E, C) dispatch and combine tensors of a routing."""
    g, group, k = idx.shape
    e = cfg.n_experts
    # Position in expert with slot priority: slot 0 of every token beats
    # slot 1 (GShard's order), then token order.
    mask = _one_hot(idx, e)                                     # (G,T,K,E)
    mask_flat = mask.transpose(1, 2).reshape(g, k * group, e)
    pos_flat = torch.cumsum(mask_flat, dim=1) - mask_flat       # (G,KT,E)
    pos = pos_flat.reshape(g, k, group, e).transpose(1, 2)      # (G,T,K,E)
    pos = torch.sum(pos * mask, dim=-1).to(torch.int64)         # (G,T,K)
    keep = (pos < c) & (gate > 0)
    gate = gate * keep
    pos_oh = _one_hot(pos, c)                                   # (G,T,K,C)
    dispatch = torch.einsum("gtke,gtkc->gtec", mask * keep[..., None],
                            pos_oh)
    combine = torch.einsum("gtke,gtkc->gtec", mask * gate[..., None], pos_oh)
    return dispatch, combine


def _expert_ffn(xin: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU FFN: xin (G, E, C, D) -> (G, E, C, D)."""
    h = torch.einsum("gecd,edf->gecf", xin, w_gate)
    u = torch.einsum("gecd,edf->gecf", xin, w_up)
    return torch.einsum("gecf,efd->gecd", F.silu(h) * u, w_down)


def moe_forward_einsum(p: Params, cfg: ArchConfig, x: torch.Tensor,
                       group: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard one-hot dispatch.  x: (B, S, D) -> (out, aux_loss)."""
    if isinstance(p["w_gate"], DTensor):
        return _moe_sharded(p, cfg, x, group)
    b, s, d = x.shape
    tokens = b * s
    group = min(group or cfg.moe_group, tokens)
    assert tokens % group == 0, (tokens, group)
    g = tokens // group
    xg = x.reshape(g, group, d)

    gate, idx, aux = _route(p, cfg, xg)                         # (G, T, K)
    # Dispatch/combine tensors (G, T, E, C).
    dispatch, combine = _dispatch_combine(gate, idx, cfg,
                                          _capacity(group, cfg))

    ddt = getattr(torch, cfg.moe_dispatch_dtype)
    # To experts: (G, E, C, D), expert-major (an all-to-all under a mesh
    # whose hook shards the expert axis).
    xin = torch.einsum("gtec,gtd->gecd", dispatch.to(ddt), xg.to(ddt))
    xin = cm.constrain(xin.to(cfg.dtype), "expert_in")

    out_e = _expert_ffn(xin, p["w_gate"], p["w_up"], p["w_down"])
    out_e = cm.constrain(out_e, "expert_in")

    out = torch.einsum("gtec,gecd->gtd", combine.to(ddt), out_e.to(ddt))
    return out.reshape(b, s, d).to(x.dtype), aux


def _moe_sharded(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 group: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_forward_einsum` on DTensor params, per shard
    (``local_map``).

    Along a mesh dim that shards the experts (``w_*`` on dim 0) each rank
    routes the tokens it holds, takes its own experts' slice of the
    dispatched tokens (what the ``"expert_in"`` layout puts on it) and
    combines their outputs with its slice of the combine tensor; along one
    that shards the FFN hidden dim (the fallback when the axis does not
    divide the expert count) it runs every expert on its hidden columns.
    Either way a rank holds part of each token's output, a pending sum.
    Along a dim where the weights replicate the rows stay sharded when
    each shard holds whole routing groups (else every rank of it computes
    alike).  The aux loss's token and probability fractions are partial
    sums over the row shards, counted once along a weight-sharded dim."""
    w_gate = p["w_gate"]
    mesh = w_gate.device_mesh
    b, s, d = x.shape
    tokens = b * s
    group = min(group or cfg.moe_group, tokens)
    assert tokens % group == 0, (tokens, group)
    x = cm.replicated_like(x, w_gate)
    rows = [i for i, pl in enumerate(x.placements)
            if pl.is_shard(0) and mesh.size(i) > 1
            and w_gate.placements[i] == Replicate()]
    n_rows = math.prod(mesh.size(i) for i in rows)
    if b % n_rows or (b // n_rows * s) % group:
        rows = []
    coord = mesh.get_coordinate()
    split = [i for i, pl in enumerate(w_gate.placements)
             if pl.is_shard(0) or pl.is_shard(2)]
    # The routing runs alike on every rank of a weight-sharded dim; the
    # fractions count once there, on its first rank.
    lead = float(all(coord[i] == 0 for i in split))
    expert_dim = next((i for i, pl in enumerate(w_gate.placements)
                       if pl.is_shard(0)), None)
    e, ddt = cfg.n_experts, getattr(torch, cfg.moe_dispatch_dtype)
    c = _capacity(group, cfg)

    def local(x, router, w_gate, w_up, w_down):
        b_l = x.shape[0]
        xg = x.reshape(b_l * s // group, group, d)
        gate, idx, probs = _route_parts(router, cfg, xg)
        frac_tokens = _one_hot(idx[..., 0], e).sum(dim=(0, 1)) \
            * (lead / tokens)
        frac_probs = probs.sum(dim=(0, 1)) * (lead / tokens)
        dispatch, combine = _dispatch_combine(gate, idx, cfg, c)
        xin = torch.einsum("gtec,gtd->gecd", dispatch.to(ddt),
                           xg.to(ddt)).to(cfg.dtype)
        if expert_dim is not None:
            n = w_gate.shape[0]
            mine = slice(coord[expert_dim] * n, (coord[expert_dim] + 1) * n)
            xin, combine = xin[:, mine], combine[:, :, mine]
        out_e = _expert_ffn(xin, w_gate, w_up, w_down)
        out = torch.einsum("gtec,gecd->gtd", combine.to(ddt), out_e.to(ddt))
        return out.reshape(b_l, s, d).to(x.dtype), frac_tokens, frac_probs

    ins, grads, out_pl, frac_pl = ([[] for _ in range(5)],
                                   [[] for _ in range(5)], [], [])
    for i, pl in enumerate(w_gate.placements):
        frac_pl.append(Partial() if i in rows or i in split
                       else Replicate())
        if i in rows:
            x_in, w_in, o = Shard(0), (Replicate(),) * 3, Shard(0)
            x_g, r_g, w_g = Shard(0), Partial(), (Partial(),) * 3
        elif pl.is_shard(0) or pl.is_shard(2):        # experts, or hidden
            x_in = Replicate()
            w_in = ((Shard(0),) * 3 if pl.is_shard(0)
                    else (Shard(2), Shard(2), Shard(1)))
            o, x_g, r_g, w_g = Partial(), Partial(), Partial(), w_in
        else:                                          # alike on every rank
            x_in, w_in, o = Replicate(), (Replicate(),) * 3, Replicate()
            x_g, r_g, w_g = Replicate(), Replicate(), (Replicate(),) * 3
        for lst, v in zip(ins, (x_in, Replicate()) + w_in):
            lst.append(v)
        for lst, v in zip(grads, (x_g, r_g) + w_g):
            lst.append(v)
        out_pl.append(o)
    fn = local_map(local, out_placements=(out_pl, frac_pl, frac_pl),
                   in_placements=tuple(ins), in_grad_placements=tuple(grads),
                   device_mesh=mesh, redistribute_inputs=True)
    out, frac_tokens, frac_probs = fn(x, p["router"], w_gate, p["w_up"],
                                      p["w_down"])
    return out, e * torch.sum(frac_tokens * frac_probs)


def moe_forward_ragged(p: Params, cfg: ArchConfig, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted dispatch: no capacity drop and no one-hot products; each
    expert's run of the sorted rows is one matmul (``lax.ragged_dot``)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)

    gate, idx, aux = _route(p, cfg, xt[None])                   # (1, T, K)
    gate, idx = gate[0], idx[0]

    flat_expert = idx.reshape(-1)                               # (T*K,)
    order = torch.argsort(flat_expert, stable=True)
    token_of = order // k
    xs = xt[token_of].to(cfg.dtype)                             # (T*K, D)
    ends = torch.cumsum(torch.bincount(flat_expert, minlength=e), 0).tolist()

    ys = torch.empty((t * k, d), dtype=cfg.dtype, device=x.device)
    start = 0
    for ex, end in enumerate(ends):
        if end > start:
            rows = xs[start:end]
            h = rows @ p["w_gate"][ex]
            u = rows @ p["w_up"][ex]
            hu = (F.silu(h.to(torch.float32))
                  * u.to(torch.float32)).to(cfg.dtype)
            ys[start:end] = hu @ p["w_down"][ex]
        start = end

    w = gate.reshape(-1)[order].to(torch.float32)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, token_of, ys.to(torch.float32) * w[:, None])
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_forward(p: Params, cfg: ArchConfig, x: torch.Tensor,
                dispatch: str = "einsum") -> torch.Tensor:
    """The FFN interface: the output alone (training adds the aux term
    through :func:`forward_logits`).  One ``model.moe`` span of
    :mod:`repro_torch.trace`: router, dispatch, experts and combine."""
    fn = moe_forward_einsum if dispatch == "einsum" else moe_forward_ragged
    with trace.span("model.moe", device=x):
        out, _ = fn(p, cfg, x)
    return out


def make_ffn_apply(cfg: ArchConfig, dispatch: str = "einsum"):
    return lambda p, h: moe_forward(p, cfg, h, dispatch)


# ---------------------------------------------------------------------------
# Full MoE decoder (granite, mixtral): transformer blocks with the MoE FFN.
# ---------------------------------------------------------------------------

AUX_WEIGHT = 0.01   # the load-balance aux loss's weight in the train loss


def model_init(generator: torch.Generator, cfg: ArchConfig, *,
               device: torch.device) -> Params:
    return tf.decoder_init(generator, cfg, device=device,
                           ffn_init=lambda g: moe_init(g, cfg))


def forward_logits(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                   dispatch: str = "einsum", *,
                   backend: kops.Backend = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits (B, S, vocab) f32 and the mean aux loss; each
    layer rematerialised under autograd when ``cfg.remat == "layer"``."""
    x = cm.embed(params["embed"], tokens).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    fwd = moe_forward_einsum if dispatch == "einsum" else moe_forward_ragged
    acfg = tf._attn_cfg(cfg)

    def body(blk, h):
        h = h + cm.attn_forward(blk["attn"], acfg,
                                cm.rmsnorm(blk["ln1"], h), positions,
                                backend=backend)
        out, aux_l = fwd(blk["ffn"], cfg, cm.rmsnorm(blk["ln2"], h))
        return cm.constrain(h + out, "btd"), aux_l

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in cm.unstack(params["blocks"], cfg.n_layers):
        x, aux_l = cm.remat(cfg.remat, body, blk, x)
        aux = aux + aux_l
    x = cm.rmsnorm(params["final_norm"], x)
    return cm.unembed(params["embed"], x), aux / cfg.n_layers


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            dispatch: str = "einsum", *, backend: kops.Backend = "auto"
            ) -> torch.Tensor:
    """Cross-entropy plus ``AUX_WEIGHT`` times the mean load-balance aux
    loss."""
    logits, aux = forward_logits(params, cfg, batch["tokens"], dispatch,
                                 backend=backend)
    return cm.cross_entropy(logits, batch["labels"]) + AUX_WEIGHT * aux


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int, dispatch: str = "einsum", *,
            backend: kops.Backend = "auto"):
    return tf.prefill(params, cfg, tokens, cache_len,
                      ffn_apply=make_ffn_apply(cfg, dispatch),
                      backend=backend)


def decode_step(params: Params, cfg: ArchConfig, cache, tokens, pos,
                dispatch: str = "einsum", *, backend: kops.Backend = "auto"):
    return tf.decode_step(params, cfg, cache, tokens, pos,
                          ffn_apply=make_ffn_apply(cfg, dispatch),
                          backend=backend)


def decode_step_multi(params: Params, cfg: ArchConfig, cache, tokens, pos,
                      dispatch: str = "einsum", *,
                      backend: kops.Backend = "auto"):
    """Per-slot-position decode (pos (B,)) — see
    ``transformer.decode_step_multi``.  Capacity-grouped routing couples
    the rows decoded together."""
    return tf.decode_step_multi(params, cfg, cache, tokens, pos,
                                ffn_apply=make_ffn_apply(cfg, dispatch),
                                backend=backend)


cache_spec = tf.cache_spec
init_cache = tf.init_cache
