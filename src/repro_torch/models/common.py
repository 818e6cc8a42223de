"""Shared primitives of the LLM/SSM families (``repro.models.common``'s
counterpart): linear, norm and embedding, rotary embeddings, grouped-query
attention with its static KV cache (and the §6.1 int8 cache), and the MLP
variants.

Conventions, as in the reference: params are nested dicts of tensors, with
per-layer params **stacked** on a leading layer axis (:func:`stack_layers`
builds them layer by layer); activations compute in ``cfg.dtype`` (bf16),
scores, softmax, norms and logits in f32; every linear layer goes through
:func:`linear`, which takes the paper's §6.1 integer path when the params
carry quantized weights (SINT through ``ops.quantized_matmul``, the
``qmatmul`` kernel).  Attention is plain PyTorch (the reference's einsum
form; XLA computes it outside any Pallas kernel).  The decode functions
write the new K/V into the cache tensors they are given, in place (the
reference's donated cache); a write position past the cache's end lands on
its last row, as ``lax.dynamic_update_slice`` clamps its start.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import trace
from repro_torch.core.layers import TORCH_INT_TYPES
from repro_torch.core.quantize import quantize_tensor
from repro_torch.kernels import ops as kops

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Activation-sharding hook.  `repro_torch.launch.shardings.install_hook` sets
# a function mapping (tensor, logical name) to the tensor laid out for a mesh
# (a DTensor redistributed to the reference's placements); with no hook, or
# for a plain tensor, `constrain` is the identity.  Models stay mesh-agnostic.
# ---------------------------------------------------------------------------

_CONSTRAIN_HOOK: Optional[Callable[[torch.Tensor, str], torch.Tensor]] = None


def set_constrain_hook(
        fn: Optional[Callable[[torch.Tensor, str], torch.Tensor]]) -> None:
    global _CONSTRAIN_HOOK
    _CONSTRAIN_HOOK = fn


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` through the installed activation-sharding hook under the
    logical name ``name`` (``"btd"``, ``"expert_in"``); the identity when no
    hook is installed."""
    if _CONSTRAIN_HOOK is None:
        return x
    return _CONSTRAIN_HOOK(x, name)


def replicated_like(t: Any, x: torch.Tensor) -> Any:
    """``t``, a plain tensor the model makes (a rotary table, a mask, or a
    dict of them), as a ``Replicate()`` DTensor on the mesh of ``x`` when
    ``x`` is a DTensor, so the two can meet in one op; ``t`` itself
    otherwise.  Every rank makes the same ``t``, so no data moves."""
    if isinstance(t, dict):
        return {k: replicated_like(v, x) for k, v in t.items()}
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


# ---------------------------------------------------------------------------
# Linear / norm / embedding
# ---------------------------------------------------------------------------


def linear_init(generator: torch.Generator, d_in: int, d_out: int, *,
                bias: bool, quant: Optional[str],
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """One linear layer, ``N(0, 1 / d_in)`` weights drawn from ``generator``
    (on its device), quantized per channel when ``quant`` names an IEC
    integer type."""
    std = 1.0 / np.sqrt(d_in)
    w = (torch.randn((d_in, d_out), generator=generator,
                     device=generator.device) * std).to(dtype)
    if quant is None:
        p = {"w": w}
    else:
        qt = quantize_tensor(w.to(torch.float32), quant)
        p = {"qw": qt.q, "w_scale": qt.scale,
             "x_scale": torch.tensor(1.0 / 127.0, dtype=torch.float32,
                                     device=w.device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=w.device)
    return p


def linear(p: Params, x: torch.Tensor, *, backend: kops.Backend = "auto"
           ) -> torch.Tensor:
    """Apply a (possibly integer-quantized) linear layer to (..., d_in):
    one ``model.linear`` span of :mod:`repro_torch.trace` (the quantize,
    the product and the cast back)."""
    with trace.span("model.linear", device=x):
        return _linear(p, x, backend)


def _linear(p: Params, x: torch.Tensor, backend: kops.Backend
            ) -> torch.Tensor:
    if "qw" in p:
        qw = p["qw"]
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        # Symmetric clip, matching quantize_tensor's weight range.
        qmax = float(torch.iinfo(qw.dtype).max)
        xq = torch.clamp(torch.round(x2 / p["x_scale"]), -qmax, qmax)
        scale = p["x_scale"] * p["w_scale"]
        if qw.dtype == TORCH_INT_TYPES["SINT"]:
            # SINT: int8 x int8 -> int32 products (the qmatmul kernel).
            y = kops.quantized_matmul(xq.to(qw.dtype), qw, scale, p.get("b"),
                                      backend=backend)
        else:
            # INT/DINT: emulated in f32 on the integer grid (int16/int32
            # products would overflow int32 accumulation), as the reference.
            y = xq @ qw.to(torch.float32) * scale
            if p.get("b") is not None:
                y = y + p["b"]
        return y.reshape(*lead, qw.shape[-1]).to(x.dtype)
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(d: int, device: torch.device) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * p["g"]).to(x.dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.bfloat16) -> Params:
    return {"emb": (torch.randn((vocab, d), generator=generator,
                                device=generator.device) * 0.02).to(dtype)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(p["emb"], DTensor):
        return _embed_sharded(p["emb"], tokens)
    return p["emb"][tokens]


def _embed_sharded(emb: DTensor, tokens: torch.Tensor) -> DTensor:
    """:func:`embed` of a DTensor table, per shard (``local_map``): along
    the mesh dim that shards the vocab each rank looks up the tokens its
    rows hold and zeros the others, and the pending sum is reduced; along
    one that shards the tokens' rows each rank looks up its rows (the
    table's gradient a partial sum over them)."""
    mesh = emb.device_mesh
    tokens = replicated_like(tokens, emb)
    tok_pl, emb_pl, out_pl, grad_pl = [], [], [], []
    vocab_dim = None
    for i, pl in enumerate(emb.placements):
        if pl.is_shard(0):
            vocab_dim = i
            tok_pl.append(Replicate())
            emb_pl.append(Shard(0))
            out_pl.append(Partial())
            grad_pl.append(Shard(0))
        else:
            rows = tokens.placements[i].is_shard(0)
            tok_pl.append(Shard(0) if rows else Replicate())
            emb_pl.append(Replicate())
            out_pl.append(Shard(0) if rows else Replicate())
            grad_pl.append(Partial() if rows else Replicate())

    def local(tokens, emb):
        if vocab_dim is None:
            return emb[tokens]
        start = mesh.get_local_rank(vocab_dim) * emb.shape[0]
        ids = tokens - start
        own = (ids >= 0) & (ids < emb.shape[0])
        rows = emb[torch.where(own, ids, torch.zeros_like(ids))]
        return torch.where(own[..., None], rows, torch.zeros_like(rows))

    x = local_map(local, out_placements=out_pl,
                  in_placements=(tuple(tok_pl), tuple(emb_pl)),
                  in_grad_placements=(tuple(tok_pl), tuple(grad_pl)),
                  device_mesh=mesh, redistribute_inputs=True)(tokens, emb)
    return x.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                                 for pl in x.placements])


def pad(t: torch.Tensor, widths: Tuple[int, ...]) -> torch.Tensor:
    """``F.pad(t, widths)`` with zeros; ``t`` itself when every width is 0,
    and a DTensor padded shard by shard (its padded dims whole)."""
    if not any(widths):
        return t
    if isinstance(t, DTensor):
        return local_map(lambda x: F.pad(x, widths),
                         out_placements=list(t.placements),
                         in_placements=(tuple(t.placements),),
                         device_mesh=t.device_mesh)(t)
    return F.pad(t, widths)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits in f32 for a stable softmax."""
    return torch.einsum("bsd,vd->bsv", x, p["emb"]).to(torch.float32)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token cross-entropy; logits (B, S, V) f32, labels (B, S)
    integer ids.  DTensor logits take :func:`_sharded_cross_entropy`."""
    if isinstance(logits, DTensor):
        return _sharded_cross_entropy(logits, labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(logz - gold)


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` of one rank's vocab
    slice ``[start, start + V_local)``, the other slices on the ranks of
    ``group``: the row maximum, the sum of exponentials and the gold logit
    (masked to the slice that owns the label, zero elsewhere) are each
    all-reduced over the group, so no rank gathers the logits.  The
    backward is the local slice of ``softmax - one_hot(label)``, which needs
    no collective."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        v_local = logits.shape[-1]
        row_max = torch.amax(logits, dim=-1)
        dist.all_reduce(row_max, op=dist.ReduceOp.MAX, group=group)
        shifted = logits - row_max[..., None]
        exps = torch.exp(shifted)
        sum_exp = exps.sum(dim=-1)
        dist.all_reduce(sum_exp, op=dist.ReduceOp.SUM, group=group)
        local = labels - start
        own = (local >= 0) & (local < v_local)
        idx = torch.where(own, local, torch.zeros_like(local))
        gold = torch.gather(shifted, -1, idx[..., None])[..., 0]
        gold = torch.where(own, gold, torch.zeros_like(gold))
        dist.all_reduce(gold, op=dist.ReduceOp.SUM, group=group)
        probs = exps.div_(sum_exp[..., None])
        ctx.save_for_backward(probs, idx, own)
        return torch.log(sum_exp) - gold

    @staticmethod
    def backward(ctx, grad):
        probs, idx, own = ctx.saved_tensors
        g = probs * grad[..., None]
        g.scatter_add_(-1, idx[..., None],
                       -(grad * own.to(grad.dtype))[..., None])
        return g, None, None, None


def _sharded_cross_entropy(logits: DTensor, labels: torch.Tensor
                           ) -> torch.Tensor:
    """:func:`cross_entropy` of DTensor logits, each rank over the tokens
    its shard holds.  Logits sharded on the vocab over one mesh dim of more
    than one rank (the tied ``emb`` on ``"model"``) take the vocab-parallel
    form (:class:`_VocabParallelNLL`): each rank keeps its vocab slice.
    Otherwise each rank takes the plain form over its tokens, the vocab
    whole."""
    mesh, v_dim = logits.device_mesh, logits.ndim - 1
    vocab_dims = [i for i, pl in enumerate(logits.placements)
                  if pl.is_shard(v_dim) and mesh.size(i) > 1]
    if len(vocab_dims) > 1 or vocab_dims and \
            logits.shape[-1] % mesh.size(vocab_dims[0]):
        raise ValueError(f"vocab-parallel cross-entropy needs the vocab "
                         f"({logits.shape[-1]}) evenly sharded over one mesh "
                         f"dim, got {logits.placements}")
    # Never a pending sum into to_local: a Partial placement replicates, and
    # so does a vocab dim sharded over one rank.
    logits = logits.redistribute(mesh, [
        Replicate() if pl.is_partial() or pl.is_shard(v_dim)
        and i not in vocab_dims else pl
        for i, pl in enumerate(logits.placements)])
    token_pl = [Replicate() if i in vocab_dims else pl
                for i, pl in enumerate(logits.placements)]
    labels = replicated_like(labels, logits).redistribute(mesh, token_pl)
    local, ids = logits.to_local(), labels.to_local().to(torch.int64)
    if vocab_dims:
        vd = vocab_dims[0]
        nll = _VocabParallelNLL.apply(
            local, ids, mesh.get_local_rank(vd) * local.shape[-1],
            mesh.get_group(vd))
    else:
        nll = torch.logsumexp(local, dim=-1) - torch.gather(
            local, -1, ids[..., None])[..., 0]
    return torch.mean(DTensor.from_local(nll, mesh, token_pl,
                                         run_check=False))


def stack_layers(init_one: Callable[[], Params], n: int,
                 device: torch.device) -> Params:
    """``n`` draws of ``init_one()`` stacked on a leading layer axis on
    ``device``.  Built layer by layer into the preallocated stack, so only
    one layer's draw lives beside it (a full-width model holds one copy)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=device)

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    first = init_one()
    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, init_one(), i)
    return out


def stacked_spec(spec: Params, lead: Tuple[int, ...]) -> Params:
    """A tree of ``meta`` stand-ins with ``lead`` prepended to every shape
    (per-layer state stacked over layers)."""
    if isinstance(spec, dict):
        return {k: stacked_spec(v, lead) for k, v in spec.items()}
    return torch.empty(lead + tuple(spec.shape), dtype=spec.dtype,
                       device="meta")


def zeros_like_spec(spec: Params, device: torch.device) -> Params:
    """Zeros on ``device`` shaped as a tree of ``meta`` stand-ins (the cache
    arenas of the ``cache_spec`` functions)."""
    if isinstance(spec, dict):
        return {k: zeros_like_spec(v, device) for k, v in spec.items()}
    return torch.zeros(spec.shape, dtype=spec.dtype, device=device)


def layer_slice(blocks: Params, layer: int) -> Params:
    """Views of one layer's slice of stacked block params (or caches)."""
    if isinstance(blocks, dict):
        return {k: layer_slice(v, layer) for k, v in blocks.items()}
    return blocks[layer]


def unstack(blocks: Params, n: int) -> list:
    """The ``n`` per-layer views of stacked block params, every leaf split
    once by ``torch.unbind``: under autograd each leaf then takes one
    stacking backward, where :func:`layer_slice`'s indexing would give each
    layer's gradient a zero-filled copy of the whole stack."""
    if isinstance(blocks, dict):
        per_key = {k: unstack(v, n) for k, v in blocks.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(blocks, 0))


def remat(cfg_remat: str, fn: Callable, *args):
    """``fn(*args)``, recomputed in the backward pass instead of keeping its
    activations when ``cfg_remat == "layer"`` and autograd records (the
    reference's ``jax.checkpoint`` around each layer's scan body)."""
    if cfg_remat == "layer" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split form)
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,) integers."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs   # (B, S, D/2)
    cos = replicated_like(torch.cos(angles)[..., None, :], x)  # (B,S,1,D/2)
    sin = replicated_like(torch.sin(angles)[..., None, :], x)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Grouped-query attention (full / causal / sliding-window; qk-norm option)
# ---------------------------------------------------------------------------


def gqa_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """Boolean (Sq, Sk) attention mask."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return ok


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention, scores and softmax in f32.  q (B, Sq, H, D),
    k and v (B, Sk, K, D), mask (Sq, Sk) or per row (B, Sq, Sk) bool.
    Returns (B, Sq, H, D) in q's type."""
    if isinstance(q, DTensor):
        return _gqa_sharded(q, k, v, mask)
    b, sq, h, d = q.shape
    kheads = k.shape[2]
    qg = q.reshape(b, sq, kheads, h // kheads, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    scores = scores / math.sqrt(d)
    m = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
    scores = torch.where(m, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, sq, h, d)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _gqa_sharded(q: DTensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor) -> DTensor:
    """:func:`gqa_attention` of DTensors, per shard (``local_map``): no two
    batch rows and no two KV-head groups meet in attention, so each rank
    attends over its rows (q's dim-0 sharding) and its KV heads with their
    query heads (q's head sharding, where the axis divides the KV heads),
    every position whole."""
    mesh, kheads = q.device_mesh, k.shape[2]
    pl = tuple(Shard(0) if p.is_shard(0) else
               Shard(2) if p.is_shard(2) and kheads % mesh.size(i) == 0
               else Replicate() for i, p in enumerate(q.placements))
    m_pl = tuple(Shard(0) if p.is_shard(0) and mask.ndim == 3
                 else Replicate() for p in pl)
    k, v, mask = (replicated_like(t, q) for t in (k, v, mask))

    def local(q, k, v, mask):
        # The shards' gradients leave in the layout the einsums give them;
        # the DTensor views they flow back through need them contiguous.
        q, k, v = (_ContiguousGrad.apply(t) for t in (q, k, v))
        return gqa_attention(q, k, v, mask)

    fn = local_map(local, out_placements=list(pl),
                   in_placements=(pl, pl, pl, m_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(q, k, v, mask)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    qk_norm: bool = False
    bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None     # sliding window (tokens), None = full
    d_head: Optional[int] = None     # defaults to d_model // n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)


def attn_init(generator: torch.Generator, a: AttnConfig,
              quant: Optional[str], dtype: torch.dtype = torch.bfloat16
              ) -> Params:
    d_head = a.head_dim
    widths = {"wq": (a.d_model, a.n_heads * d_head),
              "wk": (a.d_model, a.n_kv_heads * d_head),
              "wv": (a.d_model, a.n_kv_heads * d_head),
              "wo": (a.n_heads * d_head, a.d_model)}
    p = {name: linear_init(generator, *dims, bias=a.bias, quant=quant,
                           dtype=dtype)
         for name, dims in widths.items()}
    if a.qk_norm:
        p["q_norm"] = rmsnorm_init(d_head, generator.device)
        p["k_norm"] = rmsnorm_init(d_head, generator.device)
    return p


def split_heads(y: torch.Tensor, heads: int, d_head: int) -> torch.Tensor:
    """(B, S, heads * d_head) -> (B, S, heads, d_head).  A DTensor whose
    last dim is sharded over more ranks than divide ``heads`` (2 KV heads
    on a 4-way axis) is gathered along it first: a shard may not cut a
    head."""
    if isinstance(y, DTensor):
        mesh, last = y.device_mesh, y.ndim - 1
        whole = [Replicate() if pl.is_shard(last) and heads % mesh.size(i)
                 else pl for i, pl in enumerate(y.placements)]
        if whole != list(y.placements):
            y = y.redistribute(mesh, whole)
    return y.reshape(*y.shape[:-1], heads, d_head)


def attn_qkv(p: Params, a: AttnConfig, x: torch.Tensor,
             positions: torch.Tensor, *, backend: kops.Backend = "auto"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    d_head = a.head_dim
    q = split_heads(linear(p["wq"], x, backend=backend), a.n_heads, d_head)
    k = split_heads(linear(p["wk"], x, backend=backend), a.n_kv_heads,
                    d_head)
    v = split_heads(linear(p["wv"], x, backend=backend), a.n_kv_heads,
                    d_head)
    if a.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    return (apply_rope(q, positions, a.rope_theta),
            apply_rope(k, positions, a.rope_theta), v)


def _window(a: AttnConfig, window_override: Optional[int]) -> Optional[int]:
    return window_override if window_override is not None else a.window


def attn_forward(p: Params, a: AttnConfig, x: torch.Tensor,
                 positions: torch.Tensor, *,
                 window_override: Optional[int] = None,
                 backend: kops.Backend = "auto") -> torch.Tensor:
    """Full-sequence (train/prefill) attention."""
    out, _ = attn_prefill(p, a, x, positions, x.shape[1],
                          window_override=window_override, backend=backend)
    return out


def attn_prefill(p: Params, a: AttnConfig, x: torch.Tensor,
                 positions: torch.Tensor, cache_len: int, *,
                 window_override: Optional[int] = None,
                 backend: kops.Backend = "auto"
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill: the output and (k, v), zero-padded to ``cache_len``, which
    must hold the sequence (``F.pad`` would crop it silently where the
    reference's ``jnp.pad`` raises)."""
    if cache_len < x.shape[1]:
        raise ValueError(f"a cache of {cache_len} positions cannot hold a "
                         f"prefill of {x.shape[1]}")
    q, k, v = attn_qkv(p, a, x, positions, backend=backend)
    mask = gqa_scores_mask(positions, positions, causal=True,
                           window=_window(a, window_override))
    out = gqa_attention(q, k, v, mask)
    widths = (0, 0, 0, 0, 0, cache_len - x.shape[1])
    return (linear(p["wo"], out.reshape(*x.shape[:2], -1), backend=backend),
            (pad(k, widths), pad(v, widths)))


def _decode_mask(s_max: int, pos: torch.Tensor, window: Optional[int]
                 ) -> torch.Tensor:
    """(B, Smax) (or (Smax,) for a shared position) causal mask of one new
    token at ``pos``, with the optional sliding window."""
    k_pos = torch.arange(s_max, device=pos.device)
    mask = k_pos <= pos[..., None]
    if window is not None:
        mask &= k_pos > pos[..., None] - window
    return mask


def _cache_write(cache: Tuple[torch.Tensor, ...], k: torch.Tensor,
                 v: torch.Tensor, pos: torch.Tensor, dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one token's K/V (B, 1, K, D) at ``pos`` (shared () or per row
    (B,)) into the cache tensors, in place, and return the full K/V in
    ``dtype``.  The write index is clamped to [0, Smax - 1], where
    ``lax.dynamic_update_slice`` puts a start that overruns."""
    s_max = cache[0].shape[1]
    idx = torch.clamp(pos, 0, s_max - 1)
    rows = torch.arange(k.shape[0], device=k.device)
    if pos.ndim == 0:
        idx = idx.expand(k.shape[0])
    write = _write_rows_sharded if isinstance(cache[0], DTensor) else \
        _write_rows
    if len(cache) == 4:
        k_cache, v_cache, ks_cache, vs_cache = cache
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        for full, new in ((k_cache, kq), (v_cache, vq), (ks_cache, ks),
                          (vs_cache, vs)):
            write(full, rows, idx, new[:, 0])
        return (k_cache.to(dtype) * ks_cache[..., None].to(dtype),
                v_cache.to(dtype) * vs_cache[..., None].to(dtype))
    k_cache, v_cache = cache
    write(k_cache, rows, idx, k[:, 0])
    write(v_cache, rows, idx, v[:, 0])
    return k_cache, v_cache


def _write_rows(full: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor,
                new: torch.Tensor) -> None:
    full[rows, idx] = new


def _write_rows_sharded(full: DTensor, rows: torch.Tensor, idx: torch.Tensor,
                        new: torch.Tensor) -> None:
    """:func:`_write_rows` into a cache DTensor sharded on its batch and
    position dims (``launch.shardings.cache_shardings``): every rank takes
    the whole (one token's) ``new`` and writes the rows whose position falls
    in its slice, in place; the others keep what they hold."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, rep = full.device_mesh, [Replicate()] * full.device_mesh.ndim
    shape, offset = compute_local_shape_and_global_offset(
        full.shape, mesh, full.placements)
    local = full.to_local()
    whole = [replicated_like(t, full).redistribute(mesh, rep).to_local()
             for t in (rows, idx, new)]
    mine = slice(offset[0], offset[0] + shape[0])
    rows, idx, new = (t[mine] for t in whole)
    at = idx - offset[1]
    ok = (at >= 0) & (at < shape[1])
    at = torch.clamp(at, 0, shape[1] - 1)
    r = rows - offset[0]
    keep = ok.reshape(ok.shape + (1,) * (new.ndim - 1))
    local[r, at] = torch.where(keep, new.to(local.dtype), local[r, at])


def attn_decode(p: Params, a: AttnConfig, x: torch.Tensor, pos,
                cache: Tuple[torch.Tensor, ...], *,
                window_override: Optional[int] = None,
                backend: kops.Backend = "auto"
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One-token decode against a static cache, every row at ``pos``.

    x: (B, 1, d_model); pos: an int or a 0-d integer tensor; cache either
    ``(k, v)`` with k/v (B, Smax, K, D) in the compute type, or the int8
    variant ``(k_q, v_q, k_scale, v_scale)`` with per-(token, head) REAL
    scales — §6.1 quantization applied to serving state (kv_quant).  The
    cache tensors are updated in place and returned."""
    pos = torch.as_tensor(pos, device=x.device)
    q, k, v = attn_qkv(p, a, x, pos.reshape(1), backend=backend)
    k_full, v_full = _cache_write(cache, k, v, pos, q.dtype)
    mask = _decode_mask(k_full.shape[1], pos, _window(a, window_override))
    out = gqa_attention(q, k_full, v_full, mask[None, :])
    return (linear(p["wo"], out.reshape(x.shape[0], 1, -1), backend=backend),
            cache)


def attn_decode_multi(p: Params, a: AttnConfig, x: torch.Tensor,
                      pos: torch.Tensor, cache: Tuple[torch.Tensor, ...], *,
                      window_override: Optional[int] = None,
                      backend: kops.Backend = "auto"
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One-token decode with **per-row** positions (continuous batching).

    x: (B, 1, d_model); pos: (B,) — each slot sits at its own position in
    the shared cache, so slots admitted at different times decode in one
    fixed-shape step.  Cache layouts as in :func:`attn_decode`; each row's
    new K/V lands at its own ``pos[b]`` (clamped) and each row gets its own
    causal (and optional sliding-window) mask."""
    q, k, v = attn_qkv(p, a, x, pos[:, None], backend=backend)
    k_full, v_full = _cache_write(cache, k, v, pos, q.dtype)
    mask = _decode_mask(k_full.shape[1], pos, _window(a, window_override))
    out = gqa_attention(q, k_full, v_full, mask[:, None, :])
    return (linear(p["wo"], out.reshape(x.shape[0], 1, -1), backend=backend),
            cache)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(token, head) quantization of K/V (B, S, K, D)."""
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp_min(absmax, 1e-6) / 127.0            # (B, S, K)
    q = torch.clamp(torch.round(xf / scale[..., None]), -128, 127)
    return q.to(torch.int8), scale


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    d_model: int
    d_ff: int
    kind: str = "swiglu"      # 'swiglu' | 'gelu' | 'squared_relu'
    bias: bool = False


def mlp_init(generator: torch.Generator, m: MlpConfig, quant: Optional[str],
             dtype: torch.dtype = torch.bfloat16) -> Params:
    p = {}
    if m.kind == "swiglu":
        p["w_gate"] = linear_init(generator, m.d_model, m.d_ff, bias=m.bias,
                                  quant=quant, dtype=dtype)
    p["w_up"] = linear_init(generator, m.d_model, m.d_ff, bias=m.bias,
                            quant=quant, dtype=dtype)
    p["w_down"] = linear_init(generator, m.d_ff, m.d_model, bias=m.bias,
                              quant=quant, dtype=dtype)
    return p


def mlp_forward(p: Params, m: MlpConfig, x: torch.Tensor, *,
                backend: kops.Backend = "auto") -> torch.Tensor:
    if m.kind == "swiglu":
        h = F.silu(linear(p["w_gate"], x, backend=backend)) \
            * linear(p["w_up"], x, backend=backend)
    elif m.kind == "gelu":           # jax.nn.gelu's default: tanh form
        h = F.gelu(linear(p["w_up"], x, backend=backend), approximate="tanh")
    elif m.kind == "squared_relu":   # nemotron-4 [arXiv:2402.16819]
        h = torch.square(F.relu(linear(p["w_up"], x, backend=backend)))
    else:
        raise ValueError(m.kind)
    return linear(p["w_down"], h, backend=backend)
