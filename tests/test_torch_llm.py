"""The port's dense GQA decoder and its MoE twin against the JAX reference,
on the CPU: the six dense/moe configurations, reduced, in f32.

The same params go into both packages (JAX ``api.init``, bridged through
numpy with ``repro_torch.bridge``) and the same numpy tokens through both.
Tolerances, with their reasons:
* REAL: prefill and decode logits and the KV cache within 1e-5 of the
  largest value (f32 sums in another order, XLA's own ``rsqrt``/``exp``).
* SINT: every ``linear`` is bit-exact on the same input (integer products,
  the same two rounded f32 ops after them).  End to end the f32 ops *before*
  each activation quantize (RMSNorm, softmax, SiLU, RoPE) differ from XLA's
  in the last bit (XLA sums RMSNorm's mean in another order and takes
  another ``rsqrt``: 40% of its outputs differ by an ulp), and wherever
  ``x / x_scale`` lies within an ulp of a half-integer, that moves an
  activation code a whole step (1/127), which the later layers carry on.
  So the SINT models are held to 1e-2 of the largest value, which a
  handful of such steps stays inside and any fault of the algorithm (a
  wrong mask, position or norm) leaves far behind; the REAL runs hold
  everything but the integer linear to 1e-5.
* kv_quant: ``_quantize_kv`` codes and scales equal on the same input; in
  the model a K/V code moves at most one step (the same last-bit cause),
  scales within 1e-5 relative, logits within 1e-3 of the largest.
* MoE dispatch (einsum and ragged) on the same input within 1e-5; the
  router's indices equal, ties included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.models import common as jcm
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models.api import get_model as jget_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.api import get_model

torch.set_num_threads(1)

DENSE = ("qwen3_8b", "command_r_35b", "command_r_plus_104b",
         "nemotron_4_340b")
MOE = ("granite_moe_1b_a400m", "mixtral_8x22b")
LLM = DENSE + MOE
REAL_TOL = 1e-5
SINT_TOL = 1e-2
PROMPT, CACHE = 40, 64


def pair(arch, quant=None, seed=0, **kw):
    """(JAX cfg, JAX params, port cfg, port params) of the reduced f32
    config."""
    jcfg = jget_config(arch).reduced().with_(dtype=jnp.float32, quant=quant,
                                             **kw)
    tcfg = get_config(arch).reduced().with_(dtype=torch.float32, quant=quant,
                                            **kw)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jp, tcfg, tp


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_rel(got, want, tol, what=""):
    """|got - want| within ``tol`` of the largest |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= tol, f"{what}: {err} of the largest, tolerance {tol}"


def assert_cache(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype).replace("torch.", "") == \
            np.asarray(want[k]).dtype.name
        assert_rel(got[k], want[k], tol, f"cache {k}")


# ---------------------------------------------------------------------------
# Configs and the param tree


@pytest.mark.parametrize("reduced", (False, True))
@pytest.mark.parametrize("arch", LLM)
def test_config_matches_reference(arch, reduced):
    want, got = jget_config(arch), get_config(arch)
    if reduced:
        want, got = want.reduced(), got.reduced()
    jfields, tfields = dataclasses.asdict(want), dataclasses.asdict(got)
    assert jfields.pop("dtype") == jnp.bfloat16
    assert tfields.pop("dtype") == torch.bfloat16
    assert tfields == jfields
    assert arch in ARCH_IDS


def leaves(tree, path=()):
    """(path, shape, dtype name) of every leaf of a nested dict."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield (path + (k,), tuple(v.shape),
                   str(v.dtype).replace("torch.", ""))


@pytest.mark.parametrize("quant", (None, "SINT"))
@pytest.mark.parametrize("arch", LLM)
def test_init_tree_matches_param_specs(arch, quant):
    """The port's random init has the keys, shapes and dtypes of the JAX
    ``param_specs()`` (bf16 working type)."""
    jcfg = jget_config(arch).reduced().with_(quant=quant)
    tcfg = get_config(arch).reduced().with_(quant=quant)
    got = get_model(tcfg).init(torch.Generator().manual_seed(0),
                               device="cpu")
    assert list(leaves(got)) == list(leaves_spec(
        jget_model(jcfg).param_specs()))


def leaves_spec(tree, path=()):
    """(path, shape, dtype name) of every leaf of a JAX ShapeDtypeStruct
    tree."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves_spec(v, path + (k,))
        else:
            yield path + (k,), tuple(v.shape), np.dtype(v.dtype).name


@pytest.mark.parametrize("arch", ("qwen3_8b", "granite_moe_1b_a400m",
                                  "mamba2_370m"))
@pytest.mark.parametrize("kv_quant", (False, True))
def test_cache_specs_match_reference(arch, kv_quant):
    jcfg = jget_config(arch).reduced().with_(kv_quant=kv_quant)
    tcfg = get_config(arch).reduced().with_(kv_quant=kv_quant)
    got = get_model(tcfg).cache_specs(3, 48)
    assert list(leaves(got)) == list(leaves_spec(
        jget_model(jcfg).cache_specs(3, 48)))
    assert all(v.device.type == "meta" for v in got.values())
    cache = get_model(tcfg).init_cache(3, 48, device="cpu")
    assert all(not bool(v.any()) for v in cache.values())


# ---------------------------------------------------------------------------
# Primitives


def test_rope_matches_reference():
    """Half-split RoPE at qwen3's theta, positions to 4096 (angles of
    thousands of radians: f32 cos/sin may part by ulps)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 16))
    want = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = cm.apply_rope(t(x), t(pos), 1e6)
    assert_rel(got, want, REAL_TOL, "rope")
    want1 = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), 1e4)
    assert_rel(cm.apply_rope(t(x), t(pos[0]), 1e4), want1, REAL_TOL)
    np.testing.assert_allclose(cm.rope_frequencies(64, 1e6).numpy(),
                               np.asarray(jcm.rope_frequencies(64, 1e6)),
                               rtol=1e-6)


@pytest.mark.parametrize("window", (None, 5))
def test_gqa_attention_and_mask(window):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 12, 8, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    pos = np.arange(12)
    jmask = jcm.gqa_scores_mask(jnp.asarray(pos), jnp.asarray(pos), True,
                                window)
    mask = cm.gqa_scores_mask(t(pos), t(pos), True, window)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    want = jcm.gqa_attention(*map(jnp.asarray, (q, k, v)), jmask)
    assert_rel(cm.gqa_attention(t(q), t(k), t(v), mask), want, REAL_TOL)
    # per-row (B, Sq, Sk) masks
    rows = np.stack([np.asarray(jmask), np.asarray(jmask)[::-1]])
    want = jcm.gqa_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(rows))
    assert_rel(cm.gqa_attention(t(q), t(k), t(v), t(rows)), want, REAL_TOL)


@pytest.mark.parametrize("quant", ("SINT", "INT", "DINT"))
@pytest.mark.parametrize("bias", (False, True))
def test_linear_bit_exact(quant, bias):
    """The §6.1 linear on the same input equals the reference's bit for bit
    (SINT through ops.quantized_matmul's plain version here)."""
    rng = np.random.default_rng(2)
    jp = jcm.linear_init(jax.random.PRNGKey(3), 64, 48, bias=bias,
                         quant=quant, dtype=jnp.float32)
    if bias:
        jp = dict(jp, b=jnp.asarray(rng.standard_normal(48), jnp.float32))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    x = (rng.standard_normal((3, 5, 64)) * 0.5).astype(np.float32)
    want = np.asarray(jcm.linear(jp, jnp.asarray(x)))
    np.testing.assert_array_equal(cm.linear(tp, t(x)).numpy(), want)


@pytest.mark.parametrize("kind", ("swiglu", "gelu", "squared_relu"))
def test_mlp_kinds_match_reference(kind):
    """SwiGLU, GELU (tanh form, jax.nn.gelu's default) and squared ReLU."""
    m = jcm.MlpConfig(d_model=32, d_ff=64, kind=kind)
    jp = jcm.mlp_init(jax.random.PRNGKey(4), m, None, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    x = np.random.default_rng(5).standard_normal((2, 7, 32)).astype(
        np.float32)
    want = jcm.mlp_forward(jp, m, jnp.asarray(x))
    got = cm.mlp_forward(tp, cm.MlpConfig(d_model=32, d_ff=64, kind=kind),
                         t(x))
    assert_rel(got, want, REAL_TOL, kind)
    assert sorted(tp) == sorted(jp)


def test_quantize_kv_codes_and_scales_equal():
    x = (np.random.default_rng(6).standard_normal((2, 9, 2, 16))
         * np.array([1e-9, 0.3, 3.0, 40.0])[None, :, None, None].repeat(
             3, axis=1)[:, :9]).astype(np.float32)
    jq, js = jcm._quantize_kv(jnp.asarray(x))
    tq, ts = cm._quantize_kv(t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("arch", ("qwen3_8b", "command_r_35b"))
def test_block_forward_parallel_and_sequential(arch):
    """One block: command-r's parallel residual (one norm, attention and FFN
    side by side) and qwen3's sequential one with qk-norm."""
    jcfg, jp, tcfg, tp = pair(arch)
    assert jcfg.parallel_block == (arch == "command_r_35b")
    assert ("ln2" in tp["blocks"]) == (not jcfg.parallel_block)
    x = np.random.default_rng(7).standard_normal(
        (2, 11, jcfg.d_model)).astype(np.float32)
    pos = np.arange(11)
    jblk = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    want = jtf.block_forward(
        jblk, jcfg, jnp.asarray(x), jnp.asarray(pos),
        lambda p, h: jcm.mlp_forward(p, jtf._mlp_cfg(jcfg), h))
    got = tf.block_forward(cm.layer_slice(tp["blocks"], 0), tcfg, t(x),
                           t(pos), tf._dense_ffn(tcfg, "auto"))
    assert_rel(got, want, REAL_TOL, arch)


# ---------------------------------------------------------------------------
# The models: prefill, decode at a shared position, decode per row


def run_pair(jcfg, jp, tcfg, tp, tokens, pos_multi, cache_len=CACHE):
    """Prefill on tokens[:, :-2], one shared-position decode step, one
    per-row decode step: JAX's and the port's (cache, logits) each time (the
    port's cache copied: the next step updates the arena in place)."""
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    p = tokens.shape[1] - 2
    out = []

    def record(what, jc, jl, tc, tl):
        out.append((what, jc, jl, {k: v.clone() for k, v in tc.items()}, tl))

    jc, jl = japi.prefill(jp, {"tokens": jnp.asarray(tokens[:, :p])},
                          cache_len)
    tc, tl = tapi.prefill(tp, {"tokens": t(tokens[:, :p])}, cache_len)
    record("prefill", jc, jl, tc, tl)
    jc, jl = japi.decode(jp, jc, {"tokens": jnp.asarray(tokens[:, p:p + 1])},
                         jnp.int32(p))
    arena = tapi.init_cache(tokens.shape[0], cache_len, device="cpu")
    for k in arena:
        arena[k].copy_(tc[k])
    tc, tl = tapi.decode(tp, arena, {"tokens": t(tokens[:, p:p + 1])}, p)
    assert tc is arena                      # updated in place
    record("decode", jc, jl, tc, tl)
    jc, jl = japi.decode_multi(jp, jc, {"tokens": jnp.asarray(
        tokens[:, p + 1:])}, jnp.asarray(pos_multi, jnp.int32))
    tc, tl = tapi.decode_multi(tp, tc, {"tokens": t(tokens[:, p + 1:])},
                               t(pos_multi))
    record("decode_multi", jc, jl, tc, tl)
    return out


@pytest.mark.parametrize("quant", (None, "SINT"))
@pytest.mark.parametrize("arch", LLM)
def test_model_matches_reference(arch, quant):
    """Prefill logits and cache, a decode step at the shared position and a
    per-row decode step (one row at the next position, one rewriting an
    earlier one) against the JAX model, same params."""
    jcfg, jp, tcfg, tp = pair(arch, quant)
    tokens = np.random.default_rng(8).integers(
        0, jcfg.vocab, (2, PROMPT + 2))
    tol = REAL_TOL if quant is None else SINT_TOL
    for what, jc, jl, tc, tl in run_pair(jcfg, jp, tcfg, tp, tokens,
                                         np.array([PROMPT + 1, 17])):
        assert tl.shape == (2, 1, jcfg.vocab) and tl.dtype == torch.float32
        assert_rel(tl, jl, tol, f"{what} logits")
        assert_cache(tc, jc, tol)


def test_full_forward_matches_prefill_and_reference():
    """forward_logits against the JAX model and against the port's own
    prefill at its last position (moe with its aux loss)."""
    for arch in ("qwen3_8b", "granite_moe_1b_a400m"):
        jcfg, jp, tcfg, tp = pair(arch)
        tokens = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 24))
        if arch in MOE:
            jl, jaux = jmoe.forward_logits(jp, jcfg, jnp.asarray(tokens))
            tl, taux = moe.forward_logits(tp, tcfg, t(tokens))
            assert_rel(taux, jaux, REAL_TOL, "aux")
        else:
            jl = jtf.forward_logits(jp, jcfg, jnp.asarray(tokens))
            tl = tf.forward_logits(tp, tcfg, t(tokens))
        assert_rel(tl, jl, REAL_TOL, f"{arch} forward")
        _, last = get_model(tcfg).prefill(tp, {"tokens": t(tokens)}, 32)
        assert_rel(last, jl[:, -1:], REAL_TOL, f"{arch} prefill")


def test_sliding_window_masks_old_tokens():
    """Reduced mixtral (window 64): a prompt of 100 tokens, so prefill and
    decode both see the window cut the oldest positions."""
    jcfg, jp, tcfg, tp = pair("mixtral_8x22b")
    assert jcfg.sliding_window == tcfg.sliding_window == 64
    tokens = np.random.default_rng(10).integers(0, jcfg.vocab, (1, 102))
    for what, jc, jl, tc, tl in run_pair(jcfg, jp, tcfg, tp, tokens,
                                         np.array([101]), cache_len=128):
        assert_rel(tl, jl, REAL_TOL, f"{what} logits")
        assert_cache(tc, jc, REAL_TOL)
    # The window changes the answer: the same prompt without it differs.
    _, full = get_model(tcfg.with_(sliding_window=None)).prefill(
        tp, {"tokens": t(tokens[:, :100])}, 128)
    _, windowed = get_model(tcfg).prefill(tp, {"tokens": t(tokens[:, :100])},
                                          128)
    assert float((full - windowed).abs().max()) > 1e-3


def test_kv_quant_model():
    """The int8 KV cache (§6.1 applied to serving state) through prefill,
    decode and per-row decode."""
    jcfg, jp, tcfg, tp = pair("qwen3_8b", kv_quant=True)
    tokens = np.random.default_rng(11).integers(0, jcfg.vocab,
                                                (2, PROMPT + 2))
    for what, jc, jl, tc, tl in run_pair(jcfg, jp, tcfg, tp, tokens,
                                         np.array([PROMPT + 1, 30])):
        assert_rel(tl, jl, 1e-3, f"{what} logits")
        assert sorted(tc) == ["k", "k_scale", "v", "v_scale"]
        for k in ("k", "v"):
            assert tc[k].dtype == torch.int8
            steps = np.abs(tc[k].numpy().astype(np.int32)
                           - np.asarray(jc[k]).astype(np.int32))
            assert steps.max() <= 1 and steps.mean() < 1e-3, (what, k)
            np.testing.assert_allclose(tc[k + "_scale"].numpy(),
                                       np.asarray(jc[k + "_scale"]),
                                       rtol=1e-5, atol=0)


def test_decode_write_past_the_end_lands_on_the_last_row():
    """A row decoding at cache_len (a retired continuous slot keeps its last
    position) writes where lax.dynamic_update_slice puts it: the last row,
    shared-position and per-row alike."""
    jcfg, jp, tcfg, tp = pair("qwen3_8b")
    tokens = np.random.default_rng(12).integers(0, jcfg.vocab, (2, 22))
    for what, jc, jl, tc, tl in run_pair(jcfg, jp, tcfg, tp, tokens,
                                         np.array([20, 21]), cache_len=20):
        assert_rel(tl, jl, REAL_TOL, f"{what} logits")
        assert_cache(tc, jc, REAL_TOL)
    # The shared-position step above ran at pos 20 = cache_len.
    assert float(tc["k"][:, :, -1].abs().max()) > 0


# ---------------------------------------------------------------------------
# MoE dispatch and routing


@pytest.mark.parametrize("group", (None, 8))
@pytest.mark.parametrize("arch", MOE)
def test_moe_dispatch_matches_reference(arch, group):
    """The einsum dispatch (groups of moe_group tokens, and of 8, where the
    capacity drops tokens) and the ragged dispatch, against the
    reference's on the same input."""
    jcfg, jp, tcfg, tp = pair(arch)
    jblk = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["ffn"])
    blk = cm.layer_slice(tp["blocks"]["ffn"], 0)
    x = np.random.default_rng(13).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    want, jaux = jmoe.moe_forward_einsum(jblk, jcfg, jnp.asarray(x), group)
    got, aux = moe.moe_forward_einsum(blk, tcfg, t(x), group)
    assert_rel(got, want, REAL_TOL, "einsum")
    assert_rel(aux, jaux, REAL_TOL, "aux")
    if group is None:
        want, jaux = jmoe.moe_forward_ragged(jblk, jcfg, jnp.asarray(x))
        got, aux = moe.moe_forward_ragged(blk, tcfg, t(x))
        assert_rel(got, want, REAL_TOL, "ragged")
        assert_rel(aux, jaux, REAL_TOL, "aux")
    else:
        # capacity really drops here: the drop-free ragged result differs
        assert moe._capacity(group, tcfg) < group * tcfg.top_k
        ragged, _ = moe.moe_forward_ragged(blk, tcfg, t(x))
        assert float((ragged - got).abs().max()) > 1e-4


def test_router_breaks_ties_to_the_lower_index():
    """lax.top_k's tie order: a router of zeros gives every expert the same
    probability, and one with tied pairs of columns ties those; the port's
    stable descending sort picks the same experts in the same order."""
    jcfg, jp, tcfg, tp = pair("granite_moe_1b_a400m")
    e, d = jcfg.n_experts, jcfg.d_model
    rng = np.random.default_rng(14)
    x = rng.standard_normal((1, 6, d)).astype(np.float32)
    col = rng.standard_normal((d, 1)).astype(np.float32) * 0.05
    routers = {"zeros": np.zeros((d, e), np.float32),
               "tied pairs": np.concatenate([col, col * 0.5, col * 0.5,
                                             col], axis=1)[:, :e]}
    for name, router in routers.items():
        _, jidx, _ = jmoe._route({"router": jnp.asarray(router)}, jcfg,
                                 jnp.asarray(x))
        gate, idx, _ = moe._route({"router": t(router)}, tcfg, t(x))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx),
                                      err_msg=name)
    np.testing.assert_array_equal(
        moe._route({"router": t(routers["zeros"])}, tcfg, t(x))[1][0, 0]
        .numpy(), np.arange(tcfg.top_k))
    assert torch.allclose(gate.sum(-1), torch.ones(()))
