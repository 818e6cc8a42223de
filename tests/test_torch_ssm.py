"""The port's Mamba-2 path against the JAX reference, on the CPU: the SSD
plain versions, the reduced ``mamba2_370m`` model (REAL and §6.1-quantized)
and the wave ``Engine``.

The same params go into both packages (JAX init, bridged through numpy with
``repro_torch.bridge``) and the same numpy inputs through both.  Tolerances,
with their reasons:
* SSD: the reference's own (``tests/test_kernels.py``): rtol 2e-4, atol 2e-5
  — cumsums and products summed in other orders.
* Model logits: the reference's own prefill/decode tolerances
  (``tests/test_archs.py``): 2e-4 for prefill and the full forward, 2e-3 for
  decode; states to 2e-4.
* Engine: greedy tokens identical.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ARCH_IDS as JARCH_IDS
from repro.configs.base import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as jmamba
from repro.models.api import get_model as jget_model
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import _truncate_eos as j_truncate_eos
from repro_torch import trace
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.core.layers import TORCH_INT_TYPES
from repro_torch.launch.steps import GRAD_BACKEND, loss_and_grads
from repro_torch.models import common as cm
from repro_torch.models import hybrid, mamba2
from repro_torch.models.api import get_model
from repro_torch.serving import Engine, Request, sample_batched
from repro_torch.serving.engine import _truncate_eos

torch.set_num_threads(1)

SSD_TOL = dict(rtol=2e-4, atol=2e-5)
PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)


def tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def ssd_inputs(bsz, t, h, p, n, g, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, t, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((bsz, t, h)))) * 0.2
    a = -np.exp(rng.standard_normal(h) * 0.5)
    b = rng.standard_normal((bsz, t, g, n)) * 0.3
    c = rng.standard_normal((bsz, t, g, n)) * 0.3
    return [v.astype(np.float32) for v in (x, dt, a, b, c)]


# ---------------------------------------------------------------------------
# Configs


@pytest.mark.parametrize("reduced", (False, True))
def test_config_matches_reference(reduced):
    want = jget_config("mamba2_370m")
    got = get_config("mamba2_370m")
    if reduced:
        want, got = want.reduced(), got.reduced()
    jfields = dataclasses.asdict(want)
    tfields = dataclasses.asdict(got)
    assert jfields.pop("dtype") == jnp.bfloat16
    assert tfields.pop("dtype") == torch.bfloat16
    assert tfields == jfields
    assert (got.d_inner, got.ssm_heads, got.d_head) == \
        (want.d_inner, want.ssm_heads, want.d_head)
    assert ARCH_IDS == JARCH_IDS


def test_every_family_is_ported():
    """get_config and get_model serve every architecture of ARCH_IDS (all
    six families); an unknown id or family still raises."""
    families = set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert get_model(cfg).cfg is cfg
        families.add(cfg.family)
    assert families == {"dense", "moe", "ssm", "hybrid", "vlm", "audio"}
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("gpt_oss_999b")
    with pytest.raises(ValueError, match="unknown family"):
        get_model(get_config("mamba2_370m").with_(family="retnet"))


# ---------------------------------------------------------------------------
# SSD plain versions


# (T, H, P, N, G): a whole chunk, a ragged T with G > 1, G = H.
SSD_SHAPES = [(128, 2, 32, 16, 1), (100, 4, 16, 8, 2), (64, 8, 16, 64, 8)]


@pytest.mark.parametrize("t,h,p,n,g", SSD_SHAPES)
def test_ssd_matches_reference(t, h, p, n, g):
    """ops.ssd 'chunked', 'ref' and 'auto' (chunked on CPU tensors) against
    the interpreted Pallas kernel and the sequential reference, with a
    ragged T (100: both chunked versions pad it to the chunk) and G > 1."""
    args = ssd_inputs(2, t, h, p, n, g)
    jargs = [jnp.asarray(v) for v in args]
    pallas = np.asarray(jops.ssd(*jargs, backend="pallas", chunk=32))
    seq = np.asarray(jops.ssd(*jargs, backend="ref"))
    for backend in ("chunked", "ref", "auto"):
        got = ops.ssd(*tensors(*args), backend=backend).numpy()
        assert got.shape == (2, t, h, p)
        np.testing.assert_allclose(got, pallas, **SSD_TOL)
        np.testing.assert_allclose(got, seq, **SSD_TOL)
    with pytest.raises(ValueError, match="ssd_scan kernel has no CPU"):
        ops.ssd(*tensors(*args), backend="kernel")


def jax_final_states(x, dt, a, b):
    """The JAX package's final SSM state of each row, two ways: stepping
    ``repro.kernels.ref.ssd_update_ref`` over T, and the contribution-sum
    einsum that ``repro.models.mamba2._mamba_forward_state`` runs (restated
    here: it sits inside the model function)."""
    bsz, t, h, p = x.shape
    bf = np.repeat(b, h // b.shape[2], axis=2)
    update = jax.jit(jref.ssd_update_ref)
    stepped = []
    for i in range(bsz):
        state = jnp.zeros((h, p, b.shape[-1]), jnp.float32)
        for s in range(t):
            state, _ = update(state, x[i, s], dt[i, s], a, bf[i, s], bf[i, s])
        stepped.append(np.asarray(state))
    alpha = dt * a
    srev = jnp.cumsum(alpha[:, ::-1], axis=1)[:, ::-1]
    w = jnp.exp(srev - alpha) * dt
    einsum = jnp.einsum("bsh,bshp,bshn->bhpn", w, x, bf)
    return np.stack(stepped), np.asarray(einsum)


@pytest.mark.parametrize("t,h,p,n,g", SSD_SHAPES)
def test_ssd_final_state_matches_reference(t, h, p, n, g):
    """ops.ssd(..., return_state=True) on every plain backend: the same y
    as without the state, and the final state of the JAX package's stepped
    recurrence and of its prefill's einsum."""
    args = ssd_inputs(2, t, h, p, n, g)
    stepped, einsum = jax_final_states(*args[:4])
    for backend in ("chunked", "ref", "auto"):
        y, state = ops.ssd(*tensors(*args), backend=backend,
                           return_state=True)
        assert torch.equal(y, ops.ssd(*tensors(*args), backend=backend))
        assert state.shape == (2, h, p, n) and state.dtype == torch.float32
        np.testing.assert_allclose(state.numpy(), stepped, **SSD_TOL)
        np.testing.assert_allclose(state.numpy(), einsum, **SSD_TOL)
    np.testing.assert_allclose(
        ref.ssd_final_state_ref(*tensors(*args[:4])).numpy(), einsum,
        **SSD_TOL)


def test_mixer_inputs_are_views_of_the_conv_output():
    """x, B and C reach ops.ssd as bf16 views of the (contiguous) conv
    output that the kernel reads in place, and the plain path gives them
    the bits of f32 copies."""
    cfg = get_config("mamba2_370m").reduced()
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    p = mamba2._layer(params["blocks"], 0)["mixer"]
    x = torch.randn((2, 40, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(cfg.dtype)
    z, xbc, dt_raw = mamba2._split_proj(
        cfg, x @ p["in_proj"]["w"].to(cfg.dtype))
    conv = mamba2._causal_conv(p, xbc)
    assert conv.is_contiguous() and conv.dtype == torch.bfloat16
    xs, bmat, cmat, dt, a = mamba2._mixer_inputs(p, cfg, conv, dt_raw)
    for v in (xs, bmat, cmat):
        assert v.dtype == torch.bfloat16 and ssd_scan.reads(v)
        assert v.untyped_storage().data_ptr() == \
            conv.untyped_storage().data_ptr()
    assert dt.dtype == a.dtype == torch.float32
    got = ops.ssd(xs, dt, a, bmat, cmat, return_state=True)
    want = ops.ssd(xs.float(), dt, a, bmat.float(), cmat.float(),
                   return_state=True)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_ssd_reads_only_aligned_packed_views():
    """ssd_scan.reads: a view whose rows are packed and 16-byte aligned is
    read in place; a contiguous tensor at an unaligned base is not, and a
    contiguous clone of it is (what ops.ssd hands the kernel instead)."""
    x = torch.zeros((2, 8, 4, 16))
    assert ssd_scan.reads(x)
    shifted = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    assert shifted.is_contiguous() and not ssd_scan.reads(shifted)
    assert ssd_scan.reads(shifted.clone(memory_format=torch.contiguous_format))
    assert not ssd_scan.reads(torch.zeros((2, 8, 16, 4)).transpose(2, 3))


@pytest.mark.parametrize("mapping,same_as", [
    ({"ssd_scan": "ref"}, "ref"),
    ({"ssd_scan": "chunked", "qmatmul": "ref"}, "chunked"),
    ({"qmatmul": "ref"}, "auto"),
], ids=("ssd-ref", "ssd-chunked", "ssd-unnamed"))
def test_ssd_backend_mapping(mapping, same_as):
    """A mapping gives each kernel its own backend, and a kernel that it
    does not name takes 'auto': ops.ssd reads the ssd_scan entry."""
    args = tensors(*ssd_inputs(2, 100, 4, 16, 8, 2))
    assert torch.equal(ops.ssd(*args, backend=mapping),
                       ops.ssd(*args, backend=same_as))
    with pytest.raises(ValueError, match="names no kernel"):
        ops.ssd(*args, backend={**mapping, "ssd": "ref"})


def test_ssd_ref_functions_match_reference():
    """The plain versions one by one: the sequential scan, the chunked scan
    at several chunks, and the decode step, on one sequence."""
    x, dt, a, b, c = ssd_inputs(1, 64, 4, 8, 16, 4, seed=1)
    x, dt, b, c = x[0], dt[0], b[0], c[0]     # one sequence; G = H
    jx = [jnp.asarray(v) for v in (x, dt, a, b, c)]
    tx = tensors(x, dt, a, b, c)
    seq = np.asarray(jref.ssd_scan_ref(*jx))
    np.testing.assert_allclose(ref.ssd_scan_ref(*tx).numpy(), seq, **SSD_TOL)
    for chunk in (16, 32, 64):
        np.testing.assert_allclose(
            ref.ssd_chunked_ref(*tx, chunk=chunk).numpy(),
            np.asarray(jref.ssd_chunked_ref(*jx, chunk=chunk)), **SSD_TOL)
    state = np.random.default_rng(2).standard_normal((4, 8, 16)) \
        .astype(np.float32)
    js, jy = jref.ssd_update_ref(jnp.asarray(state), jx[0][5], jx[1][5],
                                 jx[2], jx[3][5], jx[4][5])
    ts, ty = ref.ssd_update_ref(torch.from_numpy(state), tx[0][5], tx[1][5],
                                tx[2], tx[3][5], tx[4][5])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The reduced model


def model_pair(quant, dtype="float32", seed=0):
    """(JAX cfg, JAX params, port cfg, port params) of the reduced model."""
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg = jget_config("mamba2_370m").reduced().with_(dtype=jdtype,
                                                      quant=quant)
    tcfg = get_config("mamba2_370m").reduced().with_(dtype=tdtype,
                                                     quant=quant)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jp, tcfg, tp


def assert_close_tree(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **tol)


@pytest.mark.parametrize("quant", (None, "SINT", "INT"))
def test_model_matches_reference(quant):
    """forward_logits, prefill (logits, conv and ssm states) and one decode
    step (logits, states) against the JAX model, same params."""
    jcfg, jp, tcfg, tp = model_pair(quant)
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 17)) \
        .astype(np.int32)
    full = np.asarray(jmamba.forward_logits(jp, jcfg, jnp.asarray(tokens)))
    got = mamba2.forward_logits(tp, tcfg, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), full, **PREFILL_TOL)

    japi, tapi = jget_model(jcfg), get_model(tcfg)
    jcache, jlog = japi.prefill(jp, {"tokens": jnp.asarray(tokens[:, :16])},
                                32)
    tcache, tlog = tapi.prefill(
        tp, {"tokens": torch.from_numpy(tokens[:, :16]).long()}, 32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **PREFILL_TOL)
    np.testing.assert_allclose(tlog.numpy()[:, 0], full[:, 15], **PREFILL_TOL)
    assert_close_tree(tcache, jcache, **PREFILL_TOL)
    assert tcache["conv"].dtype == torch.float32

    jcache, jlog = japi.decode(jp, jcache,
                               {"tokens": jnp.asarray(tokens[:, 16:])},
                               jnp.int32(16))
    arena = tapi.init_cache(2, 32, device="cpu")
    for k in arena:
        arena[k].copy_(tcache[k])
    out, tlog = tapi.decode(tp, arena,
                            {"tokens": torch.from_numpy(tokens[:, 16:])
                             .long()}, 16)
    assert out is arena                        # updated in place
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **DECODE_TOL)
    np.testing.assert_allclose(tlog.numpy()[:, 0], full[:, 16], **DECODE_TOL)
    assert_close_tree(arena, jcache, **DECODE_TOL)


def test_init_matches_reference_tree():
    """The port's random init gives the reference's tree: keys, shapes and
    dtypes, bf16 and SINT."""
    cfg = get_config("mamba2_370m").reduced().with_(quant="SINT")
    jcfg = jget_config("mamba2_370m").reduced().with_(quant="SINT")
    got = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    want = jget_model(jcfg).init(jax.random.PRNGKey(0))
    assert list(leaves(got)) == list(leaves(want))
    emb = got["embed"]["emb"].to(torch.float32)
    assert 0.015 < float(emb.std()) < 0.025


def leaves(tree, path=()):
    """(path, shape, dtype name) of every leaf of a nested dict."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], path + (k,))
        else:
            yield (path + (k,), tuple(tree[k].shape),
                   str(tree[k].dtype).replace("torch.", ""))


def test_bridge_bfloat16_leaves_exact():
    """JAX bf16 leaves arrive as ml_dtypes.bfloat16 numpy arrays; the bridge
    takes them through f32 (exact) to torch.bfloat16, and back."""
    jcfg, jp, tcfg, tp = model_pair(None, dtype="bfloat16")
    assert tp["embed"]["emb"].dtype == torch.bfloat16
    assert tp["blocks"]["mixer"]["conv_w"].dtype == torch.bfloat16
    assert tp["blocks"]["mixer"]["dt_bias"].dtype == torch.float32
    assert tp["blocks"]["mixer"]["in_proj"]["w"].shape[0] == jcfg.n_layers
    back = params_to_numpy(tp)
    np.testing.assert_array_equal(
        back["blocks"]["mixer"]["in_proj"]["w"],
        np.asarray(jp["blocks"]["mixer"]["in_proj"]["w"], np.float32))
    np.testing.assert_array_equal(back["embed"]["emb"],
                                  np.asarray(jp["embed"]["emb"], np.float32))


# ---------------------------------------------------------------------------
# The wave engine


def requests(vocab, n, cls, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, 5 + 4 * i)
                .astype(np.int32), max_new_tokens=3 + i % 3)
            for i in range(n)]


@pytest.mark.parametrize("quant,n_requests", [(None, 3), ("SINT", 5)])
def test_engine_greedy_tokens_match_reference(quant, n_requests):
    """A reduced f32 wave (or two) in 4 slots: the same greedy tokens as the
    JAX Engine; the port's arena keeps its storage across waves."""
    jcfg, jp, tcfg, tp = model_pair(quant)
    want = JEngine(jget_model(jcfg), jp, batch_slots=4,
                   cache_len=32).serve(requests(jcfg.vocab, n_requests,
                                                JRequest))
    engine = Engine(get_model(tcfg), tp, batch_slots=4, cache_len=32,
                    device="cpu")
    arena = {k: v.data_ptr() for k, v in engine.cache.items()}
    got = engine.serve(requests(tcfg.vocab, n_requests, Request))
    assert [c.uid for c in got] == [c.uid for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.prefill_s > 0 and g.decode_s > 0 and g.finished_s > 0
    assert {k: v.data_ptr() for k, v in engine.cache.items()} == arena


def test_engine_wave_limits():
    _, _, tcfg, tp = model_pair(None)
    engine = Engine(get_model(tcfg), tp, batch_slots=2, cache_len=8,
                    device="cpu")
    with pytest.raises(ValueError, match="overflow the cache"):
        engine.run_wave([Request(0, np.zeros(6, np.int32), 4)])
    with pytest.raises(ValueError, match="a wave holds"):
        engine.run_wave([Request(i, np.zeros(2, np.int32), 2)
                         for i in range(3)])


def test_sample_batched_and_eos():
    """Greedy rows take the argmax; a hot row draws from its own tempered
    distribution with the engine's generator (reproducibly)."""
    logits = torch.log(torch.tensor([[0.1, 0.7, 0.2], [0.5, 0.2, 0.3],
                                     [0.2, 0.2, 0.6]]))
    temps = torch.tensor([0.0, 1.0, 0.0])
    draws = torch.stack([sample_batched(logits, temps,
                                        torch.Generator().manual_seed(s))
                         for s in range(400)])
    assert (draws[:, 0] == 1).all() and (draws[:, 2] == 2).all()
    freq = torch.bincount(draws[:, 1], minlength=3).float() / 400
    assert torch.allclose(freq, torch.tensor([0.5, 0.2, 0.3]), atol=0.08)
    assert torch.equal(sample_batched(logits, torch.zeros(3), None),
                       torch.tensor([1, 0, 2]))
    toks = np.array([4, 7, 9, 7, 1])
    for eos in (None, 7, 3):
        np.testing.assert_array_equal(_truncate_eos(toks, eos),
                                      j_truncate_eos(toks, eos))


# ---------------------------------------------------------------------------
# The norm that writes a SINT projection's codes (the norm_codes kernel on
# the card): its dispatch rule, its plain version against the eager ops, and
# the split linear


def card_stand_in(requires_grad=False):
    """A stand-in for a CUDA tensor (this machine has no card)."""
    return types.SimpleNamespace(device=torch.device("cuda"),
                                 requires_grad=requires_grad)


def sint_linear(d_in, d_out, quant="SINT", seed=0):
    return cm.linear_init(torch.Generator().manual_seed(seed), d_in, d_out,
                          bias=False, quant=quant)


def linear_before_split(p, x, backend="auto"):
    """``common._linear`` as it was before its quantize and product became
    two functions."""
    if "qw" in p:
        qw = p["qw"]
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        qmax = float(torch.iinfo(qw.dtype).max)
        xq = torch.clamp(torch.round(x2 / p["x_scale"]), -qmax, qmax)
        scale = p["x_scale"] * p["w_scale"]
        if qw.dtype == TORCH_INT_TYPES["SINT"]:
            y = ops.quantized_matmul(xq.to(qw.dtype), qw, scale, p.get("b"),
                                     backend=backend)
        else:
            y = xq @ qw.to(torch.float32) * scale
            if p.get("b") is not None:
                y = y + p["b"]
        return y.reshape(*lead, qw.shape[-1]).to(x.dtype)
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def mixer_operands(dtype, seed=0):
    """A reduced SINT mixer's params and the inputs of its two norm sites:
    the residual h (B, S, d_model), and the SSD's y (B, S, H, P) f32 with
    xs (a view of a conv output) and z (a view of in_proj's output)."""
    cfg = get_config("mamba2_370m").reduced().with_(dtype=dtype,
                                                    quant="SINT")
    params = get_model(cfg).init(torch.Generator().manual_seed(seed),
                                 device="cpu")
    blk = mamba2._layer(params["blocks"], 1)
    gen = torch.Generator().manual_seed(seed + 1)
    b, s, h, hp = 2, 23, cfg.ssm_heads, cfg.ssm_headdim
    # The norm weights away from 1, so that g takes part.
    for g in (blk["ln"]["g"], blk["mixer"]["norm"]["g"]):
        g.copy_(1.0 + 0.2 * torch.randn(g.shape, generator=gen))
    resid = (3.0 * torch.randn((b, s, cfg.d_model), generator=gen)).to(dtype)
    y = torch.randn((b, s, h, hp), generator=gen)
    conv = torch.randn((b, s, cfg.d_inner + 64), generator=gen).to(dtype)
    zx = torch.randn((b, s, cfg.d_inner + 32), generator=gen).to(dtype)
    xs = conv[..., :cfg.d_inner].reshape(b, s, h, hp)
    return cfg, blk, resid, y, xs, zx[..., :cfg.d_inner]


def spy_rmsnorm_codes(monkeypatch):
    """Stubs for both ends of ``ops.rmsnorm_codes`` (the rows of a
    card stand-in cannot be cut): it returns "kernel" or "plain", and the
    list it returns records each."""
    taken = []

    def end(name):
        def fn(*args, **kwargs):
            taken.append(name)
            return name
        return fn
    monkeypatch.setattr(ops.norm_codes, "norm_codes", end("kernel"))
    monkeypatch.setattr(ref, "norm_codes_ref", end("plain"))
    monkeypatch.setattr(ops, "_rows", lambda t: t)
    return taken


def codes_on(x, backend):
    return ops.rmsnorm_codes(x, torch.ones(4), torch.tensor(1.0),
                             backend=backend)


def _case_dispatch_cpu(monkeypatch):
    """CPU tensors take the plain version under ``"auto"`` (and a mapping
    that leaves norm_codes to it); ``"kernel"`` raises, as every kernel's
    does; a SINT prefill on the CPU never launches the kernel."""
    x = torch.zeros((3, 4))
    for backend in ("auto", {"qmatmul": "ref"}):
        assert torch.equal(codes_on(x, backend),
                           torch.zeros((3, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="no CPU mode"):
        codes_on(x, "kernel")
    taken = spy_rmsnorm_codes(monkeypatch)
    assert codes_on(x, "auto") == "plain" and taken == ["plain"]


def _case_dispatch_grad(monkeypatch):
    """A card tensor that autograd records raises (no kernel has a
    backward), as ``ops._use_kernel`` has every kernel do; without grad
    mode, or with nothing that requires grad, the kernel; the training
    step's ``GRAD_BACKEND`` names the plain version."""
    taken = spy_rmsnorm_codes(monkeypatch)
    with pytest.raises(RuntimeError, match="norm_codes kernel has no "
                       "backward"):
        codes_on(card_stand_in(requires_grad=True), "auto")
    with torch.no_grad():
        assert codes_on(card_stand_in(requires_grad=True), "auto") == "kernel"
    assert codes_on(card_stand_in(), "auto") == "kernel"
    assert GRAD_BACKEND["norm_codes"] == "ref"
    assert codes_on(card_stand_in(requires_grad=True),
                    GRAD_BACKEND) == "plain"
    assert taken == ["kernel", "kernel", "plain"]


def _case_grad_backend_sint_loss(monkeypatch):
    """A SINT mamba2's training gradient with every tensor taken for a card
    tensor: ``loss_and_grads`` (``GRAD_BACKEND``) asks norm_codes and
    qmatmul only for their plain versions and equals the plain gradient bit
    for bit, while the API's own loss under autograd raises at the first
    norm's kernel."""
    cfg = get_config("mamba2_370m").reduced().with_(dtype=torch.float32,
                                                    quant="SINT")
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 16), generator=gen)
             for k in ("tokens", "labels")}
    want_loss, want = loss_and_grads(api, params, batch)
    real, asked = ops._use_kernel, []

    def card(t, backend, kernel):
        asked.append((kernel, ops._backend_of(backend, kernel)))
        return real(card_stand_in(t.requires_grad), backend, kernel)
    monkeypatch.setattr(ops, "_use_kernel", card)
    loss, grads = loss_and_grads(api, params, batch)
    assert set(asked) == {("norm_codes", "ref"), ("qmatmul", "ref")}
    assert float(loss) == float(want_loss)
    assert want.keys() == grads.keys()
    for g, w in zip(tensor_leaves(grads), tensor_leaves(want)):
        assert torch.equal(g, w)
    emb = params["embed"]["emb"].detach().requires_grad_(True)
    with pytest.raises(RuntimeError, match="norm_codes kernel has no "
                       "backward"):
        api.loss({**params, "embed": {"emb": emb}}, batch)


def tensor_leaves(tree):
    """The tensors of a nested dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tensor_leaves(v)
        elif isinstance(v, torch.Tensor):
            yield v


def _case_dispatch_not_sint(monkeypatch):
    """INT, DINT and REAL projections norm and quantize with the eager ops:
    their prefill never reaches ``ops.rmsnorm_codes``."""
    def unreachable(*args, **kwargs):
        raise AssertionError("a non-SINT model reached ops.rmsnorm_codes")
    monkeypatch.setattr(ops, "rmsnorm_codes", unreachable)
    for quant in ("INT", "DINT", None):
        assert not cm.is_sint(sint_linear(32, 16, quant))
        cfg = get_config("mamba2_370m").reduced().with_(quant=quant)
        api = get_model(cfg)
        params = api.init(torch.Generator().manual_seed(0), device="cpu")
        _, logits = api.prefill(params, {"tokens": torch.zeros(
            (1, 6), dtype=torch.long)}, 8)
        assert torch.isfinite(logits).all()
    assert cm.is_sint(sint_linear(32, 16))


def _case_dispatch_ref(monkeypatch):
    """``backend="ref"``, or a mapping that gives norm_codes its plain
    version, takes it on the card; ``"auto"``, ``"kernel"`` and a mapping
    that leaves norm_codes out launch the kernel."""
    taken = spy_rmsnorm_codes(monkeypatch)
    for backend in ("ref", {"norm_codes": "ref"}):
        assert codes_on(card_stand_in(), backend) == "plain"
    for backend in ("auto", "kernel", {"qmatmul": "ref"},
                    {"norm_codes": "kernel"}):
        assert codes_on(card_stand_in(), backend) == "kernel"
    assert taken == ["plain"] * 2 + ["kernel"] * 4


def _case_sint_path(monkeypatch, arch, dtype):
    """A SINT prefill and full forward on the CPU, through
    ``ops.rmsnorm_codes`` (two calls a Mamba layer; its plain version here)
    equal the eager norm-then-linear ops (``common.is_sint`` forced false)
    bit for bit: logits, every cache leaf; no ``model.norm_codes`` count
    (no kernel launched)."""
    cfg = get_config(arch).reduced().with_(dtype=dtype, quant="SINT")
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 11)))
    model = hybrid if cfg.family == "hybrid" else mamba2
    with monkeypatch.context() as m:
        m.setattr(cm, "is_sint", lambda p: False)
        want_cache, want = api.prefill(params, {"tokens": tokens}, 16)
        want_full = model.forward_logits(params, cfg, tokens)
    calls = []
    real = ops.rmsnorm_codes
    monkeypatch.setattr(ops, "rmsnorm_codes",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    trace.enable()
    try:
        cache, got = api.prefill(params, {"tokens": tokens}, 16)
        counters = trace.drain()["counters"]
    finally:
        trace.disable()
    n_mamba = cfg.n_layers - cfg.n_layers // max(cfg.attn_period, 1) \
        if cfg.family == "hybrid" else cfg.n_layers
    assert len(calls) == 2 * n_mamba and counters == {}
    assert torch.equal(got, want)

    def flat(tree, path=()):
        for k, v in sorted(tree.items()):
            yield from (flat(v, path + (k,)) if isinstance(v, dict)
                        else [(path + (k,), v)])
    assert [k for k, _ in flat(cache)] == [k for k, _ in flat(want_cache)]
    for (k, v), (_, w) in zip(flat(cache), flat(want_cache)):
        assert torch.equal(v, w), k
    assert torch.equal(model.forward_logits(params, cfg, tokens), want_full)


def _case_ref_gated_out(dtype):
    """``ref.norm_codes_ref`` with the gated norm's skip and gate: the codes
    that the eager ops quantize, bit for bit, and ``_gated_out`` equal to
    the eager skip, gated RMSNorm and out_proj."""
    cfg, blk, _, y, xs, z = mixer_operands(dtype)
    p = blk["mixer"]
    b, s = z.shape[:2]
    codes = ref.norm_codes_ref(
        y.reshape(b, s, -1), p["norm"]["g"], p["out_proj"]["x_scale"],
        xs=xs.reshape(b, s, -1), d_skip=p["d_skip"], z=z)
    u = (y + p["d_skip"][None, None, :, None] * xs).reshape(b, s, -1) \
        .to(cfg.dtype)
    normed = cm.rmsnorm(p["norm"], u * torch.nn.functional.silu(z))
    assert codes.dtype == torch.int8
    assert torch.equal(codes, cm._quantize(p["out_proj"], normed))
    assert torch.equal(mamba2._gated_out(p, cfg, y, xs, z, "auto"),
                       cm.linear(p["out_proj"], normed))


def _case_ref_prenorm(dtype):
    """``ref.norm_codes_ref`` alone: ``rmsnorm`` then in_proj's quantize,
    bit for bit, and the mixer's in_proj over the residual equal to the
    eager ``linear(rmsnorm(...))``."""
    cfg, blk, resid, *_ = mixer_operands(dtype)
    p = blk["mixer"]["in_proj"]
    normed = cm.rmsnorm(blk["ln"], resid)
    codes = ref.norm_codes_ref(resid, blk["ln"]["g"], p["x_scale"])
    assert torch.equal(codes, cm._quantize(p, normed))
    assert int((codes.abs() == 127).sum()) > 0
    assert torch.equal(mamba2._in_proj(blk["mixer"], resid, blk["ln"],
                                       "auto"),
                       cm.linear(p, normed))


def _case_split_linear(quant, dtype):
    """``common.linear`` after the split: bit-identical to the function
    before it, with and without a bias, and ``_product`` on ``_quantize``'s
    codes the same again."""
    gen = torch.Generator().manual_seed(4)
    x = (2.0 * torch.randn((3, 5, 48), generator=gen)).to(dtype)
    for bias in (False, True):
        p = cm.linear_init(gen, 48, 40, bias=bias, quant=quant, dtype=dtype)
        if bias:
            p["b"].copy_(torch.randn(40, generator=gen))
        want = linear_before_split(p, x)
        assert torch.equal(cm.linear(p, x), want)
        if quant is not None:
            codes = cm._quantize(p, x)
            assert codes.dtype == (torch.int8 if quant == "SINT"
                                   else torch.float32)
            assert torch.equal(cm._product(p, codes, (3, 5), dtype, "auto"),
                               want)


NORM_CODES_CASES = {
    "dispatch-cpu": _case_dispatch_cpu,
    "dispatch-grad": _case_dispatch_grad,
    "dispatch-not-sint": _case_dispatch_not_sint,
    "dispatch-ref": _case_dispatch_ref,
    "grad-backend-sint-loss": _case_grad_backend_sint_loss,
    **{f"sint-path-{arch}-{dt}": (
        lambda mp, arch=arch, dt=dt: _case_sint_path(
            mp, arch, getattr(torch, dt)))
       for arch in ("mamba2_370m", "jamba_1_5_large_398b")
       for dt in ("float32", "bfloat16")},
    **{f"ref-{site}-{dt}": (
        lambda mp, fn=fn, dt=dt: fn(getattr(torch, dt)))
       for site, fn in (("gated-out", _case_ref_gated_out),
                        ("prenorm", _case_ref_prenorm))
       for dt in ("float32", "bfloat16")},
    **{f"split-linear-{quant}-{dt}": (
        lambda mp, quant=quant, dt=dt: _case_split_linear(
            quant, getattr(torch, dt)))
       for quant in (None, "SINT", "INT", "DINT")
       for dt in ("float32", "bfloat16")},
}


@pytest.mark.parametrize("case", tuple(NORM_CODES_CASES))
def test_norm_codes_on_the_cpu(case, monkeypatch):
    """The norm_codes dispatch (``ops.rmsnorm_codes`` under the backend
    contract: CPU and ``backend="ref"`` take the plain version, a gradient
    raises unless ``GRAD_BACKEND`` names it, INT/DINT/REAL never come
    there), the plain version ``ref.norm_codes_ref`` against the eager ops
    bit for bit, the SINT models through it equal to the eager ops, and the
    split ``common._linear`` bit for bit against the function before the
    split."""
    NORM_CODES_CASES[case](monkeypatch)
