"""The port's last three model families against the JAX reference, on the
CPU: the Jamba hybrid (Mamba + attention 1:7, MoE), the LLaVA-NeXT VLM (an
image-token prefix through a GELU projector) and the Whisper
encoder-decoder, reduced (Jamba: 8 layers, d 256, 4 experts, P 32, N 32,
G 8; LLaVA: 16 image tokens; Whisper: 32 frames), in f32.

The same params go into both packages (JAX ``api.init``, bridged through
numpy with ``repro_torch.bridge``) and the same numpy inputs through both.
The JAX hybrid's SSD runs its chunked plain version here (``ops.ssd``
'auto' off the TPU), the port's ``ref.ssd_chunked_ref`` (CPU tensors).
Tolerances, as ``tests/test_torch_llm.py`` sets them and for its reasons:
REAL logits and caches within 1e-5 of the largest value; SINT end to end
within 1e-2 (an ulp of XLA's RMSNorm/softmax moves an activation code a
step) with every SINT projection bit-exact on the same input.  The engines
are held to the reference's engines on the same requests: greedy tokens
equal, request for request, and equal step counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.models import common as jcm
from repro.models import hybrid as jhybrid
from repro.models import transformer as jtf
from repro.models import vlm as jvlm
from repro.models import whisper as jwhisper
from repro.models.api import get_model as jget_model
from repro.serving import ContinuousEngine as JContinuousEngine
from repro.serving import CyclicDecoder as JCyclicDecoder
from repro.serving import Engine as JEngine
from repro.serving import Request as JRequest
from repro.serving.continuous import _batch_axes as j_batch_axes
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import common as cm
from repro_torch.models import hybrid, vlm, whisper
from repro_torch.models.api import get_model
from repro_torch.serving import (ContinuousEngine, CyclicDecoder, Engine,
                                 Request)
from repro_torch.serving.continuous import _batch_axes, _leaves

torch.set_num_threads(1)

HYBRID, VLM, AUDIO = "jamba_1_5_large_398b", "llava_next_34b", "whisper_base"
FAMILIES = (HYBRID, VLM, AUDIO)
REAL_TOL, SINT_TOL = 1e-5, 1e-2
PROMPT, CACHE = 20, 64
_PAIRS = {}


def pair(arch, quant=None):
    """(JAX api, JAX params, port api, port params) of the reduced f32
    config, built once per module."""
    key = (arch, quant)
    if key not in _PAIRS:
        jcfg = jget_config(arch).reduced().with_(dtype=jnp.float32,
                                                 quant=quant)
        tcfg = get_config(arch).reduced().with_(dtype=torch.float32,
                                                quant=quant)
        japi = jget_model(jcfg)
        jp = japi.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        _PAIRS[key] = (japi, jp, get_model(tcfg), tp)
    return _PAIRS[key]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def flat(tree, path=()):
    """{path: leaf} of a nested dict."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(flat(tree[k], path + (k,)))
        else:
            out[path + (k,)] = tree[k]
    return out


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def assert_rel(got, want, tol, what=""):
    """|got - want| within ``tol`` of the largest |want|."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= tol, f"{what}: {err} of the largest, tolerance {tol}"


def assert_cache(got, want, tol):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype).replace("torch.", "") == \
            np.asarray(want[k]).dtype.name, k
        assert_rel(got[k], want[k], tol, f"cache {k}")


def extras_np(cfg, batch, seed):
    """The family's prefill inputs besides tokens, from a seed: the vlm's
    image embeddings, the audio family's frames."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"image_emb": rng.standard_normal(
            (batch, cfg.num_image_tokens, vlm.VISION_D)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (batch, cfg.encoder_frames, cfg.d_model)).astype(np.float32)}
    return {}


def leaves_spec(tree):
    return [(k, tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in flat(tree).items()]


def leaves_port(tree):
    return [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat(tree).items()]


# ---------------------------------------------------------------------------
# Configs, the param tree, the cache and batch layouts


@pytest.mark.parametrize("reduced", (False, True))
@pytest.mark.parametrize("arch", FAMILIES)
def test_config_matches_reference(arch, reduced):
    want, got = jget_config(arch), get_config(arch)
    if reduced:
        want, got = want.reduced(), got.reduced()
    jfields, tfields = dataclasses.asdict(want), dataclasses.asdict(got)
    jfields.pop("notes")
    tfields.pop("notes")
    assert jfields.pop("dtype") == jnp.bfloat16
    assert tfields.pop("dtype") == torch.bfloat16
    assert tfields == jfields
    assert (got.d_head, got.d_inner, got.ssm_heads) == \
        (want.d_head, want.d_inner, want.ssm_heads)


def test_hybrid_layout_matches_reference():
    """Attention at position 3 of 8, 7 Mamba layers, MLP at the even
    positions and MoE at the odd ones, at full depth and reduced."""
    for cfg in (get_config(HYBRID), get_config(HYBRID).reduced()):
        assert hybrid._layout(cfg) == jhybrid._layout(
            jget_config(HYBRID).with_(n_layers=cfg.n_layers))
    assert hybrid._layout(get_config(HYBRID)) == (8, 3, 9, 7, 4, 4)


@pytest.mark.parametrize("quant", (None, "SINT"))
@pytest.mark.parametrize("arch", FAMILIES)
def test_init_tree_matches_param_specs(arch, quant):
    """The port's random init has the keys, shapes and dtypes of the JAX
    ``param_specs()`` (bf16 working type): the hybrid's stacks nested
    (n_super, n_inner, ...), the vlm's plain projector, whisper's two
    stacks with cross-attention's bias pattern."""
    jcfg = jget_config(arch).reduced().with_(quant=quant)
    tcfg = get_config(arch).reduced().with_(quant=quant)
    got = get_model(tcfg).init(torch.Generator().manual_seed(0),
                               device="cpu")
    assert leaves_port(got) == leaves_spec(jget_model(jcfg).param_specs())
    if arch == VLM:
        assert sorted(got["projector"]["fc1"]) == ["b", "w"]
    if arch == AUDIO:
        cross = got["dec_blocks"]["cross"]
        assert [("b" in cross[n]) for n in ("wq", "wk", "wv", "wo")] == \
            [True, False, True, True]


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_specs_match_reference(arch):
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    got = get_model(tcfg).cache_specs(3, 48)
    assert leaves_port(got) == leaves_spec(jget_model(jcfg).cache_specs(3,
                                                                        48))
    assert all(v.device.type == "meta" for v in flat(got).values())
    cache = get_model(tcfg).init_cache(3, 48, device="cpu")
    assert leaves_port(cache) == leaves_port(got)
    assert all(not bool(v.any()) for v in flat(cache).values())
    want_axes = j_batch_axes(jget_model(jcfg), 48)
    assert _batch_axes(get_model(tcfg), 48) == want_axes
    if arch == HYBRID:      # k, mamba.conv, mamba.ssm, v
        assert want_axes == [1, 2, 2, 1]


@pytest.mark.parametrize("arch", FAMILIES)
def test_batch_specs_and_init_batch(arch):
    """batch_specs at every kind has the reference's names and shapes
    (token ids int64 here), and init_batch draws a batch of that layout."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    for kind in ("train", "prefill", "decode"):
        want = japi.batch_specs(kind, 2, 40)
        got = tapi.batch_specs(kind, 2, 40)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape), (kind, k)
            if got[k].dtype.is_floating_point:
                assert got[k].dtype == torch.bfloat16
            else:
                assert got[k].dtype == torch.int64
        batch = tapi.init_batch(kind, 2, 40, torch.Generator().manual_seed(1),
                                device="cpu")
        assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == \
            {k: (tuple(s.shape), s.dtype) for k, s in got.items()}
        assert int(batch["tokens"].min()) >= 0
        assert int(batch["tokens"].max()) < tcfg.vocab
    if arch == VLM:
        assert tuple(tapi.batch_specs("prefill", 2, 40)["image_emb"].shape) \
            == (2, 16, vlm.VISION_D)
    if arch == AUDIO:
        assert tuple(tapi.batch_specs("prefill", 2, 40)["frames"].shape) == \
            (2, 32, tcfg.d_model)


def test_sinusoids_match_reference():
    """Whisper's position encoding at the decoder's positions.  XLA's f32
    ``exp`` is off the correctly rounded value by an ulp for about one
    frequency in ten (PyTorch's is not), and the angle carries that ulp
    times the position, so the two agree within 1e-5 below position 64 (the
    tests' prompts) and, out to the encoder's 1500 frames, within the
    position times two ulps of the frequency."""
    pos = np.arange(64)
    want = jwhisper.sinusoids(jnp.asarray(pos), 512)
    assert_rel(whisper.sinusoids(t(pos), 512), want, REAL_TOL, "sinusoids")
    pos = np.arange(0, 1500, 7)
    want = np.asarray(jwhisper.sinusoids(jnp.asarray(pos), 512))
    got = whisper.sinusoids(t(pos), 512).numpy()
    bound = pos[:, None] * 2 * np.finfo(np.float32).eps + 1e-6
    assert (np.abs(got - want) <= bound).all()


# ---------------------------------------------------------------------------
# The models: prefill, decode at a shared position, decode per row


def run_pair(arch, quant, tokens, extras, pos_multi):
    """Prefill on tokens[:, :-2] (with the family's extras), one
    shared-position decode step, one per-row decode step: JAX's and the
    port's (cache, logits) each time (the port's cache copied: the next
    step updates the arena in place)."""
    japi, jp, tapi, tp = pair(arch, quant)
    p = tokens.shape[1] - 2
    start = p + (tapi.cfg.num_image_tokens if arch == VLM else 0)
    out = []
    jb = {"tokens": jnp.asarray(tokens[:, :p]),
          **{k: jnp.asarray(v) for k, v in extras.items()}}
    tb = {"tokens": t(tokens[:, :p]), **{k: t(v) for k, v in extras.items()}}
    jc, jl = japi.prefill(jp, jb, CACHE)
    tc, tl = tapi.prefill(tp, tb, CACHE)
    out.append(("prefill", jc, jl, clone(tc), tl))
    jc, jl = japi.decode(jp, jc, {"tokens": jnp.asarray(tokens[:, p:p + 1])},
                         jnp.int32(start))
    arena = tapi.init_cache(tokens.shape[0], CACHE, device="cpu")
    for dst, src in zip(_leaves(arena), _leaves(tc)):
        dst.copy_(src)
    tc, tl = tapi.decode(tp, arena, {"tokens": t(tokens[:, p:p + 1])},
                         start)
    assert tc is arena                      # updated in place
    out.append(("decode", jc, jl, clone(tc), tl))
    jc, jl = japi.decode_multi(jp, jc, {"tokens": jnp.asarray(
        tokens[:, p + 1:])}, jnp.asarray(pos_multi, jnp.int32))
    tc, tl = tapi.decode_multi(tp, tc, {"tokens": t(tokens[:, p + 1:])},
                               t(pos_multi))
    out.append(("decode_multi", jc, jl, clone(tc), tl))
    return out


@pytest.mark.parametrize("quant", (None, "SINT"))
@pytest.mark.parametrize("arch", FAMILIES)
def test_model_matches_reference(arch, quant):
    """Prefill logits and cache, a decode step at the shared position and a
    per-row decode step (one row at the next position, one rewriting an
    earlier one) against the JAX model, same params.  Whisper's
    cross-attention K/V stay as the prefill wrote them."""
    japi, _, tapi, _ = pair(arch, quant)
    cfg = tapi.cfg
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (2, PROMPT + 2))
    start = PROMPT + (cfg.num_image_tokens if arch == VLM else 0)
    tol = REAL_TOL if quant is None else SINT_TOL
    runs = run_pair(arch, quant, tokens, extras_np(cfg, 2, 9),
                    np.array([start + 1, 5]))
    for what, jc, jl, tc, tl in runs:
        assert tl.shape == (2, 1, cfg.vocab) and tl.dtype == torch.float32
        assert_rel(tl, jl, tol, f"{what} logits")
        assert_cache(tc, jc, tol)
    if arch == AUDIO:
        prefilled = runs[0][3]
        for _, _, _, tc, _ in runs[1:]:
            assert torch.equal(tc["xk"], prefilled["xk"])
            assert torch.equal(tc["xv"], prefilled["xv"])
    if arch == HYBRID:
        conv = runs[0][3]["mamba"]["conv"]
        assert conv.dtype == cfg.dtype and conv.abs().max() > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_match_reference_and_prefill(arch):
    """The teacher-forced forward against the JAX model's, and its last
    position against the port's own prefill."""
    japi, jp, tapi, tp = pair(arch)
    cfg = tapi.cfg
    tokens = np.random.default_rng(10).integers(0, cfg.vocab, (2, 16))
    ex = extras_np(cfg, 2, 11)
    if arch == HYBRID:
        want = jhybrid.forward_logits(jp, japi.cfg, jnp.asarray(tokens))
        got = hybrid.forward_logits(tp, cfg, t(tokens))
    elif arch == VLM:
        prefix = jvlm.project(jp, jnp.asarray(ex["image_emb"]))
        want = jtf.forward_logits(jp, japi.cfg, jnp.asarray(tokens),
                                  prefix_embed=prefix)
        got = vlm.forward_logits(tp, cfg, {"tokens": t(tokens),
                                           "image_emb": t(ex["image_emb"])})
        assert_rel(vlm.project(tp, t(ex["image_emb"])), prefix, REAL_TOL,
                   "projector")
    else:
        want = jwhisper.forward_logits(jp, japi.cfg,
                                       jnp.asarray(ex["frames"]),
                                       jnp.asarray(tokens))
        got = whisper.forward_logits(tp, cfg, t(ex["frames"]), t(tokens))
    assert_rel(got, want, REAL_TOL, f"{arch} forward")
    _, last = tapi.prefill(tp, {"tokens": t(tokens),
                                **{k: t(v) for k, v in ex.items()}}, 64)
    assert_rel(last, want[:, -1:], REAL_TOL, f"{arch} prefill")


def quantized_linears(tree, path=()):
    """(path, params) of every §6.1-quantized linear of a param tree."""
    if "qw" in tree:
        yield path, tree
        return
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from quantized_linears(tree[k], path + (k,))


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_sint_projection_is_bit_exact(arch):
    """Every SINT linear of the model (the Mamba in/out projections, the
    attention, MLP and cross-attention projections; first layer of each
    stack) equals the reference's bit for bit on the same input; the
    vlm's projector and the experts stay plain."""
    _, jp, tapi, tp = pair(arch, "SINT")
    jflat = flat(jp)
    rng = np.random.default_rng(12)
    found = list(quantized_linears(tp))
    for path, p in found:
        lead = p["qw"].ndim - 2
        one = {k: v[(0,) * lead] for k, v in p.items()}
        jone = {k: jnp.asarray(jflat[path + (k,)])[(0,) * lead] for k in p}
        x = (rng.standard_normal((2, 3, one["qw"].shape[0])) * 0.5).astype(
            np.float32)
        want = np.asarray(jcm.linear(jone, jnp.asarray(x)))
        np.testing.assert_array_equal(cm.linear(one, t(x)).numpy(), want,
                                      err_msg=str(path))
    names = {path[-1] for path, _ in found}
    want = {HYBRID: {"in_proj", "out_proj", "wq", "wk", "wv", "wo",
                     "w_gate", "w_up", "w_down"},
            VLM: {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"},
            AUDIO: {"wq", "wk", "wv", "wo", "w_up", "w_down"}}[arch]
    assert names == want
    if arch == HYBRID:
        assert tp["blocks"]["moe"]["moe"]["w_up"].is_floating_point()
    if arch == VLM:
        assert "w" in tp["projector"]["fc1"] and "w" in tp["projector"]["fc2"]


# ---------------------------------------------------------------------------
# Sensitivity (the reference's tests/test_archs.py checks)


def test_vlm_prefix_changes_text_logits():
    _, _, tapi, tp = pair(VLM)
    cfg = tapi.cfg
    b = tapi.init_batch("train", 1, 32, torch.Generator().manual_seed(1),
                        device="cpu")
    text = slice(cfg.num_image_tokens, None)
    one = vlm.forward_logits(tp, cfg, b)[:, text]
    two = vlm.forward_logits(tp, cfg, dict(b, image_emb=b["image_emb"] + 1))
    assert float((one - two[:, text]).abs().max()) > 1e-6


def test_whisper_cross_attention_sees_frames():
    _, _, tapi, tp = pair(AUDIO)
    b = tapi.init_batch("train", 1, 16, torch.Generator().manual_seed(1),
                        device="cpu")
    one = whisper.forward_logits(tp, tapi.cfg, b["frames"], b["tokens"])
    two = whisper.forward_logits(tp, tapi.cfg, b["frames"] * 2.0,
                                 b["tokens"])
    assert float((one - two).abs().max()) > 1e-6


# ---------------------------------------------------------------------------
# The engines


def requests(n, cls, vocab, lens=(6, 11, 4, 9), new=(5, 3, 6, 4)):
    rng = np.random.default_rng(3)
    return [cls(uid=i, prompt=rng.integers(0, vocab, lens[i % len(lens)])
                .astype(np.int32), max_new_tokens=new[i % len(new)])
            for i in range(n)]


def by_uid(done):
    return {c.uid: np.asarray(c.tokens) for c in done}


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=str(uid))


@pytest.mark.parametrize("arch", (VLM, AUDIO))
def test_engine_extras_match_reference(arch):
    """The wave Engine with ``extras`` (the vlm's image embeddings, the
    audio family's frames, one row per slot) merged into every prefill and
    decode batch: the JAX wave engine's greedy tokens, two waves."""
    japi, jp, tapi, tp = pair(arch)
    ex = extras_np(tapi.cfg, 2, 13)
    cache = CACHE + (tapi.cfg.num_image_tokens if arch == VLM else 0)
    want = by_uid(JEngine(japi, jp, batch_slots=2, cache_len=cache,
                          extras={k: jnp.asarray(v) for k, v in ex.items()})
                  .serve(requests(4, JRequest, tapi.cfg.vocab)))
    eng = Engine(tapi, tp, batch_slots=2, cache_len=cache,
                 extras={k: t(v) for k, v in ex.items()}, device="cpu")
    assert_same(by_uid(eng.serve(requests(4, Request, tapi.cfg.vocab))),
                want)
    assert all(v.device.type == "cpu" for v in eng.extras.values())
    if arch == VLM:     # the arena must hold the image prefix and the text
        short = Engine(tapi, tp, batch_slots=2, cache_len=CACHE,
                       extras={k: t(v) for k, v in ex.items()}, device="cpu")
        with pytest.raises(ValueError, match="cannot hold"):
            short.serve(requests(2, Request, tapi.cfg.vocab, lens=(60,)))


def test_cyclic_decoder_on_vlm_matches_reference():
    """CyclicDecoder.decode_tokens on the vlm from a prefilled cache (image
    prefix and prompt): the reference's tokens, one cycle per segment per
    token, the cache within 1e-5 of the reference's."""
    japi, jp, tapi, tp = pair(VLM)
    prompt = np.random.default_rng(4).integers(0, tapi.cfg.vocab, (1, 12))
    ex = extras_np(tapi.cfg, 1, 14)
    cache_len = CACHE + tapi.cfg.num_image_tokens
    jcache, jlogits = japi.prefill(jp, {"tokens": jnp.asarray(prompt),
                                        "image_emb": jnp.asarray(
                                            ex["image_emb"])}, cache_len)
    jfirst = jnp.argmax(jlogits[:, -1], -1).astype(jnp.int32)
    jtoks, jcache, _ = JCyclicDecoder(
        japi.cfg, jp, n_segments=2, batch=1,
        cache_len=cache_len).decode_tokens(jcache, jfirst, 12, 6)
    cache, logits = tapi.prefill(tp, {"tokens": t(prompt),
                                      "image_emb": t(ex["image_emb"])},
                                 cache_len)
    first = torch.argmax(logits[:, -1], -1)
    assert int(first[0]) == int(jfirst[0])
    cd = CyclicDecoder(tapi.cfg, tp, n_segments=2, batch=1,
                       cache_len=cache_len, device="cpu")
    toks, out, stats = cd.decode_tokens(cache, first, 12, 6)
    assert toks == jtoks and out is cache
    assert len(stats.cycle_times_s) == 12
    assert_cache(cache, jcache, REAL_TOL)


def test_continuous_hybrid_matches_reference():
    """Five requests through two slots of the ContinuousEngine (slots
    retire and are re-admitted; the hybrid prefills at exact length): the
    JAX engine's greedy tokens, request for request, the same number of
    steps; the arena keeps its storage across serves."""
    japi, jp, tapi, tp = pair(HYBRID)
    vocab = tapi.cfg.vocab
    jeng = JContinuousEngine(japi, jp, batch_slots=2, cache_len=CACHE)
    want = by_uid(jeng.serve(requests(5, JRequest, vocab)))
    eng = ContinuousEngine(tapi, tp, batch_slots=2, cache_len=CACHE,
                           device="cpu")
    assert eng._bucket is None
    arena = [v.data_ptr() for v in _leaves(eng.cache)]
    done = eng.serve(requests(5, Request, vocab))
    assert_same(by_uid(done), want)
    assert eng.last_stats.admitted == 5
    assert eng.last_stats.steps == jeng.last_stats.steps
    assert eng.last_stats.steps < sum(c.tokens.size for c in done)
    assert [v.data_ptr() for v in _leaves(eng.cache)] == arena


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_serve_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve`` for the three families on the
    CPU (the vlm and audio families with zero extras; ``--cyclic`` through
    the CyclicDecoder for the vlm, through the wave engine for the others,
    as the reference)."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--requests",
            "3", "--prompt-len", "6", "--max-new", "4", "--batch-slots",
            "2", "--cache-len", "32"]
    launch_serve.main(argv)
    out = capsys.readouterr().out
    assert sum(line.startswith("req ") for line in out.splitlines()) == 3
    launch_serve.main(argv + ["--cyclic", "2"])
    out = capsys.readouterr().out
    if arch == VLM:
        assert "cyclic decode: 4 tokens" in out
    else:
        assert sum(line.startswith("req ") for line in out.splitlines()) == 3
    if arch == HYBRID:
        launch_serve.main(argv + ["--engine", "continuous", "--quant",
                                  "SINT"])
        assert "serve stats" in capsys.readouterr().out
