"""The port's LLM training stack against the JAX reference, on the CPU.

Each family's ``api.loss`` and its gradient (``launch.steps.loss_and_grads``,
the port's ``jax.value_and_grad``) are held to the JAX ``api.loss`` and
``jax.grad`` from the same params (JAX ``api.init``, bridged through numpy
with ``repro_torch.bridge``) on the same numpy batch, reduced configs in
f32, B 2 x S 64: the loss within 1e-5 relative, every gradient leaf within
1e-5 of that leaf's largest value (f32 dots summed in another order; the
hybrid's SSD is the chunked plain version on both sides, the reference's
own gradient path off the TPU).  One whole train step (loss, gradient norm,
AdamW, the updated params) is held to the reference's jitted step the same
way.  The rest are the port's twins of the reference's training tests
(``test_archs.py::test_smoke_forward_and_train_step`` over every
architecture, the vlm prefix and Whisper frames reaching the loss,
``test_system.py::test_checkpoint_resume_bitexact`` and
``::test_loss_decreases`` at the reference's size), the train launcher on
the CPU, and the guard that keeps a gradient out of the kernels.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget_config
from repro.launch.steps import make_optimizer as jmake_optimizer
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.api import get_model as jget_model
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.launch.steps import (GRAD_BACKEND, loss_and_grads,
                                      make_optimizer, make_train_step)
from repro_torch.models.api import get_model
from repro_torch.models.vlm import VISION_D
from repro_torch.optim.adamw import tree_map

torch.set_num_threads(1)

FAMILIES = ("qwen3_8b", "granite_moe_1b_a400m", "mamba2_370m",
            "jamba_1_5_large_398b", "llava_next_34b", "whisper_base")
TOL = 1e-5
# Jamba's a_log gradient sums B x T x P x N products with cancellation:
# two f32 summation orders of it part by just over 1e-5 of its largest
# value here, so it is held to twice the common tolerance.
LEAF_TOL = {("jamba_1_5_large_398b", "blocks/mamba/mixer/a_log"): 2e-5}
BATCH, SEQ = 2, 64
_PAIRS = {}


def pair(arch):
    """(JAX api, JAX params, port api, port params) of the reduced f32
    config, built once per module."""
    if arch not in _PAIRS:
        jcfg = jget_config(arch).reduced().with_(dtype=jnp.float32)
        tcfg = get_config(arch).reduced().with_(dtype=torch.float32)
        japi = jget_model(jcfg)
        jp = japi.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        _PAIRS[arch] = (japi, jp, get_model(tcfg), tp)
    return _PAIRS[arch]


def numpy_batch(cfg, seed=1):
    """A train batch of B 2 x S 64 as numpy (token ids int32, extras f32),
    laid out as ``batch_specs("train", 2, 64)``."""
    rng = np.random.default_rng(seed)
    text = SEQ - cfg.num_image_tokens if cfg.family == "vlm" else SEQ
    out = {k: rng.integers(0, cfg.vocab, (BATCH, text)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        out["image_emb"] = rng.standard_normal(
            (BATCH, cfg.num_image_tokens, VISION_D)).astype(np.float32)
    elif cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return out


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def port_batch(b):
    return {k: torch.from_numpy(v).to(torch.int64) if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def close_leaves(got, want, what, tol=TOL, floor=1e-30):
    """Every leaf of ``got`` (port) within ``tol`` of ``want``'s (JAX)
    largest value (at least ``floor``); the same leaves on both sides."""
    got, want = dict(flat(got)), dict(flat(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[name].detach().to(torch.float32).numpy()
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(g - w).max())
        leaf_tol = LEAF_TOL.get((what, name), tol)
        assert err <= leaf_tol * scale, f"{what} {name}: {err} of {scale}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    japi, jp, tapi, tp = pair(arch)
    b = numpy_batch(tapi.cfg)
    jloss, jgrads = jax.value_and_grad(japi.loss)(jp, jax_batch(b))
    loss, grads = loss_and_grads(tapi, tp, port_batch(b))
    assert loss.shape == () and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    close_leaves(grads, jgrads, arch)
    # The loss without a gradient, through the API's own backend.
    with torch.no_grad():
        np.testing.assert_allclose(float(tapi.loss(tp, port_batch(b))),
                                   float(jloss), rtol=TOL)
    assert not any(p.requires_grad for _, p in flat(tp))


@pytest.mark.parametrize("arch", ("qwen3_8b", "mamba2_370m"))
def test_train_step_matches_reference(arch):
    """Two steps of ``make_train_step`` (warmup 1, so the second step's
    learning rate is not 0) against the reference's jitted step: loss and
    gradient norm within 1e-5 relative, both moments (which carry both
    steps' gradients) within 1e-4 of each leaf's largest value, and the
    updated params within a tenth of the learning rate (times the larger
    of 1 and the leaf's largest value): AdamW's normalised update moves an
    element whose gradient is f32 noise by up to the learning rate, so two
    correct gradients can move such an element by a few hundredths of it
    apart (4.7e-5 here at lr 1e-3)."""
    japi, jp, tapi, tp = pair(arch)
    tp = tree_map(torch.clone, tp)
    jinit, jupdate = jmake_optimizer(1e-3, warmup=1, steps=10)
    tinit, tupdate = make_optimizer(1e-3, warmup=1, steps=10)
    jstep = jax.jit(jmake_train_step(japi, jupdate))
    tstep = make_train_step(tapi, tupdate)
    jstate, tstate = jinit(jp), tinit(tp)
    for seed in (1, 2):
        b = numpy_batch(tapi.cfg, seed)
        jp, jstate, jm = jstep(jp, jstate, jax_batch(b))
        tp, tstate, tm = tstep(tp, tstate, port_batch(b))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL)
    close_leaves(tstate.mu, jstate.mu, f"{arch} mu", tol=1e-4)
    close_leaves(tstate.nu, jstate.nu, f"{arch} nu", tol=1e-4)
    close_leaves(tp, jp, f"{arch} params", tol=0.1 * 1e-3, floor=1.0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_train_step(arch):
    """The reduced config in its own dtype: a finite scalar loss, one train
    step with finite metrics, and the params moved."""
    cfg = get_config(arch).reduced()
    assert cfg.n_layers <= max(cfg.attn_period, 2)
    assert cfg.d_model <= 512
    assert cfg.n_experts <= 4
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = api.init(gen, device="cpu")
    batch = api.init_batch("train", 2, 64, gen, device="cpu")
    with torch.no_grad():
        loss = api.loss(params, batch)
    assert loss.shape == ()
    assert torch.isfinite(loss), f"{arch}: loss not finite"

    before = tree_map(torch.clone, params)
    opt_init, opt_update = make_optimizer()
    step = make_train_step(api, opt_update)
    params2, _, metrics = step(params, opt_init(params), batch)
    assert torch.isfinite(metrics["loss"])
    assert torch.isfinite(metrics["grad_norm"])
    moved = any(not torch.equal(a, b) for (_, a), (_, b) in
                zip(flat(before), flat(params2)) if a.is_floating_point())
    assert moved, f"{arch}: train step did not update parameters"


@pytest.mark.parametrize("arch,extra,change", [
    ("llava_next_34b", "image_emb", lambda v: v + 1.0),
    ("whisper_base", "frames", lambda v: v * 2.0)])
def test_loss_sees_the_prefix_and_the_frames(arch, extra, change):
    """Twins of ``test_archs.py::test_vlm_prefix_changes_text_logits`` and
    ``::test_whisper_cross_attention_sees_frames``."""
    _, _, api, params = pair(arch)
    b = port_batch(numpy_batch(api.cfg))
    with torch.no_grad():
        one = float(api.loss(params, b))
        two = float(api.loss(params, dict(b, **{extra: change(b[extra])})))
    assert abs(one - two) > 1e-6


def test_checkpoint_resume_bitexact(tmp_path):
    """Two steps, a checkpoint, then two more steps from the live params
    and from the restored ones (the optimizer state copied first: the step
    updates it in place): the same loss, bit for bit."""
    cfg = get_config("mamba2_370m").reduced()
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    opt_init, opt_update = make_optimizer()
    opt = opt_init(params)
    step = make_train_step(api, opt_update)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4, seed=0)).batches()
    batches = [{k: torch.from_numpy(v).long() for k, v in next(data).items()}
               for _ in range(4)]

    def run(params, opt, batches):
        for b in batches:
            params, opt, m = step(params, opt, b)
        return params, opt, float(m["loss"])

    params1, opt1, _ = run(params, opt, batches[:2])
    save(str(tmp_path), 2, {"params": params1})
    params1r = restore(str(tmp_path), {"params": params1})["params"]
    for (_, a), (_, b) in zip(flat(params1), flat(params1r)):
        assert torch.equal(a, b)
    opt1_copy = opt1._replace(mu=tree_map(torch.clone, opt1.mu),
                              nu=tree_map(torch.clone, opt1.nu))
    _, _, loss_a = run(params1, opt1, batches[2:])
    _, _, loss_b = run(params1r, opt1_copy, batches[2:])
    assert loss_a == loss_b


def test_loss_decreases():
    """The reference's ``test_loss_decreases`` at its size (qwen3 reduced,
    40 steps of 8 x 64 tokens, lr 3e-3): the mean of the last 5 losses at
    least 0.3 below the first 5's."""
    cfg = get_config("qwen3_8b").reduced()
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    opt_init, opt_update = make_optimizer(3e-3, warmup=5, steps=60)
    opt = opt_init(params)
    step = make_train_step(api, opt_update)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8, seed=0)).batches()
    losses = []
    for _ in range(40):
        b = {k: torch.from_numpy(v).long() for k, v in next(data).items()}
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


@pytest.mark.parametrize("arch", ("mamba2_370m", "llava_next_34b"))
def test_launch_train_on_cpu(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train`` end to end on the CPU, with a
    checkpoint every 2 steps."""
    launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "4", "--batch", "2", "--seq", "32",
                       "--log-every", "2", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "2"])
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in out if ln.startswith("step")] == \
        ["0", "2", "3"]
    assert out[-1].startswith("final loss")
    assert latest_step(str(tmp_path)) == 4
    assert (tmp_path / "step_00000002" / "manifest.json").exists()


def test_launch_train_refuses_the_mesh_and_the_missing_card(monkeypatch):
    """``--production-mesh`` needs the (16, 16) mesh's 256 ranks: with no
    process group (none here) it raises the mesh's own error; so does a
    launch without a card."""
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        launch_train.main(["--arch", "qwen3_8b", "--reduced",
                           "--production-mesh", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "qwen3_8b", "--reduced"])


def on_card(t):
    """A stand-in for a CUDA tensor with ``t``'s requires_grad (this
    machine has no card)."""
    return types.SimpleNamespace(device=torch.device("cuda"),
                                 requires_grad=t.requires_grad)


def test_gradient_guard_raises():
    """A kernel asked for a gradient raises, naming itself; without grad
    mode, or on an input that needs none, it launches; the plain versions
    never ask."""
    x = torch.zeros(3, requires_grad=True)
    for kernel in ops.KERNELS:
        with pytest.raises(RuntimeError, match=f"the {kernel} kernel has "
                           "no backward"):
            ops._use_kernel(on_card(x), "auto", kernel)
        with pytest.raises(RuntimeError, match="no backward"):
            ops._use_kernel(on_card(x), {kernel: "kernel"}, kernel)
        with torch.no_grad():
            assert ops._use_kernel(on_card(x), "auto", kernel)
        assert ops._use_kernel(on_card(x.detach()), "auto", kernel)
        assert not ops._use_kernel(on_card(x), {kernel: "ref"}, kernel)


def test_train_step_takes_the_plain_versions(monkeypatch):
    """With every tensor taken for a card tensor: the API's loss under
    autograd reaches ssd_scan and raises, while the train step's gradient
    (``GRAD_BACKEND``: the chunked SSD) never asks for a kernel and equals
    the plain gradient on the CPU."""
    _, _, api, params = pair("mamba2_370m")
    params = tree_map(torch.clone, params)
    b = port_batch(numpy_batch(api.cfg))
    want_loss, want = loss_and_grads(api, params, b)
    real = ops._use_kernel
    asked = []

    def card(t, backend, kernel):
        asked.append(kernel)
        return real(on_card(t), backend, kernel)

    monkeypatch.setattr(ops, "_use_kernel", card)
    loss, grads = loss_and_grads(api, params, b)
    assert asked == [] and GRAD_BACKEND["ssd_scan"] == "chunked"
    assert float(loss) == float(want_loss)
    for (_, g), (_, w) in zip(flat(grads), flat(want)):
        assert torch.equal(g, w)
    for _, p in flat(params):
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="ssd_scan kernel has no "
                       "backward"):
        api.loss(params, b)
    assert asked == ["ssd_scan"]
