"""The port's sharded LLM train step on CPU gloo ranks, against the JAX
reference's unsharded train step and the port's own.

One module-scoped fixture spawns four gloo ranks
(``repro_torch.launch.mesh.spawn``) that run every case below on its
``(data, model)`` mesh: the six families of ``test_torch_llm_train.FAMILIES``
reduced in f32 on ``(2, 2)``, and qwen3-8b and granite-moe also on ``(4, 1)``
and ``(1, 4)``, two steps of ``launch.steps.make_sharded_train_step`` each
from the same params (the reference's ``api.init`` bridged through numpy) on
the same batches.  Meanwhile this process runs the reference's jitted
``make_train_step`` (its own ``(1, 1)`` mesh step fails under jax 0.9) and
the port's unsharded ``make_train_step`` on the same params and batches.
The ranks import this module to unpickle the rank function, so JAX is
imported only inside the functions this process runs.

Tolerances, those of ``test_torch_llm_train``: the loss and the gradient
norm of each step within ``TOL`` relative, and the first step's gradient,
leaf by leaf, within ``TOL`` (``LEAF_TOL``) of the leaf's largest value.  A
shard's matmuls and the vocab-parallel cross-entropy sum in another order
than the whole-tensor ops, so the sharded step is held to both unsharded
steps with the same tolerances.  The update is held apart from the
gradient: the params after two sharded steps equal, within ``ADAMW_TOL`` of
the leaf's largest value (at least 1), the port's unsharded AdamW driven by
the sharded step's own gradients.  The params are not held to the
unsharded steps' params: AdamW's normalised update moves an element whose
gradient is f32 noise by up to the learning rate, and at B 4 x S 64 the
reference's step and the port's unsharded one already part by up to 0.28
of it after two steps (five of the six families beyond a tenth), the
sharded steps by up to 0.37.  Every param and both moments of each leaf
come back with ``to_placements`` of the port's sharding rules.
"""

import concurrent.futures
import contextlib
import io
import os
import tempfile
import traceback

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import restore, save
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import shardings as tsh
from repro_torch.launch.steps import (make_optimizer, make_sharded_train_step,
                                      make_train_step)
from repro_torch.models.api import get_model
from repro_torch.optim.adamw import OptState, apply_updates, tree_map

WORLD = 4
FAMILIES = ("qwen3_8b", "granite_moe_1b_a400m", "mamba2_370m",
            "jamba_1_5_large_398b", "llava_next_34b", "whisper_base")
CASES = tuple((arch, (2, 2)) for arch in FAMILIES) + tuple(
    (arch, shape) for arch in ("qwen3_8b", "granite_moe_1b_a400m")
    for shape in ((4, 1), (1, 4)))
CASE_IDS = tuple(f"{a}-{d}x{m}" for a, (d, m) in CASES)
# The case whose checkpoint the unsharded step resumes from.
RESUME = ("qwen3_8b", (2, 2))
BATCH, SEQ, STEPS, LR = 4, 64, 2, 1e-3
TOL = 1e-5
# Jamba's a_log gradient: test_torch_llm_train.LEAF_TOL.
LEAF_TOL = {("jamba_1_5_large_398b", "blocks/mamba/mixer/a_log"): 2e-5}
# The same AdamW on the same gradients: only the clip's scale, from the
# gradient norm summed over shards in another order, moves last bits.
ADAMW_TOL = 1e-6


def _cfg(arch):
    return get_config(arch).reduced().with_(dtype=torch.float32)


def _batches(cfg, n):
    """``n`` train batches of B 4 x S 64 as numpy, laid out as
    ``batch_specs("train", 4, 64)`` (``test_torch_llm_train.numpy_batch``
    at four rows)."""
    from repro_torch.models.vlm import VISION_D
    out = []
    for seed in range(1, n + 1):
        rng = np.random.default_rng(seed)
        text = SEQ - cfg.num_image_tokens if cfg.family == "vlm" else SEQ
        b = {k: rng.integers(0, cfg.vocab, (BATCH, text)).astype(np.int32)
             for k in ("tokens", "labels")}
        if cfg.family == "vlm":
            b["image_emb"] = rng.standard_normal(
                (BATCH, cfg.num_image_tokens, VISION_D)).astype(np.float32)
        elif cfg.family == "audio":
            b["frames"] = rng.standard_normal(
                (BATCH, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _port_batch(b):
    return {k: torch.from_numpy(v).to(torch.int64) if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _numpy(tree):
    return {k: v.detach().numpy() for k, v in _flat(tree)}


# ---------------------------------------------------------------------------
# What a rank runs


def _placements(tree):
    return {k: tuple(v.placements) for k, v in _flat(tree)}


def _run_sharded(case, mesh, ckpt_dir):
    """Two sharded steps of the case: per step (loss, grad norm), the
    params after them (rank 0 only), and each leaf's placements against
    the rules'."""
    cfg = _cfg(case["arch"])
    api = get_model(cfg)
    params = params_from_numpy(case["params"], device="cpu")
    p_specs = tsh.param_shardings(params, cfg, mesh)
    params = tsh.shard_params(params, cfg, mesh)
    opt_init, opt_update = make_optimizer(LR, warmup=1, steps=10)
    opt = opt_init(params)
    grads = []

    def update(g, state, p):
        # Each leaf gathered (a collective: every rank), with the
        # placements the step handed the optimizer.
        grads.append({k: (v.full_tensor().numpy(), tuple(v.placements))
                      for k, v in _flat(g)})
        return opt_update(g, state, p)

    step = make_sharded_train_step(api, update, mesh)
    metrics = []
    for b in case["batches"][:STEPS]:
        params, opt, m = step(params, opt, _port_batch(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    o_specs = tsh.opt_shardings(opt, p_specs, mesh)
    want = {
        "params": tsh._map_paths(lambda _, s: tsh.to_placements(s, mesh),
                                 p_specs),
        "mu": tsh._map_paths(lambda _, s: tsh.to_placements(s, mesh),
                             o_specs.mu),
        "nu": tsh._map_paths(lambda _, s: tsh.to_placements(s, mesh),
                             o_specs.nu)}
    got = {"params": _placements(params), "mu": _placements(opt.mu),
           "nu": _placements(opt.nu)}
    # An unsharded state laid out on the mesh takes the same placements.
    placed = tsh.shard_opt_state(opt_init(params_from_numpy(
        case["params"], device="cpu")), params_from_numpy(
            case["params"], device="cpu"), cfg, mesh)
    got["placed_mu"], want["placed_mu"] = _placements(placed.mu), want["mu"]
    got["placed_nu"], want["placed_nu"] = _placements(placed.nu), want["nu"]
    # A replicated leaf's full_tensor is the live leaf: copy it before
    # the resume case steps on.
    full = {k: v.full_tensor().clone() for k, v in _flat(params)}
    out = {"metrics": metrics,
           "placements": {k: (got[k], dict(_flat(want[k]))) for k in got},
           "step": int(opt.step)}
    if ckpt_dir is not None:
        save(ckpt_dir, STEPS, {"params": params,
                               "opt": {"mu": opt.mu, "nu": opt.nu}})
        # The sharded run goes on from the live state; the restored one
        # (onto the mesh) must equal it.
        like = {"params": params, "opt": {"mu": opt.mu, "nu": opt.nu}}
        back = restore(ckpt_dir, like, device="cpu")
        out["restored_same"] = all(
            a.placements == b.placements and torch.equal(
                a.to_local(), b.to_local())
            for (_, a), (_, b) in zip(_flat(like), _flat(back)))
        params, opt, m = step(params, opt,
                              _port_batch(case["batches"][STEPS]))
        out["resumed"] = (float(m["loss"]), float(m["grad_norm"]))
    if mesh.get_rank() == 0:
        out["params"] = {k: v.numpy() for k, v in full.items()}
        out["grads"] = [{k: a for k, (a, _) in g.items()}
                        for g in grads[:STEPS]]
    out["grad_placements"] = [{k: pl for k, (_, pl) in g.items()}
                              for g in grads[:STEPS]]
    return out


# The train launcher: reduced qwen3-8b in its own bf16, as a user runs it.
LAUNCH = ["--arch", "qwen3_8b", "--reduced", "--device", "cpu", "--steps",
          "3", "--batch", "2", "--seq", "32", "--log-every", "1"]


def _launch(argv):
    """``launch.train.main(argv)``'s printed step lines, or the exception
    it raised as (type name, message)."""
    from repro_torch.launch import train as launch_train
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            launch_train.main(argv)
    except Exception as e:              # the test asserts which
        return type(e).__name__, str(e)
    return [ln for ln in buf.getvalue().splitlines()
            if ln.startswith(("step", "final"))]


def _cache_writes(mesh):
    """A decode step's K/V write (``common._cache_write``) into caches laid
    out by ``cache_shardings`` on ``mesh`` against the same write into
    plain ones: batch 4 (rows on ``"data"``, positions on ``"model"``) and
    batch 1 (positions on both axes), per-row positions (some past the
    end, which land on the last) and a shared one; and a Mamba SSM update.
    Returns whether each gathered result equals the plain one."""
    from repro_torch.models import common as tcm
    gen = torch.Generator().manual_seed(5)
    out = {}
    for batch, pos in ((4, torch.tensor([0, 3, 6, 9])), (1, torch.tensor(5)),
                       (4, torch.tensor(7))):
        cache = {"k": torch.randn(1, batch, 8, 2, 3, generator=gen),
                 "v": torch.randn(1, batch, 8, 2, 3, generator=gen)}
        k, v = (torch.randn(batch, 1, 2, 3, generator=gen) for _ in "kv")
        cfg = _cfg("qwen3_8b")
        laid = tsh.place(cache, tsh.cache_shardings(
            cache, cfg, mesh, batch_size=batch), mesh)
        tcm._cache_write((cache["k"][0], cache["v"][0]), k, v, pos,
                         torch.float32)
        tcm._cache_write((laid["k"][0], laid["v"][0]), k, v, pos,
                         torch.float32)
        out[(batch, tuple(pos.reshape(-1).tolist()))] = all(
            torch.equal(laid[n].full_tensor(), cache[n]) for n in "kv")
    # A Mamba decode step's SSM update on a state laid out as the cache
    # rules lay it (rows on "data", heads on "model").
    from repro_torch.kernels import ref
    from repro_torch.models import mamba2
    b, h, p_, n = 4, 4, 3, 5
    state, xt, bt, ct = (torch.randn(*shape, generator=gen) for shape in
                         ((b, h, p_, n), (b, h, p_), (b, h, n), (b, h, n)))
    dt, a = torch.rand(b, h, generator=gen), -torch.rand(h, generator=gen)
    want = ref.ssd_update_ref(state, xt, dt, a, bt, ct)
    laid = tsh.place({"ssm": state}, {"ssm": ("data", "model")}, mesh)
    got = mamba2._ssd_update_sharded(laid["ssm"], xt, dt, a, bt, ct)
    out["ssm_update"] = all(torch.equal(g.full_tensor(), w)
                            for g, w in zip(got, want))
    return out


def _hidden_fallback(mesh):
    """granite-moe reduced to 2 experts on the 4-way model axis of
    ``mesh``, which the axis does not divide: the experts shard their FFN
    hidden dim.  The sharded loss and gradient against the unsharded ones,
    and the experts' placements."""
    from repro_torch.launch.steps import loss_and_grads
    cfg = _cfg("granite_moe_1b_a400m").with_(n_experts=2)
    api = get_model(cfg)
    plain = api.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _port_batch(_batches(cfg, 1)[0])
    want_loss, want = loss_and_grads(api, plain, batch)
    params = tsh.shard_params(plain, cfg, mesh)
    with tsh.hooked(mesh):
        loss, grads = loss_and_grads(api, params, tsh.shard_batch(batch,
                                                                  mesh))
    grads = dict(_flat(grads))
    err = max(float((grads[k].full_tensor() - w).abs().max()
                    / w.abs().max().clamp_min(1e-30))
              for k, w in _flat(want))
    return {"losses": (float(loss), float(want_loss)), "grad_err": err,
            "w_up": tuple(params["blocks"]["ffn"]["w_up"].placements)}


def _routed_collectives(mesh):
    """qwen3-8b's loss and gradient on ``mesh`` with DTensor's collectives
    on the functional path and routed through the plain calls
    (``launch.mesh.route_gloo_cuda_collectives``, here for CPU tensors):
    the two losses, the largest gradient difference over the leaf's
    largest value, and the collectives each path issued."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch.steps import loss_and_grads
    cfg = _cfg("qwen3_8b")
    api = get_model(cfg)
    params = tsh.shard_params(api.init(torch.Generator().manual_seed(0),
                                       device="cpu"), cfg, mesh)
    batch = tsh.shard_batch(_port_batch(_batches(cfg, 1)[0]), mesh)
    out = []
    for routed in (False, True):
        restore = (tmesh.route_gloo_cuda_collectives(("cpu",)) if routed
                   else (lambda: None))
        try:
            with tsh.hooked(mesh), CommDebugMode() as comm:
                loss, grads = loss_and_grads(api, params, batch)
            grads = {k: g.redistribute(p.device_mesh, p.placements)
                     .full_tensor() for (k, g), (_, p) in
                     zip(_flat(grads), _flat(params))}
        finally:
            restore()
        out.append((float(loss), grads, {str(k).split(".")[0] for k in
                                         comm.get_comm_counts()}))
    (loss0, g0, ops0), (loss1, g1, ops1) = out
    return {"losses": (loss0, loss1), "ops": (ops0, ops1),
            "grad_err": max(float((g0[k] - g1[k]).abs().max()
                                  / g0[k].abs().max().clamp_min(1e-30))
                            for k in g0)}


def _rank_cases(rank, world, cases, ckpt_dir):
    """One rank: every case on its mesh (built collectively, in one
    order); a case that raises returns its traceback for its test."""
    import warnings
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    meshes = {}
    out = {}
    for case in cases:
        shape = case["mesh"]
        if shape not in meshes:
            meshes[shape] = DeviceMesh("cpu", torch.arange(WORLD)
                                       .reshape(shape),
                                       mesh_dim_names=("data", "model"))
        try:
            resume = (case["arch"], shape) == RESUME
            out[case["name"]] = _run_sharded(
                case, meshes[shape], ckpt_dir if resume else None)
        except Exception:
            out[case["name"]] = {"error": traceback.format_exc()}
    out["cache_write"] = _cache_writes(meshes[(2, 2)])
    out["routed"] = _routed_collectives(meshes[(2, 2)])
    out["hidden"] = _hidden_fallback(meshes[(1, 4)])
    # Under a process group the launcher trains on the host mesh (rank 0
    # alone; the other ranks are outside it); the production mesh needs 256.
    out["launch"] = {"host": _launch(LAUNCH),
                     "production": _launch(LAUNCH + ["--production-mesh"])}
    return out


# ---------------------------------------------------------------------------
# This process: the reference's and the port's unsharded steps


def _reference(arch, jparams, batches):
    """The reference's jitted train step, two steps: per step (loss, grad
    norm), and ``jax.grad`` of the first."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as jget_config
    from repro.launch.steps import make_optimizer as jmake_optimizer
    from repro.launch.steps import make_train_step as jmake_train_step
    from repro.models.api import get_model as jget_model
    japi = jget_model(jget_config(arch).reduced().with_(dtype=jnp.float32))
    jinit, jupdate = jmake_optimizer(LR, warmup=1, steps=10)
    jstep = jax.jit(jmake_train_step(japi, jupdate))
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    grads = jax.jit(jax.grad(japi.loss))(jparams, first)
    state, metrics = jinit(jparams), []
    for b in batches[:STEPS]:
        jparams, state, m = jstep(jparams, state,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics,
            "grads": {k: np.asarray(v) for k, v in _flat(grads)}}


def _plain(arch, params, batches):
    """The port's unsharded train step from the same params: per step (loss,
    grad norm), and the first step's gradient."""
    api = get_model(_cfg(arch))
    params = params_from_numpy(params, device="cpu")
    opt_init, opt_update = make_optimizer(LR, warmup=1, steps=10)
    opt = opt_init(params)
    grads = []

    def update(g, state, p):
        grads.append(_numpy(g))
        return opt_update(g, state, p)

    step = make_train_step(api, update)
    metrics = []
    for b in batches[:STEPS]:
        params, opt, m = step(params, opt, _port_batch(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": metrics, "grads": grads[0]}


def _adamw_on(arch, params, grads):
    """The port's unsharded AdamW from ``params`` driven by ``grads``, one
    step per gradient tree (numpy in, numpy out)."""
    params = params_from_numpy(params, device="cpu")
    opt_init, opt_update = make_optimizer(LR, warmup=1, steps=10)
    opt = opt_init(params)
    for g in grads:
        g = params_from_numpy(_nest(g), device="cpu")
        updates, opt = opt_update(g, opt, params)
        params = apply_updates(params, updates)
    return _numpy(params)


def _nest(flat):
    """A '/'-joined flat dict as nested dicts."""
    out = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _init(arch):
    import jax
    from repro.configs.base import get_config as jget_config
    from repro.models.api import get_model as jget_model
    import jax.numpy as jnp
    japi = jget_model(jget_config(arch).reduced().with_(dtype=jnp.float32))
    jp = japi.init(jax.random.PRNGKey(0))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def runs():
    """{case name: {"ranks": [per-rank result], "ref": the reference's
    unsharded run, "plain": the port's, "ckpt": the resume case's
    checkpoint directory}}."""
    inits, cases = {}, []
    for arch, shape in CASES:
        if arch not in inits:
            cfg = _cfg(arch)
            jp, np_params = _init(arch)
            inits[arch] = (jp, np_params, _batches(cfg, STEPS + 1))
        cases.append({"name": f"{arch}-{shape[0]}x{shape[1]}", "arch": arch,
                      "mesh": shape, "params": inits[arch][1],
                      "batches": inits[arch][2]})
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        ckpt = os.path.join(tmp, "ckpt")
        pending = pool.submit(tmesh.spawn, _rank_cases, WORLD, "gloo",
                              cases, ckpt, timeout=600.0)
        refs = {arch: {"ref": _reference(arch, jp, batches),
                       "plain": _plain(arch, np_params, batches)}
                for arch, (jp, np_params, batches) in inits.items()}
        no_group = _launch(LAUNCH)
        ranks = pending.result()
        out = {"launch": {"no_group": no_group,
                          "ranks": [r["launch"] for r in ranks],
                          "cache_writes": [r["cache_write"] for r in ranks],
                          "routed": [r["routed"] for r in ranks],
                          "hidden": [r["hidden"] for r in ranks]}}
        for case in cases:
            entry = out[case["name"]] = dict(
                refs[case["arch"]], case=case,
                ranks=[r[case["name"]] for r in ranks])
            if "grads" in entry["ranks"][0]:
                entry["adamw"] = _adamw_on(case["arch"], case["params"],
                                           entry["ranks"][0]["grads"])
        # The resume case's checkpoint, restored into the unsharded step.
        arch, shape = RESUME
        name = f"{arch}-{shape[0]}x{shape[1]}"
        cfg = _cfg(arch)
        api = get_model(cfg)
        like = api.init(torch.Generator().manual_seed(0), device="cpu")
        like = {"params": like, "opt": {"mu": like, "nu": like}}
        back = restore(ckpt, tree_map(
            lambda t: torch.empty(t.shape, dtype=torch.float32
                                  if t.is_floating_point() else t.dtype,
                                  device="meta"), like), device="cpu")
        opt_init, opt_update = make_optimizer(LR, warmup=1, steps=10)
        opt = OptState(step=torch.tensor(STEPS, dtype=torch.int32),
                       mu=back["opt"]["mu"], nu=back["opt"]["nu"])
        step = make_train_step(api, opt_update)
        _, _, m = step(back["params"], opt,
                       _port_batch(inits[arch][2][STEPS]))
        out[name]["unsharded_resume"] = (float(m["loss"]),
                                         float(m["grad_norm"]))
    return out


# ---------------------------------------------------------------------------
# Assertions


def _ranks(entry):
    for r in entry["ranks"]:
        if "error" in r:
            pytest.fail(r["error"])
    return entry["ranks"]


def _close_leaves(got, want, what, tol, floor=1e-30, arch=None):
    """Every leaf of ``got`` within ``tol`` of ``want``'s largest value (at
    least ``floor``); the same leaves on both sides."""
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        g = np.asarray(got[name], np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name)
        scale = max(float(np.abs(w).max()), floor)
        err = float(np.abs(g - w).max())
        leaf_tol = LEAF_TOL.get((arch, name), tol)
        assert err <= leaf_tol * scale, f"{what} {name}: {err} of {scale}"


@pytest.mark.parametrize("case", CASE_IDS)
@pytest.mark.parametrize("against", ("ref", "plain"))
def test_sharded_step_matches_unsharded(runs, case, against):
    """Loss and gradient norm of both steps, on every rank, and the first
    step's gradient leaves, against the reference's (``ref``) or the
    port's (``plain``) unsharded step."""
    entry = runs[case]
    ranks = _ranks(entry)
    want = entry[against]
    for r in ranks:
        np.testing.assert_allclose(np.array(r["metrics"]),
                                   np.array(want["metrics"]), rtol=TOL)
    _close_leaves(ranks[0]["grads"][0], want["grads"], f"{case} {against}",
                  TOL, arch=entry["case"]["arch"])


@pytest.mark.parametrize("case", CASE_IDS)
def test_sharded_update_is_the_unsharded_adamw(runs, case):
    """The params after two sharded steps against the unsharded AdamW
    driven by the gradients the sharded step handed its optimizer, which
    carried their params' placements (no pending sum)."""
    entry = runs[case]
    ranks = _ranks(entry)
    _close_leaves(ranks[0]["params"], entry["adamw"], case, ADAMW_TOL,
                  floor=1.0)
    for r in ranks:
        want = r["placements"]["params"][1]
        for g in r["grad_placements"]:
            assert g == want


@pytest.mark.parametrize("case", CASE_IDS)
def test_params_and_moments_keep_their_placements(runs, case):
    for r in _ranks(runs[case]):
        assert r["step"] == STEPS
        for what, (got, want) in r["placements"].items():
            assert got == want, what


def test_checkpoint_resumes_into_the_unsharded_step(runs):
    """The resume case saved its params and moments after two steps (each
    leaf gathered, written by rank 0), restored them onto the mesh (equal
    shards, equal placements) and took a third step; the unsharded step
    restored from the same checkpoint takes the same third step."""
    arch, shape = RESUME
    entry = runs[f"{arch}-{shape[0]}x{shape[1]}"]
    for r in _ranks(entry):
        assert r["restored_same"]
        np.testing.assert_allclose(r["resumed"], entry["unsharded_resume"],
                                   rtol=TOL)


def test_launcher_trains_on_the_host_mesh_under_a_group(runs):
    """``launch.train`` under a four-rank group: rank 0 trains on the host
    ``(1, 1)`` mesh and prints the losses the launcher prints without a
    group; the other ranks, outside the mesh, print nothing."""
    want = runs["launch"]["no_group"]
    assert isinstance(want, list) and len(want) == 4, want
    got = [r["host"] for r in runs["launch"]["ranks"]]
    strip = lambda lines: [ln.split("(")[0] for ln in lines]
    assert strip(got[0]) == strip(want)
    assert got[1:] == [[]] * (WORLD - 1)


def test_launcher_production_mesh_needs_256_ranks(runs):
    for r in runs["launch"]["ranks"]:
        kind, message = r["production"]
        assert kind == "RuntimeError"
        assert "needs 256 ranks but only 4 present" in message


def test_sharded_decode_writes_equal_the_plain_ones(runs):
    for r in runs["launch"]["cache_writes"]:
        assert r and all(r.values()), r


def test_routed_collectives_give_the_functional_result(runs):
    """The gloo-on-CUDA routing (here on CPU tensors) issues only the plain
    calls and gives the loss and gradient of the functional path, within
    the f32 order of a reduce-scatter taken as an all-reduce."""
    for r in runs["launch"]["routed"]:
        functional, routed = r["ops"]
        assert functional == {"c10d_functional", "c10d"}
        assert routed == {"c10d"}
        np.testing.assert_allclose(*r["losses"], rtol=TOL)
        assert r["grad_err"] <= TOL


def test_moe_hidden_dim_fallback(runs):
    """Two experts on four model ranks shard the FFN hidden dim (the
    reference's fallback): the loss and every gradient leaf as the
    unsharded ones'."""
    from torch.distributed.tensor import Replicate, Shard
    for r in runs["launch"]["hidden"]:
        assert r["w_up"] == (Replicate(), Shard(3))
        np.testing.assert_allclose(*r["losses"], rtol=TOL)
        assert r["grad_err"] <= TOL
