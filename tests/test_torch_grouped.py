"""The port's grouped fleet against the JAX package, on the CPU: the heads'
in-kernel epilogue specs, the grouped packing (``ops.build_grouped_plan``,
``grouped_fuse_reason``), the grouped kernel's plain version
(``ref.grouped_mlp_ref``), ``ops.grouped_apply`` and ``GroupedStreamEngine``.

Params are shared through ``repro_torch.bridge`` and inputs are made with
numpy from a seed.  The fleet is ``test_grouped.mixed_groups``: classifier,
reconstruction, margin and forecast groups over a 4-reading window of 2
features.  Tolerances, with their reasons:

* SINT logits are bit-exact between the eager plain versions (integer
  dots, two separately rounded ops per requantize).  A score lane is a mean,
  which XLA takes as a sum times 1/n and torch as a sum divided by n (equal
  only when n is a power of two), and a softmax runs each library's exp:
  those lanes are held to 1e-6 relative.
* The reference's Pallas kernel (interpret mode) and its engine step are
  jitted, and XLA contracts the requantize mul+add into an FMA and sums
  means in another order: 1e-6 against the kernel, ``OUT_TOL`` against the
  engine (``test_torch_serving``); verdict labels match exactly.
* REAL/INT/DINT use ``test_torch_core.TOL``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import layers as JL
from repro.core import quantize as jquant
from repro.core import sequential as jsequential
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import GroupedStreamEngine as JGroupedStreamEngine
from repro.serving import ModelGroup as JModelGroup
from repro.serving.core import AdaptConfig as JAdaptConfig
from repro.sim import (build_autoencoder, build_detector, build_forecaster,
                       build_margin_model, fleet_readings)
from repro.sim import heads as jheads
from repro_torch.core import layers as TL
from repro_torch.core import sequential as tsequential
from repro_torch.kernels import fused_mlp, ops, ref
from repro_torch.serving import (AdaptConfig, GroupedStreamEngine,
                                 ModelGroup)
from repro_torch.sim import heads
from test_grouped import mixed_groups
from test_torch_core import TOL, jitter, to_torch
from test_torch_serving import assert_parity, serve, verdict_key

torch.set_num_threads(1)

SCHEMES = ("REAL", "SINT", "INT", "DINT")
NO_NORM = dict(norm_mean=(0.0, 0.0), norm_std=(1.0, 1.0))
KINDS = (0, 1, 1, 1)        # mixed_groups: classifier, then three score heads


def port_model(jmodel):
    """The port's model with the reference model's graph (same uids)."""
    layers = []
    for node in jmodel.graph.nodes:
        layer = node.layer
        layers.append(TL.Dense(units=layer.units, activation=layer.activation,
                               use_bias=layer.use_bias)
                      if isinstance(layer, JL.Dense) else TL.Input())
    return tsequential(layers, jmodel.input_shape)


def port_head(jhead):
    cls = getattr(heads, type(jhead).__name__)
    return cls(**{f.name: getattr(jhead, f.name)
                  for f in dataclasses.fields(jhead) if f.init})


def port_groups(jgroups, **adapt):
    """The port's ModelGroups for reference ones (``adapt`` by name)."""
    return [ModelGroup(g.name, port_model(g.model), to_torch(g.params),
                       g.n_streams, port_head(g.head), g.fused,
                       adapt.get(g.name)) for g in jgroups]


def jstacks(jgroups):
    return [jops.dense_stack(g.model, g.params) for g in jgroups]


def tstacks(stacks):
    return [[(to_torch({0: p})[0], act) for p, act in stack]
            for stack in stacks]


def softmax_stack(scheme, seed=7):
    """A 3-layer classifier with a final softmax over the fleet's 8-wide
    window: deeper than mixed_groups (so the others skip a position) and the
    one place a softmax fuses."""
    jm = jsequential([JL.Input(), JL.Dense(units=5, activation="tanh"),
                      JL.Dense(units=4, activation="relu"),
                      JL.Dense(units=3, activation="softmax")], (8,))
    p = jitter(jm.init_params(jax.random.PRNGKey(seed)), seed)
    if scheme != "REAL":
        calib = 2.0 * np.random.default_rng(seed).standard_normal(
            (4, 8)).astype(np.float32)
        p = jquant.quantize_params(
            jm, p, scheme, calibration=jquant.calibration_samples(calib, k=4))
    return jops.dense_stack(jm, p)


def fleet(scheme, softmax):
    stacks = jstacks(mixed_groups(scheme))
    kinds = list(KINDS)
    if softmax:
        stacks.append(softmax_stack(scheme))
        kinds.append(0)
    return stacks, kinds


def operands(plan, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((plan.n_groups, m, plan.k0)).astype(np.float32)
    tgt = rng.standard_normal((plan.n_groups, m, plan.n_out)) \
        .astype(np.float32)
    return x, tgt


# ---------------------------------------------------------------------------
# (a) heads and (b) packing


def test_kernel_epilogue_specs_match_reference():
    jgroups = mixed_groups("REAL")
    got = [port_head(g.head).kernel_epilogue() for g in jgroups]
    assert got == [g.head.kernel_epilogue() for g in jgroups] == [
        ("logits", "none"), ("mse", "window"), ("mse", "center"),
        ("mse", "tail")]
    assert heads.DetectorHead().kernel_epilogue() is None
    # The margin center is uploaded once per device and reused.
    mg = port_head(jgroups[2].head)
    assert mg._center(torch.device("cpu")) is mg._center(torch.device("cpu"))
    np.testing.assert_array_equal(mg._center().numpy(),
                                  np.asarray(jgroups[2].head._center()))


def test_grouped_act_ids_pin_the_kernel_enum():
    # csrc/grouped_mlp.cu's `enum GroupedAct` is this table, which is the
    # reference's (sorted names), not slice 1's fused ACT_IDS.
    assert fused_mlp.GROUPED_ACT_IDS == {
        "binary_step": 0, "elu": 1, "leaky_relu": 2, "linear": 3, "relu": 4,
        "sigmoid": 5, "softmax": 6, "swish": 7, "tanh": 8}
    from repro.kernels import fused_mlp as jfused
    assert fused_mlp.GROUPED_ACT_IDS == jfused.GROUPED_ACT_IDS
    assert (fused_mlp.GROUPED_KIND_LOGITS, fused_mlp.GROUPED_KIND_SCORE) == \
        (jfused.GROUPED_KIND_LOGITS, jfused.GROUPED_KIND_SCORE) == (0, 1)


@pytest.mark.parametrize("softmax", (False, True))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_build_grouped_plan_matches_reference(scheme, softmax):
    stacks, kinds = fleet(scheme, softmax)
    jplan, jarrays = jops.build_grouped_plan(stacks, kinds, k0=8)
    plan, arrays = ops.build_grouped_plan(tstacks(stacks), kinds, k0=8)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    assert hash(plan) == hash(ops.build_grouped_plan(
        tstacks(stacks), kinds, k0=8)[0])
    for key in ("w", "scale", "bias", "x_scale"):
        assert len(arrays[key]) == len(jarrays[key]) == plan.n_layers
        for got, want in zip(arrays[key], jarrays[key]):
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(arrays["meta"].numpy(),
                                  np.asarray(jarrays["meta"]))
    if softmax:
        # The 2-layer groups skip the last position, where the union keeps
        # the finished autoencoder's 8 lanes.
        assert plan.skips[0] == (0, 0, 1) and plan.skips[4] == (0, 0, 0)
        assert plan.widths == ((8, 6), (6, 8), (8, 8))


# ---------------------------------------------------------------------------
# (c) the packing gate


def test_grouped_fuse_reason():
    stacks = jstacks(mixed_groups("SINT"))
    assert ops.grouped_fuse_reason(tstacks(stacks)) is None
    assert "narrower" in ops.grouped_fuse_reason(tstacks(stacks), k0=6)
    with pytest.raises(ValueError, match="GROUPED_KIND"):
        ops.build_grouped_plan(tstacks(stacks), KINDS[:3])
    # Mixed weight dtypes at a position cannot share one kernel mode.
    mixed = tstacks(stacks[:2] + jstacks(mixed_groups("REAL"))[2:])
    reason = ops.grouped_fuse_reason(mixed, names=["clf", "ae", "mg", "fc"])
    assert "layer position 0 mixes weight dtypes ['float32', 'int8']" in reason
    assert jops.grouped_fuse_reason(stacks[:2] + jstacks(
        mixed_groups("REAL"))[2:]) is not None
    # A final softmax packs; a hidden one does not.
    assert ops.grouped_fuse_reason(tstacks([softmax_stack("REAL")])) is None
    jm = jsequential([JL.Input(), JL.Dense(units=4, activation="softmax"),
                      JL.Dense(units=2, activation="linear")], (8,))
    hidden = jops.dense_stack(jm, jm.init_params(jax.random.PRNGKey(0)))
    assert "layer 0 activation 'softmax' is not element-wise" in \
        ops.grouped_fuse_reason(tstacks([hidden]))
    # A union tile over Hopper's shared-memory bill: 2 tiles x 8 rows x
    # 4096 f32 lanes = 262,144 B > 232,448 B; the message names the slabs.
    jm = jsequential([JL.Input(), JL.Dense(units=4096, activation="relu"),
                      JL.Dense(units=2, activation="linear")], (8,))
    wide = jops.dense_stack(jm, jm.init_params(jax.random.PRNGKey(0)))
    reason = ops.grouped_fuse_reason(tstacks([jstacks(mixed_groups("REAL"))[0],
                                              wide]),
                                     names=["clf", "wide"])
    assert "262144 bytes" in reason and "232448 bytes" in reason
    assert "widest slab 'wide'" in reason and "clf=" in reason
    # The four §7 bodies at full width pack in every scheme: their widest
    # union width is the autoencoder's 400 lanes (25,600 B).
    for scheme in SCHEMES:
        assert ops.grouped_fuse_reason(tstacks(
            [jops.dense_stack(m, p) for m, p in section7(scheme, False)]),
            k0=400) is None
    assert fused_mlp.grouped_smem_bytes(400, [64, 32, 64, 400]) == 25600


@pytest.mark.parametrize("softmax", (False, True))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_kernel_meta_true_widths_and_kmajor_arenas(scheme, softmax):
    """The kernel's meta table is the reference's followed by each group's
    true (k, n) per position (the group's n_out on a skip slot), read
    against the arenas they came from; on the int8 path the plan-time
    K-major copy of each arena holds every slab transposed exactly, zero in
    every pad (past a group's true widths, and to the MMA granules)."""
    stacks, kinds = fleet(scheme, softmax)
    plan, arrays = ops.build_grouped_plan(tstacks(stacks), kinds, k0=8)
    n_layers = plan.n_layers
    meta = arrays["kernel_meta"]
    assert meta.dtype == torch.int32
    assert meta.shape == (plan.n_groups, 2 + 4 * n_layers)
    assert torch.equal(meta[:, :2 + 2 * n_layers], arrays["meta"])
    prepared = ops.prepare_grouped(plan, arrays)
    want = fused_mlp.INT8_MMA if scheme == "SINT" else fused_mlp.F32_TILE
    assert fused_mlp.path(prepared) == prepared.path == want
    assert torch.equal(prepared.meta, meta)
    for g, stack in enumerate(arrays["stacks"]):
        for l in range(n_layers):
            k = int(meta[g, 2 + 2 * n_layers + l])
            n = int(meta[g, 2 + 3 * n_layers + l])
            slab = arrays["w"][l][g]
            if l < len(stack):
                w = stack[l]["qw"] if "qw" in stack[l] else stack[l]["w"]
                assert (k, n) == tuple(w.shape)
                assert torch.equal(slab[:k, :n], w.to(slab.dtype))
            else:
                assert k == n == plan.n_outs[g] and plan.skips[g][l] == 1
                k = n = 0
            assert not slab[k:].any() and not slab[:, n:].any()
            wt = prepared.wt[l]
            if want == fused_mlp.F32_TILE:
                assert wt is None
                continue
            ku, nu = plan.widths[l]
            assert wt.shape == (plan.n_groups, -(-nu // 8) * 8,
                                -(-ku // 32) * 32)
            assert torch.equal(wt[g, :nu, :ku], slab.T)
            assert not wt[g, n:].any() and not wt[g, :, k:].any()


# ---------------------------------------------------------------------------
# (d) the plain version and (e) grouped_apply


@pytest.mark.parametrize("softmax", (False, True))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_grouped_mlp_ref_matches_reference(scheme, softmax):
    stacks, kinds = fleet(scheme, softmax)
    plan, arrays = ops.build_grouped_plan(tstacks(stacks), kinds, k0=8)
    x, tgt = operands(plan, 23, seed=1)
    kw = dict(kinds=plan.kinds, true_k0s=plan.true_k0s, n_outs=plan.n_outs,
              n_pay=plan.payload_width)
    want = np.asarray(jref.grouped_mlp_ref(
        jnp.asarray(x), [list(zip(
            [{k: jnp.asarray(v) for k, v in p.items()} for p, _ in stack],
            plan.acts[g])) for g, stack in enumerate(stacks)],
        tgt=jnp.asarray(tgt), **kw))
    got = ref.grouped_mlp_ref(
        torch.from_numpy(x), [list(zip(arrays["stacks"][g], plan.acts[g]))
                              for g in range(plan.n_groups)],
        tgt=torch.from_numpy(tgt), **kw).numpy()
    assert got.shape == want.shape == (plan.n_groups, 23, plan.payload_width)
    assert_lanes(scheme, plan, got, want)
    # grouped_apply's plain branches (batched for all-int8 fleets) are the
    # same numbers, up to the masked softmax's own exp and division.
    got_apply = ops.grouped_apply(torch.from_numpy(x), plan, arrays,
                                  torch.from_numpy(tgt)).numpy()
    assert_lanes(scheme, plan, got_apply, got)


def assert_lanes(scheme, plan, got, want):
    """SINT logits bit-equal, SINT score and softmax lanes to 1e-6 relative,
    the other schemes to their TOL (module docstring)."""
    for g in range(plan.n_groups):
        exact = plan.kinds[g] == 0 and plan.acts[g][-1] != "softmax"
        if scheme == "SINT" and exact:
            np.testing.assert_array_equal(got[g], want[g])
        elif scheme == "SINT":
            np.testing.assert_allclose(got[g], want[g], rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_allclose(got[g], want[g], **TOL[scheme])


@pytest.mark.parametrize("softmax", (False, True))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_grouped_apply_matches_pallas_kernel_interpreted(scheme, softmax):
    stacks, kinds = fleet(scheme, softmax)
    jplan, jarrays = jops.build_grouped_plan(stacks, kinds, k0=8)
    plan, arrays = ops.build_grouped_plan(tstacks(stacks), kinds, k0=8)
    x, tgt = operands(plan, 37, seed=2)
    want = np.asarray(jops.grouped_apply(jnp.asarray(x), jplan, jarrays,
                                         jnp.asarray(tgt), backend="pallas"))
    got = ops.grouped_apply(torch.from_numpy(x), plan, arrays,
                            torch.from_numpy(tgt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_kernel_backend_raises_on_cpu_tensors():
    stacks, kinds = fleet("SINT", softmax=False)
    plan, arrays = ops.build_grouped_plan(tstacks(stacks), kinds, k0=8)
    x, tgt = (torch.from_numpy(a) for a in operands(plan, 4, seed=3))
    with pytest.raises(ValueError, match="no CPU mode"):
        ops.grouped_apply(x, plan, arrays, tgt, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.grouped_fused_mlp(x, ops.prepare_grouped(plan, arrays), tgt)
    torch.testing.assert_close(
        ops.grouped_apply(x, plan, arrays, tgt, backend="ref"),
        ops.grouped_apply(x, plan, arrays, tgt), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (f)-(h) the engine against the reference engine


def reference_verdicts(jgroups, readings, **kw):
    engine = JGroupedStreamEngine(jgroups, n_features=2, stride=3,
                                  shard=False, **NO_NORM, **kw)
    return engine, serve(engine, readings)


# 30 cycles at stride 3 over a 4-reading window: 9 verdict steps, and the
# ring write position wraps 7 times.
N_CYCLES = 30


def readings_for(n_streams, seed=0):
    return np.random.default_rng(seed).normal(
        size=(N_CYCLES, n_streams, 2)).astype(np.float32)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_engine_matches_reference_engine(scheme):
    jgroups = mixed_groups(scheme)
    readings = readings_for(8)
    jengine, want = reference_verdicts(jgroups, readings)
    engine = GroupedStreamEngine(port_groups(jgroups), n_features=2,
                                 stride=3, device="cpu", **NO_NORM)
    assert engine.mega_reason is None and jengine.mega_reason is None
    got = serve(engine, readings)
    assert_parity(got, want)
    assert engine.stats.steps == 9
    assert engine.stats.dispatches == engine.stats.steps      # (h)
    assert engine.group_windows() == jengine.group_windows() == {
        "clf": 18, "ae": 18, "mg": 18, "fc": 18}
    assert engine.groups == jengine.groups
    assert engine.live_thresholds() == jengine.live_thresholds()
    for name in ("clf", "ae", "mg", "fc"):
        np.testing.assert_allclose(engine.last_outputs[name],
                                   jengine.last_outputs[name], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("variant", ("adaptive", "async", "per_group"))
def test_engine_variants_match_reference_engine(variant):
    """One adaptive score group; ``async_depth=1`` (one boundary late,
    drained by flush); and ``megakernel=False``: each against the reference
    engine's synchronous megakernel run (mega and per-group steps run the
    same arithmetic)."""
    jgroups = mixed_groups("SINT")
    adapt = {}
    if variant == "adaptive":
        jgroups[1] = dataclasses.replace(
            jgroups[1], head=jheads.ReconstructionHead(threshold=0.25,
                                                       target_fpr=0.2),
            adapt=JAdaptConfig(min_count=4))
        adapt = {"ae": AdaptConfig(min_count=4)}
    readings = readings_for(8, seed=1)
    jengine, want = reference_verdicts(jgroups, readings)
    kw = dict(n_features=2, stride=3, device="cpu", **NO_NORM)
    if variant == "async":
        kw["async_depth"] = 1
    if variant == "per_group":
        kw["megakernel"] = False
    engine = GroupedStreamEngine(port_groups(jgroups, **adapt), **kw)
    got = serve(engine, readings, flush=True)
    assert_parity(got, want)
    steps = engine.stats.steps
    assert engine.stats.dispatches == (4 * steps if variant == "per_group"
                                       else steps)                 # (h)
    if variant == "adaptive":
        live = engine.live_thresholds()["ae"]
        assert live != 0.25
        np.testing.assert_allclose(live, jengine.live_thresholds()["ae"],
                                   rtol=1e-5, atol=1e-6)


def test_async_and_per_group_paths_agree_with_mega():
    groups = port_groups(mixed_groups("SINT"))
    readings = readings_for(8, seed=4)
    kw = dict(n_features=2, stride=3, device="cpu", **NO_NORM)
    runs = {}
    for name, extra in (("mega", {}), ("async", {"async_depth": 1}),
                        ("per_group", {"megakernel": False})):
        engine = GroupedStreamEngine(groups, **kw, **extra)
        runs[name] = ([verdict_key(v) for v in serve(engine, readings,
                                                     flush=True)],
                      engine.last_outputs)
    assert runs["async"][0] == runs["mega"][0]
    for name in ("clf", "ae", "mg", "fc"):
        np.testing.assert_array_equal(runs["async"][1][name],
                                      runs["mega"][1][name])
    # The per-group step's scores are torch.mean over the same values.
    assert [k[:4] for k in runs["per_group"][0]] == \
        [k[:4] for k in runs["mega"][0]]
    for name in ("clf", "ae", "mg", "fc"):
        np.testing.assert_allclose(runs["per_group"][1][name],
                                   runs["mega"][1][name], rtol=1e-6,
                                   atol=0)


def test_mega_reason_and_knob():
    groups = port_groups(mixed_groups("SINT"))
    kw = dict(n_features=2, stride=3, device="cpu", **NO_NORM)
    single = GroupedStreamEngine(groups[:1], **kw)
    assert "single unit" in single.mega_reason
    pinned = GroupedStreamEngine(
        [dataclasses.replace(groups[0], fused=False)] + groups[1:], **kw)
    assert "group 'clf': fused=False pins the per-layer path" == \
        pinned.mega_reason
    mixed = port_groups(mixed_groups("SINT")[:2] + mixed_groups("REAL")[2:])
    engine = GroupedStreamEngine(mixed, **kw)
    assert "mixes weight dtypes" in engine.mega_reason
    with pytest.raises(ValueError, match="megakernel=True .* mixes weight"):
        GroupedStreamEngine(mixed, megakernel=True, **kw)
    # The unpackable fleet serves per group, one fused step per group.
    readings = readings_for(8, seed=2)
    serve(engine, readings)
    assert engine.stats.dispatches == 4 * engine.stats.steps
    # A mesh needs a process group, world size 1 included.
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        GroupedStreamEngine(groups, shard=True, **kw)
    with pytest.raises(ValueError, match="needs a 'data' axis"):
        GroupedStreamEngine(groups, mesh=object(), **kw)
    with pytest.raises(ValueError, match="duplicate"):
        GroupedStreamEngine(groups[:1] * 2, **kw)


def test_unequal_windows_serve_per_group_at_their_own_boundaries():
    """Groups whose windows differ fire on their own cadences: those
    boundaries serve per group, and the verdicts match the reference."""
    jgroups = mixed_groups("REAL")[:2]
    wide = jsequential([JL.Input(), JL.Dense(units=6, activation="relu"),
                        JL.Dense(units=10, activation="linear")], (10,))
    jgroups.append(JModelGroup("w5", wide, wide.init_params(
        jax.random.PRNGKey(9)), 2, jheads.ReconstructionHead(threshold=0.5)))
    readings = readings_for(6, seed=5)
    _, want = reference_verdicts(jgroups, readings)
    engine = GroupedStreamEngine(port_groups(jgroups), n_features=2,
                                 stride=3, device="cpu", **NO_NORM)
    assert engine.mega_reason is None
    got = serve(engine, readings)
    assert_parity(got, want)
    # clf + ae stack at every boundary (one launch), w5 fires alone.
    assert engine.stats.dispatches == engine.stats.steps
    assert {v.cycle for v in got if v.group == "w5"} == set(range(4, 30, 3))


# ---------------------------------------------------------------------------
# (i) the slice as a whole, at the §7 detector's full widths


@functools.lru_cache(maxsize=None)
def section7(scheme, calibrated=True):
    """(model, params) of the four §7 bodies: classifier, autoencoder,
    margin trunk, forecaster.  Cached: callers only read them."""
    out = []
    for i, build in enumerate((build_detector, build_autoencoder,
                               build_margin_model, build_forecaster)):
        jm = build()
        p = jitter(jm.init_params(jax.random.PRNGKey(i)), i)
        if scheme != "REAL":
            calib = 2.0 * np.random.default_rng(i).standard_normal(
                (4, jm.input_shape[0])).astype(np.float32)
            p = jquant.quantize_params(
                jm, p, scheme, calibration=jquant.calibration_samples(
                    calib, k=4) if calibrated else None)
        out.append((jm, p))
    return tuple(out)


def test_full_width_four_head_fleet_matches_reference_engine():
    """2 plants per group, 210 cycles: the 200-reading windows fill, then
    two verdict steps (cycles 199 and 209) through the mega path."""
    bodies = section7("SINT")
    center = tuple(float(c) for c in np.random.default_rng(3).normal(
        size=16).astype(np.float32))
    jheads_ = (jheads.ClassifierHead(),
               jheads.ReconstructionHead(threshold=1.0),
               jheads.MarginHead(threshold=1.0, center=center),
               jheads.ForecastHead(threshold=0.1))
    jgroups = [JModelGroup(name, m, p, 2, h) for name, (m, p), h in zip(
        ("clf", "ae", "mg", "fc"), bodies, jheads_)]
    readings = fleet_readings(8, 210, seed=2)
    jengine = JGroupedStreamEngine(jgroups, shard=False)
    want = serve(jengine, readings)
    engine = GroupedStreamEngine(port_groups(jgroups), device="cpu")
    assert engine.mega_reason is None
    got = serve(engine, readings)
    assert len(got) == 16 and engine.stats.dispatches == 2
    assert_parity(got, want)
    for name in ("clf", "ae", "mg", "fc"):
        np.testing.assert_allclose(engine.last_outputs[name],
                                   jengine.last_outputs[name], rtol=1e-5,
                                   atol=1e-6)
