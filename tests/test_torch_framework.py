"""The port's ICSML framework core against the JAX reference, on the CPU:
every layer of ``core/layers.py``, the §4.2.1 memory plan and the planned
arena, the model's accounting, §6.3 multipart inference and the scan-cycle
runtime, §4.3 porting and the quantization error bound.

The same params go into both packages (JAX init, bridged through numpy with
``repro_torch.bridge``) and the same numpy inputs go through both.  Plans,
segment boundaries, accounting and summaries are integers and text: held
equal.  SINT Dense arithmetic is held bit-exact; REAL layers within 1e-5
relative (convolutions and pooled means sum in another order); shape-only
layers exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import Graph as JGraph, Node as JNode
from repro.core import layers as JL
from repro.core import memory as jmemory
from repro.core import porting as jporting
from repro.core import quantize as jquant
from repro.core import runtime as jruntime
from repro.core.model import Model as JModel
from repro.core import sequential as jsequential
from repro.sim import build_detector as jbuild_detector
from repro_torch.bridge import params_from_numpy
from repro_torch.core import Graph as TGraph, Node as TNode
from repro_torch.core import layers as TL
from repro_torch.core import memory as tmemory
from repro_torch.core import porting as tporting
from repro_torch.core import quantize as tquant
from repro_torch.core import runtime as truntime
from repro_torch.core.model import Model as TModel
from repro_torch.core import sequential as tsequential
from repro_torch.sim import build_detector

from _hyp import given, settings, st

torch.set_num_threads(1)

REAL_TOL = dict(rtol=1e-5, atol=1e-6)


def to_torch(params):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")


def jittered(params, seed, scale=0.1):
    """Nonzero biases and perturbed weights (BatchNorm variances kept
    positive)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        noise = scale * rng.standard_normal(a.shape).astype(np.float32)
        if path[-1].key == "var":
            return jnp.asarray(np.abs(a + noise) + 0.1)
        return jnp.asarray(a + noise)
    return jax.tree_util.tree_map_with_path(leaf, params)


def shared_params(tm, seed, scale=0.1):
    """Jittered params for both packages, drawn by the port's init (the
    reference's eager init compiles a program per conv shape)."""
    tp = tm.init_params(torch.Generator().manual_seed(seed), device="cpu")
    jp = jittered({uid: {k: jnp.asarray(v.numpy()) for k, v in p.items()}
                   for uid, p in tp.items()}, seed, scale)
    return jp, to_torch(jp)


def both(builder, *args):
    """The same graph built from each package's layers."""
    return builder(JL, jsequential, *args), builder(TL, tsequential, *args)


def mobilenet_ish(L, sequential):
    """``benchmarks/multipart_bench.py::mobilenet_ish``, the §6.3 demo."""
    layers = [L.Input(features=(16, 16, 3))]
    ch = 8
    for _ in range(3):
        layers += [
            L.Conv2D(filters=ch, kernel_size=(3, 3), strides=(2, 2)),
            L.BatchNorm(activation="relu"),
            L.DepthwiseConv2D(kernel_size=(3, 3)),
            L.BatchNorm(activation="relu"),
        ]
        ch *= 2
    layers += [L.GlobalAvgPool(), L.Dense(units=10, activation="softmax")]
    return sequential(layers, (16, 16, 3))


def mlp(L, sequential, sizes, in_dim, act="relu"):
    return sequential([L.Input()] + [L.Dense(units=s, activation=act)
                                     for s in sizes], (in_dim,))


def branching(L, G, N, kind):
    """The reference memory tests' branching graphs: a Concat that keeps an
    early producer alive, and an Add residual."""
    join = L.Concat() if kind == "concat" else L.Add()
    return G(nodes=(
        N(uid=0, layer=L.Input(), inputs=()),
        N(uid=1, layer=L.Dense(units=32), inputs=(0,)),
        N(uid=2, layer=L.Dense(units=32), inputs=(1,)),
        N(uid=3, layer=L.Dense(units=32, activation="relu"), inputs=(2,)),
        N(uid=4, layer=join, inputs=(1, 3)),
        N(uid=5, layer=L.Dense(units=8), inputs=(4,)),
    ))


def branch_models(kind):
    return (JModel(graph=branching(JL, JGraph, JNode, kind),
                   input_shape=(16,)),
            TModel(graph=branching(TL, TGraph, TNode, kind),
                   input_shape=(16,)))


def run_layer(jlayer, tlayer, in_shapes, seed=0):
    rng = np.random.default_rng(seed + 1)
    xs = [rng.standard_normal(s).astype(np.float32) for s in in_shapes]
    jp, tp = shared_params(tsequential([tlayer], in_shapes[0]), seed)
    jp, tp = jp[0], tp[0]
    want = np.asarray(jlayer.apply(jp, [jnp.asarray(x) for x in xs]))
    got = tlayer.apply(tp, [torch.from_numpy(x) for x in xs]).numpy()
    assert got.shape == want.shape == tlayer.out_shape(list(in_shapes))
    assert tlayer.out_shape(list(in_shapes)) == jlayer.out_shape(
        list(in_shapes))
    return got, want


# ---------------------------------------------------------------------------
# Layers


@pytest.mark.parametrize("fn", sorted(JL.ACTIVATIONS))
def test_activation_layer(fn):
    got, want = run_layer(JL.Activation(fn=fn), TL.Activation(fn=fn), [(37,)])
    if fn in ("relu", "linear", "binary_step", "leaky_relu"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **REAL_TOL)


@pytest.mark.parametrize("name,make,shapes", [
    ("concat", lambda L: L.Concat(), [(5,), (7,), (3,)]),
    ("concat_axis0", lambda L: L.Concat(axis=0), [(2, 4), (3, 4)]),
    ("add", lambda L: L.Add(), [(6, 5), (6, 5), (6, 5)]),
    ("flatten", lambda L: L.Flatten(), [(4, 3, 2)]),
])
def test_shape_layers_exact(name, make, shapes):
    got, want = run_layer(make(JL), make(TL), shapes)
    np.testing.assert_array_equal(got, want)


def test_concat_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="concat shape mismatch"):
        TL.Concat(axis=0).out_shape([(2, 4), (3, 5)])


@pytest.mark.parametrize("act", ["linear", "relu"])
def test_batchnorm(act):
    got, want = run_layer(JL.BatchNorm(activation=act),
                          TL.BatchNorm(activation=act), [(5, 6, 8)], seed=3)
    np.testing.assert_allclose(got, want, **REAL_TOL)


def test_global_avg_pool():
    got, want = run_layer(JL.GlobalAvgPool(), TL.GlobalAvgPool(),
                          [(7, 5, 12)])
    np.testing.assert_allclose(got, want, **REAL_TOL)


def test_lambda_layer():
    # Each side builds its own Lambda: fn is a function of its package.
    jl = JL.Lambda(fn=lambda a, b: jnp.concatenate([a * b, a]), out=(10,))
    tl = TL.Lambda(fn=lambda a, b: torch.cat([a * b, a]), out=(10,))
    got, want = run_layer(jl, tl, [(5,), (5,)])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="requires fn"):
        TL.Lambda().apply({}, [torch.zeros(3)])


CONV_CASES = [(size, stride, pad) for size in (16, 15, 7)
              for stride in (1, 2) for pad in ("SAME", "VALID")]


@pytest.mark.parametrize("size,stride,pad", CONV_CASES)
def test_conv2d(size, stride, pad):
    jl = JL.Conv2D(filters=6, kernel_size=(3, 3), strides=(stride, stride),
                   padding=pad, activation="relu")
    tl = TL.Conv2D(filters=6, kernel_size=(3, 3), strides=(stride, stride),
                   padding=pad, activation="relu")
    got, want = run_layer(jl, tl, [(size, size, 4)], seed=size + stride)
    np.testing.assert_allclose(got, want, **REAL_TOL)


@pytest.mark.parametrize("size,stride,pad", CONV_CASES)
def test_depthwise_conv2d(size, stride, pad):
    jl = JL.DepthwiseConv2D(kernel_size=(3, 3), strides=(stride, stride),
                            padding=pad)
    tl = TL.DepthwiseConv2D(kernel_size=(3, 3), strides=(stride, stride),
                            padding=pad)
    got, want = run_layer(jl, tl, [(size, size, 5)], seed=size * stride)
    np.testing.assert_allclose(got, want, **REAL_TOL)


def test_conv_layers_take_a_batch():
    # One apply over (B, H, W, C) equals B single-sample applies.
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 9, 9, 4)).astype(np.float32))
    for layer in (TL.Conv2D(filters=5, strides=(2, 2)),
                  TL.DepthwiseConv2D(kernel_size=(5, 3), padding="VALID")):
        p = layer.init_params(torch.Generator().manual_seed(0), [(9, 9, 4)])
        batched = layer.apply(p, [x])
        for i in range(3):
            np.testing.assert_allclose(batched[i], layer.apply(p, [x[i]]),
                                       rtol=1e-6, atol=1e-6)


def test_new_layers_init_params_match_reference_shapes():
    gen = torch.Generator().manual_seed(0)
    shape = (9, 9, 4)
    for make in (lambda L: L.Conv2D(filters=7, kernel_size=(3, 5)),
                 lambda L: L.DepthwiseConv2D(kernel_size=(3, 3)),
                 lambda L: L.BatchNorm()):
        want = jax.eval_shape(lambda k: make(JL).init_params(k, [shape]),
                              jax.random.PRNGKey(0))
        got = make(TL).init_params(gen, [shape])
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    bn = TL.BatchNorm().init_params(gen, [shape])     # identity statistics
    assert all(torch.equal(bn[k], torch.full((4,), float(k in ("gamma",
                                                                "var"))))
               for k in bn)
    w = TL.Conv2D(filters=7, kernel_size=(3, 5)).init_params(gen, [shape])["w"]
    assert float(w.abs().max()) <= (6.0 / (3 * 5 * 4 + 7)) ** 0.5


def test_mobilenet_ish_apply_matches_reference():
    jm, tm = both(mobilenet_ish)
    jp, tp = shared_params(tm, 0)
    x = np.random.default_rng(2).standard_normal((16, 16, 3)).astype(
        np.float32)
    # One compiled program: eager JAX compiles every conv op on its own.
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    got = tm.apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **REAL_TOL)
    planned = tm.apply_planned(tp, torch.from_numpy(x))
    np.testing.assert_allclose(planned.numpy(), want, **REAL_TOL)
    assert torch.equal(planned, got)


# ---------------------------------------------------------------------------
# Accounting


def accounting(model):
    return (model.param_bytes(), model.flops(), model.node_flops(),
            model.node_in_shapes(), model.summary())


@pytest.mark.parametrize("name", ["detector", "mobilenet_ish", "concat",
                                  "add", "mlp"])
def test_accounting_and_summary_equal_reference(name):
    if name == "detector":
        jm, tm = jbuild_detector(), build_detector()
    elif name == "mobilenet_ish":
        jm, tm = both(mobilenet_ish)
    elif name == "mlp":
        jm, tm = both(mlp, (64, 32, 16, 2), 400)
    else:
        jm, tm = branch_models(name)
    assert accounting(tm) == accounting(jm)


# ---------------------------------------------------------------------------
# Memory plan


def plan_fields(plan):
    return plan.arena_size, plan.arena_bytes, {
        uid: (b.uid, b.offset, b.size, tuple(b.shape), tuple(b.live), b.end)
        for uid, b in plan.buffers.items()}


def assert_same_plans(jg, tg, input_shape):
    for reuse in (True, False):
        assert plan_fields(tmemory.plan_memory(tg, input_shape, reuse=reuse)) \
            == plan_fields(jmemory.plan_memory(jg, input_shape, reuse=reuse))
    assert tmemory.activation_bytes(tg, input_shape) == \
        jmemory.activation_bytes(jg, input_shape)


@pytest.mark.parametrize("name", ["concat", "add", "mobilenet_ish",
                                  "deep_chain"])
def test_plan_memory_equals_reference(name):
    if name == "mobilenet_ish":
        jm, tm = both(mobilenet_ish)
    elif name == "deep_chain":
        jm, tm = both(mlp, (256,) * 20, 256)
    else:
        jm, tm = branch_models(name)
    assert_same_plans(jm.graph, tm.graph, jm.input_shape)
    assert plan_fields(tm.memory_plan()) == plan_fields(jm.memory_plan())


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(1, 300), min_size=1, max_size=10),
       st.integers(1, 300))
def test_plan_memory_chain_sweep(sizes, in_dim):
    jm, tm = both(mlp, tuple(sizes), in_dim)
    assert_same_plans(jm.graph, tm.graph, (in_dim,))


def test_plan_validate_rejects_overlap():
    a = tmemory.BufferInfo(uid=0, offset=0, size=128, shape=(4,), live=(0, 2))
    b = tmemory.BufferInfo(uid=1, offset=64, size=128, shape=(4,),
                           live=(1, 1))
    with pytest.raises(ValueError, match="overlap"):
        tmemory.MemoryPlan(arena_size=256, buffers={0: a, 1: b}).validate()
    with pytest.raises(ValueError, match="outside arena"):
        tmemory.MemoryPlan(arena_size=128, buffers={1: b}).validate()


def test_arena_write_zero_fills_and_reads_back():
    info = tmemory.BufferInfo(uid=0, offset=128, size=128, shape=(3, 7),
                              live=(0, 1))
    arena = torch.full((512,), 5.0)
    val = torch.arange(21, dtype=torch.float32).reshape(3, 7)
    out = tmemory.arena_write(arena, info, val)
    assert out is arena
    assert torch.equal(tmemory.arena_read(arena, info), val)
    assert torch.all(arena[128 + 21:256] == 0)       # the padded tail
    assert torch.all(arena[:128] == 5) and torch.all(arena[256:] == 5)
    want = jmemory.arena_write(jnp.full((512,), 5.0), info, jnp.asarray(
        val.numpy()))
    np.testing.assert_array_equal(arena.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Planned execution, segments, multipart


def sint_detector_pair(seed=0):
    jm, tm = jbuild_detector(), build_detector()
    jp = jittered(jm.init_params(jax.random.PRNGKey(seed)), seed, 0.05)
    calib = 2.0 * np.random.default_rng(100 + seed).standard_normal(
        (8, 400)).astype(np.float32)
    jp = jquant.quantize_params(jm, jp, "SINT",
                                calibration=jquant.calibration_samples(
                                    calib, k=8))
    return jm, jp, tm, to_torch(jp)


@pytest.fixture(scope="module")
def sint_detector():
    return sint_detector_pair()


def test_sint_detector_arenas_bit_equal(sint_detector):
    jm, jp, tm, tp = sint_detector
    x = np.random.default_rng(4).standard_normal(400).astype(np.float32)
    jarena, jplan = jm._run_arena(jp, jnp.asarray(x))
    tarena, tplan = tm._run_arena(tp, torch.from_numpy(x))
    assert plan_fields(tplan) == plan_fields(jplan)
    np.testing.assert_array_equal(tarena.numpy(), np.asarray(jarena))
    got = tm.apply_planned(tp, torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.apply_planned(jp, jnp.asarray(x))))
    assert torch.equal(got, tm.apply(tp, torch.from_numpy(x)))
    # apply_segment over the reference's own schedule slices.
    for start, stop in ((0, 2), (0, 4), (0, 6)):
        ja = jm.apply_segment(jp, jnp.zeros((jplan.arena_size,)),
                              jnp.asarray(x), start, stop)
        ta = tm.apply_segment(tp, torch.zeros(tplan.arena_size),
                              torch.from_numpy(x), start, stop)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tm.read_output(tarena).numpy(),
                                  np.asarray(jm.read_output(jarena)))


@pytest.mark.parametrize("name", ["detector", "mobilenet_ish", "mlp8",
                                  "concat"])
def test_segment_boundaries_identical(name):
    if name == "detector":
        jm, tm = jbuild_detector(), build_detector()
    elif name == "mobilenet_ish":
        jm, tm = both(mobilenet_ish)
    elif name == "mlp8":
        jm, tm = both(mlp, (64,) * 8, 32)
    else:
        jm, tm = branch_models(name)
    for n in range(1, 9):
        assert truntime.segment_boundaries(tm, n) == \
            jruntime.segment_boundaries(jm, n)
    clamp = len(tm.graph.nodes) + 3
    assert truntime.segment_boundaries(tm, clamp) == \
        jruntime.segment_boundaries(jm, clamp)
    assert len(truntime.segment_boundaries(tm, clamp)) == len(tm.graph.nodes)


@pytest.mark.parametrize("n_segments", [1, 2, 3, 4, 5, 8])
def test_multipart_equals_single_shot(n_segments, sint_detector):
    jm, jp, tm, tp = sint_detector
    x = np.random.default_rng(n_segments).standard_normal(400).astype(
        np.float32)
    mi = truntime.MultipartInference(tm, tp, n_segments)
    assert mi.device == torch.device("cpu")
    out = mi.run_all(x)
    assert torch.equal(out, tm.apply(tp, torch.from_numpy(x)))
    # The reference's segments are jitted, and XLA may FMA-contract the
    # requantize; its eager planned execution is the bit-reference.
    jmi = jruntime.MultipartInference(jm, jp, n_segments)
    assert mi.bounds == jmi.bounds
    assert mi.segment_flops() == jmi.segment_flops()
    np.testing.assert_array_equal(out.numpy(), np.asarray(jm.apply_planned(
        jp, jnp.asarray(x))))


def test_multipart_conv_model_equals_single_shot():
    jm, tm = both(mobilenet_ish)
    _, tp = shared_params(tm, 1)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (16, 16, 3)).astype(np.float32))
    single = tm.apply(tp, x)
    for n in (1, 2, 4, 8):
        mi = truntime.MultipartInference(tm, tp, n)
        assert mi.n_segments == n
        assert torch.equal(mi.run_all(x), single)


def test_multipart_step_api_and_errors():
    tm = tsequential([TL.Input()] + [TL.Dense(units=s, activation="relu")
                                     for s in (64, 64, 64, 10)], (32,))
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    mi = truntime.MultipartInference(tm, tp, 3)
    state = mi.start(torch.ones(32))
    with pytest.raises(RuntimeError, match="not complete"):
        mi.output(state)
    steps = 0
    while not state.finished(mi.n_segments):
        state = mi.step(state)
        steps += 1
    assert steps == mi.n_segments == 3
    assert mi.output(state).shape == (10,)
    with pytest.raises(RuntimeError, match="already complete"):
        mi.step(state)


def test_new_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = tsequential([TL.Input(), TL.Dense(units=4)], (8,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        truntime.MultipartInference(tm, {0: {}, 1: {}}, 1)
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    tporting.export_weights(tporting.extract_mlp_weights(tp, tm),
                            str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tporting.load_mlp_params(tm, str(tmp_path))
    assert tporting.load_mlp_params(tm, str(tmp_path), device="cpu")[1][
        "w"].device.type == "cpu"


# ---------------------------------------------------------------------------
# Scan-cycle runtime


def control(reading, state):
    total = 0.0 if state is None else state
    total += float(reading.sum())
    return np.array([total * 0.5], np.float32), total


@pytest.mark.parametrize("n_segments", [1, 2, 3])
def test_scan_cycle_runtime_matches_reference(n_segments):
    sizes, in_dim = (16, 8, 2), 20
    jm, tm = both(mlp, sizes, in_dim)
    jp = jittered(jm.init_params(jax.random.PRNGKey(n_segments)), n_segments,
                  0.05)
    rng = np.random.default_rng(n_segments)
    stream = [rng.standard_normal(2).astype(np.float32) for _ in range(60)]
    jlog = jruntime.ScanCycleRuntime(control, jruntime.SlidingWindowDetector(
        jm, jp, window=10, n_features=2, n_segments=n_segments)).run(stream)
    tlog = truntime.ScanCycleRuntime(control, truntime.SlidingWindowDetector(
        tm, to_torch(jp), window=10, n_features=2,
        n_segments=n_segments)).run(stream)
    assert tlog.detections == jlog.detections
    assert 0 < len(tlog.detections) < len(tlog.inference_latency_cycles)
    assert tlog.inference_latency_cycles == jlog.inference_latency_cycles
    assert set(tlog.inference_latency_cycles) == {n_segments}
    assert len(tlog.cycle_times_s) == 60
    np.testing.assert_array_equal(np.asarray(tlog.control_outputs),
                                  np.asarray(jlog.control_outputs))
    summary = tlog.summary()
    assert summary["cycles"] == 60
    assert summary["n_inferences"] == len(jlog.inference_latency_cycles)


# ---------------------------------------------------------------------------
# §4.3 porting


def test_arrbin_bytes_equal_reference(tmp_path):
    rng = np.random.default_rng(0)
    for i, arr in enumerate((rng.standard_normal((13, 7)).astype(np.float32),
                             np.arange(-8, 8, dtype=np.int8))):
        a, b = str(tmp_path / f"a{i}.bin"), str(tmp_path / f"b{i}.bin")
        assert tporting.arrbin(a, torch.from_numpy(arr)) == \
            jporting.arrbin(b, arr) == arr.nbytes
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        np.testing.assert_array_equal(
            tporting.binarr(a, arr.dtype, arr.shape), arr)
    with pytest.raises(ValueError, match="expected"):
        tporting.binarr(a, np.int8, (17,))


def test_weight_directories_cross_packages(tmp_path):
    jm, tm = both(mlp, (64, 32, 2), 400)
    jp = jittered(jm.init_params(jax.random.PRNGKey(3)), 3)
    tp = to_torch(jp)
    jdir, tdir = tmp_path / "ref", tmp_path / "port"
    jpaths = jporting.export_weights(jporting.extract_mlp_weights(jp, jm),
                                     str(jdir))
    tpaths = tporting.export_weights(tporting.extract_mlp_weights(tp, tm),
                                     str(tdir))
    assert [os.path.basename(p) for p in tpaths] == \
        [os.path.basename(p) for p in jpaths]
    for a, b in zip(tpaths, jpaths):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    # A directory written by the reference loads into the port, and back.
    loaded = tporting.load_mlp_params(tm, str(jdir), device="cpu")
    back = jporting.load_mlp_params(jm, str(tdir))
    for uid in jp:
        for k in jp[uid]:
            np.testing.assert_array_equal(loaded[uid][k].numpy(),
                                          np.asarray(jp[uid][k]))
            np.testing.assert_array_equal(np.asarray(back[uid][k]),
                                          np.asarray(jp[uid][k]))


def test_port_mlp_bit_identical(tmp_path):
    jm, tm = both(mlp, (64, 32, 2), 400)
    tp = to_torch(jittered(jm.init_params(jax.random.PRNGKey(9)), 9))
    ported, ported_params = tporting.port_mlp(tm, tp, str(tmp_path))
    assert ported_params[1]["w"].device.type == "cpu"
    assert [type(n.layer) for n in ported.graph.nodes] == \
        [type(n.layer) for n in tm.graph.nodes]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 400)).astype(np.float32))
    assert torch.equal(ported.apply(ported_params, x), tm.apply(tp, x))
    m = tporting.build_mlp([64, 32, 2], 400, ["relu", "relu", "linear"])
    assert m.graph.infer_shapes((400,))[m.graph.output_uid] == (2,)
    with pytest.raises(ValueError, match="one activation per layer"):
        tporting.build_mlp([4, 2], 8, ["relu"])


# ---------------------------------------------------------------------------
# §6.1 error bound


def test_quantization_error_bound():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((40, 9)).astype(np.float32)
    jq = jquant.quantize_tensor(jnp.asarray(w), "SINT")
    tq = tquant.quantize_tensor(torch.from_numpy(w), "SINT")
    bound = tquant.quantization_error_bound(tq.scale)
    np.testing.assert_array_equal(
        bound.numpy(), np.asarray(jquant.quantization_error_bound(jq.scale)))
    err = torch.abs(torch.from_numpy(w) - tq.dequantize())
    assert torch.all(err <= bound * (1 + 1e-6))
