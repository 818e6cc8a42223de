"""The PyTorch port's core and plain kernel versions against the JAX
reference, on the CPU.

The same params go into both packages (JAX init and §6.1 quantization,
bridged through numpy with ``repro_torch.bridge``) and the same numpy inputs
go through both.  SINT is held bit-exact (integer accumulation, two
separately rounded f32 ops per requantize); float paths within a stated
tolerance.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.codegen.verify import numpy_mlp_ref
from repro.core import layers as JL
from repro.core import quantize as jquant
from repro.core import sequential as jsequential
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sim import build_autoencoder as jbuild_autoencoder
from repro.sim import build_detector as jbuild_detector
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.core import layers as TL
from repro_torch.core import quantize as tquant
from repro_torch.core import sequential as tsequential
from repro_torch.kernels import fused_mlp, ops, qmatmul
from repro_torch.sim import build_autoencoder, build_detector

torch.set_num_threads(1)

SCHEMES = ("REAL", "SINT", "INT", "DINT")

# Tolerances for the paths that are not bit-exact, with their reasons:
# * REAL: f32 dots are summed in another order by XLA and by torch's CPU GEMM.
# * INT: products of 16-bit codes pass 2**24, so the emulated f32 dot rounds
#   in a library-dependent order, and a last-bit difference ahead of a
#   requantize can move one activation code by one step (1/32767 of its
#   calibrated range), which the next layer's weights carry to the output —
#   measured at ~7e-5 here and ~1.5e-4 between the card's kernel and cuBLAS.
# * DINT: the same f32 emulation; its steps are 2**-31 of the range, so only
#   the summation order shows.
TOL = {"REAL": dict(rtol=1e-5, atol=1e-5),
       "INT": dict(rtol=1e-3, atol=1e-3),
       "DINT": dict(rtol=1e-5, atol=1e-5)}

BUILDERS = {"detector": (jbuild_detector, build_detector),
            "autoencoder": (jbuild_autoencoder, build_autoencoder)}


def to_torch(params, device="cpu"):
    """A JAX param tree as a port param tree (through numpy)."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             device=device)


def jitter(params, seed):
    """Nonzero biases and perturbed weights, so every requantize has a bias
    add for an FMA contraction to shift."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32)), params)


def quantized(jmodel, params, scheme, k0, seed):
    if scheme == "REAL":
        return params
    calib = 2.0 * np.random.default_rng(100 + seed).standard_normal(
        (4, k0)).astype(np.float32)
    return jquant.quantize_params(
        jmodel, params, scheme,
        calibration=jquant.calibration_samples(calib, k=4))


@functools.lru_cache(maxsize=None)
def model_pair(kind, scheme, seed=0):
    """(jax model, jax params, port model, port params) for a §7 body.
    Cached: callers only read the params."""
    jbuild, tbuild = BUILDERS[kind]
    jm, tm = jbuild(), tbuild()
    p = jitter(jm.init_params(jax.random.PRNGKey(seed)), seed)
    p = quantized(jm, p, scheme, jm.input_shape[0], seed)
    return jm, p, tm, to_torch(p)


def small_pair(widths, acts, k0, scheme, seed):
    """The same pair for a small all-Dense stack over a ``k0``-wide input."""
    jm = jsequential([JL.Input()] + [JL.Dense(units=w, activation=a)
                                     for w, a in zip(widths, acts)], (k0,))
    tm = tsequential([TL.Input()] + [TL.Dense(units=w, activation=a)
                                     for w, a in zip(widths, acts)], (k0,))
    p = jitter(jm.init_params(jax.random.PRNGKey(seed)), seed)
    p = quantized(jm, p, scheme, k0, seed)
    return jm, p, tm, to_torch(p)


def assert_matches(scheme, got, want):
    if scheme == "SINT":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL[scheme])


# ---------------------------------------------------------------------------
# Model core


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_model_apply_matches_jax(kind, scheme):
    jm, jp, tm, tp = model_pair(kind, scheme)
    x = np.random.default_rng(1).standard_normal((16, 400)).astype(np.float32)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    got = tm.apply(tp, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert_matches(scheme, got, want)


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_builders_match_reference_graph(kind):
    jbuild, tbuild = BUILDERS[kind]
    jm, tm = jbuild(), tbuild()
    assert tm.input_shape == jm.input_shape
    assert tm.graph.schedule == jm.graph.schedule
    for jn, tn in zip(jm.graph.nodes, tm.graph.nodes):
        assert (tn.uid, tn.inputs, type(tn.layer).__name__) == \
            (jn.uid, jn.inputs, type(jn.layer).__name__)
        if isinstance(jn.layer, JL.Dense):
            assert (tn.layer.units, tn.layer.activation) == \
                (jn.layer.units, jn.layer.activation)


def test_init_params_glorot_from_generator():
    tm = build_detector()
    a = tm.init_params(torch.Generator().manual_seed(7), device="cpu")
    b = tm.init_params(torch.Generator().manual_seed(7), device="cpu")
    jp = jbuild_detector().init_params(jax.random.PRNGKey(0))
    assert sorted(a) == sorted(jp)
    for uid in jp:
        assert sorted(a[uid]) == sorted(jp[uid])
        for k in jp[uid]:
            assert tuple(a[uid][k].shape) == jp[uid][k].shape
            assert a[uid][k].dtype == torch.float32
            assert torch.equal(a[uid][k], b[uid][k])
    w = a[1]["w"]
    limit = np.sqrt(6.0 / (400 + 64))
    assert float(w.abs().max()) <= limit and float(w.std()) > limit / 3


def test_bridge_round_trip_keeps_dtypes():
    _, jp, _, tp = model_pair("detector", "SINT")
    back = params_to_numpy(tp)
    for uid, p in jp.items():
        for k, v in p.items():
            v = np.asarray(v)
            assert back[uid][k].dtype == v.dtype
            assert back[uid][k].shape == v.shape
            np.testing.assert_array_equal(back[uid][k], v)
    assert tp[1]["qw"].dtype == torch.int8
    assert tp[1]["x_scale"].dtype == torch.float32 and tp[1]["x_scale"].ndim == 0


# ---------------------------------------------------------------------------
# §6.1 quantization


@pytest.mark.parametrize("per_channel", (True, False))
@pytest.mark.parametrize("scheme", ("SINT", "INT", "DINT"))
def test_quantize_tensor_codes_and_scales_bit_equal(scheme, per_channel):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((40, 12)) * rng.uniform(0.01, 3.0, 12)) \
        .astype(np.float32)
    want = jquant.quantize_tensor(jnp.asarray(w), scheme,
                                  per_channel=per_channel)
    got = tquant.quantize_tensor(torch.from_numpy(w), scheme,
                                 per_channel=per_channel)
    assert got.q.numpy().dtype == np.asarray(want.q).dtype
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("scheme", ("SINT", "INT", "DINT"))
def test_quantize_params_matches_jax(scheme):
    jm, tm = jbuild_detector(), build_detector()
    p = jitter(jm.init_params(jax.random.PRNGKey(0)), 0)
    tp = to_torch(p)
    # Uncalibrated: every leaf bit-equal.
    want = jquant.quantize_params(jm, p, scheme)
    got = tquant.quantize_params(tm, tp, scheme)
    for uid in want:
        assert sorted(got[uid]) == sorted(want[uid])
        for k, v in want[uid].items():
            assert got[uid][k].numpy().dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(got[uid][k].numpy(), np.asarray(v))
    # Calibrated: codes, weight scales, biases and the input layer's
    # activation scale bit-equal.  Deeper activation scales come from hidden
    # activations, f32 dots summed in another order by XLA and torch, so
    # they agree to a few ulps.
    calib = 2.0 * np.random.default_rng(5).standard_normal(
        (6, 400)).astype(np.float32)
    want = jquant.quantize_params(
        jm, p, scheme, calibration=jquant.calibration_samples(calib, k=6))
    got = tquant.quantize_params(
        tm, tp, scheme,
        calibration=tquant.calibration_samples(calib, k=6, device="cpu"))
    for uid in want:
        for k, v in want[uid].items():
            if k == "x_scale" and uid > 1:
                np.testing.assert_allclose(got[uid][k].numpy(), np.asarray(v),
                                           rtol=1e-6)
            else:
                np.testing.assert_array_equal(got[uid][k].numpy(),
                                              np.asarray(v))


def test_calibration_samples_benign_only():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    y = np.array([0, 1] * 5)
    got = tquant.calibration_samples(x, y, k=3, device="cpu")
    want = jquant.calibration_samples(x, y, k=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="benign"):
        tquant.calibration_samples(x, np.ones(10), k=3, device="cpu")


@pytest.mark.parametrize("scheme", ("REAL", "SINT", "INT", "DINT"))
def test_memory_report_and_op_counts_match(scheme):
    assert tquant.memory_report(512, 512, scheme) == \
        jquant.memory_report(512, 512, scheme)
    q = scheme != "REAL"
    assert tquant.op_counts(400, 64, q) == jquant.op_counts(400, 64, q)


# ---------------------------------------------------------------------------
# Plain kernel versions and the ops wrappers


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_fused_forward_sint_bit_exact_vs_numpy_oracle(kind):
    jm, jp, tm, tp = model_pair(kind, "SINT", seed=2)
    x = 1.5 * np.random.default_rng(2).standard_normal(
        (23, 400)).astype(np.float32)
    got = ops.fused_forward(torch.from_numpy(x), ops.dense_stack(tm, tp))
    np.testing.assert_array_equal(
        got.numpy(), numpy_mlp_ref(x, jops.dense_stack(jm, jp)))


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_fused_forward_real_matches_jax_ref(kind):
    jm, jp, tm, tp = model_pair(kind, "REAL", seed=3)
    x = np.random.default_rng(3).standard_normal((23, 400)).astype(np.float32)
    got = ops.fused_forward(torch.from_numpy(x), ops.dense_stack(tm, tp))
    want = jref.fused_mlp_ref(jnp.asarray(x), jops.dense_stack(jm, jp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["REAL"])


def test_fused_forward_matches_pallas_kernel_interpreted():
    """A small SINT stack through the reference's Pallas kernel (interpret
    mode) and the port's fused_forward.  Tolerance: the Pallas body is
    jitted, and XLA contracts its requantize mul+add into an FMA (the
    last-bit shift codegen/verify.numpy_mlp_ref documents)."""
    jm, jp, tm, tp = small_pair([24, 8, 2], ["relu", "relu", "linear"], 16,
                                "SINT", seed=3)
    x = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    want = jops.fused_forward(jnp.asarray(x), jops.dense_stack(jm, jp),
                              backend="pallas")
    got = ops.fused_forward(torch.from_numpy(x), ops.dense_stack(tm, tp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_quantized_matmul_matches_reference_and_pallas_kernel():
    rng = np.random.default_rng(0)
    xq = rng.integers(-127, 128, (37, 40)).astype(np.int8)
    wq = rng.integers(-127, 128, (40, 10)).astype(np.int8)
    scale = (rng.random(10) * 1e-3).astype(np.float32)
    bias = rng.standard_normal(10).astype(np.float32)
    got = ops.quantized_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                               torch.from_numpy(scale), torch.from_numpy(bias))
    args = tuple(jnp.asarray(a) for a in (xq, wq, scale, bias))
    # The eager reference runs the same two rounded ops: bit-exact.
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.qmatmul_ref(*args)))
    # The jitted Pallas kernel may FMA-contract its epilogue: one ulp.
    pallas = np.asarray(jops.quantized_matmul(*args, backend="pallas"))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-6, atol=1e-6)
    no_bias = ops.quantized_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                                   float(scale[0]))
    np.testing.assert_array_equal(
        no_bias.numpy(), np.asarray(jref.qmatmul_ref(args[0], args[1],
                                                     scale[0])))


@pytest.mark.parametrize("m", (1, 8, 63, 64, 65, 1000))
def test_qmatmul_path_switch_and_plain_version(m):
    """The kernel's path from M (``qmatmul.path``: int8 tensor cores from
    one wgmma's 64 rows, the weight-streaming kernel below), and the plain
    version on either side, bit-exact against the reference's."""
    assert qmatmul.path(m) == ("tensor_cores" if m >= 64 else "stream")
    rng = np.random.default_rng(m)
    xq = rng.integers(-127, 128, (m, 48)).astype(np.int8)
    wq = rng.integers(-127, 128, (48, 20)).astype(np.int8)
    scale = (rng.random(20) * 1e-3).astype(np.float32)
    bias = rng.standard_normal(20).astype(np.float32)
    got = ops.quantized_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                               torch.from_numpy(scale), torch.from_numpy(bias))
    want = jref.qmatmul_ref(*(jnp.asarray(a) for a in (xq, wq, scale, bias)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _mixed_stack():
    """The detector with its last layer REAL and the rest SINT: a stack
    whose layers are not all int8."""
    sint = ops.dense_stack(*model_pair("detector", "SINT")[2:])
    real = ops.dense_stack(*model_pair("detector", "REAL")[2:])
    return sint[:3] + real[3:]


@pytest.mark.parametrize("kind,scheme", [
    (kind, scheme) for kind in ("autoencoder", "detector", "37-13-5-3")
    for scheme in SCHEMES] + [("detector", "mixed")])
def test_fused_path_and_kmajor_weight_copies(kind, scheme):
    """``fused_mlp.path`` sends an all-int8 stack to the tensor-core kernel
    and any other to the f32-tile kernel.  On the int8 path the plan-time
    K-major copy of each weight holds it transposed exactly and is zero in
    every pad (columns to a multiple of 8, depth to a multiple of 32); the
    layout's shared-memory bill and tile stride are its path's."""
    if scheme == "mixed":
        stack = _mixed_stack()
    elif kind == "37-13-5-3":
        _, _, tm, tp = small_pair([13, 5, 3], ["relu", "tanh", "linear"], 37,
                                  scheme, 0)
        stack = ops.dense_stack(tm, tp)
    else:
        stack = ops.dense_stack(*model_pair(kind, scheme)[2:])
    prepared = ops.prepare_fused(stack)
    want = fused_mlp.INT8_MMA if scheme == "SINT" else fused_mlp.F32_TILE
    assert fused_mlp.path(prepared) == prepared.path == want
    widths = [prepared.k0] + [layer.w.shape[1] for layer in prepared.layers]
    assert prepared.smem_bytes == fused_mlp.smem_bytes(widths, want)
    if want == fused_mlp.F32_TILE:
        assert prepared.wt == (None,) * len(stack)
        assert prepared.ld == max(widths)
        return
    assert prepared.ld == -(-max(widths[:-1]) // 32) * 32 + 16
    for (p, _), wt in zip(stack, prepared.wt):
        k, n = p["qw"].shape
        assert wt.dtype == torch.int8
        assert wt.shape == (-(-n // 8) * 8, -(-k // 32) * 32)
        assert torch.equal(wt[:n, :k], p["qw"].T)
        assert not wt[n:].any() and not wt[:, k:].any()


def _quantize_by_reciprocal(h, scale, qmax):
    """csrc/mlp_common.cuh::quantize in numpy float32 (whose operations
    round to nearest, as the kernels' intrinsics do): zero passes, the
    product with the correctly rounded reciprocal where it lies more than
    |a| * 2**-20 from every half-integer, the IEEE quotient elsewhere."""
    f32 = np.float32
    inv = f32(1) / scale
    if not f32(2.0**-125) <= inv <= f32(2.0**125):
        inv = f32(np.nan)
    a = h * inv
    edge = f32(0.5) - np.abs(a - np.rint(a))
    with np.errstate(invalid="ignore"):
        t = np.where(edge > np.abs(a) * f32(2.0**-20), a, h / scale)
    t = np.where(h == 0, h, t)
    return np.minimum(np.maximum(np.rint(t), -qmax), qmax)


@pytest.mark.parametrize("qmax", (127, 32767, 2147483647))
def test_quantize_rule_equals_ieee_division(qmax):
    """The int8 kernels' quantize finds rint(h / scale) mostly without the
    division: equal to the plain version's IEEE quotient for every input,
    here random ones and ones within 40 ulp of a half-integer quotient (the
    only places where the product and the quotient can round apart)."""
    rng = np.random.default_rng(qmax)
    f32 = np.float32
    qmax = f32(qmax)
    for _ in range(8):
        scale = f32(10 ** rng.uniform(-6, 3))
        m = rng.integers(-int(min(qmax, 2**24)), int(min(qmax, 2**24)) + 1,
                         100_000).astype(np.float64)
        half = ((m + 0.5) * float(scale)).astype(f32)
        steps = rng.integers(-40, 41, half.shape)
        near = half.copy()
        for _ in range(40):
            move = np.abs(steps) > 0
            near = np.where(move, np.nextafter(
                near, np.where(steps > 0, np.inf, -np.inf).astype(f32)), near)
            steps = steps - np.sign(steps)
        spread = (rng.standard_normal(100_000) * float(scale)
                  * 10 ** rng.uniform(0, 3)).astype(f32)
        for h in (near, half, spread, np.zeros(4, f32)):
            with np.errstate(over="ignore"):
                want = np.minimum(np.maximum(np.rint(h / scale), -qmax), qmax)
                got = _quantize_by_reciprocal(h, scale, qmax)
            np.testing.assert_array_equal(got, want)


def test_kernel_backend_raises_on_cpu_tensors():
    _, _, tm, tp = model_pair("detector", "SINT")
    stack = ops.dense_stack(tm, tp)
    x = torch.zeros((4, 400))
    with pytest.raises(ValueError, match="no CPU mode"):
        ops.fused_forward(x, stack, backend="kernel")
    xq = torch.zeros((4, 400), dtype=torch.int8)
    with pytest.raises(ValueError, match="no CPU mode"):
        ops.quantized_matmul(xq, stack[0][0]["qw"], 1.0, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        ops.fused_forward(x, stack, backend="pallas")
    # The kernel wrappers themselves take CUDA tensors only.
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_mlp(x, ops.prepare_fused(stack))
    # 'ref' runs the plain version anywhere.
    torch.testing.assert_close(ops.fused_forward(x, stack, backend="ref"),
                               ops.fused_forward(x, stack), rtol=0, atol=0)


def test_fuse_reason_uses_the_kernels_shared_memory_bill():
    for kind in BUILDERS:
        for scheme in SCHEMES:
            _, _, tm, tp = model_pair(kind, scheme)
            assert ops.fuse_reason(ops.dense_stack(tm, tp)) is None
            assert ops.model_fusable(tm, ops.dense_stack(tm, tp))
    _, _, tm, tp = small_pair([8, 2], ["relu", "softmax"], 16, "REAL", 0)
    reason = ops.fuse_reason(ops.dense_stack(tm, tp))
    assert "softmax" in reason
    with pytest.raises(ValueError, match="softmax"):
        ops.fused_forward(torch.zeros((2, 16)), ops.dense_stack(tm, tp))
    # An all-int8 stack's bill is two int8 code tiles and the kernel's step
    # table: 2 tiles x 8 rows x (16384 + 16) B + 448 B = 262,848 B >
    # 232,448 B per block.
    _, _, tm, tp = small_pair([16384, 2], ["relu", "linear"], 16, "SINT", 0)
    reason = ops.fuse_reason(ops.dense_stack(tm, tp))
    assert "262848 bytes" in reason and "232448 bytes" in reason
    assert not ops.can_fuse(ops.dense_stack(tm, tp))
    # The f32 autoencoder fuses: its widest tiles take 2 x 8 x 400 x 4 B.
    assert fused_mlp.smem_bytes([400, 64, 16, 64, 400]) == 25600
