"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at the shapes ``chip_smoke.py`` drives.  Every test here needs
an NVIDIA GPU and nvcc and skips without CUDA (the kernels have no CPU
mode); run them on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py``.

Tolerances: SINT is bit-exact (``torch.equal``: integer accumulation and an
unfused requantize on both sides).  REAL within 1e-5 (f32 FMA dot in the
kernel against cuBLAS's summation order).  DINT within 1e-4: the emulated
integer products pass 2**24, so f32 rounding follows the summation order.
INT within 1e-3: the same, and a last-bit difference ahead of a requantize
can move an INT activation code by one step (1/32767 of its calibrated
range), which the next layer's weights carry to the output (measured up to
1.5e-4 on the card).  The grouped kernel's score lanes are reductions summed
in another order than ``torch.mean``: within 1e-5 relative for SINT; a
final softmax runs its own expf and row sum: within the REAL tolerance.
``sparse_matmul`` (f32 FMAs in K order against cuBLAS's f32 product, TF32
off) within 1e-4, pruned columns exactly 0.  ``ssd_scan`` (another cumsum
and product order than the plain version, 3xTF32 tensor-core products) y
and final state within the reference's own rtol 2e-4 / atol 2e-5; on bf16
views bit-equal to the same call on f32 copies.  The framework's
convolutions (cuDNN, not a kernel of the port) within 1e-5 of the CPU with
cuDNN's TF32 flag on; multipart inference ``torch.equal`` to ``apply``; an
exported SINT block bit-exact against the numpy oracle, whose logits the
``fused_mlp`` engine's own step outputs equal bit for bit.  Training on the
card (autograd and Adam in f32, validation through ``fused_mlp``) follows
the CPU path from the same init: train losses and validation metrics within
1e-4 relative (an accuracy within one validation window), the returned
params within 1e-4 of the largest weight.  The LLM train step launches no
kernel (no kernel has a backward: ``ops`` raises when one is asked for a
gradient) and follows the CPU within 1e-4; the loss without a gradient runs
``ssd_scan`` and equals the chunked plain version's within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import layers as TL
from repro_torch.core import prune, quantize, sequential
from repro_torch.kernels import (fused_mlp, norm_codes, ops, qmatmul, ref,
                                 sparse_matmul, ssd_scan)
from repro_torch.models import mamba2
from repro_torch.models.api import get_model
from repro_torch.models.vlm import VISION_D
from repro_torch.serving import (Engine, GroupedStreamEngine, ModelGroup,
                                 Request, StreamEngine)
from repro_torch.sim import (ClassifierHead, ForecastHead, MarginHead,
                             ReconstructionHead, build_autoencoder,
                             build_detector, build_forecaster,
                             build_margin_model, fleet_readings)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

TOL = {"REAL": 1e-5, "INT": 1e-3, "DINT": 1e-4}
BUILDERS = {"detector": build_detector, "autoencoder": build_autoencoder,
            "margin": build_margin_model, "forecaster": build_forecaster}
FLEET = ("detector", "autoencoder", "margin", "forecaster")
FLEET_KINDS = (ops.GROUPED_KIND_LOGITS,) + (ops.GROUPED_KIND_SCORE,) * 3


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_model(kind, scheme, seed=0):
    model = BUILDERS[kind]()
    params = model.init_params(torch.Generator().manual_seed(seed),
                               device="cuda")
    if scheme != "REAL":
        calib = np.random.default_rng(seed).standard_normal(
            (8, model.input_shape[0])).astype(np.float32)
        params = quantize.quantize_params(
            model, params, scheme,
            calibration=quantize.calibration_samples(calib, k=8))
    return model, params


def check(scheme, got, want):
    torch.cuda.synchronize()
    if scheme == "SINT":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=TOL[scheme],
                                   atol=TOL[scheme])


@pytest.mark.parametrize("m", (1024, 1000, 37))
@pytest.mark.parametrize("scheme", ("REAL", "SINT", "INT", "DINT"))
@pytest.mark.parametrize("kind", ("autoencoder", "detector"))
def test_fused_mlp_matches_plain(kind, scheme, m):
    model, params = card_model(kind, scheme)
    stack = ops.dense_stack(model, params)
    x = torch.randn((m, 400), generator=torch.Generator().manual_seed(m)) \
        .cuda()
    before = fused_mlp.launches
    got = ops.fused_forward(x, stack)
    assert fused_mlp.launches == before + 1
    check(scheme, got, ref.fused_mlp_ref(x, stack))


def act_model(acts, widths, scheme, k0=400, seed=5):
    model = sequential([TL.Input()] + [TL.Dense(units=w, activation=a)
                                       for w, a in zip(widths, acts)], (k0,))
    params = model.init_params(torch.Generator().manual_seed(seed),
                               device="cuda")
    if scheme != "REAL":
        calib = np.random.default_rng(seed).standard_normal(
            (8, k0)).astype(np.float32)
        params = quantize.quantize_params(
            model, params, scheme,
            calibration=quantize.calibration_samples(calib, k=8))
    return ops.dense_stack(model, params)


@pytest.mark.parametrize("m", (1, 7, 8, 9, 15, 16, 17, 127, 128, 129))
@pytest.mark.parametrize("scheme", ("REAL", "SINT"))
@pytest.mark.parametrize("kind", ("autoencoder", "detector"))
def test_fused_mlp_tile_edges(kind, scheme, m):
    """Both paths at the edges of the 8-row block and of the m16 tile whose
    upper half it fills: M = 1, 7, 8, 9, 15, 16, 17, 127, 128, 129."""
    model, params = card_model(kind, scheme)
    stack = ops.dense_stack(model, params)
    prepared = ops.prepare_fused(stack)
    assert fused_mlp.path(prepared) == (
        fused_mlp.INT8_MMA if scheme == "SINT" else fused_mlp.F32_TILE)
    x = torch.randn((m, 400), generator=torch.Generator().manual_seed(m)) \
        .cuda()
    check(scheme, fused_mlp.fused_mlp(x, prepared),
          ref.fused_mlp_ref(x, stack))


@pytest.mark.parametrize("m", (1, 9, 1000))
@pytest.mark.parametrize("scheme", ("REAL", "SINT", "INT", "DINT"))
def test_fused_mlp_widths_off_the_granules(scheme, m):
    """A 37-13-5-3 stack: K not a multiple of 32 (nor of 4, so the input is
    staged lane by lane), N not a multiple of 8."""
    stack = act_model(["relu", "relu", "linear"], [13, 5, 3], scheme, k0=37)
    x = torch.randn((m, 37), generator=torch.Generator().manual_seed(m)) \
        .cuda()
    before = fused_mlp.launches
    got = ops.fused_forward(x, stack)
    assert fused_mlp.launches == before + 1
    check(scheme, got, ref.fused_mlp_ref(x, stack))


def test_fused_mlp_mixed_stack_runs_the_f32_tile_path():
    """The detector with its last layer REAL and the others SINT: not all
    int8, so fused_mlp.path sends it to the f32-tile kernel, whose SINT
    layers dot their codes in int32 (REAL tolerance for the REAL layer's
    summation order; it goes last because ahead of a SINT layer a last-bit
    difference can move a code by a whole step, in the plain version too)."""
    sint = ops.dense_stack(*card_model("detector", "SINT"))
    real = ops.dense_stack(*card_model("detector", "REAL"))
    stack = sint[:3] + real[3:]
    prepared = ops.prepare_fused(stack)
    assert fused_mlp.path(prepared) == fused_mlp.F32_TILE
    for m in (1000, 37):
        x = torch.randn((m, 400),
                        generator=torch.Generator().manual_seed(m)).cuda()
        check("REAL", fused_mlp.fused_mlp(x, prepared),
              ref.fused_mlp_ref(x, stack))


@pytest.mark.parametrize("scheme", ("REAL", "SINT"))
def test_fused_and_grouped_calls_are_bit_equal(scheme):
    """Two calls of each kernel on the same inputs give the same bits (no
    atomics, a fixed order on both paths)."""
    stack = ops.dense_stack(*card_model("autoencoder", scheme))
    prepared = ops.prepare_fused(stack)
    x = torch.randn((1000, 400),
                    generator=torch.Generator().manual_seed(3)).cuda()
    assert torch.equal(fused_mlp.fused_mlp(x, prepared),
                       fused_mlp.fused_mlp(x, prepared))
    stacks = [ops.dense_stack(*card_model(kind, scheme, seed=i))
              for i, kind in enumerate(FLEET)]
    plan, arrays = ops.build_grouped_plan(stacks, FLEET_KINDS, k0=400)
    grouped = ops.prepare_grouped(plan, arrays)
    g = torch.Generator().manual_seed(4)
    xg = torch.randn((plan.n_groups, 1000, plan.k0), generator=g).cuda()
    tgt = torch.randn((plan.n_groups, 1000, plan.n_out), generator=g).cuda()
    assert torch.equal(fused_mlp.grouped_fused_mlp(xg, grouped, tgt),
                       fused_mlp.grouped_fused_mlp(xg, grouped, tgt))


def test_fused_mlp_continuous_activations():
    """Every continuous activation the kernel implements, one per layer, in
    f32 (libm's expf/tanhf against PyTorch's: within the REAL tolerance)."""
    acts = ["sigmoid", "tanh", "elu", "leaky_relu", "swish", "relu", "linear"]
    stack = act_model(acts, [64, 48, 32, 32, 24, 16, 8], "REAL")
    x = 2.0 * torch.randn((1000, 400),
                          generator=torch.Generator().manual_seed(1)).cuda()
    check("REAL", ops.fused_forward(x, stack), ref.fused_mlp_ref(x, stack))


def test_fused_mlp_binary_step_sint():
    """binary_step is discontinuous at 0, so it is checked where its input
    is exact: after a SINT layer (integer dot, unfused requantize), whose
    0/1 outputs the next SINT layer quantizes exactly."""
    stack = act_model(["binary_step", "linear"], [64, 2], "SINT")
    x = torch.randn((1000, 400), generator=torch.Generator().manual_seed(2)) \
        .cuda()
    got = ops.fused_forward(x, stack)
    check("SINT", got, ref.fused_mlp_ref(x, stack))
    hidden = ref.fused_mlp_ref(x, stack[:1])
    assert 0.2 < float(hidden.mean()) < 0.8      # both sides of the step


def qmatmul_operands(m, k, n, seed):
    g = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).cuda()
    wq = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8).cuda()
    scale = (torch.rand(n, generator=g) * 1e-3).cuda()
    bias = torch.randn(n, generator=g).cuda()
    return xq, wq, scale, bias


# M on both sides of the tensor-core switch (qmatmul.path: M >= 64).
@pytest.mark.parametrize("m", (1024, 1000, 65, 64, 63, 37, 8))
@pytest.mark.parametrize("k,n", ((400, 64), (64, 32), (32, 16), (16, 2)))
def test_qmatmul_matches_plain(k, n, m):
    xq, wq, scale, bias = qmatmul_operands(m, k, n, k * n + m)
    before = qmatmul.launches
    got = ops.quantized_matmul(xq, wq, scale, bias)
    assert qmatmul.launches == before + 1
    check("SINT", got, ref.qmatmul_ref(xq, wq, scale, bias))
    check("SINT", ops.quantized_matmul(xq, wq, scale),
          ref.qmatmul_ref(xq, wq, scale))


@pytest.mark.parametrize("m", (1000, 64, 63, 8))
@pytest.mark.parametrize("n", (4384, 1024))
def test_qmatmul_mamba_widths(n, m):
    """mamba2-370m's in_proj and out_proj widths (N 4384 = 34 x 128 + 32:
    a ragged last tile) with K cut to 256, on both paths."""
    xq, wq, scale, bias = qmatmul_operands(m, 256, n, n + m)
    check("SINT", qmatmul.qmatmul(xq, wq, scale, bias),
          ref.qmatmul_ref(xq, wq, scale, bias))
    check("SINT", qmatmul.qmatmul(xq, wq, scale),
          ref.qmatmul_ref(xq, wq, scale))


@pytest.mark.parametrize("m", (1000, 8))
def test_qmatmul_unaligned_operands(m):
    """Operands that are not 16-byte aligned (a view one byte into its
    storage) take the byte-wise instance of either path."""
    xq, wq, scale, bias = qmatmul_operands(m, 256, 4384, m)
    shifted = torch.empty(m * 256 + 1, dtype=torch.int8, device="cuda")
    shifted[1:] = xq.reshape(-1)
    xs = shifted[1:].view(m, 256)
    assert xs.data_ptr() % 16 and xs.is_contiguous()
    check("SINT", qmatmul.qmatmul(xs, wq, scale, bias),
          ref.qmatmul_ref(xq, wq, scale, bias))


# qwen3-8b's SINT projections (K x N): wq and wo, wk and wv, gate and up,
# down.
QWEN3_SHAPES = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096))


@pytest.mark.parametrize("m", (8, 64, 1024))
@pytest.mark.parametrize("k,n", QWEN3_SHAPES)
def test_qmatmul_qwen3_widths(k, n, m):
    """qwen3-8b's four projection shapes at full width: K = 12288 walks 96
    K steps of a tensor-core tile, and at M = 8 the streaming path reads a
    50 MB weight.  torch.equal to the plain version."""
    g = torch.Generator(device="cuda").manual_seed(k + n + m)
    xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    scale = torch.rand(n, generator=g, device="cuda") * 1e-5
    bias = torch.randn(n, generator=g, device="cuda")
    before = qmatmul.launches
    got = ops.quantized_matmul(xq, wq, scale, bias)
    assert qmatmul.launches == before + 1
    check("SINT", got, ref.qmatmul_ref(xq, wq, scale, bias))
    check("SINT", qmatmul.qmatmul(xq, wq, scale),
          ref.qmatmul_ref(xq, wq, scale))


# The SINT projections (K x N) of the last three families at full width:
# Jamba's Mamba in_proj and out_proj, attention (wq/wo, wk/wv) and MLP (up,
# down); LLaVA-NeXT-34b's attention and MLP; whisper-base's attention and
# MLP.
FAMILY_SHAPES = ((8192, 34944), (16384, 8192), (8192, 8192), (8192, 1024),
                 (8192, 24576), (24576, 8192), (7168, 7168), (7168, 1024),
                 (7168, 20480), (20480, 7168), (512, 512), (512, 2048),
                 (2048, 512))


@pytest.mark.parametrize("m", (8, 1024))
@pytest.mark.parametrize("k,n", FAMILY_SHAPES)
def test_qmatmul_family_widths(k, n, m):
    """torch.equal to the plain version at the hybrid's, the VLM's and
    Whisper's projection shapes, on both sides of the path switch."""
    g = torch.Generator(device="cuda").manual_seed(k + n + m)
    xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                       dtype=torch.int8)
    scale = torch.rand(n, generator=g, device="cuda") * 1e-5
    bias = torch.randn(n, generator=g, device="cuda")
    check("SINT", qmatmul.qmatmul(xq, wq, scale, bias),
          ref.qmatmul_ref(xq, wq, scale, bias))


def test_qmatmul_takes_int8_only():
    x = torch.zeros((4, 8), dtype=torch.int16, device="cuda")
    with pytest.raises(ValueError, match="int8"):
        qmatmul.qmatmul(x, x.T.contiguous(), torch.ones(4, device="cuda"))


@pytest.mark.parametrize("fused", (None, False))
def test_engine_launches_its_kernels(fused):
    model, params = card_model("detector", "SINT")
    readings = np.tile(fleet_readings(8, 230, seed=0), (1, 4, 1))
    kw = dict(n_streams=32, fused=fused)
    engine = StreamEngine(model, params, **kw)
    plain = StreamEngine(model, params, backend="ref", **kw)
    engine.warmup()
    counts = (fused_mlp.launches, qmatmul.launches)
    got, want = [], []
    for c in range(readings.shape[0]):
        got.extend(engine.ingest(readings[c]))
        want.extend(plain.ingest(readings[c]))
    steps = engine.stats.steps
    assert steps == 4
    if fused is None:
        assert fused_mlp.launches - counts[0] == steps
        assert qmatmul.launches == counts[1]
    else:
        assert qmatmul.launches - counts[1] == 4 * steps
        assert fused_mlp.launches == counts[0]
    assert [v.pred for v in got] == [v.pred for v in want]
    np.testing.assert_array_equal(engine.last_logits, plain.last_logits)


def run_grouped(stacks, kinds, m, seed=0):
    """The grouped kernel and its plain version on one random fleet batch;
    checks that ops.grouped_apply launched the kernel exactly once."""
    plan, arrays = ops.build_grouped_plan(stacks, kinds, k0=400)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((plan.n_groups, m, plan.k0), generator=g).cuda()
    tgt = torch.randn((plan.n_groups, m, plan.n_out), generator=g).cuda()
    before = fused_mlp.grouped_launches
    got = ops.grouped_apply(x, plan, arrays, tgt)
    assert fused_mlp.grouped_launches == before + 1
    want = ref.grouped_mlp_ref(
        x, [list(zip(arrays["stacks"][k], plan.acts[k]))
            for k in range(plan.n_groups)],
        kinds=plan.kinds, true_k0s=plan.true_k0s, n_outs=plan.n_outs,
        tgt=tgt, n_pay=plan.payload_width)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (plan.n_groups, m, plan.payload_width)
    assert torch.isfinite(got).all()
    return plan, got, want


@pytest.mark.parametrize("m", (1024, 1000, 37))
@pytest.mark.parametrize("scheme", ("REAL", "SINT", "INT", "DINT"))
def test_grouped_mlp_matches_plain(scheme, m):
    """The four-head §7 fleet at full width: logits bit-equal for SINT,
    score lanes within 1e-5 relative; REAL/INT/DINT within their TOL."""
    stacks = [ops.dense_stack(*card_model(kind, scheme, seed=i))
              for i, kind in enumerate(FLEET)]
    plan, got, want = run_grouped(stacks, FLEET_KINDS, m)
    assert plan.widths == ((400, 64), (64, 32), (32, 64), (64, 400))
    if scheme == "SINT":
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[1:], want[1:], rtol=1e-5, atol=0)
    else:
        check(scheme, got, want)


def test_grouped_mlp_final_softmax():
    """A softmax classifier (masked to its 3 true lanes inside a 400-wide
    union) beside the autoencoder."""
    stacks = [act_model(["relu", "relu", "softmax"], [64, 32, 3], "SINT"),
              ops.dense_stack(*card_model("autoencoder", "SINT"))]
    _, got, want = run_grouped(stacks, FLEET_KINDS[:2], 1000)
    torch.testing.assert_close(got, want, rtol=TOL["REAL"], atol=TOL["REAL"])
    assert (got[0, :, 3:] == 0).all()
    torch.testing.assert_close(got[0, :, :3].sum(-1),
                               torch.ones(1000, device="cuda"))


@pytest.mark.parametrize("m", (1, 9, 1000))
@pytest.mark.parametrize("scheme", ("REAL", "SINT"))
def test_grouped_mlp_true_widths(scheme, m):
    """Three groups whose true widths differ at every position (inputs 400,
    397 and 250 of the 400-wide union; depths 4, 3 and 4, so one group skips
    the last position): each product runs at its own widths, held to the
    per-group plain version."""
    stacks = [act_model(["relu", "relu", "relu", "linear"], [64, 32, 16, 2],
                        scheme, seed=1),
              act_model(["relu", "relu", "linear"], [45, 21, 7],
                        scheme, k0=397, seed=2),
              act_model(["relu", "relu", "relu", "linear"], [96, 40, 33, 11],
                        scheme, k0=250, seed=3)]
    plan, got, want = run_grouped(stacks, (0, 1, 0), m)
    assert plan.true_k0s == (400, 397, 250)
    assert plan.skips == ((0, 0, 0, 0), (0, 0, 0, 1), (0, 0, 0, 0))
    if scheme == "SINT":
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    else:
        check(scheme, got, want)


def test_grouped_mlp_skip_heavy():
    """Groups of 1, 6 and 2 layers: the shallow ones pass their payload
    through five and four skipped positions, every continuous activation
    runs somewhere (f32)."""
    stacks = [act_model(["linear"], [2], "REAL"),
              act_model(["sigmoid", "tanh", "elu", "leaky_relu", "swish",
                         "linear"], [64, 48, 32, 24, 16, 8], "REAL"),
              act_model(["relu", "linear"], [16, 400], "REAL")]
    plan, got, want = run_grouped(stacks, (0, 0, 1), 1000)
    assert plan.skips == ((0, 1, 1, 1, 1, 1), (0,) * 6, (0, 0, 1, 1, 1, 1))
    check("REAL", got, want)


@pytest.mark.parametrize("megakernel", (None, False))
def test_grouped_engine_launches_its_kernels(megakernel):
    """The four-head fleet, 32 plants per group: one grouped launch per
    verdict step (or one fused_mlp per group per step), preds equal to the
    plain path."""
    readings = np.tile(fleet_readings(8, 230, seed=0), (1, 16, 1))
    heads = (ClassifierHead(), ReconstructionHead(threshold=0.5),
             MarginHead(threshold=0.5, center=(0.0,) * 16),
             ForecastHead(threshold=0.5))
    groups = [ModelGroup(kind, *card_model(kind, "SINT", seed=i), 32, head)
              for i, (kind, head) in enumerate(zip(FLEET, heads))]
    engine = GroupedStreamEngine(groups, megakernel=megakernel)
    plain = GroupedStreamEngine(groups, megakernel=megakernel,
                                backend="ref")
    engine.warmup()
    counts = (fused_mlp.grouped_launches, fused_mlp.launches)
    got, want = [], []
    for c in range(readings.shape[0]):
        got.extend(engine.ingest(readings[c]))
        want.extend(plain.ingest(readings[c]))
    steps = engine.stats.steps
    assert steps == 4
    if megakernel is None:
        assert fused_mlp.grouped_launches - counts[0] == steps
        assert fused_mlp.launches == counts[1]
    else:
        assert fused_mlp.launches - counts[1] == 4 * steps
        assert fused_mlp.grouped_launches == counts[0]
    assert [v.pred for v in got] == [v.pred for v in want]
    np.testing.assert_array_equal(engine.last_outputs["detector"],
                                  plain.last_outputs["detector"])
    for kind in FLEET[1:]:
        np.testing.assert_allclose(engine.last_outputs[kind],
                                   plain.last_outputs[kind], rtol=1e-5)


# ---------------------------------------------------------------------------
# sparse_matmul: the §6.2 pruned layer (784 inputs padded to 7 x 128, 512)


def stale_output(shape):
    """Leave NaNs in the caching allocator's next block of this size, so an
    output element the kernel never writes shows."""
    torch.full(shape, float("nan"), device="cuda")


def pruned_layer(sparsity, block, seed=0):
    w = torch.randn((896, 512), generator=torch.Generator().manual_seed(seed))
    return prune.compress_blocks(
        prune.block_magnitude_prune(w.cuda(), sparsity, block), block)


# M on both sides of the small-M switch (sparse_matmul.plan: M <= 32).
@pytest.mark.parametrize("m", (8, 1024, 37, 1, 33))
@pytest.mark.parametrize("sparsity,block", [(s, (128, 128)) for s in
                                            (0.0, 0.25, 0.5, 0.75)]
                         + [(0.5, (64, 64))])
def test_sparse_matmul_matches_plain(sparsity, block, m):
    w = pruned_layer(sparsity, block)
    x = torch.randn((m, 896), generator=torch.Generator().manual_seed(m)) \
        .cuda()
    stale_output((m, 512))
    before = sparse_matmul.launches
    got = ops.sparse_dense(x, w)
    assert sparse_matmul.launches == before + 1
    want = ref.sparse_matmul_ref(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    dead = (w.to_dense() == 0).all(dim=0)
    assert (got[:, dead] == 0).all()


@pytest.mark.parametrize("m", (8, 1024))
@pytest.mark.parametrize("block", ((128, 128), (64, 64)))
def test_sparse_matmul_is_deterministic(block, m):
    """Partial sums are combined in a fixed order, without atomics: two
    calls on the same inputs give the same bits."""
    w = pruned_layer(0.5, block)
    x = torch.randn((m, 896), generator=torch.Generator().manual_seed(m)) \
        .cuda()
    first = sparse_matmul.sparse_matmul(x, w)
    second = sparse_matmul.sparse_matmul(x, w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_sparse_matmul_on_two_streams():
    """The large path's split-run counters belong to a stream: two weights
    with split runs, called back to back at M = 1024 on two streams, both
    match the plain version."""
    weights = [pruned_layer(0.5, (128, 128), seed=1),
               pruned_layer(0.25, (128, 128), seed=2)]
    assert all(len(w.col_pieces) > w.shape[1] // w.block[1] for w in weights)
    x = torch.randn((1024, 896), generator=torch.Generator().manual_seed(7)) \
        .cuda()
    streams = [torch.cuda.Stream() for _ in weights]
    for stream in streams:
        stream.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(3):
        for w, stream in zip(weights, streams):
            with torch.cuda.stream(stream):
                outs.append((w, sparse_matmul.sparse_matmul(x, w)))
    torch.cuda.synchronize()
    for w, got in outs:
        torch.testing.assert_close(got, ref.sparse_matmul_ref(x, w),
                                   rtol=1e-4, atol=1e-4)


def test_sparse_matmul_pruned_column_and_all_zero():
    """A block-column pruned whole is written as exact zeros by its own
    blocks (no masking pass); an all-zero weight keeps one block."""
    w = torch.randn((896, 512), generator=torch.Generator().manual_seed(3)) \
        .cuda()
    w[:, 128:256] = 0
    bs = prune.compress_blocks(w, (128, 128))
    assert bs.col_offsets.tolist() == [0, 7, 7, 14, 21]
    x = torch.randn((1024, 896), generator=torch.Generator().manual_seed(4)) \
        .cuda()
    stale_output((1024, 512))
    got = ops.sparse_dense(x, bs)
    torch.cuda.synchronize()
    assert (got[:, 128:256] == 0).all()
    torch.testing.assert_close(got, x @ w, rtol=1e-4, atol=1e-4)
    zero = prune.compress_blocks(torch.zeros((896, 512), device="cuda"),
                                 (128, 128))
    assert zero.nnz_blocks == 1
    stale_output((1024, 512))
    assert (ops.sparse_dense(x, zero) == 0).all()


# ---------------------------------------------------------------------------
# ssd_scan: the Mamba-2 SSD


def ssd_inputs(bsz, t, h, p, n, g, seed=0):
    """Inputs shaped as the model makes them: dt a softplus, A negative."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, t, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((bsz, t, h)))) * 0.2
    a = -np.exp(rng.standard_normal(h) * 0.5)
    b = rng.standard_normal((bsz, t, g, n)) * 0.3
    c = rng.standard_normal((bsz, t, g, n)) * 0.3
    return [torch.from_numpy(v.astype(np.float32)).cuda()
            for v in (x, dt, a, b, c)]


SSD_CARD_SHAPES = [
    (8, 1024, 32, 64, 128, 1),      # mamba2-370m's prefill in the serve runs
    (8, 1000, 32, 64, 128, 1),      # a ragged last chunk
    (1, 4096, 32, 64, 128, 1),      # one long row
    (2, 300, 16, 32, 32, 2),        # the reduced widths, two groups
    (3, 200, 8, 64, 64, 4),
    (2, 129, 4, 32, 128, 1),
    (4, 1024, 128, 128, 128, 8),    # Jamba's Mamba layers in chip_smoke (A)
    (1, 1000, 16, 128, 128, 8),     # P 128 with a ragged last chunk
]


def ssd_ids(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", SSD_CARD_SHAPES, ids=ssd_ids)
def test_ssd_scan_matches_chunked(shape):
    args = ssd_inputs(*shape)
    before = ssd_scan.launches
    got = ops.ssd(*args)
    assert ssd_scan.launches == before + 1
    want = ops.ssd(*args, backend="chunked")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape", SSD_CARD_SHAPES, ids=ssd_ids)
def test_ssd_scan_state_matches_plain(shape):
    """The kernel's final state (one launch with y) against the plain
    contribution sum, y unchanged by asking for it."""
    args = ssd_inputs(*shape, seed=3)
    before = ssd_scan.launches
    y, state = ops.ssd(*args, return_state=True)
    assert ssd_scan.launches == before + 1
    bsz, _, h, p, n, _ = shape
    assert state.shape == (bsz, h, p, n) and state.dtype == torch.float32
    want = ref.ssd_final_state_ref(*args[:4])
    torch.cuda.synchronize()
    assert torch.isfinite(state).all()
    torch.testing.assert_close(state, want, rtol=2e-4, atol=2e-5)
    assert torch.equal(y, ops.ssd(*args))


def test_ssd_scan_is_deterministic():
    args = ssd_inputs(8, 1000, 32, 64, 128, 1, seed=4)
    first = ops.ssd(*args, return_state=True)
    second = ops.ssd(*args, return_state=True)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(first, second))


def conv_output(bsz, t, h, p, n, g, seed):
    """x, B and C as the model hands them over: bf16 views of one
    (B, T, H P + 2 G N) conv output."""
    gen = torch.Generator().manual_seed(seed)
    xbc = (torch.randn((bsz, t, h * p + 2 * g * n), generator=gen) * 0.5) \
        .to(torch.bfloat16).cuda()
    return (xbc[..., :h * p].reshape(bsz, t, h, p),
            xbc[..., h * p:h * p + g * n].reshape(bsz, t, g, n),
            xbc[..., h * p + g * n:].reshape(bsz, t, g, n))


@pytest.mark.parametrize("shape", [(8, 1000, 32, 64, 128, 1),
                                   (2, 300, 16, 32, 32, 2),
                                   (2, 300, 32, 128, 128, 8)], ids=ssd_ids)
def test_ssd_scan_reads_bf16_views_in_place(shape):
    """bf16 strided views give the bits of the same call on f32 contiguous
    copies (bf16 is exact in f32, and every op after the load is explicit)
    and agree with the plain versions on the same views; ops.ssd copies
    nothing for them."""
    x, b, c = conv_output(*shape, seed=5)
    assert not x.is_contiguous() and ssd_scan.reads(x) and ssd_scan.reads(b)
    _, dt, a, _, _ = ssd_inputs(*shape, seed=5)
    got = ssd_scan.ssd_scan(x, dt, a, b, c, return_state=True)
    want = ssd_scan.ssd_scan(*(v.float().contiguous() for v in (x, dt, a)),
                             b.float().contiguous(), c.float().contiguous(),
                             return_state=True)
    via_ops = ops.ssd(x, dt, a, b, c, return_state=True)
    plain = ops.ssd(x, dt, a, b, c, backend="chunked", return_state=True)
    torch.cuda.synchronize()
    for u, v, w, q in zip(got, want, via_ops, plain):
        assert torch.equal(u, v) and torch.equal(u, w)
        assert torch.isfinite(u).all()
        torch.testing.assert_close(u, q, rtol=2e-4, atol=2e-5)


def test_ssd_copies_an_unaligned_contiguous_input():
    """A contiguous x at a base that is not 16-byte aligned is one the
    kernel cannot read in place: ops.ssd copies it and launches."""
    args = ssd_inputs(2, 300, 16, 32, 32, 2, seed=6)
    x = args[0]
    buf = torch.empty(x.numel() + 1, device=x.device)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and not ssd_scan.reads(shifted)
    before = ssd_scan.launches
    got = ops.ssd(shifted, *args[1:], return_state=True)
    assert ssd_scan.launches == before + 1
    want = ops.ssd(*args, return_state=True)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_ssd_scan_matches_sequential():
    args = ssd_inputs(2, 300, 8, 64, 128, 1, seed=1)
    torch.testing.assert_close(ops.ssd(*args), ops.ssd(*args, backend="ref"),
                               rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# norm_codes: an RMSNorm row written out as a SINT projection's codes

NORM_WIDTHS = (64, 1024, 2048, 16384)
# site -> gated: the block's pre-norm, the mixer's gated norm (D skip and
# SiLU gate first)
NORM_SITES = {"norm": False, "gated_out": True}
# layout -> (extra columns, first column) of the tensors the rows are cut
# from: packed rows, strided views the kernel reads with 16-byte loads (the
# conv output's and in_proj output's channels), and views it reads element
# by element (an odd stride and a misaligned start)
NORM_LAYOUTS = {"packed": (0, 0), "views": (256, 128), "unaligned": (3, 1)}


def norm_rows(m, w, dtype, layout, gen):
    """(m, w) normal rows in ``dtype``, cut from a wider tensor as
    ``layout`` says."""
    extra, first = NORM_LAYOUTS[layout]
    base = torch.randn((m, w + extra), generator=gen, device="cuda")
    return base.to(dtype)[:, first:first + w]


def norm_operands(m, w, site, layout="packed", dtype=torch.bfloat16,
                  x_scale=1.0 / 127.0, seed=0):
    """(x, g, x_scale, kwargs) of a norm_codes call: gated, y f32 (the
    SSD's output) with 64-column heads (fewer columns: one head)."""
    gated = NORM_SITES[site]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = norm_rows(m, w, torch.float32 if gated else dtype, layout, gen)
    g = 1.0 + 0.1 * torch.randn((w,), generator=gen, device="cuda")
    kw = {}
    if gated:
        kw["xs"] = norm_rows(m, w, dtype, layout, gen)
        kw["d_skip"] = 1.0 + 0.5 * torch.rand((max(w // 64, 1),),
                                              generator=gen, device="cuda")
        kw["z"] = norm_rows(m, w, dtype, layout, gen)
    scale = torch.tensor(x_scale, dtype=torch.float32, device="cuda")
    return x, g, scale, kw


def check_codes(got, want):
    """Codes equal on >= 99.9% of entries and never a step apart: only the
    order of the row's sum of squares differs, which can move rsqrt's last
    bit and with it a code sitting on a rounding boundary."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int8
    assert got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) >= 0.999


@pytest.mark.parametrize("layout", tuple(NORM_LAYOUTS))
@pytest.mark.parametrize("site", tuple(NORM_SITES))
@pytest.mark.parametrize("w", NORM_WIDTHS)
def test_norm_codes_matches_plain(w, site, layout):
    """bf16 rows, 333 of them (no block count divides it), at the model's
    x_scale 1/127, where a third of the codes clip at +-127."""
    x, g, scale, kw = norm_operands(333, w, site, layout)
    before = norm_codes.launches
    got = norm_codes.norm_codes(x, g, scale, **kw)
    assert norm_codes.launches == before + 1
    want = ref.norm_codes_ref(x, g, scale, **kw)
    check_codes(got, want)
    assert int((want.int().abs() == 127).sum()) > 0


@pytest.mark.parametrize("site", tuple(NORM_SITES))
@pytest.mark.parametrize("w", NORM_WIDTHS)
def test_norm_codes_rounds_half_to_even_at_the_clip(w, site):
    """x_scale 2**-6: the normed bf16 values between 1 and 2 sit on a grid
    of 2**-7, so half of their codes (64..127) are exact .5 ties that
    rint must round to even, and every value past 2 clips."""
    x, g, scale, kw = norm_operands(1000, w, site, x_scale=2.0 ** -6, seed=1)
    got = norm_codes.norm_codes(x, g, scale, **kw)
    want = ref.norm_codes_ref(x, g, scale, **kw)
    check_codes(got, want)
    # The plain version's normed values, before the quantize: the ties.
    u = x
    if kw:
        h = kw["d_skip"].shape[0]
        u = (x.reshape(len(x), h, -1) + kw["d_skip"][:, None]
             * kw["xs"].reshape(len(x), h, -1)).reshape(x.shape) \
            .to(torch.bfloat16)
        u = u * torch.nn.functional.silu(kw["z"])
    uf = u.float()
    n = (uf * torch.rsqrt((uf * uf).mean(-1, keepdim=True) + 1e-6) * g) \
        .to(torch.bfloat16).float() / scale
    ties = (n - n.floor() == 0.5) & (n.abs() < 127)
    assert int(ties.sum()) > 0
    assert torch.equal(want[ties].float() % 2, torch.zeros_like(n[ties]))
    assert int((want.int().abs() == 127).sum()) > 0


@pytest.mark.parametrize("site", tuple(NORM_SITES))
@pytest.mark.parametrize("w", NORM_WIDTHS)
def test_norm_codes_f32_rows(w, site):
    """The f32 working type (the reduced f32 configs): no bf16 rounding
    anywhere, 37 rows."""
    x, g, scale, kw = norm_operands(37, w, site, dtype=torch.float32,
                                    seed=2)
    check_codes(norm_codes.norm_codes(x, g, scale, **kw),
                ref.norm_codes_ref(x, g, scale, **kw))


@pytest.mark.parametrize("m", (0, 1, 2))
def test_norm_codes_few_rows(m):
    x, g, scale, kw = norm_operands(m, 2048, "gated_out", "views")
    got = norm_codes.norm_codes(x, g, scale, **kw)
    assert got.shape == (m, 2048)
    if m:
        check_codes(got, ref.norm_codes_ref(x, g, scale, **kw))


def test_rmsnorm_codes_reads_the_mixers_views():
    """``ops.rmsnorm_codes`` on the mixer's own layout: y (B, S, W) f32,
    xs and z (B, S, W) views of the conv output and of in_proj's output
    (row strides 2,304 and 4,384 at mamba2-370m's widths), one launch, the
    kernel's codes on the flattened rows, and the plain version under
    ``backend="ref"``."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s, w = 4, 500, 2048
    y = torch.randn((b, s, w), generator=gen, device="cuda")
    conv = torch.randn((b, s, 2304), generator=gen,
                       device="cuda").to(torch.bfloat16)
    zxbcdt = torch.randn((b, s, 4384), generator=gen,
                         device="cuda").to(torch.bfloat16)
    xs, z = conv[..., :w], zxbcdt[..., :w]
    g = torch.ones((w,), device="cuda")
    d_skip = torch.ones((32,), device="cuda")
    scale = torch.full((48,), 1.0 / 127.0, device="cuda")[5]
    kw = dict(xs=xs, d_skip=d_skip, z=z)
    before = norm_codes.launches
    got = ops.rmsnorm_codes(y, g, scale, **kw)
    assert norm_codes.launches == before + 1
    assert torch.equal(got, norm_codes.norm_codes(
        y.reshape(-1, w), g, scale, xs=xs.reshape(-1, w), d_skip=d_skip,
        z=z.reshape(-1, w)))
    want = ops.rmsnorm_codes(y, g, scale, backend="ref", **kw)
    assert norm_codes.launches == before + 2
    check_codes(got, want)


def test_norm_codes_rejects_what_it_cannot_read():
    x, g, scale, kw = norm_operands(8, 64, "gated_out")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        norm_codes.norm_codes(x.cpu(), g, scale, **kw)
    with pytest.raises(ValueError, match="xs, d_skip and z together"):
        norm_codes.norm_codes(x, g, scale, xs=kw["xs"], d_skip=kw["d_skip"])
    by_column = kw["xs"].t().contiguous().t()    # (8, 64), column stride 8
    with pytest.raises(ValueError, match="columns packed"):
        norm_codes.norm_codes(x, g, scale, **{**kw, "xs": by_column})
    with pytest.raises(ValueError, match="one f32 value"):
        norm_codes.norm_codes(x, g, scale.cpu(), **kw)


# The norm_codes path's distance from the eager norm and quantize at four
# layers (largest difference over the largest value): a code a step off at
# a rounding boundary grows through the layers as any last-bit change does.
# On an H100, B 4 x T 1000, seeds 0-5: logits 0.0048-0.0103, SSM states
# 0.0022-0.0107, conv states 0.0049-0.0073; the chunked plain SSD in
# ssd_scan's place moves the eager path by 0.0072-0.0133, 0.0074-0.0126 and
# 0.0057-0.0099.  A fault of the kernel (a lost skip or gate, a wrong head)
# moves them by O(1).
NORM_CODES_DEPTH_TOL = 2e-2


def test_sint_mamba2_prefill_fused_matches_eager():
    """Four layers of mamba2-370m at full width, bf16 SINT, a prefill of
    B 4 x T 1000: two norm_codes launches a layer, and the last position's
    logits and the final SSM and conv states within NORM_CODES_DEPTH_TOL of
    their largest value of the eager norm and quantize's
    (``{"norm_codes": "ref"}``)."""
    cfg = get_config("mamba2_370m").with_(n_layers=4, quant="SINT")
    api = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(gen)
    tokens = torch.randint(0, cfg.vocab, (4, 1000), generator=gen,
                           device="cuda")
    before = norm_codes.launches
    with torch.no_grad():
        cache, logits = api.prefill(params, {"tokens": tokens}, 1004)
        assert norm_codes.launches - before == 2 * cfg.n_layers
        eager = get_model(cfg, backend={"norm_codes": "ref"})
        want_cache, want = eager.prefill(params, {"tokens": tokens}, 1004)
    assert norm_codes.launches - before == 2 * cfg.n_layers
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    for got_t, want_t in ((logits, want), (cache["ssm"], want_cache["ssm"]),
                          (cache["conv"], want_cache["conv"])):
        err = float((got_t.float() - want_t.float()).abs().max())
        assert err <= NORM_CODES_DEPTH_TOL * float(want_t.float().abs()
                                                   .max()), err


@pytest.mark.parametrize("quant", (None, "SINT"))
def test_mamba_engine_launches_its_kernels(quant):
    """A reduced f32 Mamba-2 wave on the card: one ssd_scan launch per layer
    per prefill, two qmatmul launches per layer per forward (SINT), greedy
    tokens equal to the plain path's."""
    cfg = get_config("mamba2_370m").reduced().with_(dtype=torch.float32,
                                                    quant=quant)
    params = get_model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 40 + 30 * i),
                    max_new_tokens=6) for i in range(3)]
    before = (ssd_scan.launches, qmatmul.launches)
    got = Engine(get_model(cfg), params, batch_slots=4,
                 cache_len=128).serve(reqs)
    assert ssd_scan.launches - before[0] == cfg.n_layers
    assert qmatmul.launches - before[1] == (2 * cfg.n_layers * 6
                                            if quant else 0)
    want = Engine(get_model(cfg, backend="ref"), params, batch_slots=4,
                  cache_len=128).serve(reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_qwen3_width_sint_engine_equals_plain_qmatmul():
    """Two layers of qwen3-8b at full width (d 4096, 32 q and 8 kv heads of
    128, d_ff 12288, vocab 151936), bf16 SINT, through the wave engine:
    seven qmatmul launches per layer per forward, and tokens and prefill
    logits equal to the same engine with qmatmul's plain version."""
    cfg = get_config("qwen3_8b").with_(n_layers=2, quant="SINT")
    params = get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 100 + 20 * i),
                    max_new_tokens=4) for i in range(3)]
    before = qmatmul.launches
    engine = Engine(get_model(cfg), params, batch_slots=4, cache_len=160)
    got = engine.serve(reqs)
    assert qmatmul.launches - before == 7 * cfg.n_layers * 4
    plain = Engine(get_model(cfg, backend={"qmatmul": "ref"}), params,
                   batch_slots=4, cache_len=160)
    want = plain.serve(reqs)
    assert torch.equal(engine.last_prefill_logits, plain.last_prefill_logits)
    assert torch.isfinite(engine.last_prefill_logits).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_jamba_width_mamba_mixer_equals_plain_qmatmul():
    """One Jamba Mamba mixer at full width (d 8192, 128 SSD heads of P 128,
    N 128, G 8), bf16 SINT, B 2 x T 200: the output and both states equal
    to the same mixer with qmatmul's plain version (the ssd_scan kernel in
    both), two qmatmul and one ssd_scan launch per call."""
    cfg = get_config("jamba_1_5_large_398b").with_(quant="SINT")
    g = torch.Generator(device="cuda").manual_seed(0)
    p = mamba2.mamba_init(g, cfg)
    x = (torch.randn((2, 200, cfg.d_model), generator=g, device="cuda")
         ).to(torch.bfloat16)
    before = (qmatmul.launches, ssd_scan.launches)
    got, got_state = mamba2._mamba_forward_state(p, cfg, x)
    assert (qmatmul.launches - before[0], ssd_scan.launches - before[1]) \
        == (2, 1)
    want, want_state = mamba2._mamba_forward_state(
        p, cfg, x, backend={"qmatmul": "ref"})
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)
    for k in ("conv", "ssm"):
        assert torch.equal(got_state[k], want_state[k])


def test_llava_width_two_layers_equal_plain_qmatmul():
    """Two layers of llava-next-34b at full width (d 7168, 56 q and 8 kv
    heads of 128, d_ff 20480, vocab 64000), bf16 SINT, with a 64-token
    image prefix through the wave engine's extras: seven qmatmul launches
    per layer per forward, tokens and prefill logits equal to the same
    engine with qmatmul's plain version, and the prefix moves the
    logits."""
    cfg = get_config("llava_next_34b").with_(n_layers=2, quant="SINT",
                                             num_image_tokens=64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = get_model(cfg).init(gen)
    image = torch.randn((2, 64, VISION_D), generator=gen,
                        device="cuda").to(torch.bfloat16)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 90 + 20 * i),
                    max_new_tokens=4) for i in range(2)]
    before = qmatmul.launches
    engine = Engine(get_model(cfg), params, batch_slots=2, cache_len=256,
                    extras={"image_emb": image})
    got = engine.serve(reqs)
    assert qmatmul.launches - before == 7 * cfg.n_layers * 4
    plain = Engine(get_model(cfg, backend={"qmatmul": "ref"}), params,
                   batch_slots=2, cache_len=256, extras={"image_emb": image})
    want = plain.serve(reqs)
    assert torch.equal(engine.last_prefill_logits, plain.last_prefill_logits)
    assert torch.isfinite(engine.last_prefill_logits).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
    other = Engine(get_model(cfg), params, batch_slots=2, cache_len=256,
                   extras={"image_emb": image + 1})
    other.serve(reqs)
    assert not torch.equal(other.last_prefill_logits,
                           engine.last_prefill_logits)


# ---------------------------------------------------------------------------
# The framework on the card: IEEE f32 convolutions, multipart inference, and
# the IEC 61131-3 export held against the fused_mlp engine


@pytest.mark.parametrize("layer", [
    TL.Conv2D(filters=64, kernel_size=(3, 3), strides=(2, 2)),
    TL.Conv2D(filters=32, kernel_size=(3, 3), padding="VALID"),
    TL.DepthwiseConv2D(kernel_size=(3, 3)),
    TL.DepthwiseConv2D(kernel_size=(5, 5), strides=(2, 2), padding="VALID"),
], ids=["conv_same_s2", "conv_valid", "dw_same", "dw_valid_s2"])
def test_conv_layers_stay_ieee_f32_with_tf32_on(layer):
    """cuDNN's TF32 flag at PyTorch's default (on): the layer still computes
    IEEE f32, within 1e-5 of the CPU plain path (TF32 misses that by orders
    of magnitude at 288-deep sums), and leaves the flag as it found it."""
    shape = (17, 17, 32)
    p = layer.init_params(torch.Generator().manual_seed(0), [shape])
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4,) + shape).astype(np.float32))
    want = layer.apply(p, [x])
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = layer.apply({k: v.cuda() for k, v in p.items()}, [x.cuda()])
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scheme", ("SINT", "REAL"))
def test_multipart_on_card_equals_single_shot(scheme):
    from repro_torch.core.runtime import MultipartInference
    model, params = card_model("detector", scheme, seed=3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        400).astype(np.float32)).cuda()
    single = model.apply(params, x)
    assert torch.equal(model.apply_planned(params, x), single)
    for n in (1, 2, 4, 8):
        mi = MultipartInference(model, params, n)
        assert mi.device.type == "cuda"
        out = mi.run_all(x.cpu().numpy())
        assert out.device.type == "cuda" and torch.equal(out, single)


def test_export_verifies_against_the_card_engine():
    """A narrow SINT classifier (40-8-2, a 20-reading window) served by
    StreamEngine on the card, one fused_mlp launch per verdict step, and
    every window replayed through the emulated block: the block's outputs
    and the engine's logits both bit-equal to the numpy oracle."""
    from repro_torch.codegen import export_st, verify_export, window_starts
    from repro_torch.configs import msf_detector as spec
    model = sequential([TL.Input(), TL.Dense(units=8, activation="relu"),
                        TL.Dense(units=2, activation="linear")], (40,))
    raw = fleet_readings(8, 230, seed=5)
    norm = (raw - np.asarray(spec.NORM_MEAN, np.float32)) / np.asarray(
        spec.NORM_STD, np.float32)
    params = quantize.quantize_params(
        model, model.init_params(torch.Generator().manual_seed(0),
                                 device="cuda"), "SINT",
        calibration=quantize.calibration_samples(
            norm[:20].transpose(1, 0, 2).reshape(8, 40), k=8))
    head = ClassifierHead()
    export = export_st(model, params, head=head,
                       normalize=(spec.NORM_MEAN, spec.NORM_STD))
    before = fused_mlp.launches
    res = verify_export(export, model, params, head, raw, spec.STRIDE)
    steps = len(window_starts(230, 20, spec.STRIDE))
    assert fused_mlp.launches - before == steps
    assert res["windows"] == res["engine_windows"] == 8 * steps
    assert res["failures"] == 0 and res["borderline"] == 0
    assert res["max_body_diff"] == 0.0 and res["max_engine_diff"] == 0.0


def test_training_on_card_follows_the_cpu():
    """Two epochs of the §7 classifier on the card, cuBLAS's TF32 flag on,
    and on the CPU from the same seed (one CPU generator draws the init for
    both), at the tolerances of ``chip_smoke.py`` run (r); one ``fused_mlp``
    launch per validation epoch and one for the test split."""
    from repro_torch.sim import build_dataset, train_detector
    x, y = build_dataset(normal_cycles=3000, attack_cycles=800, stride=8,
                         seed=0)
    kw = dict(epochs=2, batch_size=128, lr=1e-3)
    before = fused_mlp.launches
    # cuBLAS's TF32 flag on: training keeps its products IEEE f32 and puts
    # the caller's flag back.
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, card = train_detector(x, y, device="cuda", **kw)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert fused_mlp.launches - before == 2 + 1
    _, cpu = train_detector(x, y, device="cpu", **kw)
    assert len(card.history) == len(cpu.history) == 2
    np.testing.assert_allclose([l for _, l, _ in card.history],
                               [l for _, l, _ in cpu.history], rtol=1e-4)
    n_val = int(0.1275 * len(x))
    for (_, _, got), (_, _, want) in zip(card.history, cpu.history):
        assert abs(got - want) <= 1.0 / n_val + 1e-6
    largest = max(float(v.abs().max()) for p in cpu.params.values()
                  for v in p.values())
    for uid, p in cpu.params.items():
        for k, v in p.items():
            got = card.params[uid][k]
            assert got.device.type == "cuda" and not got.requires_grad
            torch.testing.assert_close(got.cpu(), v, rtol=0,
                                       atol=1e-4 * largest)


def test_ssd_raises_under_grad():
    """No kernel has a backward: ``ops.ssd`` on card tensors that require
    grad raises (under ``"auto"`` and ``"kernel"``) and launches nothing;
    under ``torch.no_grad()`` it launches; the chunked plain version takes
    the gradient."""
    x, dt, a, b, c = ssd_inputs(1, 128, 4, 64, 128, 1)
    x = x.requires_grad_(True)
    before = ssd_scan.launches
    for backend in ("auto", "kernel"):
        with pytest.raises(RuntimeError, match="ssd_scan kernel has no "
                           "backward"):
            ops.ssd(x, dt, a, b, c, backend=backend)
    assert ssd_scan.launches == before
    with torch.no_grad():
        y = ops.ssd(x, dt, a, b, c)
    assert ssd_scan.launches == before + 1
    want = ops.ssd(x, dt, a, b, c, backend={"ssd_scan": "chunked"})
    want.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    torch.testing.assert_close(y, want.detach(), rtol=2e-4, atol=2e-5)


TRAIN_FAMILIES = ("qwen3_8b", "granite_moe_1b_a400m", "mamba2_370m",
                  "jamba_1_5_large_398b", "llava_next_34b", "whisper_base")


@pytest.mark.parametrize("arch", ("mamba2_370m", "jamba_1_5_large_398b"))
def test_no_grad_loss_through_ssd_scan_equals_chunked(arch):
    """The loss without a gradient (reduced, f32) runs ssd_scan once per
    Mamba layer and equals the same loss through the chunked plain SSD
    within 1e-4 relative."""
    cfg = get_config(arch).reduced().with_(dtype=torch.float32)
    api = get_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init(gen)
    batch = api.init_batch("train", 2, 128, gen)
    n_mamba = cfg.n_layers - cfg.n_layers // max(cfg.attn_period, 1) \
        if cfg.family == "hybrid" else cfg.n_layers
    before = ssd_scan.launches
    with torch.no_grad():
        got = api.loss(params, batch)
        assert ssd_scan.launches - before == n_mamba
        want = get_model(cfg, backend={"ssd_scan": "chunked"}).loss(
            params, batch)
    assert ssd_scan.launches - before == n_mamba
    assert torch.isfinite(got)
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


@pytest.mark.parametrize("arch", TRAIN_FAMILIES)
def test_train_step_on_card_follows_the_cpu(arch):
    """One AdamW train step of the reduced f32 config on the card and on the
    CPU from the same params and batch: no kernel launched (the gradient
    takes the plain versions), loss and gradient norm within 1e-4
    relative, every gradient leaf within 1e-4 of its largest value, the
    updated params within 1e-4 of the largest param (a zero-initialised
    leaf holds only AdamW's first +-lr step, whose signs follow the last
    bits of gradients near zero)."""
    from repro_torch.launch.steps import (loss_and_grads, make_optimizer,
                                          make_train_step)
    from repro_torch.optim.adamw import leaves, tree_map
    cfg = get_config(arch).reduced().with_(dtype=torch.float32)
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    cpu_params = api.init(gen, device="cpu")
    cpu_batch = api.init_batch("train", 2, 64, gen, device="cpu")
    card_params = tree_map(lambda p: p.to("cuda"), cpu_params)
    card_batch = {k: v.to("cuda") for k, v in cpu_batch.items()}
    opt_init, opt_update = make_optimizer()
    step = make_train_step(api, opt_update)
    before = (ssd_scan.launches, qmatmul.launches)
    _, card_grads = loss_and_grads(api, card_params, card_batch)
    card_params, _, card_m = step(card_params, opt_init(card_params),
                                  card_batch)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, qmatmul.launches) == before
    _, cpu_grads = loss_and_grads(api, cpu_params, cpu_batch)
    cpu_params, _, cpu_m = step(cpu_params, opt_init(cpu_params), cpu_batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(card_m[k]) - float(cpu_m[k])) \
            <= 1e-4 * abs(float(cpu_m[k]))
    for got, want in zip(leaves(card_grads), leaves(cpu_grads)):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    largest = max(float(p.abs().max()) for p in leaves(cpu_params))
    for got, want in zip(leaves(card_params), leaves(cpu_params)):
        assert got.device.type == "cuda" and not got.requires_grad
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * largest)
