"""§6.2 pruning in the port against the JAX reference, on the CPU.

The same numpy weights go through both packages' ``core.prune``: pruned
weights, block indices and tile values must be identical (the same f32
sorts and comparisons).  ``ops.sparse_dense`` on CPU tensors (the plain
version, ``x @ w.to_dense()``) is held to the reference's Pallas kernel run
interpreted, within 1e-4 (rtol and atol: the two sum the K products in
another order; the reference's own kernel test holds it to the same).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import icsml_mlp as jicsml
from repro.core import prune as jprune
from repro.kernels.sparse_matmul import sparse_matmul as jsparse_matmul
from repro_torch.configs import icsml_mlp
from repro_torch.core import prune
from repro_torch.kernels import ops, sparse_matmul
from test_torch_core import small_pair

torch.set_num_threads(1)

SPARSITIES = (0.0, 0.3, 0.6, 0.9)
BLOCKS = ((64, 64), (128, 128))


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def pruned_pair(sparsity, block, shape=(256, 384), seed=0):
    """(JAX BlockSparseWeight, port BlockSparseWeight) of one weight."""
    w = normal(shape, seed)
    jw = jprune.block_magnitude_prune(jnp.asarray(w), sparsity, block)
    tw = prune.block_magnitude_prune(torch.from_numpy(w), sparsity, block)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    return jprune.compress_blocks(jw, block), prune.compress_blocks(tw, block)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("sparsity", SPARSITIES)
def test_block_prune_and_compress_identical(sparsity, block):
    jbs, tbs = pruned_pair(sparsity, block)
    np.testing.assert_array_equal(tbs.indices, jbs.indices)
    assert tbs.indices.dtype == np.int32
    np.testing.assert_array_equal(tbs.values.numpy(), np.asarray(jbs.values))
    assert (tbs.nnz_blocks, tbs.density, tbs.shape, tbs.block) == \
        (jbs.nnz_blocks, jbs.density, jbs.shape, jbs.block)
    np.testing.assert_array_equal(tbs.to_dense().numpy(),
                                  np.asarray(jbs.to_dense()))
    # The kernel's walk: the reference kernel's column-major tile order,
    # each tile's block row and each block-column's run.
    order = np.lexsort((jbs.indices[:, 0], jbs.indices[:, 1]))
    np.testing.assert_array_equal(tbs.col_rows.numpy(), jbs.indices[order, 0])
    np.testing.assert_array_equal(tbs.col_values.numpy(),
                                  np.asarray(jbs.values)[order])
    n_cols = jbs.shape[1] // block[1]
    np.testing.assert_array_equal(
        np.diff(tbs.col_offsets.numpy()),
        np.bincount(jbs.indices[:, 1], minlength=n_cols))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("sparsity", SPARSITIES)
def test_sparse_dense_matches_interpreted_pallas(sparsity, block):
    jbs, tbs = pruned_pair(sparsity, block)
    x = normal((64, 256), 1)
    want = np.asarray(jsparse_matmul(jnp.asarray(x), jbs, interpret=True))
    for backend in ("auto", "ref"):
        got = ops.sparse_dense(torch.from_numpy(x), tbs, backend=backend)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="sparse_matmul kernel has no CPU"):
        ops.sparse_dense(torch.from_numpy(x), tbs, backend="kernel")


def test_pruned_column_and_all_zero_weight():
    """A block-column pruned whole gives exact zeros (the reference masks
    it); an all-zero weight keeps one block (the static-shape rule)."""
    w = normal((256, 384), 2)
    w[:, 128:256] = 0.0
    jbs = jprune.compress_blocks(jnp.asarray(w), (128, 128))
    tbs = prune.compress_blocks(torch.from_numpy(w), (128, 128))
    np.testing.assert_array_equal(tbs.indices, jbs.indices)
    assert tbs.col_offsets.tolist() == [0, 2, 2, 4]
    x = normal((32, 256), 3)
    got = ops.sparse_dense(torch.from_numpy(x), tbs).numpy()
    assert (got[:, 128:256] == 0).all()
    np.testing.assert_allclose(
        got, np.asarray(jsparse_matmul(jnp.asarray(x), jbs, interpret=True)),
        rtol=1e-4, atol=1e-4)
    zero = np.zeros((128, 256), np.float32)
    jz = jprune.compress_blocks(jnp.asarray(zero), (128, 128))
    tz = prune.compress_blocks(torch.from_numpy(zero), (128, 128))
    assert tz.nnz_blocks == jz.nnz_blocks == 1
    np.testing.assert_array_equal(tz.indices, jz.indices)
    assert (ops.sparse_dense(torch.from_numpy(x[:, :128]), tz) == 0).all()


def run_plan(x, tbs, launch):
    """Walk ``launch``'s grid as the kernel does, in numpy.  Small path:
    block (bx, by) sums its block-column's whole run for its rows and
    columns.  Large path: block (bx, by) sums one piece of the work list,
    and a column's pieces are added in piece order.  Returns the output,
    how many blocks wrote each element, and how often each (tile, output
    element) product was taken."""
    (m, _), (bk, bn), n = x.shape, tbs.block, tbs.shape[1]
    offsets, pieces = tbs.col_offsets.numpy(), tbs.col_pieces.numpy()
    rows, values = tbs.col_rows.numpy(), tbs.col_values.numpy()
    out = np.zeros((m, n), np.float32)
    writes = np.zeros((m, n), np.int64)
    uses = np.zeros((len(values), m, n), np.int64)
    gx, gy = launch.grid
    slices = bn // launch.cols
    for bx in range(gx):
        if launch.path == "small":
            col = bx * launch.cols
            cb, c0 = divmod(col, bn)
            first, count, runs = None, 1, [(offsets[cb], offsets[cb + 1])]
        else:
            piece, s = divmod(bx, slices)
            cb, t0, t1, first, count = pieces[piece]
            c0 = s * launch.cols
            col, runs = cb * bn + c0, [(t0, t1)]
        assert c0 + launch.cols <= bn        # a slice of one block-column
        if first is not None and piece != first + count - 1:
            continue                  # the column's last piece adds them all
        if first is not None:
            runs = [tuple(pieces[p][1:3]) for p in range(first, first + count)]
        cols = slice(col, col + launch.cols)
        for by in range(gy):
            r = slice(by * launch.rows, min((by + 1) * launch.rows, m))
            acc = np.zeros((r.stop - r.start, launch.cols), np.float32)
            for t0, t1 in runs:
                for t in range(t0, t1):
                    acc += x[r, rows[t] * bk:(rows[t] + 1) * bk] \
                        @ values[t][:, c0:c0 + launch.cols]
                    uses[t, r, cols] += 1
            out[r, cols] = acc
            writes[r, cols] += 1
    return out, writes, uses


@pytest.mark.parametrize("m", (1, 8, 32, 33, 1024))
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("sparsity", (0.0, 0.6))
def test_sparse_plan_covers_each_output_once(sparsity, block, m):
    """The kernel's schedule (``sparse_matmul.plan``, the work list
    ``col_pieces``): the small path up to M = 32; every output element
    written by exactly one block; every nonzero tile's product taken
    exactly once for each output element of its block-column, and none for
    another column.  Walked in numpy, it matches the reference's plain
    product within 1e-4."""
    jbs, tbs = pruned_pair(sparsity, block)
    launch = sparse_matmul.plan(m, tbs)
    assert launch.path == ("small" if m <= 32 else "large")
    x = normal((m, tbs.shape[0]), 5)
    got, writes, uses = run_plan(x, tbs, launch)
    assert (writes == 1).all()
    bn = tbs.block[1]
    for t, c in enumerate(np.repeat(np.arange(tbs.shape[1] // bn),
                                    np.diff(tbs.col_offsets.numpy()))):
        in_col = np.zeros(tbs.shape[1], bool)
        in_col[c * bn:(c + 1) * bn] = True
        assert (uses[t][:, in_col] == 1).all()
        assert (uses[t][:, ~in_col] == 0).all()
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(x)
                                               @ jbs.to_dense()),
                               rtol=1e-4, atol=1e-4)


def test_run_pieces_balance_long_runs():
    """The work list cuts each run into near-equal pieces of at most
    ceil(nnz / (2 n_cols)) tiles, in run order; an empty run is one empty
    piece."""
    pieces = prune.run_pieces(np.array([0, 5, 5, 9, 12]))
    most = -(-12 // 8)
    np.testing.assert_array_equal(pieces[:, 0], [0, 0, 0, 1, 2, 2, 3, 3])
    assert ((pieces[:, 2] - pieces[:, 1]) <= most).all()
    for c, start, end in ((0, 0, 5), (1, 5, 5), (2, 5, 9), (3, 9, 12)):
        mine = pieces[pieces[:, 0] == c]
        assert mine[0, 1] == start and mine[-1, 2] == end
        np.testing.assert_array_equal(mine[1:, 1], mine[:-1, 2])
        assert (mine[:, 3] == np.flatnonzero(pieces[:, 0] == c)[0]).all()
        assert (mine[:, 4] == len(mine)).all()


@pytest.mark.parametrize("shape,indices,values_shape", [
    ((200, 256), [[0, 0]], (1, 128, 128)),        # K not a multiple of bk
    ((256, 300), [[0, 0]], (1, 128, 128)),        # N not a multiple of bn
    ((256, 256), [[2, 0]], (1, 128, 128)),        # a tile's rows past K
    ((256, 256), [[0, -1]], (1, 128, 128)),       # a negative block index
    ((256, 256), [[0, 0], [1, 1]], (1, 128, 128)),  # fewer tiles than indices
    ((256, 256), [[0, 0]], (1, 64, 128)),         # tiles of another block
], ids=("k", "n", "row", "negative", "count", "tile"))
def test_block_sparse_weight_rejects_bad_layout(shape, indices, values_shape):
    """A weight built by hand, not by compress_blocks, is checked when it is
    built: the kernel's grid covers N / bn block-columns and reads rows
    below K, so any other layout would leave output unwritten or read past
    x."""
    with pytest.raises(ValueError, match="BlockSparseWeight"):
        prune.BlockSparseWeight(values=torch.zeros(values_shape),
                                indices=np.asarray(indices, np.int32),
                                shape=shape, block=(128, 128))


@pytest.mark.parametrize("sparsity", (0.0, 0.1, 0.5, 0.75, 0.95))
def test_magnitude_prune_identical(sparsity):
    w = normal((40, 30), 4)
    got = prune.magnitude_prune(torch.from_numpy(w), sparsity)
    want = jprune.magnitude_prune(jnp.asarray(w), sparsity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The reference takes an f32 mean (XLA: a sum times 1/n); the port
    # counts exactly.
    assert prune.sparsity_of(got) == pytest.approx(jprune.sparsity_of(want),
                                                   rel=1e-6)
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError, match="sparsity"):
            prune.magnitude_prune(torch.from_numpy(w), bad)


@pytest.mark.parametrize("block", (None, (16, 16)))
def test_prune_model_identical(block):
    jm, jp, tm, tp = small_pair((64, 32), ("relu", "linear"), 64, "REAL",
                                seed=5)
    want = jprune.prune_model(jm, jp, 0.5, block=block)
    got = prune.prune_model(tm, tp, 0.5, block=block)
    assert sorted(got) == sorted(want)
    for uid in want:
        for k in want[uid]:
            np.testing.assert_array_equal(got[uid][k].numpy(),
                                          np.asarray(want[uid][k]))


@pytest.mark.parametrize("kw", [
    dict(quantized=False),
    dict(quantized=True),
    dict(quantized=True, check_inputs=True, input_sparsity=0.4),
])
def test_skip_op_counts_identical(kw):
    for sparsity in (0.0, 0.5, 0.9):
        assert prune.skip_op_counts(784, 512, sparsity, **kw) == \
            jprune.skip_op_counts(784, 512, sparsity, **kw)


def test_icsml_layer_constants():
    assert (icsml_mlp.PRUNE_LAYER, icsml_mlp.QUANT_LAYER,
            icsml_mlp.BENCH_FEATURES) == (jicsml.PRUNE_LAYER,
                                          jicsml.QUANT_LAYER,
                                          jicsml.BENCH_FEATURES)
