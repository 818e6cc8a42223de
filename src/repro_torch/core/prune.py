"""Weight pruning and operation skipping (§6.2): ``repro.core.prune``'s
counterpart.

The paper prunes weights to zero and asks whether the runtime can *skip* the
corresponding arithmetic; on the PLC a per-element IF-skip loses in float and
wins under SINT quantization.  A GPU cannot predicate single multiply-adds
cheaply either, so, as in the reference, the skip is made structural: the
weight is tiled into blocks, zero blocks are dropped at plan time
(:func:`compress_blocks`), and the block-sparse kernel
(``kernels/csrc/sparse_matmul.cu``) visits only the nonzero tiles.  The
paper's element-wise economics are reproduced analytically by
:func:`skip_op_counts`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.layers import Dense
from repro_torch.core.model import Model, ParamTree


def magnitude_prune(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Zero out the smallest-magnitude ``sparsity`` fraction of weights."""
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
    if sparsity == 0.0:
        return w
    k = int(math.ceil(sparsity * w.numel()))  # at least `sparsity` achieved
    if k == 0:
        return w
    thresh = torch.sort(torch.abs(w).reshape(-1)).values[k - 1]
    return torch.where(torch.abs(w) <= thresh, torch.zeros_like(w), w)


def block_magnitude_prune(
    w: torch.Tensor, sparsity: float, block: Tuple[int, int] = (128, 128)
) -> torch.Tensor:
    """Structured pruning: zero whole blocks by their L1 norm."""
    bi, bj = block
    n, m = w.shape
    if n % bi or m % bj:
        raise ValueError(
            f"weight shape {tuple(w.shape)} not divisible by block {block}")
    blocks = w.reshape(n // bi, bi, m // bj, bj)
    norms = torch.abs(blocks).sum(dim=(1, 3))
    k = int(round(sparsity * norms.numel()))
    if k == 0:
        return w
    thresh = torch.sort(norms.reshape(-1)).values[k - 1]
    mask = (norms > thresh)[:, None, :, None]
    return (blocks * mask).reshape(n, m)


def run_pieces(offsets: np.ndarray) -> np.ndarray:
    """The large-M block-sparse kernel's work list: each block-column's run
    of tiles (``offsets[c]:offsets[c + 1]`` in column order) cut into
    pieces of near-equal length, at most ``ceil(nnz / (2 n_cols))`` tiles
    each, so that a column with a long run does not set the kernel's time.
    An empty run is one empty piece (its blocks write zeros).

    Returns (n_pieces, 5) int32 rows ``(column, first tile, end tile,
    the column's first piece, the column's piece count)``, columns in
    order, pieces in run order.  The kernel sums a column's pieces in that
    order (csrc/sparse_matmul.cu)."""
    counts = np.diff(offsets)
    n_cols = len(counts)
    most = max(1, -(-int(offsets[-1]) // (2 * n_cols)))
    pieces = []
    for c in range(n_cols):
        k = max(1, -(-int(counts[c]) // most))
        bounds = offsets[c] + (int(counts[c]) * np.arange(k + 1)) // k
        first = len(pieces)
        pieces += [(c, bounds[i], bounds[i + 1], first, k) for i in range(k)]
    return np.asarray(pieces, np.int32).reshape(-1, 5)


@dataclasses.dataclass(frozen=True)
class BlockSparseWeight:
    """Plan-time representation consumed by the block-sparse kernel.

    ``indices[k] = (bi, bj)`` lists the nonzero blocks (row-major block
    order, as the reference's); ``values[k]`` holds the matching
    ``(block_k, block_n)`` tile.  Built once with them, on ``values``'
    device, is what the kernel walks: ``col_values``, the tiles sorted by
    output block-column (then block-row); ``col_rows``, each sorted tile's
    block-row; ``col_offsets``, where each block-column's run of tiles starts
    in that order (``n_col_blocks + 1`` entries; an empty run is a
    block-column pruned whole); ``col_pieces``, the large-M kernel's work
    list (:func:`run_pieces`).  No index crosses from the host per call.
    """

    values: torch.Tensor       # (nnz_blocks, bk, bn)
    indices: np.ndarray        # (nnz_blocks, 2) int32 block coordinates
    shape: Tuple[int, int]
    block: Tuple[int, int]
    col_values: torch.Tensor = dataclasses.field(init=False, repr=False)
    col_rows: torch.Tensor = dataclasses.field(init=False, repr=False)
    col_offsets: torch.Tensor = dataclasses.field(init=False, repr=False)
    col_pieces: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        indices = np.asarray(self.indices, np.int32).reshape(-1, 2)
        object.__setattr__(self, "indices", indices)
        (k, n), (bk, bn) = self.shape, self.block
        if bk <= 0 or bn <= 0 or k % bk or n % bn:
            raise ValueError(f"BlockSparseWeight: shape {self.shape} not "
                             f"divisible by block {self.block}")
        n_rows, n_cols = k // bk, n // bn
        if ((indices < 0) | (indices >= (n_rows, n_cols))).any():
            raise ValueError(f"BlockSparseWeight: a block index lies outside "
                             f"the {n_rows} x {n_cols} block grid")
        if tuple(self.values.shape) != (len(indices), bk, bn):
            raise ValueError(f"BlockSparseWeight: values of shape "
                             f"{tuple(self.values.shape)} for {len(indices)} "
                             f"blocks of {self.block}")
        order = np.lexsort((indices[:, 0], indices[:, 1]))
        counts = np.bincount(indices[:, 1], minlength=n_cols)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        dev = self.values.device
        object.__setattr__(self, "col_values", self.values[
            torch.as_tensor(order, device=dev)].contiguous())
        object.__setattr__(self, "col_rows", torch.as_tensor(
            indices[order, 0].copy(), dtype=torch.int32, device=dev))
        object.__setattr__(self, "col_offsets", torch.as_tensor(
            offsets, dtype=torch.int32, device=dev))
        object.__setattr__(self, "col_pieces", torch.as_tensor(
            run_pieces(offsets), dtype=torch.int32, device=dev))

    @property
    def nnz_blocks(self) -> int:
        return int(self.indices.shape[0])

    @property
    def density(self) -> float:
        bn, bm = self.block
        total = (self.shape[0] // bn) * (self.shape[1] // bm)
        return self.nnz_blocks / max(total, 1)

    def to_dense(self) -> torch.Tensor:
        bn, bm = self.block
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        for k, (bi, bj) in enumerate(self.indices):
            out[bi * bn:(bi + 1) * bn, bj * bm:(bj + 1) * bm] = self.values[k]
        return out


def compress_blocks(
    w: torch.Tensor, block: Tuple[int, int] = (128, 128), tol: float = 0.0
) -> BlockSparseWeight:
    """Extract the nonzero-block structure of a (pruned) weight matrix."""
    bn, bm = block
    n, m = w.shape
    if n % bn or m % bm:
        raise ValueError(f"shape {tuple(w.shape)} not divisible by block "
                         f"{block}")
    tiles = w.reshape(n // bn, bn, m // bm, bm).permute(0, 2, 1, 3)
    live = torch.amax(torch.abs(tiles), dim=(2, 3)) > tol
    nz = torch.nonzero(live).cpu().numpy().astype(np.int32)
    if nz.size == 0:
        nz = np.zeros((1, 2), np.int32)  # keep at least one block
    sel = torch.as_tensor(nz, dtype=torch.long, device=w.device)
    values = tiles[sel[:, 0], sel[:, 1]].contiguous()
    return BlockSparseWeight(values=values, indices=nz, shape=(n, m),
                             block=block)


def prune_model(
    model: Model, params: ParamTree, sparsity: float, *,
    block: Tuple[int, int] | None = None
) -> ParamTree:
    """Magnitude-prune every Dense weight in a model."""
    out: ParamTree = {}
    for node in model.graph.nodes:
        p = dict(params[node.uid])
        if isinstance(node.layer, Dense) and "w" in p:
            if block is not None:
                p["w"] = block_magnitude_prune(p["w"], sparsity, block)
            else:
                p["w"] = magnitude_prune(p["w"], sparsity)
        out[node.uid] = p
    return out


def sparsity_of(w: torch.Tensor) -> float:
    """The fraction of zero entries (exact: a count over the size)."""
    return int((w == 0.0).sum()) / w.numel()


# ---------------------------------------------------------------------------
# §6.2 economics, reproduced analytically (the reference's own counts).
# ---------------------------------------------------------------------------


def skip_op_counts(
    in_features: int,
    units: int,
    sparsity: float,
    *,
    quantized: bool,
    check_inputs: bool = False,
    input_sparsity: float = 0.0,
) -> Dict[str, float]:
    """Expected operation counts for IF-based skipping (§6.2): float ops,
    int ops and comparison ops."""
    n = in_features * units
    checks = float(n)
    executed = 1.0 - sparsity
    if check_inputs:
        checks += n * (1.0 - sparsity)  # second check short-circuits
        executed *= 1.0 - input_sparsity
    macs = n * executed
    return {
        "compare": checks,
        "mac": macs,
        "mac_dtype": "int" if quantized else "float",
        "rescale_float_mul": in_features + units if quantized else 0,
    }
