"""The yardstick's peaks and the least time a piece of work can take on one
NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the 700 W limit).

Frozen copies of ``chip_smoke.py``'s ``bound``, ``qmatmul_shape_bound``,
``_ssd_flops`` and ``ssd_bound``, taking shapes instead of tensors.  They
count a kernel's work from its shapes, whatever implements it: each input
byte read once, each output byte written once, each product at the peak
of its operand type.  A later change to the program cannot move them.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12        # bf16 on the tensor cores
TF32_FLOPS_PER_S = 495e12        # TF32 on the tensor cores
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores


def bound(n_bytes: float, op_seconds: float) -> Tuple[float, str]:
    """(seconds, what bounds it): the larger of the byte time and the
    operation time."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (max(t_bytes, op_seconds),
            "bytes" if t_bytes >= op_seconds else "operations")


def qmatmul_shape_bound(m: int, k: int, n: int) -> Tuple[float, str]:
    """An int8 (m, k) x (k, n) product with f32 scales (n,) and an f32
    (m, n) output, no bias."""
    return bound(m * k + k * n + 4 * n + 4 * m * n,
                 2 * m * k * n / INT8_OPS_PER_S)


def ssd_flops(t: int, chunk: int, p: int, n: int, last_update: bool
              ) -> Tuple[int, int]:
    """The chunked algorithm's products for one (batch row, head) over T
    steps, as (C Bᵀ, the rest): per chunk of l steps the causal halves of
    C Bᵀ (N l (l + 1)) and of (decay ∘ C Bᵀ) x (P l (l + 1)), the readout
    of the carried state (2 l N P, not in the first chunk: the state is 0)
    and the state update (2 l N P; after the last chunk only if
    ``last_update``)."""
    starts = range(0, t, chunk)
    cb = rest = 0
    for i, t0 in enumerate(starts):
        l = min(chunk, t - t0)
        cb += n * l * (l + 1)
        rest += p * l * (l + 1)
        rest += 2 * l * n * p * ((i > 0) + (last_update
                                             or i < len(starts) - 1))
    return cb, rest


# The chunk the SSD's work is counted at (the kernel's, 64 steps).
SSD_CHUNK = 64


def ssd_bound(bsz: int, t: int, h: int, p: int, g: int, n: int,
              in_dtype: str, in_bytes: int, state: bool
              ) -> Tuple[float, str]:
    """One SSD scan over (B, T, H, P) with B and C (B, T, G, N), the final
    state written too when ``state``.  On f32 inputs every product is three
    TF32 tensor-core passes (3xTF32).  On bf16 x, B and C their low parts
    are 0: C Bᵀ is one bf16 product at the bf16 rate and the other three
    products two TF32 passes.  Bytes: x, B and C read once in their own
    type (``in_bytes``: their element count times its size), dt (B, T, H)
    and A (H,) f32, y (B, T, H, P) f32 written once, the state
    (B, H, P, N) f32 once."""
    cb, rest = (f * bsz * h for f in ssd_flops(t, SSD_CHUNK, p, n, True))
    if in_dtype == "bfloat16":
        op_seconds = cb / BF16_FLOPS_PER_S + 2 * rest / TF32_FLOPS_PER_S
    else:
        op_seconds = 3 * (cb + rest) / TF32_FLOPS_PER_S
    moved = (in_bytes + 4 * (bsz * t * h + h + bsz * t * h * p)
             + (4 * bsz * h * p * n if state else 0))
    return bound(moved, op_seconds)


def product_seconds(flops: float, dtype: str) -> float:
    """The least time of ``flops`` of products with operands of ``dtype``
    (int8 counts operations)."""
    peak = {"int8": INT8_OPS_PER_S, "bfloat16": BF16_FLOPS_PER_S,
            "float16": BF16_FLOPS_PER_S, "tf32": TF32_FLOPS_PER_S,
            "float32": F32_FLOPS_PER_S}[dtype]
    return flops / peak


def linear_bound(m: int, k: int, n: int, quant) -> Tuple[float, str]:
    """An (m, k) x (k, n) linear layer: the int8 product where the
    configuration quantizes it (``qmatmul_shape_bound``), else a bf16
    product with bf16 operands and output."""
    if quant:
        return qmatmul_shape_bound(m, k, n)
    return bound(2 * (m * k + k * n + m * n),
                 product_seconds(2 * m * k * n, "bfloat16"))
