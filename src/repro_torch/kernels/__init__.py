"""Hand-written Hopper kernels and their wrappers.

* ``fused_mlp`` — the whole Dense stack in ONE launch (``csrc/fused_mlp.cu``).
* ``grouped_fused_mlp`` — a heterogeneous fleet of stacks in ONE launch
  (``csrc/grouped_mlp.cu``; its wrapper lives in ``fused_mlp.py``).
* ``qmatmul`` — int8 GEMM with fused dequantization (``csrc/qmatmul.cu``).
* ``sparse_matmul`` — block-sparse f32 matmul over the nonzero tiles of a
  §6.2-pruned weight (``csrc/sparse_matmul.cu``).
* ``ssd_scan`` — the Mamba-2 SSD chunked scan, the whole batch in ONE launch
  (``csrc/ssd_scan.cu``).
* ``norm_codes`` — an RMSNorm row (after the Mamba-2 skip and gate, where
  asked) written out as the int8 codes of the SINT projection it feeds
  (``csrc/norm_codes.cu``).

``ops`` holds the public wrappers and the ``backend`` contract, ``ref`` the
plain PyTorch versions, ``build`` the nvcc build and ctypes loading.
"""
