"""Hand-written Hopper kernels for the §7 detector and their wrappers.

* ``fused_mlp`` — the whole Dense stack in ONE launch (``csrc/fused_mlp.cu``).
* ``grouped_fused_mlp`` — a heterogeneous fleet of stacks in ONE launch
  (``csrc/grouped_mlp.cu``; its wrapper lives in ``fused_mlp.py``).
* ``qmatmul`` — int8 GEMM with fused dequantization (``csrc/qmatmul.cu``).

``ops`` holds the public wrappers and the ``backend`` contract, ``ref`` the
plain PyTorch versions, ``build`` the nvcc build and ctypes loading.
"""
