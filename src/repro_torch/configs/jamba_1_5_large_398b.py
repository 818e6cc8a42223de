"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e
top-2. [arXiv:2403.19887]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,            # 9 super-blocks of 8 (1 attention : 7 mamba)
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    mlp_kind="swiglu",
    bias=False,
    n_experts=16,
    top_k=2,
    attn_period=8,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=128,        # d_inner=16384 -> 128 SSD heads
    ssm_groups=8,
    conv_kernel=4,
    source="arXiv:2403.19887",
)
