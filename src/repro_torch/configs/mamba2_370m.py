"""mamba2-370m [ssm]: attention-free SSD (state-space duality).
[arXiv:2405.21060]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                 # attention-free, no separate FFN (mamba2 block)
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,         # d_inner=2048 -> 32 SSD heads
    ssm_groups=1,
    conv_kernel=4,
    source="arXiv:2405.21060",
)
