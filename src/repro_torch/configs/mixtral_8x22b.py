"""mixtral-8x22b [moe]: 8 experts top-2, native sliding-window attention.
[arXiv:2401.04088]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,             # per-expert FFN width
    vocab=32768,
    mlp_kind="swiglu",
    bias=False,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)
