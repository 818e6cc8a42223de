"""command-r-35b [dense]: GQA, no-bias, parallel attention/FFN block.
[hf:CohereForAI/c4ai-command-r-v01]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    mlp_kind="swiglu",
    bias=False,
    parallel_block=True,
    rope_theta=8_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
