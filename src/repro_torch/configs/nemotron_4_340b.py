"""nemotron-4-340b [dense]: GQA, squared-ReLU MLP (no GLU).
[arXiv:2402.16819]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    mlp_kind="squared_relu",
    bias=False,
    source="arXiv:2402.16819",
)
