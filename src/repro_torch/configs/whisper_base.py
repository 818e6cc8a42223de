"""whisper-base [audio]: encoder-decoder; mel+conv frontend stubbed (the
batch provides 1500 frame embeddings). [arXiv:2212.04356]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,             # 6 encoder + 6 decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    mlp_kind="gelu",
    bias=True,
    encoder_frames=1500,
    source="arXiv:2212.04356",
)
