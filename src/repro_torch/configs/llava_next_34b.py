"""llava-next-34b [vlm]: anyres tiling VLM; language backbone below, vision
encoder + projector stubbed (the batch provides patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf scaled per assignment]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    mlp_kind="swiglu",
    bias=False,
    rope_theta=1_000_000.0,
    # anyres tiling: base 576 tokens + 4 tiles x 576 = 2880 image tokens
    num_image_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
