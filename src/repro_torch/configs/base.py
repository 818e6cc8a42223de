"""Architecture configuration schema and the port's registry
(``repro.configs.base``'s counterpart).

``ArchConfig`` carries the same fields, properties and ``reduced()`` sizes as
the reference; ``dtype`` is a :class:`torch.dtype`.  :func:`get_config`
covers every architecture of ``ARCH_IDS`` (all six families); an id that is
not one raises.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional

import torch

ARCH_IDS = (
    "llava_next_34b",
    "mamba2_370m",
    "whisper_base",
    "granite_moe_1b_a400m",
    "command_r_35b",
    "jamba_1_5_large_398b",
    "nemotron_4_340b",
    "qwen3_8b",
    "command_r_plus_104b",
    "mixtral_8x22b",
)

# Input shapes assigned to this paper (global batch, sequence length).
INPUT_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""
    # attention features
    qk_norm: bool = False
    mlp_kind: str = "swiglu"         # swiglu | gelu | squared_relu
    bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    swa_for_long: int = 4096
    parallel_block: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / jamba mamba layers)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    conv_kernel: int = 4
    # hybrid (jamba): one attention layer per `attn_period` mixer layers
    attn_period: int = 0
    # modality stubs
    num_image_tokens: int = 0
    encoder_frames: int = 0
    # execution policy (the ICSML levers)
    dtype: Any = torch.bfloat16
    quant: Optional[str] = None      # None | SINT | INT | DINT (serving)
    kv_quant: bool = False
    remat: str = "layer"
    scan_unroll: int = 1
    d_head_override: Optional[int] = None
    seq_parallel: bool = False
    moe_group: int = 512
    moe_dispatch_dtype: str = "float32"
    notes: str = ""

    @property
    def d_head(self) -> int:
        if self.d_head_override:
            return self.d_head_override
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: ≤2 layers, d_model ≤ 512, ≤4 experts (the
        reference's sizes)."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        kw = dict(
            n_layers=2 if self.family != "hybrid" else max(self.attn_period, 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 1024),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_headdim=min(self.ssm_headdim, 32) if self.ssm_headdim else 0,
            num_image_tokens=(min(self.num_image_tokens, 16)
                              if self.num_image_tokens else 0),
            encoder_frames=(min(self.encoder_frames, 32)
                            if self.encoder_frames else 0),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
            swa_for_long=64,
        )
        return self.with_(**kw)


def get_config(arch_id: str) -> ArchConfig:
    """The named configuration; raises for an id not in ``ARCH_IDS``."""
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}: the port serves "
                         f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}").CONFIG
