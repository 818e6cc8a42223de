"""The LM data pipeline (``repro.data``'s counterpart)."""

from repro_torch.data.pipeline import (DataConfig, ShardedDataset,
                                       SyntheticLM, read_shard, write_shard)

__all__ = ["DataConfig", "ShardedDataset", "SyntheticLM", "read_shard",
           "write_shard"]
