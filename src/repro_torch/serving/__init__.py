"""Fleet serving on the card (``repro.serving``'s stream-engine half):
``StreamEngine`` for one model, ``GroupedStreamEngine`` for a heterogeneous
fleet of model groups."""

from repro_torch.serving.core import (AdaptConfig, LatencyReservoir,
                                      ServingCore, ServingUnit, StreamStats,
                                      Verdict)
from repro_torch.serving.grouped import GroupedStreamEngine, ModelGroup
from repro_torch.serving.streams import StreamEngine

__all__ = ["AdaptConfig", "GroupedStreamEngine", "LatencyReservoir",
           "ModelGroup", "ServingCore", "ServingUnit", "StreamEngine",
           "StreamStats", "Verdict"]
