"""Fleet serving on the card (``repro.serving``'s single-model half)."""

from repro_torch.serving.core import (AdaptConfig, LatencyReservoir,
                                      ServingCore, ServingUnit, StreamStats,
                                      Verdict)
from repro_torch.serving.streams import StreamEngine

__all__ = ["AdaptConfig", "LatencyReservoir", "ServingCore", "ServingUnit",
           "StreamEngine", "StreamStats", "Verdict"]
