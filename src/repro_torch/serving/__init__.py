"""Serving on the card (``repro.serving``'s counterpart): the fleet
``StreamEngine`` for one model, ``GroupedStreamEngine`` for a heterogeneous
fleet of model groups, and the wave-batched LLM ``Engine``."""

from repro_torch.serving.core import (AdaptConfig, LatencyReservoir,
                                      ServingCore, ServingUnit, StreamStats,
                                      Verdict)
from repro_torch.serving.engine import (Completion, Engine, Request,
                                        sample_batched)
from repro_torch.serving.grouped import GroupedStreamEngine, ModelGroup
from repro_torch.serving.streams import StreamEngine

__all__ = ["AdaptConfig", "Completion", "Engine", "GroupedStreamEngine",
           "LatencyReservoir", "ModelGroup", "Request", "ServingCore",
           "ServingUnit", "StreamEngine", "StreamStats", "Verdict",
           "sample_batched"]
