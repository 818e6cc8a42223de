"""Serving on the card (``repro.serving``'s counterpart): the fleet
``StreamEngine`` for one model, ``GroupedStreamEngine`` for a heterogeneous
fleet of model groups, the wave-batched LLM ``Engine``, the
continuous-batching ``ContinuousEngine`` and the §6.3 multipart
``CyclicDecoder``."""

from repro_torch.serving.continuous import ContinuousEngine, ServeStats
from repro_torch.serving.core import (AdaptConfig, LatencyReservoir,
                                      ServingCore, ServingUnit, StreamStats,
                                      Verdict)
from repro_torch.serving.cyclic import CycleStats, CyclicDecoder
from repro_torch.serving.engine import (Completion, Engine, Request,
                                        sample_batched)
from repro_torch.serving.grouped import GroupedStreamEngine, ModelGroup
from repro_torch.serving.streams import StreamEngine

__all__ = ["AdaptConfig", "Completion", "ContinuousEngine", "CycleStats",
           "CyclicDecoder", "Engine", "GroupedStreamEngine",
           "LatencyReservoir", "ModelGroup", "Request", "ServeStats",
           "ServingCore", "ServingUnit", "StreamEngine", "StreamStats",
           "Verdict", "sample_batched"]
