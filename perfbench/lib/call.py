"""One engine call as the window records it."""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional


@dataclasses.dataclass
class Call:
    requests: List[Any]          # traffic.Req, as sent
    done: List[Any]              # the engine's Completions
    start_s: float               # perf_counter at the call and its end
    end_s: float
    stats: Optional[Any] = None  # the engine's ServeStats, where it has one
    kind: str = ""               # "wave" or "continuous"
