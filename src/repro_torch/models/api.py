"""Uniform model API over the ported architecture families
(``repro.models.api``'s counterpart).

``get_model(cfg)`` returns a :class:`ModelAPI` whose functions have the same
signatures for every family, so the serving engine is family-agnostic:

  init(generator, device="cuda") -> params
  prefill(params, batch, cache_len) -> (cache, logits)
  decode(params, cache, batch, pos) -> (cache, logits)        pos: shared
  decode_multi(params, cache, batch, pos) -> (cache, logits)  pos: (B,)
  init_cache(batch, cache_len, device="cuda") -> cache arena

``decode`` updates the cache arena in place and returns it.  The port has
the ``"ssm"`` family (mamba2); the others raise, naming ROADMAP item 14, and
``loss`` waits for training (item 10).  ``backend`` (``'auto'|'kernel'|
'ref'``, or a mapping from kernel name to one of them: ``ops.Backend``)
goes to every kernel wrapper the model calls.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import Device, resolve_device
from repro_torch.kernels.ops import Backend
from repro_torch.models import mamba2

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]
PORTED_FAMILIES = ("ssm",)


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., Params]
    prefill: Callable[[Params, Batch, int], Tuple[Any, torch.Tensor]]
    decode: Callable[[Params, Any, Batch, Any], Tuple[Any, torch.Tensor]]
    decode_multi: Callable[[Params, Any, Batch, Any],
                           Tuple[Any, torch.Tensor]]
    init_cache: Callable[..., Any]


def get_model(cfg: ArchConfig, *, backend: Backend = "auto") -> ModelAPI:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported: the "
            f"port has {PORTED_FAMILIES}; the other families are ROADMAP "
            "item 14")

    def init(generator: torch.Generator, device: Device = "cuda") -> Params:
        """Random params from ``generator`` (draws on its device), on
        ``device``; raises without CUDA unless ``device="cpu"``."""
        return mamba2.model_init(generator, cfg, device=resolve_device(device))

    def init_cache(batch: int, cache_len: int, device: Device = "cuda"):
        return mamba2.init_cache(cfg, batch, cache_len,
                                 device=resolve_device(device))

    return ModelAPI(
        cfg=cfg, init=init,
        prefill=lambda p, b, cl: mamba2.prefill(p, cfg, b["tokens"], cl,
                                                backend=backend),
        decode=lambda p, c, b, pos: mamba2.decode_step(
            p, cfg, c, b["tokens"], pos, backend=backend),
        decode_multi=lambda p, c, b, pos: mamba2.decode_step_multi(
            p, cfg, c, b["tokens"], pos, backend=backend),
        init_cache=init_cache)
