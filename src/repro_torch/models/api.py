"""Uniform model API over the ported architecture families
(``repro.models.api``'s counterpart).

``get_model(cfg)`` returns a :class:`ModelAPI` whose functions have the same
signatures for every family, so the serving engines are family-agnostic:

  init(generator, device="cuda") -> params
  prefill(params, batch, cache_len) -> (cache, logits)
  decode(params, cache, batch, pos) -> (cache, logits)        pos: shared
  decode_multi(params, cache, batch, pos) -> (cache, logits)  pos: (B,)
  cache_specs(batch, cache_len) -> cache tree of ``meta`` tensors
  init_cache(batch, cache_len, device="cuda") -> cache arena

``decode`` and ``decode_multi`` update the cache arena in place and return
it.  The port has the ``"dense"`` (transformer), ``"moe"`` and ``"ssm"``
(mamba2) families; ``hybrid``, ``vlm`` and ``audio`` raise, naming ROADMAP
§1 item 4b, and ``loss`` waits for the LLM training stack (item 4c).
``backend`` (``'auto'|'kernel'|'ref'``, or a mapping from kernel name to one
of them: ``ops.Backend``) goes to every kernel wrapper the model calls, and
is kept on the API for the engines that call the model's layers themselves
(``serving.cyclic``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import Device, resolve_device
from repro_torch.kernels.ops import Backend
from repro_torch.models import mamba2, moe, transformer

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]
PORTED_FAMILIES = ("dense", "moe", "ssm")


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., Params]
    prefill: Callable[[Params, Batch, int], Tuple[Any, torch.Tensor]]
    decode: Callable[[Params, Any, Batch, Any], Tuple[Any, torch.Tensor]]
    decode_multi: Callable[[Params, Any, Batch, Any],
                           Tuple[Any, torch.Tensor]]
    cache_specs: Callable[[int, int], Any]
    init_cache: Callable[..., Any]
    backend: Backend = "auto"


def get_model(cfg: ArchConfig, *, backend: Backend = "auto") -> ModelAPI:
    fam = cfg.family
    if fam not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {fam!r} ({cfg.name}) is not ported: the port has "
            f"{PORTED_FAMILIES}; hybrid, vlm and audio are ROADMAP §1 "
            "item 4b")
    mod, model_init = {"dense": (transformer, transformer.decoder_init),
                       "moe": (moe, moe.model_init),
                       "ssm": (mamba2, mamba2.model_init)}[fam]

    def init(generator: torch.Generator, device: Device = "cuda") -> Params:
        """Random params from ``generator`` (draws on its device), on
        ``device``; raises without CUDA unless ``device="cpu"``."""
        return model_init(generator, cfg, device=resolve_device(device))

    def init_cache(batch: int, cache_len: int, device: Device = "cuda"):
        return mod.init_cache(cfg, batch, cache_len,
                              device=resolve_device(device))

    return ModelAPI(
        cfg=cfg, init=init,
        prefill=lambda p, b, cl: mod.prefill(p, cfg, b["tokens"], cl,
                                             backend=backend),
        decode=lambda p, c, b, pos: mod.decode_step(
            p, cfg, c, b["tokens"], pos, backend=backend),
        decode_multi=lambda p, c, b, pos: mod.decode_step_multi(
            p, cfg, c, b["tokens"], pos, backend=backend),
        cache_specs=lambda bsz, cl: mod.cache_spec(cfg, bsz, cl),
        init_cache=init_cache, backend=backend)
