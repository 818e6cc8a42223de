"""Uniform model API over the architecture families
(``repro.models.api``'s counterpart).

``get_model(cfg)`` returns a :class:`ModelAPI` whose functions have the same
signatures for every family, so the serving engines are family-agnostic:

  init(generator, device="cuda") -> params
  loss(params, batch) -> scalar                                (train)
  prefill(params, batch, cache_len) -> (cache, logits)
  decode(params, cache, batch, pos) -> (cache, logits)        pos: shared
  decode_multi(params, cache, batch, pos) -> (cache, logits)  pos: (B,)
  cache_specs(batch, cache_len) -> cache tree of ``meta`` tensors
  init_cache(batch, cache_len, device="cuda") -> cache arena
  batch_specs(kind, batch, seq) -> batch of ``meta`` tensors
  init_batch(kind, batch, seq, generator, device="cuda") -> random batch

``decode`` and ``decode_multi`` update the cache arena in place and return
it.  The port has all six families: ``dense`` (transformer), ``moe``,
``ssm`` (mamba2), ``hybrid`` (Jamba), ``vlm`` (LLaVA-NeXT) and ``audio``
(Whisper).  ``loss`` is each family's ``loss_fn``: the mean next-token
cross-entropy of a ``"train"`` batch (MoE adds ``moe.AUX_WEIGHT`` times its
load-balance aux loss), each layer rematerialised under autograd when
``cfg.remat == "layer"``; ``repro_torch.launch.steps.make_train_step``
differentiates it.  Batch layouts per family, as the reference:

  dense/moe/ssm/hybrid: {tokens (B, S)}
  vlm:   {tokens (B, S - I), image_emb (B, I, VISION_D)} at prefill
  audio: {tokens (B, S), frames (B, F, d_model)} at prefill

and ``{tokens (B, 1)}`` at decode (a ``"train"`` batch adds ``labels`` like
``tokens``).  ``backend`` (``'auto'|'kernel'|'ref'``, or a mapping from
kernel name to one of them: ``ops.Backend``) goes to every kernel wrapper
the model calls, and is kept on the API for the engines that call the
model's layers themselves (``serving.cyclic``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import Device, resolve_device
from repro_torch.kernels.ops import Backend
from repro_torch.models import hybrid, mamba2, moe, transformer, vlm, whisper

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]
# family -> (module with prefill/decode/cache functions, its param init)
_FAMILIES = {"dense": (transformer, transformer.decoder_init),
             "moe": (moe, moe.model_init),
             "ssm": (mamba2, mamba2.model_init),
             "hybrid": (hybrid, hybrid.model_init),
             "vlm": (vlm, vlm.model_init),
             "audio": (whisper, whisper.model_init)}
PORTED_FAMILIES = tuple(_FAMILIES)


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ArchConfig
    init: Callable[..., Params]
    loss: Callable[[Params, Batch], torch.Tensor]
    prefill: Callable[[Params, Batch, int], Tuple[Any, torch.Tensor]]
    decode: Callable[[Params, Any, Batch, Any], Tuple[Any, torch.Tensor]]
    decode_multi: Callable[[Params, Any, Batch, Any],
                           Tuple[Any, torch.Tensor]]
    cache_specs: Callable[[int, int], Any]
    init_cache: Callable[..., Any]
    batch_specs: Callable[[str, int, int], Batch]
    backend: Backend = "auto"

    def init_batch(self, kind: str, batch: int, seq: int,
                   generator: torch.Generator, device: Device = "cuda"
                   ) -> Batch:
        """A random batch matching :attr:`batch_specs`, drawn from
        ``generator`` (on its device) and placed on ``device``: token ids
        uniform in the vocabulary, embeddings standard normal in their
        dtype."""
        dev = resolve_device(device)
        out = {}
        for name, s in self.batch_specs(kind, batch, seq).items():
            if s.dtype.is_floating_point:
                v = torch.randn(s.shape, generator=generator,
                                device=generator.device).to(s.dtype)
            else:
                v = torch.randint(0, self.cfg.vocab, s.shape,
                                  generator=generator,
                                  device=generator.device, dtype=s.dtype)
            out[name] = v.to(dev)
        return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg: ArchConfig) -> Callable[[str, int, int], Batch]:
    """The family's batch layout at (kind, batch, seq): token ids int64;
    the vlm's ``image_emb`` takes ``cfg.num_image_tokens`` of ``seq``."""
    def specs(kind: str, batch: int, seq: int) -> Batch:
        if kind not in ("train", "prefill"):
            return {"tokens": _meta((batch, 1), torch.int64)}
        extra = {}
        if cfg.family == "vlm":
            extra["image_emb"] = _meta(
                (batch, cfg.num_image_tokens, vlm.VISION_D), cfg.dtype)
            seq = max(seq - cfg.num_image_tokens, 1)
        elif cfg.family == "audio":
            extra["frames"] = _meta((batch, cfg.encoder_frames, cfg.d_model),
                                    cfg.dtype)
        out = {"tokens": _meta((batch, seq), torch.int64)}
        if kind == "train":
            out["labels"] = _meta((batch, seq), torch.int64)
        return {**out, **extra}
    return specs


def get_model(cfg: ArchConfig, *, backend: Backend = "auto") -> ModelAPI:
    """The family's :class:`ModelAPI`, every kernel wrapper on its paths
    given ``backend``.  Serving and a loss without a gradient take
    ``"auto"``: the kernels on the card.  The train step differentiates
    the model built with ``launch.steps.GRAD_BACKEND``
    (``{"ssd_scan": "chunked", "qmatmul": "ref"}``): no kernel of the port
    has a backward (``ops`` raises if one is asked for a gradient), and the
    chunked SSD is the reference's own gradient path off the TPU."""
    fam = cfg.family
    if fam not in _FAMILIES:
        raise ValueError(f"unknown family {fam!r} ({cfg.name}): the port "
                         f"has {PORTED_FAMILIES}")
    mod, model_init = _FAMILIES[fam]

    def init(generator: torch.Generator, device: Device = "cuda") -> Params:
        """Random params from ``generator`` (draws on its device), on
        ``device``; raises without CUDA unless ``device="cpu"``."""
        return model_init(generator, cfg, device=resolve_device(device))

    def init_cache(batch: int, cache_len: int, device: Device = "cuda"):
        return mod.init_cache(cfg, batch, cache_len,
                              device=resolve_device(device))

    def loss(p, b):
        return mod.loss_fn(p, cfg, b, backend=backend)

    if fam == "vlm":
        def prefill(p, b, cl):
            return vlm.prefill(p, cfg, b, cl, backend=backend)
    elif fam == "audio":
        def prefill(p, b, cl):
            return whisper.prefill(p, cfg, b["frames"], b["tokens"], cl,
                                   backend=backend)
    else:
        def prefill(p, b, cl):
            return mod.prefill(p, cfg, b["tokens"], cl, backend=backend)

    return ModelAPI(
        cfg=cfg, init=init, loss=loss, prefill=prefill,
        decode=lambda p, c, b, pos: mod.decode_step(
            p, cfg, c, b["tokens"], pos, backend=backend),
        decode_multi=lambda p, c, b, pos: mod.decode_step_multi(
            p, cfg, c, b["tokens"], pos, backend=backend),
        cache_specs=lambda bsz, cl: mod.cache_spec(cfg, bsz, cl),
        init_cache=init_cache, batch_specs=_batch_specs(cfg),
        backend=backend)
