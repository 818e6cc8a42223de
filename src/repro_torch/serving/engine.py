"""Batched LLM serving: static-batch prefill + synchronized decode
(``repro.serving.engine``'s counterpart).

The ICSML discipline applied to serving, as in the reference: the decode
state arena is **preallocated** at construction (``api.init_cache``) and
updated in place step after step (the analogue of the reference's donated
cache); requests are admitted in waves, and all slots share the position
counter, as the PLC scan cycle shares one clock.  ``extras`` (the vlm's
``image_emb``, the audio family's ``frames``: one row per slot) are merged
into every prefill and decode batch, as the reference.  Decode positions
count from the text prompt's length, as the reference's engine counts them:
a vlm's image prefix is not added to them.  The engine runs on the card
unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.device import Device, resolve_device
from repro_torch.models.api import ModelAPI


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int token ids
    max_new_tokens: int
    temperature: float = 0.0      # 0 => greedy
    eos_token: Optional[int] = None   # retire early when sampled


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: np.ndarray
    prefill_s: float
    decode_s: float
    finished_s: float = 0.0       # wall time from serve() start to retirement

    @property
    def tokens_per_s(self) -> float:
        n = len(self.tokens)
        return n / self.decode_s if self.decode_s > 0 else float("inf")


def sample_batched(logits: torch.Tensor, temperatures: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """Per-row sampling: logits (B, V), temperatures (B,).

    Rows with temperature <= 0 take the argmax; the others draw from their
    own temperature-scaled distribution (``torch.multinomial`` with
    ``generator``, on the logits' device).  Returns (B,) int64."""
    greedy = torch.argmax(logits, dim=-1)
    hot = temperatures > 0.0
    if not bool(hot.any()):
        return greedy
    scaled = logits / torch.clamp_min(temperatures, 1e-6)[:, None]
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                generator=generator)[:, 0]
    return torch.where(hot, sampled, greedy)


def _copy_into(dst: Any, src: Any) -> None:
    """Copy a (nested) cache tree into the arena of the same layout."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        dst.copy_(src)


def _truncate_eos(tokens: np.ndarray, eos: Optional[int]) -> np.ndarray:
    if eos is None:
        return tokens
    hits = np.flatnonzero(tokens == eos)
    return tokens[: hits[0] + 1] if hits.size else tokens


class Engine:
    """Wave-batched serving over a :class:`ModelAPI`."""

    def __init__(self, api: ModelAPI, params: Any, *, batch_slots: int,
                 cache_len: int,
                 extras: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, device: Device = "cuda"):
        self.device = resolve_device(device)
        self.api = api
        self.params = params
        self.batch_slots = batch_slots
        self.cache_len = cache_len
        self.extras = {k: v.to(self.device)
                       for k, v in (extras or {}).items()}
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        # The static state arena, written in place by every decode step.
        self.cache = api.init_cache(batch_slots, cache_len,
                                    device=self.device)
        # The last wave's prefill logits at the last prompt position
        # (B, vocab) f32, on the device.
        self.last_prefill_logits: Optional[torch.Tensor] = None

    def run_wave(self, requests: Sequence[Request]) -> List[Completion]:
        """Serve one wave of ≤ batch_slots requests (right-padded prompts)."""
        reqs = list(requests)
        if not 0 < len(reqs) <= self.batch_slots:
            raise ValueError(f"a wave holds 1 to {self.batch_slots} "
                             f"requests, got {len(reqs)}")
        b = self.batch_slots
        plen = max(len(r.prompt) for r in reqs)
        max_new = max(r.max_new_tokens for r in reqs)
        if plen + max_new - 1 > self.cache_len:
            raise ValueError(f"prompt ({plen}) + max_new_tokens ({max_new}) "
                             f"overflow the cache ({self.cache_len})")
        prompts = np.zeros((b, plen), np.int64)
        temps = np.zeros((b,), np.float32)   # empty slots run greedy
        for i, r in enumerate(reqs):
            prompts[i, :len(r.prompt)] = r.prompt
            temps[i] = r.temperature
        temps_t = torch.from_numpy(temps).to(self.device)

        with trace.span("engine.prefill", device=self.device):
            t0 = time.perf_counter()
            batch = {"tokens": torch.from_numpy(prompts).to(self.device),
                     **self.extras}
            states, logits = self.api.prefill(self.params, batch,
                                              self.cache_len)
            _copy_into(self.cache, states)
            self.last_prefill_logits = logits[:, -1]
            cur = sample_batched(logits[:, -1], temps_t, self._generator)
            out = np.zeros((b, max_new), np.int64)
            out[:, 0] = cur.cpu().numpy()
            t_prefill = time.perf_counter() - t0

        t1 = time.perf_counter()
        for step in range(1, max_new):
            self.cache, logits = self.api.decode(
                self.params, self.cache,
                {"tokens": cur[:, None], **self.extras}, plen + step - 1)
            cur = sample_batched(logits[:, -1], temps_t, self._generator)
            out[:, step] = cur.cpu().numpy()    # waits for the step
        t_decode = time.perf_counter() - t1

        return [
            Completion(uid=r.uid,
                       tokens=_truncate_eos(out[i, :r.max_new_tokens],
                                            r.eos_token),
                       prefill_s=t_prefill, decode_s=t_decode)
            for i, r in enumerate(reqs)
        ]

    def serve(self, requests: Sequence[Request]) -> List[Completion]:
        """Serve any number of requests in waves.  ``finished_s`` is the wall
        time from serve() start to the end of the request's wave."""
        done: List[Completion] = []
        with trace.span("engine.serve"):
            t0 = time.perf_counter()
            for i in range(0, len(requests), self.batch_slots):
                wave = self.run_wave(requests[i:i + self.batch_slots])
                t_wave = time.perf_counter() - t0
                for c in wave:
                    c.finished_s = t_wave
                done.extend(wave)
        return done
